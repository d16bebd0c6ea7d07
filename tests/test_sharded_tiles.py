"""2-D tile grid sharding with halo exchange (grid_sharding="tiles",
SURVEY §2 "grid tiles = shards").

Three layers of evidence:
  * raster-level: border-crossing evidence placed by agents near tile
    corners is shipped through the two-phase ppermute halo exchange and
    lands identically to a single full-grid raster (corners included);
  * engine-level: on the tiled-rooms world (evidence core-contained) the
    tiles decomposition is BIT-IDENTICAL to the replicated psum path;
  * static proof: worlds whose agents' evidence escapes the exchangeable
    region are rejected at build time.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from swarm_tpu.config import EngineConfig, GridConfig, SwarmConfig
from swarm_tpu.engine.sim import make_agent_params, sim_init
from swarm_tpu.geom.world import make_tiled_rooms, walls_by_group
from swarm_tpu.ops.beam_raster import (BeamSpec, endpoint_rays,
                                       free_raster_reference)
from swarm_tpu.ops.raster import logodds_delta
from swarm_tpu.parallel import make_mesh, make_sharded_sim_step, shard_state
from swarm_tpu.parallel.sharded import _halo_exchange


def _mesh2d(r, c):
    devs = np.asarray(jax.devices()[:r * c]).reshape(r, c)
    return Mesh(devs, ("gr", "gc"))


def _tiled_world(n_rooms=8, per_row=2, scan_rays=37):
    """Tiled-room world whose natural agent order is device-major for a
    (n_rooms/per_row, per_row)-tile mesh with one room tile per device."""
    n_agents = 2 * n_rooms
    walls, origins = make_tiled_rooms(n_rooms, per_row=per_row)
    size = max(per_row * 256, (n_rooms // per_row) * 128)
    size = -(-size // 256) * 256
    grid = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    eng = EngineConfig(parity_mode=False, compute_frontiers=False,
                      raster_mode="beam", scan_rays=scan_rays,
                      raster_4way=False, fast_raster=False,
                      kernel_endpoints=False, endpoint_hits=True)
    cfg = SwarmConfig(n_agents=n_agents, grid=grid, engine=eng)
    params = make_agent_params(n_agents, separation=2.0, cfg=cfg)
    i = np.arange(n_agents)
    room = i // 2
    ox = origins[room, 0] + np.where(i % 2 == 1, 5.5, 0.5)
    oy = origins[room, 1] + np.where(i % 2 == 1, 3.5, 0.5)
    params = params._replace(
        home_x=jnp.asarray(ox, jnp.float32),
        home_y=jnp.asarray(oy, jnp.float32),
        x_offset=jnp.zeros((n_agents,), jnp.float32))
    return cfg, walls, params, walls_by_group(walls), jnp.asarray(
        room, jnp.int32)


def test_halo_exchange_raster_equivalence():
    """Agents at tile inner corners paint across ALL borders (diagonals
    included); the exchanged tile mosaic equals the full-grid raster."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = _mesh2d(2, 2)
    size = 512
    # big clamp: free_raster_reference clamps its own output, and at
    # saturation the clamp groups differently between one 4-agent call
    # and four 1-agent calls — engine paths share the per-device
    # grouping, but this test's reference is a single call
    grid = GridConfig(size=size, origin_x=0.0, origin_y=0.0,
                      logodds_clamp=1e6)
    wr = wc = size // 2
    halo_r, halo_c = 32, 128
    spec = BeamSpec.scan(61)
    res = grid.resolution

    # one agent per device, sitting 3 cells from its tile's inner corner
    corner = np.array([[wr - 3, wc - 3], [wr - 3, wc + 3],
                       [wr + 3, wc - 3], [wr + 3, wc + 3]], np.float32)
    xy = jnp.asarray(corner[:, ::-1] * res)            # (x, y) world
    yaw = jnp.asarray([0.7, 2.3, -1.9, 0.1])
    key = jax.random.PRNGKey(3)
    dist = jax.random.uniform(key, (4, 61), minval=0.15, maxval=1.19)
    trusted = dist < 1.0
    active = jnp.ones((4,), bool)

    def raster_one(i_sl, band, band_cols):
        """Evidence of agent slice i into a (banded) target."""
        d_free, w = free_raster_reference(
            jnp.zeros((band[1] if band else size,
                       band_cols[1] if band_cols else size)),
            xy[i_sl], yaw[i_sl], dist[i_sl], active[i_sl], spec, grid,
            n_groups=spec.n_beams, reach=26, band=band,
            band_cols=band_cols, tail_weight=0.0)
        ep, w2 = logodds_delta(
            endpoint_rays(xy[i_sl], yaw[i_sl], dist[i_sl],
                          trusted[i_sl], active[i_sl], spec),
            grid, k_max=1, band=band, band_cols=band_cols)
        return d_free + ep, w + w2

    # reference: all four agents into the full grid
    ref, w_ref = raster_one(slice(None), None, None)

    dummy = jnp.arange(4.0)

    def body(_):
        tr = jax.lax.axis_index("gr")
        tc = jax.lax.axis_index("gc")
        i = tr * 2 + tc
        band = (tr * wr - halo_r, wr + 2 * halo_r)
        band_cols = (tc * wc - halo_c, wc + 2 * halo_c)
        # each device owns ONE agent (masked; shapes stay static)
        own = jnp.arange(4) == i
        ext, w = raster_one_masked(band, band_cols, own)
        core = _halo_exchange(ext, 2, 2, halo_r, halo_c, wr, wc,
                              "gr", "gc")
        return core, jax.lax.psum(w, ("gr", "gc"))

    def raster_one_masked(band, band_cols, own):
        d_free, w = free_raster_reference(
            jnp.zeros((band[1], band_cols[1])),
            xy, yaw, jnp.where(own[:, None], dist, 0.0), active & own,
            spec, grid, n_groups=spec.n_beams, reach=26, band=band,
            band_cols=band_cols, tail_weight=0.0)
        ep, w2 = logodds_delta(
            endpoint_rays(xy, yaw, dist, trusted & own[:, None],
                          active & own, spec),
            grid, k_max=1, band=band, band_cols=band_cols)
        return d_free + ep, w + w2

    f = shard_map(body, mesh=mesh, in_specs=(P(("gr", "gc")),),
                  out_specs=(P("gr", "gc"), P()), check_vma=False)
    tiled, w_tiled = f(dummy)

    # compare post-accumulation clamped maps (what the engine keeps):
    # free_raster_reference clamps its own output, so saturated cells
    # differ pre-clamp depending on whether the sum crossed the clamp
    # before or after the halo merge
    cl = grid.logodds_clamp
    np.testing.assert_allclose(
        np.asarray(jnp.clip(tiled, -cl, cl)),
        np.asarray(jnp.clip(ref, -cl, cl)), atol=1e-5)
    assert int(w_tiled) == int(w_ref)


def test_tiles_engine_bit_equal_replicated():
    d = len(jax.devices())
    if d < 8:
        pytest.skip("needs 8 devices")
    cfg, walls, params, wg, roa = _tiled_world(8, per_row=2)
    steps = 8

    rep_step = make_sharded_sim_step(cfg, walls, params, make_mesh(8),
                                     donate=False)
    st_rep = shard_state(sim_init(cfg, params), make_mesh(8))
    for _ in range(steps):
        st_rep, m_rep = rep_step(st_rep)

    mesh = _mesh2d(4, 2)
    tile_step = make_sharded_sim_step(cfg, walls, params, mesh,
                                      donate=False, grid_sharding="tiles",
                                      walls_grouped=wg, room_of_agent=roa)
    st_til = shard_state(sim_init(cfg, params), mesh,
                         grid_tiles_sharded=True)
    for _ in range(steps):
        st_til, m_til = tile_step(st_til)

    np.testing.assert_array_equal(np.asarray(st_til.pose_true),
                                  np.asarray(st_rep.pose_true))
    np.testing.assert_array_equal(np.asarray(st_til.srv.logodds),
                                  np.asarray(st_rep.srv.logodds))
    assert int(m_til.writes) == int(m_rep.writes)
    assert int(m_til.band_escapes) == 0
    from swarm_tpu.engine.sim import total_writes_value
    assert total_writes_value(st_til.srv.total_writes) > 0


def test_tiles_engine_with_frontiers_and_merge():
    """Frontier two-stage gather + in-engine merge compile and run on the
    tiles decomposition."""
    d = len(jax.devices())
    if d < 8:
        pytest.skip("needs 8 devices")
    cfg, walls, params, wg, roa = _tiled_world(8, per_row=2)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, compute_frontiers=True, merge_every=4))
    mesh = _mesh2d(4, 2)
    step = make_sharded_sim_step(cfg, walls, params, mesh, donate=False,
                                 grid_sharding="tiles",
                                 walls_grouped=wg, room_of_agent=roa)
    st = shard_state(sim_init(cfg, params), mesh, grid_tiles_sharded=True)
    for _ in range(5):
        st, m = step(st)
    assert np.isfinite(np.asarray(st.srv.logodds)).all()
    assert int(m.writes) > 0
    assert int(m.n_frontiers) >= 0


def test_tiles_static_proof_rejects_escaping_rooms():
    """Rooms laid out in one tile COLUMN while the mesh splits columns:
    later devices' agents live outside their tiles — fail at build."""
    d = len(jax.devices())
    if d < 4:
        pytest.skip("needs 4 devices")
    cfg, walls, params, wg, roa = _tiled_world(4, per_row=1)
    # per_row=1: all rooms in tile column 0; mesh (2, 2) expects rooms in
    # both columns
    mesh = _mesh2d(2, 2)
    with pytest.raises(ValueError, match="escape"):
        make_sharded_sim_step(cfg, walls, params, mesh, donate=False,
                              grid_sharding="tiles",
                              walls_grouped=wg, room_of_agent=roa)

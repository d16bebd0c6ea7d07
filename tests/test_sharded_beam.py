"""Mesh-sharded step with the beam-model raster: every decomposition moves
the fast path's integer counts through its collectives, so it must match
the single-device fused engine running the same fast path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from swarm_tpu.config import EngineConfig, GridConfig, SwarmConfig
from swarm_tpu.engine.sim import (make_agent_params, make_sim_step, sim_init,
                                  total_writes_value)
from swarm_tpu.geom.world import BEDROOM_WALLS
from swarm_tpu.parallel import make_mesh, make_sharded_sim_step, shard_state


def _fused(cfg, walls, params, steps, wg=None, roa=None):
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 fast_raster=True))
    step = make_sim_step(cfg, jnp.asarray(walls), params, donate=False,
                         walls_grouped=wg, room_of_agent=roa)
    st = sim_init(cfg, params)
    for _ in range(steps):
        st, m = step(st)
    return st, m


def test_sharded_beam_matches_single_chip():
    """Replicated decomposition (grouped free space + exact endpoint
    scatter) against the fused engine's fast path on one device."""
    n = 8
    eng = EngineConfig(parity_mode=False, compute_frontiers=False,
                       raster_mode="beam", scan_rays=37,
                       raster_4way=False, beam_groups=8,
                       kernel_endpoints=False, endpoint_hits=True)
    grid = GridConfig(size=512, origin_x=-3.0, origin_y=-4.0)
    cfg = SwarmConfig(n_agents=n, grid=grid, engine=eng)
    params = make_agent_params(n, separation=2.0, cfg=cfg)
    walls = BEDROOM_WALLS
    steps = 8

    mesh = make_mesh(4)
    sh_step = make_sharded_sim_step(cfg, walls, params, mesh, donate=False)
    st_sh = shard_state(sim_init(cfg, params), mesh)
    for _ in range(steps):
        st_sh, m_sh = sh_step(st_sh)
    st_ref, m_ref = _fused(cfg, walls, params, steps)

    # trajectories identical (same RNG streams, raster doesn't feed nav)
    np.testing.assert_allclose(np.asarray(st_sh.pose_true),
                               np.asarray(st_ref.pose_true),
                               rtol=1e-5, atol=1e-6)
    # counts merge exactly; the endpoint scatter adds floats, each cell
    # from one device here, so the maps agree bit for bit
    diff = np.abs(np.asarray(st_sh.srv.logodds) -
                  np.asarray(st_ref.srv.logodds))
    assert (diff > 1e-3).sum() == 0, (diff > 1e-3).sum()
    assert int(m_sh.writes) == int(m_ref.writes) > 0


def test_sharded_pallas_kernels_match_xla_tier():
    """Rows decomposition (4 devices, one room band each) against the fused
    fast path in the same world: equal write totals, bit-equal maps."""
    import pytest

    from tests.test_sharded_spatial import _vertical_world

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")

    vcfg, vwalls, vparams, vwg, vroa = _vertical_world(4)
    vcfg = vcfg.replace(engine=dataclasses.replace(
        vcfg.engine, kernel_endpoints=True))
    step = make_sharded_sim_step(
        vcfg, vwalls, vparams, make_mesh(4), donate=False,
        grid_sharding="rows", walls_grouped=vwg, room_of_agent=vroa)
    st = shard_state(sim_init(vcfg, vparams), make_mesh(4),
                     grid_rows_sharded=True)
    for _ in range(3):
        st, m = step(st)
    st_ref, m_ref = _fused(vcfg, vwalls, vparams, 3, vwg, vroa)
    np.testing.assert_array_equal(np.asarray(st.srv.logodds),
                                  np.asarray(st_ref.srv.logodds))
    assert total_writes_value(st.srv.total_writes) == \
        total_writes_value(st_ref.srv.total_writes) > 0


def test_sharded_tiles_pallas_kernels_match_xla_tier():
    """Tiles decomposition on a 2x2 mesh — halo exchange of the counts,
    grid-edge guard, tile windows — against the fused fast path in the
    same world: equal write totals, bit-equal maps."""
    import pytest

    from jax.sharding import Mesh

    from swarm_tpu.geom.world import make_tiled_rooms_blocks, walls_by_group

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")

    # device-major room layout: each device's agent block lives inside
    # its own 2-D tile (the static containment proof's requirement)
    size = 512
    walls_np, origins = make_tiled_rooms_blocks(2, 2, size)
    n_rooms = origins.shape[0]
    n_agents = 2 * n_rooms
    eng = EngineConfig(parity_mode=False, compute_frontiers=False,
                       raster_mode="beam", scan_rays=37,
                       raster_4way=False, kernel_endpoints=True)
    cfg = SwarmConfig(n_agents=n_agents,
                      grid=GridConfig(size=size, origin_x=0.0,
                                      origin_y=0.0),
                      engine=eng)
    params = make_agent_params(n_agents, separation=2.0, cfg=cfg)
    i = np.arange(n_agents)
    room = i // 2
    params = params._replace(
        home_x=jnp.asarray(origins[room, 0] + np.where(i % 2, 5.5, 0.5),
                           jnp.float32),
        home_y=jnp.asarray(origins[room, 1] + np.where(i % 2, 3.5, 0.5),
                           jnp.float32),
        x_offset=jnp.zeros((n_agents,), jnp.float32))
    wg = walls_by_group(walls_np)
    roa = jnp.asarray(room, jnp.int32)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("gr", "gc"))
    step = make_sharded_sim_step(
        cfg, walls_np, params, mesh, donate=False, grid_sharding="tiles",
        walls_grouped=wg, room_of_agent=roa)
    st = shard_state(sim_init(cfg, params), mesh, grid_tiles_sharded=True)
    for _ in range(3):
        st, m = step(st)
    st_ref, m_ref = _fused(cfg, walls_np, params, 3, wg, roa)
    np.testing.assert_array_equal(np.asarray(st.srv.logodds),
                                  np.asarray(st_ref.srv.logodds))
    assert total_writes_value(st.srv.total_writes) == \
        total_writes_value(st_ref.srv.total_writes) > 0

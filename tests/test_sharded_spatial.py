"""Spatially row-sharded grid (grid_sharding="rows") vs the replicated
psum decomposition: bit-identical maps with ZERO map collectives, on a
vertically tiled world where each device's rooms fill whole row bands."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swarm_tpu.config import EngineConfig, GridConfig, SwarmConfig
from swarm_tpu.engine.sim import make_agent_params, sim_init
from swarm_tpu.geom.world import (make_tiled_rooms, make_vertical_rooms,
                                  walls_by_group)
from swarm_tpu.parallel import make_mesh, make_sharded_sim_step, shard_state


def _vertical_world(n_devices: int):
    """One room per device, stacked vertically: tile row r = device r's
    grid band (128 rows each)."""
    n_agents = 2 * n_devices
    walls, origins, size = make_vertical_rooms(n_devices)
    grid = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    eng = EngineConfig(parity_mode=False, compute_frontiers=False,
                       raster_mode="beam", scan_rays=37,
                       raster_4way=False, beam_groups=8,
                       fast_raster=False,
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


def test_rows_sharded_grid_matches_replicated():
    d = min(4, len(jax.devices()))
    cfg, walls, params, wg, roa = _vertical_world(d)
    mesh = make_mesh(d)
    steps = 8

    rep_step = make_sharded_sim_step(cfg, walls, params, mesh, donate=False)
    st_rep = shard_state(sim_init(cfg, params), mesh)
    for _ in range(steps):
        st_rep, m_rep = rep_step(st_rep)

    row_step = make_sharded_sim_step(cfg, walls, params, mesh, donate=False,
                                     grid_sharding="rows",
                                     walls_grouped=wg, room_of_agent=roa)
    st_row = shard_state(sim_init(cfg, params), mesh, grid_rows_sharded=True)
    for _ in range(steps):
        st_row, m_row = row_step(st_row)

    np.testing.assert_array_equal(np.asarray(st_row.pose_true),
                                  np.asarray(st_rep.pose_true))
    # maps bit-identical: in-band evidence is computed by the same code in
    # the same order; out-of-band contributions are zero on both paths
    np.testing.assert_array_equal(np.asarray(st_row.srv.logodds),
                                  np.asarray(st_rep.srv.logodds))
    assert int(m_row.writes) == int(m_rep.writes)
    from swarm_tpu.engine.sim import total_writes_value
    assert total_writes_value(st_row.srv.total_writes) == \
        total_writes_value(st_rep.srv.total_writes)
    assert total_writes_value(st_row.srv.total_writes) > 0


def test_rows_sharding_rejects_band_escaping_agents():
    """A horizontally laid-out world (rooms side by side in one band) puts
    later devices' agents outside their bands — must fail statically."""
    d = min(4, len(jax.devices()))
    if d < 2:
        pytest.skip("needs >= 2 devices")
    n_agents = 2 * d
    from swarm_tpu.geom.world import make_tiled_rooms
    walls, origins = make_tiled_rooms(d, per_row=d)   # one row of rooms
    size = -(-max(d * 256, 128) // 256) * 256
    grid = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    eng = EngineConfig(parity_mode=False, compute_frontiers=False,
                       raster_mode="beam", scan_rays=37, raster_4way=False,
                       fast_raster=False, kernel_endpoints=False,
                       endpoint_hits=True)
    cfg = SwarmConfig(n_agents=n_agents, grid=grid, engine=eng)
    params = make_agent_params(n_agents, separation=2.0, cfg=cfg)
    mesh = make_mesh(d)
    with pytest.raises(ValueError, match="band"):
        make_sharded_sim_step(cfg, walls, params, mesh, donate=False,
                              grid_sharding="rows",
                              walls_grouped=walls_by_group(walls),
                              room_of_agent=jnp.asarray(
                                  np.arange(n_agents) // 2, jnp.int32))

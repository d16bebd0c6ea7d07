"""Buffer donation (SURVEY §5: jit donation/aliasing is the surviving
hazard class of the pure-functional design).

`make_sim_step`/`make_sharded_sim_step` default to donate=True (the
deployable config: the state pytree is re-used in place, halving device memory
traffic for the big grid buffers). Every other test passes donate=False;
these runs pin down that donation changes NOTHING numerically.
"""

import jax
import jax.numpy as jnp
import numpy as np

from swarm_tpu.config import EngineConfig, GridConfig, SwarmConfig
from swarm_tpu.engine.sim import make_agent_params, make_sim_step, sim_init
from swarm_tpu.geom.world import BEDROOM_WALLS
from swarm_tpu.parallel import make_mesh, make_sharded_sim_step, shard_state


def _cfg(n=4):
    return SwarmConfig(
        n_agents=n,
        grid=GridConfig(size=256, origin_x=-3.0, origin_y=-4.0),
        engine=EngineConfig(parity_mode=False, compute_frontiers=False,
                            raster_mode="beam", scan_rays=37,
                            raster_4way=False, merge_every=4))


def _assert_tree_equal(a, b):
    for (pa, la), (pb, lb) in zip(jax.tree_util.tree_leaves_with_path(a),
                                  jax.tree_util.tree_leaves_with_path(b)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb),
                                      err_msg=str(pa))


def test_fused_donation_matches_undonated():
    cfg = _cfg()
    params = make_agent_params(cfg.n_agents, separation=2.0, cfg=cfg)
    walls = BEDROOM_WALLS

    step_d = make_sim_step(cfg, walls, params, donate=True)
    step_u = make_sim_step(cfg, walls, params, donate=False)

    st_d = sim_init(cfg, params)
    st_u = sim_init(cfg, params)
    for _ in range(6):
        st_d, m_d = step_d(st_d)
        st_u, m_u = step_u(st_u)
    _assert_tree_equal(st_d, st_u)
    _assert_tree_equal(m_d, m_u)


def test_sharded_donation_matches_undonated():
    cfg = _cfg(n=8)
    params = make_agent_params(cfg.n_agents, separation=2.0, cfg=cfg)
    walls = BEDROOM_WALLS
    mesh = make_mesh(4)

    step_d = make_sharded_sim_step(cfg, walls, params, mesh, donate=True)
    step_u = make_sharded_sim_step(cfg, walls, params, mesh, donate=False)

    st_d = shard_state(sim_init(cfg, params), mesh)
    st_u = shard_state(sim_init(cfg, params), mesh)
    for _ in range(6):
        st_d, m_d = step_d(st_d)
        st_u, m_u = step_u(st_u)
    _assert_tree_equal(st_d, st_u)
    _assert_tree_equal(m_d, m_u)


def test_tiles_donation_matches_undonated():
    """Donation on the 2-D tiles decomposition (ppermute halo exchange +
    tile-sharded state) — the r2 grid layout's donation hazard check."""
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from tests.test_sharded_tiles import _mesh2d, _tiled_world

    cfg, walls, params, wg, roa = _tiled_world(8, per_row=2)
    mesh = _mesh2d(4, 2)
    results = {}
    for donate in (False, True):
        step = make_sharded_sim_step(cfg, walls, params, mesh,
                                     donate=donate,
                                     grid_sharding="tiles",
                                     walls_grouped=wg, room_of_agent=roa)
        st = shard_state(sim_init(cfg, params), mesh,
                         grid_tiles_sharded=True)
        for _ in range(4):
            st, m = step(st)
        results[donate] = (st, m)
    _assert_tree_equal(results[False][0], results[True][0])
    assert int(results[True][1].writes) == int(results[False][1].writes)

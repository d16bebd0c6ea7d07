"""Round-2 sharded-path fixes: TARG delivery on the mesh-sharded step,
beam-model 4-way raster parity with the fused fast path, and the
runtime band-escape guard for the rows-sharded grid."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from swarm_tpu.config import EngineConfig, GridConfig, SwarmConfig
from swarm_tpu.engine.sim import make_agent_params, make_sim_step, sim_init
from swarm_tpu.geom.world import BEDROOM_WALLS
from swarm_tpu.models import nav as navm
from swarm_tpu.parallel import make_mesh, make_sharded_sim_step, shard_state


def test_sharded_targets_assigned_and_pursued():
    """enable_targets on the sharded path must actually deliver TARG:
    round-1 advisor found the flag silently ignored in the shard_map body
    (frontier assignment never ran, agents never entered GO_TO_TARGET)."""
    n = 8
    cfg = SwarmConfig(
        n_agents=n,
        grid=GridConfig(size=256, origin_x=-3.0, origin_y=-4.0),
        engine=EngineConfig(parity_mode=False, compute_frontiers=True))
    params = make_agent_params(n, separation=2.0, cfg=cfg)
    mesh = make_mesh(4)
    step = make_sharded_sim_step(cfg, BEDROOM_WALLS, params, mesh,
                                 donate=False, enable_targets=True)
    st = shard_state(sim_init(cfg, params), mesh)
    got_target = went_goto = False
    for _ in range(120):
        st, ms = step(st)
        got_target = got_target or bool(jnp.any(st.nav.has_target))
        went_goto = went_goto or bool(
            jnp.any(st.nav.state == navm.GO_TO_TARGET))
        if got_target and went_goto:
            break
    assert got_target, "sharded path never delivered a frontier target"
    assert went_goto, "no sharded agent entered GO_TO_TARGET"


def test_sharded_beam_4way_matches_fused_pallas():
    """With raster_4way=True the sharded beam body must use the same fast
    tier (grouped free space + exact endpoint scatter) as the fused fast
    path — the line-scatter it used before produced a different map for
    identical cfg (round-1 advisor finding)."""
    n = 8
    eng = EngineConfig(parity_mode=False, compute_frontiers=False,
                       raster_mode="beam", scan_rays=37,
                       raster_4way=True, beam_groups=8,
                       kernel_endpoints=False, endpoint_hits=True)
    grid = GridConfig(size=512, origin_x=-3.0, origin_y=-4.0)
    base = SwarmConfig(n_agents=n, grid=grid, engine=eng)
    params = make_agent_params(n, separation=2.0, cfg=base)
    steps = 8

    mesh = make_mesh(4)
    sh_step = make_sharded_sim_step(base, BEDROOM_WALLS, params, mesh,
                                    donate=False)
    st_sh = shard_state(sim_init(base, params), mesh)
    for _ in range(steps):
        st_sh, m_sh = sh_step(st_sh)

    cfg_ref = base.replace(engine=dataclasses.replace(eng, fast_raster=True))
    ref_step = make_sim_step(cfg_ref, BEDROOM_WALLS, params, donate=False)
    st_ref = sim_init(cfg_ref, params)
    for _ in range(steps):
        st_ref, m_ref = ref_step(st_ref)

    np.testing.assert_allclose(np.asarray(st_sh.pose_true),
                               np.asarray(st_ref.pose_true),
                               rtol=1e-5, atol=1e-6)
    diff = np.abs(np.asarray(st_sh.srv.logodds) -
                  np.asarray(st_ref.srv.logodds))
    assert (diff > 1e-3).sum() == 0, (diff > 1e-3).sum()
    assert int(m_sh.writes) == int(m_ref.writes) > 0


def _vertical_world(n_devices: int):
    from swarm_tpu.geom.world import make_vertical_rooms, walls_by_group

    n_agents = 2 * n_devices
    walls, origins, size = make_vertical_rooms(n_devices)
    eng = EngineConfig(parity_mode=False, compute_frontiers=False,
                       raster_mode="beam", scan_rays=37,
                       raster_4way=False, beam_groups=8, fast_raster=False,
                       kernel_endpoints=False, endpoint_hits=True)
    cfg = SwarmConfig(n_agents=n_agents,
                      grid=GridConfig(size=size, origin_x=0.0, origin_y=0.0),
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
    return cfg, walls, params, walls_by_group(walls), jnp.asarray(
        room, jnp.int32)


def test_band_escape_guard():
    """Rows-sharded runtime guard: clean runs report 0
    escapes; an estimate driven past the drift margin must fire the guard
    instead of silently diverging from the replicated decomposition."""
    d = min(4, len(jax.devices()))
    cfg, walls, params, wg, roa = _vertical_world(d)
    mesh = make_mesh(d)
    step = make_sharded_sim_step(cfg, walls, params, mesh, donate=False,
                                 grid_sharding="rows",
                                 walls_grouped=wg, room_of_agent=roa)

    st = shard_state(sim_init(cfg, params), mesh, grid_rows_sharded=True)
    st, m = step(st)
    assert int(m.band_escapes) == 0

    # inject a y-estimate excursion far beyond any band margin
    bad = st.odom._replace(y_est=st.odom.y_est + 50.0)
    _, m_bad = step(st._replace(odom=bad))
    assert int(m_bad.band_escapes) > 0

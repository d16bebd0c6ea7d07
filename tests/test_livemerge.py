"""In-engine continuous map merge (slam/livemerge + engine integration).

The reference merger re-aligns every incoming submap against the global map
and rejects fitness < 0.6 (server_nodes/map_merger.py:35-62). Here: the
windowed correlative matcher recovers known pose offsets, stays put on
degenerate geometry (zero-motion prior), produces ~zero residual when a
scan matches its own raster, and — end to end — recovers an injected
odometry slip that an unmerged engine can never correct.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from swarm_tpu.config import (EngineConfig, GridConfig, SensorConfig,
                              SlamConfig, SwarmConfig)
from swarm_tpu.engine.sim import make_agent_params, make_sim_step, sim_init
from swarm_tpu.geom.world import make_multi_room
from swarm_tpu.slam.scanmatch import match_scan_window

RES = 0.05
INNER, SEARCH = 64, 8
SIDE = INNER + 2 * SEARCH


def _two_wall_scene():
    """Map with a vertical wall x=2 and horizontal wall y=3; agent truth at
    (1, 1, yaw 0.5) sees both — both translation axes constrained."""
    S = 128
    mass = np.zeros((S, S), np.float32)
    mass[:, int(2.0 / RES)] = 1.0
    mass[int(3.0 / RES), :] = 1.0
    rel = np.linspace(-np.pi / 2, np.pi / 2, 61)

    def ray_range(a, yaw):
        d = np.inf
        c, s = np.cos(yaw + a), np.sin(yaw + a)
        if c > 1e-6:
            d = min(d, (2.0 - 1.0) / c)
        if s > 1e-6:
            d = min(d, (3.0 - 1.0) / s)
        return d

    r = np.array([ray_range(a, 0.5) for a in rel])
    valid = np.isfinite(r) & (r < 2.4) & (r > 0.05)
    return mass, rel, r, valid


def _match(mass, rel, r, valid, err):
    """Match the true-pose scan reported from pose (1,1,0.5) + err."""
    rx, ry, ryaw = 1.0 + err[0], 1.0 + err[1], 0.5 + err[2]
    off_x = np.where(valid, r * np.cos(ryaw + rel), 0.0)
    off_y = np.where(valid, r * np.sin(ryaw + rel), 0.0)
    gx, gy = rx / RES, ry / RES
    S = mass.shape[0]
    sx = int(np.clip(np.floor(gx) - SIDE // 2, 0, S - SIDE))
    sy = int(np.clip(np.floor(gy) - SIDE // 2, 0, S - SIDE))
    win = mass[sy:sy + SIDE, sx:sx + SIDE]
    return match_scan_window(
        jnp.asarray(off_x, jnp.float32), jnp.asarray(off_y, jnp.float32),
        jnp.asarray(valid), jnp.asarray(win),
        (gx - sx - SEARCH - 0.5, gy - sy - SEARCH - 0.5),
        INNER, SEARCH, n_theta=9, theta_range=0.15, resolution=RES,
        prior_weight=0.05)


def test_match_recovers_known_offsets():
    mass, rel, r, valid = _two_wall_scene()
    for ex, ey in [(0.15, 0.0), (-0.1, 0.1), (0.0, -0.2)]:
        m = _match(mass, rel, r, valid, (ex, ey, 0.0))
        assert bool(m.ok)
        # correction points back toward truth, within the dilation radius
        # (2 cells = 0.1 m dead zone) + one splat cell
        assert abs(float(m.ddx) + ex) < 0.12, (ex, float(m.ddx))
        assert abs(float(m.ddy) + ey) < 0.12, (ey, float(m.ddy))


def test_match_degenerate_wall_stays_put():
    """A single straight wall constrains only its normal — the zero-motion
    prior must keep the along-wall component at zero instead of snapping
    to the search-window edge (the aperture problem)."""
    S = 128
    mass = np.zeros((S, S), np.float32)
    mass[:, int(2.0 / RES)] = 1.0          # vertical wall only
    rel = np.linspace(-np.pi / 2, np.pi / 2, 61)
    with np.errstate(divide="ignore"):
        r = np.where(np.abs(rel) < 1.0, 1.0 / np.cos(rel), np.inf)
    valid = np.isfinite(r) & (r < 2.4)
    rx, ry = 1.0, 1.0
    off_x = np.where(valid, r * np.cos(rel), 0.0)
    off_y = np.where(valid, r * np.sin(rel), 0.0)
    gx, gy = rx / RES, ry / RES
    sx = int(np.clip(np.floor(gx) - SIDE // 2, 0, S - SIDE))
    sy = int(np.clip(np.floor(gy) - SIDE // 2, 0, S - SIDE))
    m = match_scan_window(
        jnp.asarray(off_x, jnp.float32), jnp.asarray(off_y, jnp.float32),
        jnp.asarray(valid), jnp.asarray(mass[sy:sy + SIDE, sx:sx + SIDE]),
        (gx - sx - SEARCH - 0.5, gy - sy - SEARCH - 0.5),
        INNER, SEARCH, n_theta=9, theta_range=0.15, resolution=RES)
    assert abs(float(m.ddy)) < 0.08, float(m.ddy)   # along-wall: no snap
    assert abs(float(m.ddx)) < 0.08, float(m.ddx)


def _engine_cfg(merge_every, n=2, max_range=3.0, **slam_kw):
    return SwarmConfig(
        n_agents=n,
        slam=SlamConfig(closure_radius_m=0.0, **slam_kw),
        sensors=SensorConfig(max_range=max_range),
        grid=GridConfig(size=256, origin_x=-3.0, origin_y=-4.0),
        engine=EngineConfig(parity_mode=False, compute_frontiers=False,
                            raster_mode="beam", scan_rays=61,
                            raster_4way=False, merge_every=merge_every))


def _engine_setup(merge_every, n=2):
    walls = make_multi_room(max(1, n // 2), per_row=2)
    cfg = _engine_cfg(merge_every, n=n)
    params = make_agent_params(n, separation=2.0, cfg=cfg)
    i = np.arange(n)
    room = i // 2
    params = params._replace(
        home_x=jnp.asarray((room % 2) * 8.0, jnp.float32),
        home_y=jnp.asarray((room // 2) * 6.0, jnp.float32),
        x_offset=jnp.zeros((n,), jnp.float32))
    return cfg, walls, params


def test_self_match_residual_near_zero():
    """A scan matched against its own rastered evidence must return ~zero
    correction — the raster's floor-binning and the matcher's splat agree
    on cell conventions."""
    from swarm_tpu.ops.beam_raster import (BeamSpec, beams_from_scan,
                                           endpoint_rays,
                                           free_raster_reference,
                                           reach_cells)
    from swarm_tpu.ops.raster import logodds_delta
    from swarm_tpu.slam.livemerge import scan_merge

    cfg = _engine_cfg(merge_every=1, n=1)
    grid = cfg.grid
    rx = jnp.array([1.2345], jnp.float32)
    ry = jnp.array([0.8311], jnp.float32)
    ryaw = jnp.array([0.5], jnp.float32)
    scan = jnp.full((1, 61), 0.9, jnp.float32)
    alive = jnp.ones((1,), bool)
    spec = BeamSpec.scan(61)
    db, tb = beams_from_scan(scan, cfg.sensors.max_range,
                             cfg.sensors.min_range)
    axy = jnp.stack([rx, ry], axis=-1)
    zero = jnp.zeros((grid.size, grid.size), jnp.float32)
    d_free, _ = free_raster_reference(zero, axy, ryaw, db, alive, spec,
                                      grid, n_groups=16,
                                      reach=reach_cells(cfg))
    ep, _ = logodds_delta(endpoint_rays(axy, ryaw, db, tb, alive, spec),
                          grid, k_max=1)
    lo = jnp.clip(3 * (d_free + ep), -10, 10)
    m = scan_merge(lo, rx, ry, ryaw, scan, alive, cfg)
    assert bool(m.ok[0])
    assert abs(float(m.ddx[0])) < 0.02
    assert abs(float(m.ddy[0])) < 0.02
    assert abs(float(m.ddtheta[0])) < 1e-6


def _run_slip(merge_every, steps=150, slip_step=60):
    cfg, walls, params = _engine_setup(merge_every)
    state = sim_init(cfg, params)
    step = make_sim_step(cfg, walls, params, donate=False)
    err0 = []
    for k in range(steps):
        if k == slip_step:
            od = state.odom
            state = state._replace(odom=od._replace(
                x_est=od.x_est.at[0].add(0.30),
                y_est=od.y_est.at[0].add(-0.15)))
        state, m = step(state)
        cx = float(state.odom.x_est[0]) + float(state.srv.merge_dx[0])
        cy = float(state.odom.y_est[0]) + float(state.srv.merge_dy[0])
        err0.append(np.hypot(cx - float(state.pose_true[0, 0]),
                             cy - float(state.pose_true[0, 1])))
    return np.asarray(err0)


def test_slip_recovery_end_to_end():
    """An injected 0.34 m odometry slip: without merge the server-frame
    pose error stays at the slip forever; with the merge stage it decays
    back toward the dead zone (reference analogue: the merger re-aligning
    a drifted agent's submaps, map_merger.py:45-56)."""
    e_off = _run_slip(merge_every=0)
    e_on = _run_slip(merge_every=4)
    assert e_off[-20:].mean() > 0.25          # unmerged: error persists
    assert e_on[-20:].mean() < 0.17           # merged: recovered
    assert e_on[:55].mean() < 0.12            # pre-slip: no self-harm


def test_sharded_merge_matches_fused():
    """Replicated-grid sharded engine with merge on: corrections agree
    with the fused engine (same RNG streams, same map)."""
    from swarm_tpu.parallel import make_mesh, make_sharded_sim_step, shard_state

    n = 8
    walls = make_multi_room(4, per_row=2)
    # line raster: the one tier that is bit-identical between the fused
    # and sharded engines, so merge corrections must agree exactly
    cfg = _engine_cfg(merge_every=3, n=n)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, raster_mode="line"))
    params = make_agent_params(n, separation=2.0, cfg=cfg)
    i = np.arange(n)
    room = i // 2
    params = params._replace(
        home_x=jnp.asarray((room % 2) * 8.0, jnp.float32),
        home_y=jnp.asarray((room // 2) * 6.0, jnp.float32),
        x_offset=jnp.zeros((n,), jnp.float32))

    f_step = make_sim_step(cfg, walls, params, donate=False)
    st_f = sim_init(cfg, params)
    merges_f = 0
    for _ in range(7):
        st_f, m_f = f_step(st_f)
        merges_f += int(m_f.merges)

    mesh = make_mesh(4)
    s_step = make_sharded_sim_step(cfg, walls, params, mesh, donate=False)
    st_s = shard_state(sim_init(cfg, params), mesh)
    merges_s = 0
    for _ in range(7):
        st_s, m_s = s_step(st_s)
        merges_s += int(m_s.merges)

    assert merges_f > 0                      # the cadence actually fired
    assert merges_s == merges_f
    np.testing.assert_allclose(np.asarray(st_s.srv.merge_dx),
                               np.asarray(st_f.srv.merge_dx), atol=1e-6)
    np.testing.assert_allclose(np.asarray(st_s.srv.merge_dy),
                               np.asarray(st_f.srv.merge_dy), atol=1e-6)
    np.testing.assert_allclose(np.asarray(st_s.pose_true),
                               np.asarray(st_f.pose_true),
                               rtol=1e-5, atol=1e-6)


def test_rows_sharded_merge_runs():
    """Row-band grid sharding + merge: the window crops in band-local rows
    and corrections still fire (band containment keeps each agent's mass
    inside its device's band)."""
    from swarm_tpu.geom.world import make_vertical_rooms, walls_by_group
    from swarm_tpu.parallel import make_mesh, make_sharded_sim_step, shard_state

    d = 4
    n = 2 * d
    walls, origins, size = make_vertical_rooms(d)
    cfg = SwarmConfig(
        n_agents=n,
        slam=SlamConfig(closure_radius_m=0.0,
                        merge_window_cells=48, merge_search_cells=8),
        # default 1.2 m range: the raster reach window and the runtime
        # band-escape guard margin must fit inside the 128-row band
        # (rooms sit 1.2 m inside their tile)
        sensors=SensorConfig(max_range=1.2),
        grid=GridConfig(size=size, origin_x=0.0, origin_y=0.0),
        engine=EngineConfig(parity_mode=False, compute_frontiers=False,
                            raster_mode="beam", scan_rays=61,
                            raster_4way=False, fast_raster=False,
                            kernel_endpoints=False, endpoint_hits=True,
                            merge_every=3))
    params = make_agent_params(n, separation=2.0, cfg=cfg)
    i = np.arange(n)
    room = i // 2
    params = params._replace(
        home_x=jnp.asarray(origins[room, 0] + np.where(i % 2, 5.5, 0.5),
                           jnp.float32),
        home_y=jnp.asarray(origins[room, 1] + np.where(i % 2, 3.5, 0.5),
                           jnp.float32),
        x_offset=jnp.zeros((n,), jnp.float32))
    mesh = make_mesh(d)
    step = make_sharded_sim_step(
        cfg, walls, params, mesh, donate=False, grid_sharding="rows",
        walls_grouped=walls_by_group(walls),
        room_of_agent=jnp.asarray(room, jnp.int32))
    st = shard_state(sim_init(cfg, params), mesh, grid_rows_sharded=True)
    merges = 0
    for _ in range(7):
        st, m = step(st)
        merges += int(m.merges)
    assert merges > 0
    from swarm_tpu.engine.sim import total_writes_value
    assert total_writes_value(st.srv.total_writes) > 0
    assert int(m.band_escapes) == 0


def test_chunked_merge_rotates_and_matches_fused():
    """merge_chunk < n: each event merges one rotating global chunk; the
    merged set (and the corrections) are identical between the fused and
    sharded engines, and every agent gets its turn across K events."""
    from swarm_tpu.parallel import make_mesh, make_sharded_sim_step, shard_state
    from swarm_tpu.slam.livemerge import scan_merge, scan_merge_chunked

    n = 8
    walls = make_multi_room(4, per_row=2)
    cfg = _engine_cfg(merge_every=2, n=n)
    cfg = cfg.replace(
        engine=dataclasses.replace(cfg.engine, raster_mode="line"),
        slam=dataclasses.replace(cfg.slam, merge_chunk=2))
    params = make_agent_params(n, separation=2.0, cfg=cfg)
    i = np.arange(n)
    room = i // 2
    params = params._replace(
        home_x=jnp.asarray((room % 2) * 8.0, jnp.float32),
        home_y=jnp.asarray((room // 2) * 6.0, jnp.float32),
        x_offset=jnp.zeros((n,), jnp.float32))

    steps = 10                     # 5 merge events > K=4 chunks: full rotation
    f_step = make_sim_step(cfg, walls, params, donate=False)
    st_f = sim_init(cfg, params)
    merges_f = 0
    for _ in range(steps):
        st_f, m_f = f_step(st_f)
        merges_f += int(m_f.merges)

    mesh = make_mesh(4)
    s_step = make_sharded_sim_step(cfg, walls, params, mesh, donate=False)
    st_s = shard_state(sim_init(cfg, params), mesh)
    merges_s = 0
    for _ in range(steps):
        st_s, m_s = s_step(st_s)
        merges_s += int(m_s.merges)

    assert merges_f > 0
    assert merges_s == merges_f
    np.testing.assert_allclose(np.asarray(st_s.srv.merge_dx),
                               np.asarray(st_f.srv.merge_dx), atol=1e-6)
    np.testing.assert_allclose(np.asarray(st_s.srv.merge_dy),
                               np.asarray(st_f.srv.merge_dy), atol=1e-6)

    # unit-level: chunk membership rotates over events and non-chunk
    # agents are ok=False; the chunk's own results equal the full match
    key = jax.random.PRNGKey(1)
    lo = jax.random.uniform(key, (cfg.grid.size, cfg.grid.size),
                            minval=-2.0, maxval=2.0)
    rx = jnp.linspace(2.0, 12.0, n)
    ry = jnp.full((n,), 3.0)
    ryaw = jnp.zeros((n,))
    scan = jnp.full((n, cfg.engine.scan_rays), 0.8)
    alive = jnp.ones((n,), bool)
    full = scan_merge(lo, rx, ry, ryaw, scan, alive, cfg)
    seen = np.zeros(n, bool)
    for e in range(4):
        mc = scan_merge_chunked(lo, rx, ry, ryaw, scan, alive, cfg,
                                event=jnp.int32(e), n_global=n)
        sel = np.asarray(mc.ok)
        inchunk = (np.arange(n) >= 2 * e) & (np.arange(n) < 2 * e + 2)
        assert not sel[~inchunk].any()
        np.testing.assert_array_equal(sel[inchunk],
                                      np.asarray(full.ok)[inchunk])
        np.testing.assert_allclose(np.asarray(mc.ddx)[inchunk],
                                   np.asarray(full.ddx)[inchunk],
                                   atol=1e-6)
        seen |= inchunk
    assert seen.all()


def test_merge_fail_update_and_increments_semantics():
    """Unit semantics of the escalation plumbing (slam/livemerge.py):
    failed attempts increment, good attempts reset, unattempted carry;
    with recovery disabled merge_increments reproduces the pre-recovery
    inline arithmetic exactly."""
    from swarm_tpu.slam.livemerge import merge_fail_update, merge_increments
    from swarm_tpu.slam.scanmatch import WindowMatch

    cfg = _engine_cfg(merge_every=4, merge_recover_after=3)
    slam = cfg.slam
    n = 5
    # agents: 0 fails, 1 good small, 2 good but railing (> max_step),
    # 3 unattempted, 4 recovered (railing but claimed by recovery)
    m = WindowMatch(
        ddx=jnp.array([0.0, 0.05, 0.30, 0.0, 0.30], jnp.float32),
        ddy=jnp.zeros((n,), jnp.float32),
        ddtheta=jnp.array([0.0, 0.01, 0.0, 0.0, 0.20], jnp.float32),
        fitness=jnp.full((n,), 0.9, jnp.float32),
        ok=jnp.array([False, True, True, False, True]),
        ddtheta_meas=jnp.zeros((n,), jnp.float32),
        distinct=jnp.ones((n,), bool),
        distinct_gap=jnp.full((n,), jnp.inf, jnp.float32))
    attempted = jnp.array([True, True, True, False, True])
    recovered = jnp.array([False, False, False, False, True])
    alive = jnp.ones((n,), bool)
    fail0 = jnp.array([2, 2, 2, 2, 5], jnp.int32)
    fail1 = merge_fail_update(fail0, m, attempted, recovered, alive, cfg)
    np.testing.assert_array_equal(
        np.asarray(fail1), [3, 0, 3, 2, 0])  # fail+1, reset, rail+1,
    #                                          carry, recovery resets

    upd = m.ok & alive
    fdx, fdy, fdth, idx, idy, idth = merge_increments(m, upd, recovered,
                                                      cfg)
    # full correction passes through unclamped where applied
    np.testing.assert_allclose(np.asarray(fdx),
                               np.where(np.asarray(upd),
                                        np.asarray(m.ddx), 0.0))
    cmx, cmr = slam.merge_max_step_m, slam.merge_max_step_rad
    # normal agents: tight clamps, yaw increment off (yaw_damping 0)
    assert abs(float(idx[1]) - slam.merge_damping * 0.05) < 1e-7
    assert abs(float(idx[2]) - slam.merge_damping * cmx) < 1e-7
    assert float(idth[2]) == 0.0
    # recovered agent: wide clamps and yaw persists under merge_damping
    assert abs(float(idx[4]) - slam.merge_damping * 0.30) < 1e-7
    assert abs(float(idth[4]) - slam.merge_damping * 0.20) < 1e-7

    # disabled path == pre-recovery inline arithmetic
    cfg0 = _engine_cfg(merge_every=4)
    assert cfg0.slam.merge_recover_after == 0
    _, _, _, jdx, jdy, jdth = merge_increments(m, upd, recovered, cfg0)
    np.testing.assert_allclose(
        np.asarray(jdx),
        cfg0.slam.merge_damping * np.clip(np.asarray(fdx), -cmx, cmx))
    np.testing.assert_allclose(
        np.asarray(jdth),
        cfg0.slam.merge_yaw_damping * np.clip(np.asarray(fdth),
                                              -cmr, cmr))


def test_distinct_gate_rejects_aperture_ambiguous_match():
    """Peak-distinctness (SlamConfig.merge_distinct_margin): a scan that
    sees only one straight wall scores flat along the wall (the aperture
    problem) — fitness passes but `distinct` must be False; a corner
    scan (two perpendicular walls) pins both axes and stays distinct.
    These are exactly the measured false-verified geometries (wall-hugging
    scans, 21-31% of verified events)."""
    import numpy as np
    from swarm_tpu.slam.scanmatch import match_scan_window

    inner, search, res = 64, 8, 0.05
    side = inner + 2 * search
    ax = ay = inner / 2.0
    r = 61

    def run(case):
        win = np.zeros((side, side), np.float32)
        if case == "wall":
            win[search + 40, :] = 1.0
            px = np.linspace(-20, 20, r)
            py = np.full(r, 40 - ay)
        else:
            win[search + 40, search:search + 45] = 1.0
            win[search:search + 45, search + 44] = 1.0
            px = np.concatenate([np.linspace(-20, 10, r // 2),
                                 np.full(r - r // 2, 44 - ax)])
            py = np.concatenate([np.full(r // 2, 40 - ay),
                                 np.linspace(-20, 10, r - r // 2)])
        m = match_scan_window(
            jnp.asarray(px * res), jnp.asarray(py * res),
            jnp.ones((r,), bool), jnp.asarray(win), (ax, ay), inner,
            search, n_theta=11, theta_range=0.2, resolution=res,
            distinct_margin=0.05, distinct_radius=3)
        return m

    wall = run("wall")
    corner = run("corner")
    assert bool(wall.ok) and not bool(wall.distinct)
    assert bool(corner.ok) and bool(corner.distinct)
    # gate off -> every match is distinct (r4 behavior preserved)
    m_off = run("corner")._replace()  # corner again, margin on, sanity
    assert bool(m_off.distinct)

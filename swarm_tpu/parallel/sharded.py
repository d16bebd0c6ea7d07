"""The fused swarm step sharded over a device mesh with `shard_map`.

Parallel decomposition (SURVEY §2 "Parallelism strategies"):

  * Agent state (pose, odometry, EKF, nav FSM) shards over the `agents`
    mesh axis — robots are independent programs, so the per-agent physics,
    sensing, estimation and navigation run with ZERO communication.
  * The occupancy grid is logically shared. Each shard rasters only its own
    agents' rays into local evidence and one `psum` merges it. The beam
    raster's evidence is integer crossing counts (ops/fast_raster.py), so
    the merge is exact and the map is bit-equal to the fused engine's.
  * The small coordination state (loop-closure buffers, territory AABBs,
    heartbeats — all O(N) scalars) is replicated; shards `all_gather` the
    step's telemetry (a few floats per agent — the QuasarPacket fields,
    dual_bot_mapper.py:41-42) and every device computes the identical
    server update, so no second collective round-trip is needed.

Requires throughput mode (`cfg.engine.parity_mode = False`): the tri-state
parity raster is packet-order-dependent and inherently sequential; the
log-odds view is the scalable path (tri-state view = threshold of it).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from swarm_tpu.config import SwarmConfig
from swarm_tpu.coord.assign import greedy_assign, greedy_assign_rooms
from swarm_tpu.coord.heartbeat import heartbeat_update
from swarm_tpu.coord.zones import ZoneState, zone_observe_rows, zones_for_agents
from swarm_tpu.engine.sim import (
    AgentParams, FaultSchedule, MapState, SimState, StepMetrics, no_faults,
    writes_accumulate)
from swarm_tpu.models import nav as navm
from swarm_tpu.models.ekf import EkfState, ekf_step_batch
from swarm_tpu.models.landmarks import detect_landmark_sim
from swarm_tpu.models.odometry import OdomState, drift_integrate, encoder_emit, quantize_yaw_deg
from swarm_tpu.models.sensors import sense_4way
from swarm_tpu.geom.world import cast_rays
from swarm_tpu.ops.frontier import frontier_clusters, frontier_targets_coarse
from swarm_tpu.ops.raster import RayBatch, logodds_delta, tri_state_view
from swarm_tpu.slam.closure import ClosureState, closure_add_poses_batch
from swarm_tpu.slam.livemerge import FrameState
from swarm_tpu.utils.angles import wrap_pi


def state_specs(axis="agents", grid_rows_sharded: bool = False,
                lo_spec=None) -> SimState:
    """PartitionSpec pytree for SimState: agent-batched leaves shard over
    `axis` (a mesh axis name, or a tuple of names for 2-D meshes),
    server/scalar state is replicated. With grid_rows_sharded the
    log-odds grid is additionally SPATIALLY sharded by row bands over the
    same axis (SURVEY §2 parallelism table row 2 — grid tiles = shards);
    each shard then rasters only its own agents into its own band and the
    map needs NO collective at all. `lo_spec` overrides the log-odds
    spec directly — the 2-D tile decomposition passes P(rows_ax, cols_ax)."""
    ag, rep = P(axis), P()
    if lo_spec is not None:
        lo = lo_spec
    else:
        lo = P(axis, None) if grid_rows_sharded else rep
    return SimState(
        t=rep, step=rep, key=rep,
        pose_true=ag,
        odom=OdomState(*([ag] * 6)),
        ekf=EkfState(*([ag] * 3)),
        nav=navm.NavState(*([ag] * 8)),
        total_dist=ag,
        v2v_total=ag,
        srv=MapState(
            grid=rep, logodds=lo,
            closure=ClosureState(*([rep] * len(ClosureState._fields))),
            zone=ZoneState(*([rep] * 5)),
            last_packet_t=rep, pkt_counts=rep,
            zone_boxes=rep, zone_active=rep,
            frontier_centroids=rep, n_frontiers=rep, total_writes=rep,
            merge_dx=rep, merge_dy=rep, merge_dyaw=rep,
            anchor=lo, merge_fail=rep,
            merge_yaw_rate=rep, merge_dist_mark=rep,
            frame=FrameState(*([rep] * len(FrameState._fields)))))


def shard_state(state: SimState, mesh,
                grid_rows_sharded: bool = False,
                grid_tiles_sharded: bool = False) -> SimState:
    """Place a host SimState onto the mesh with the engine's shardings."""
    if grid_tiles_sharded:
        specs = state_specs(tuple(mesh.axis_names),
                            lo_spec=P(*mesh.axis_names))
    else:
        specs = state_specs(mesh.axis_names[0], grid_rows_sharded)
    if state.srv.anchor.shape[0] == 1:
        # [1, 1] placeholder (SlamConfig.merge_anchor off) — replicate
        specs = specs._replace(srv=specs.srv._replace(anchor=P()))
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs)


def agent_evidence_box(walls_grouped, room_of_agent, cfg: SwarmConfig,
                       margin_cells: int = 3,
                       drift_margin_m: float = 1.0):
    """Static per-agent grid (row, col) bounds of possible raster
    evidence: (rmin, rmax, cmin, cmax), each [N] int.

    The agent's TRUE pose cannot leave its room (walls are solid and beams
    are wall-limited), but the raster origin is the drift-corrected
    odometry ESTIMATE — which walls do NOT bound. `drift_margin_m` budgets
    that: the spatially-sharded grids are bit-identical to the replicated
    decomposition only while every agent's estimate error stays under
    it (loop closures keep drift bounded in practice; raise the margin —
    or shrink rooms relative to bands/tiles — for longer uncorrected
    runs). numpy, trace-free."""
    import numpy as np
    wg = np.asarray(walls_grouped)
    roa = np.asarray(room_of_agent)
    ys = wg[..., [1, 3]].reshape(wg.shape[0], -1)
    xs = wg[..., [0, 2]].reshape(wg.shape[0], -1)
    res = cfg.grid.resolution
    pad = margin_cells + int(np.ceil(drift_margin_m / res))
    rmin = np.floor((ys.min(1)[roa] - cfg.grid.origin_y) / res) - pad
    rmax = np.ceil((ys.max(1)[roa] - cfg.grid.origin_y) / res) + pad
    cmin = np.floor((xs.min(1)[roa] - cfg.grid.origin_x) / res) - pad
    cmax = np.ceil((xs.max(1)[roa] - cfg.grid.origin_x) / res) + pad
    return (rmin.astype(int), rmax.astype(int),
            cmin.astype(int), cmax.astype(int))


def merge_window_box(walls_grouped, room_of_agent, cfg: SwarmConfig):
    """Static per-agent clamp box for scan-merge window PLACEMENT:
    the room evidence box snapped OUTWARD to the [TILE_ROWS, TILE_COLS]
    raster-tile lattice and clipped to the grid. (rmin, rmax, cmin,
    cmax), each [N] int.

    The merge window stays agent-CENTERED (floor(g) - side//2); this box
    only bounds the start via clip(start, rmin, rmax - side). Three
    properties make it the right bound:
    - decomposition-INVARIANT: a static per-agent quantity, so every
      decomposition clamps the same way (clamping into the *local* band
      edges — the old scheme — recentres windows near a band edge and
      diverges from the replicated engine);
    - almost always a NO-OP: interval width tile - side (48 rows /
      176 cols at defaults), so it binds only when the agent is within
      side//2 of a tile edge — unlike the raw room box, whose
      room - side interval (6 rows at defaults) pinned the window and
      pushed near-wall agents out of the inner region, collapsing the
      fitness gate (merges 5 vs 69 on the 4-agent accuracy run);
    - PROVABLE: bands/tiles that own whole raster tiles contain it, so
      the sharded builders can statically verify the local dynamic_slice
      never needs rows/cols outside the device's shard.
    numpy, trace-free."""
    import numpy as np

    from swarm_tpu.geom.world import TILE_COLS, TILE_ROWS
    from swarm_tpu.slam.livemerge import merge_window_side
    side = merge_window_side(cfg)
    rmin, rmax, cmin, cmax = agent_evidence_box(
        walls_grouped, room_of_agent, cfg, margin_cells=3,
        drift_margin_m=0.0)
    size = cfg.grid.size
    rmin = np.maximum((rmin // TILE_ROWS) * TILE_ROWS, 0)
    rmax = np.minimum(-(-rmax // TILE_ROWS) * TILE_ROWS, size)
    cmin = np.maximum((cmin // TILE_COLS) * TILE_COLS, 0)
    cmax = np.minimum(-(-cmax // TILE_COLS) * TILE_COLS, size)
    if ((rmax - rmin) < side).any() or ((cmax - cmin) < side).any():
        raise ValueError(
            f"an agent's tile-snapped room box is smaller than the "
            f"{side}-cell scan-merge window; shrink "
            "slam.merge_window_cells / merge_search_cells")
    return rmin, rmax, cmin, cmax


def agent_evidence_rows(walls_grouped, room_of_agent, cfg: SwarmConfig,
                        margin_cells: int = 3,
                        drift_margin_m: float = 1.0):
    """Row bounds only (the rows-band decomposition's static proof)."""
    rmin, rmax, _, _ = agent_evidence_box(
        walls_grouped, room_of_agent, cfg, margin_cells, drift_margin_m)
    return rmin, rmax


def _halo_exchange(ext, R: int, C: int, halo_r: int, halo_c: int,
                   core_r: int, core_c: int, axis_r: str, axis_c: str):
    """Two-phase halo merge of an extended-tile delta over the (R, C)
    device grid, returning the device's CORE [core_r, core_c] delta.

    `ext` is [core_r + 2*halo_r, core_c + 2*halo_c]: the device rasters
    its agents into its tile plus a halo ring; evidence an agent painted
    past its tile border lands in the halo and is shipped to the owning
    neighbour with `ppermute` (row phase first, full-width
    strips, so corner evidence propagates through the column phase —
    the classic 2-D halo pattern). Grid-edge strips have no partner:
    ppermute's unpaired destinations receive zeros, and out-of-grid
    ghost evidence is simply discarded with the halo ring. Integer counts
    merge exactly in any order; float evidence equals the replicated psum
    decomposition wherever each cell's contributions arrive in the same
    order (exactly true when every cell is painted by one device)."""
    if R > 1:
        top = ext[:halo_r]
        bot = ext[core_r + halo_r:]
        from_south = jax.lax.ppermute(
            top, axis_r, [(i, i - 1) for i in range(1, R)])
        from_north = jax.lax.ppermute(
            bot, axis_r, [(i, i + 1) for i in range(R - 1)])
        ext = ext.at[core_r:core_r + halo_r].add(from_south)
        ext = ext.at[halo_r:2 * halo_r].add(from_north)
    if C > 1:
        left = ext[:, :halo_c]
        right = ext[:, core_c + halo_c:]
        from_east = jax.lax.ppermute(
            left, axis_c, [(i, i - 1) for i in range(1, C)])
        from_west = jax.lax.ppermute(
            right, axis_c, [(i, i + 1) for i in range(C - 1)])
        ext = ext.at[:, core_c:core_c + halo_c].add(from_east)
        ext = ext.at[:, halo_c:2 * halo_c].add(from_west)
    return ext[halo_r:halo_r + core_r, halo_c:halo_c + core_c]


def _sharded_step_body(state: SimState, cfg: SwarmConfig, walls,
                       params: AgentParams, faults: FaultSchedule,
                       enable_targets: bool, axis,
                       grid_rows: bool = False, tiles=None,
                       guard_box=None, win_box=None, room_boxes=None):
    """shard_map body: agent leaves arrive as [N/D] local rows, server state
    replicated. Mirrors engine.sim.sim_step stage-for-stage.

    axis: mesh axis name for the agent decomposition — a tuple of two
    names when the grid is 2-D tile-sharded (`tiles` set).
    tiles: (R, C, halo_r, halo_c) static tuple for the tiles+halo grid
    decomposition; axis is then (row_axis, col_axis)."""
    n = cfg.n_agents
    navc = cfg.nav
    sens = cfg.sensors
    dt = navc.drive_tick_s + navc.settle_tick_s
    srv = state.srv

    n_loc = state.pose_true.shape[0]
    if tiles is not None:
        axis_r, axis_c = axis
        R, C, halo_r, halo_c = tiles
        tr = jax.lax.axis_index(axis_r)
        tc = jax.lax.axis_index(axis_c)
        shard = tr * C + tc
    else:
        shard = jax.lax.axis_index(axis)
    ridx = shard * n_loc + jnp.arange(n_loc, dtype=jnp.int32)  # global ids

    # per-agent params for this shard (params are replicated closures)
    p = jax.tree.map(lambda a: a[ridx], params)

    hit = (faults.agent[None, :] == ridx[:, None]) & \
        (state.t >= faults.t_start[None, :]) & (state.t < faults.t_end[None, :])
    alive = ~jnp.any(hit, axis=1)

    # Per-agent counter-based RNG streams folded by GLOBAL agent id — bit
    # identical to engine.sim.sim_step under any mesh size.
    key, k_step = jax.random.split(state.key)
    k_agents = jax.vmap(lambda i: jax.random.fold_in(k_step, i))(
        ridx.astype(jnp.uint32))
    k_sense = jax.vmap(lambda k: jax.random.fold_in(k, 0))(k_agents)
    k_drift = jax.vmap(lambda k: jax.random.fold_in(k, 1))(k_agents)

    # 1-2. sense + landmark (local)
    dist4 = jax.vmap(lambda k, pp: sense_4way(k, pp, walls, sens))(
        k_sense, state.pose_true)
    lm = detect_landmark_sim(dist4[:, 0], dist4[:, 1], dist4[:, 3],
                             navc.lm_sim_close_m, sens.max_range)
    lm = jnp.where(alive, lm, 0)

    # 3. telemetry (local)
    odom, enc_tot = encoder_emit(state.odom, cfg.noise)
    yaw_q = jnp.radians(quantize_yaw_deg(odom.yaw_est,
                                         cfg.noise.yaw_quantize_deg))

    # 4. server ingest — local raster + psum, gathered coordination
    from swarm_tpu.slam.livemerge import (
        frame_add, frame_advance, frame_init, frame_theta_q)
    merge_dx_loc = srv.merge_dx[ridx]
    merge_dy_loc = srv.merge_dy[ridx]
    frame_loc = jax.tree.map(lambda x: x[ridx], srv.frame)
    adv_d = inno_d = frame_init(n_loc)       # zero deltas
    adv_x = adv_y = jnp.zeros((n_loc,), jnp.float32)
    if cfg.slam.merge_frame_gain > 0.0:
        # continuous frame-tracked velocity correction (mirrors
        # engine.sim._ingest_batched; same `leaf + delta` float
        # expressions through frame_add, so decompositions stay
        # bit-equal)
        adv_x, adv_y, adv_d = frame_advance(
            frame_loc, odom.x_est + p.x_offset, odom.y_est, alive, cfg)
        merge_dx_loc = merge_dx_loc + adv_x
        merge_dy_loc = merge_dy_loc + adv_y
        frame_loc = frame_add(frame_loc, adv_d)
    rx = odom.x_est + p.x_offset + srv.closure.drift_dx[ridx] + \
        merge_dx_loc
    ry = odom.y_est + srv.closure.drift_dy[ridx] + merge_dy_loc
    ryaw = yaw_q + srv.merge_dyaw[ridx]
    gate_yaw = yaw_q
    if cfg.slam.merge_frame_gain > 0.0:
        # quantized de-rotation; gate on the reported yaw only (mirrors
        # engine.sim._ingest_batched — see the runaway note there)
        ryaw = ryaw - frame_theta_q(frame_loc.theta, cfg)
    if cfg.slam.merge_bias_alpha > 0.0:
        from swarm_tpu.slam.livemerge import merge_bias_ff
        ryaw = ryaw + merge_bias_ff(srv.merge_yaw_rate[ridx],
                                    srv.merge_dist_mark[ridx],
                                    state.total_dist, cfg)
    beam_mode = cfg.engine.raster_mode == "beam" and \
        not cfg.engine.parity_mode
    scan_dist = None
    if cfg.engine.scan_rays > 0:
        from swarm_tpu.models.scan import scan_angles, sense_scan
        k_scan = jax.vmap(lambda k: jax.random.fold_in(k, 2))(k_agents)
        scan_dist = jax.vmap(
            lambda k, pp: sense_scan(k, pp, walls, cfg.engine.scan_rays,
                                     sens))(k_scan, state.pose_true)

    # continuous map merge at cadence (mirrors engine.sim._ingest_batched):
    # match against the PREVIOUS map — the full replicated grid, or this
    # device's band (band containment keeps each agent's mass in-band).
    n_merges_loc = jnp.zeros((), jnp.int32)
    merge_fitsum_loc = jnp.zeros((), jnp.float32)
    merge_ok_loc = jnp.zeros((n_loc,), bool)
    merge_fit_loc = jnp.zeros((n_loc,), jnp.float32)
    cdx = cdy = cdth = jnp.zeros((n_loc,), jnp.float32)
    rate_d_loc = mark_d_loc = jnp.zeros((n_loc,), jnp.float32)
    fail_loc = srv.merge_fail[ridx]
    new_fail_loc = fail_loc
    if cfg.engine.merge_every > 0 and scan_dist is not None:
        from swarm_tpu.slam.livemerge import (
            merge_fail_update, merge_increments, merge_zero,
            scan_merge_recover)
        do_merge = (state.step % cfg.engine.merge_every) == \
            (cfg.engine.merge_every - 1)
        band_row0 = (shard * srv.logodds.shape[0]) if grid_rows else None
        band_col0 = None
        if tiles is not None:
            band_row0 = tr * srv.logodds.shape[0]
            band_col0 = tc * srv.logodds.shape[1]
        def run_merge(_):
            if cfg.slam.merge_anchor:
                match_map = jnp.where(jnp.abs(srv.anchor) >= 0.5,
                                      srv.anchor, srv.logodds)
            else:
                match_map = srv.logodds
            wb = None if win_box is None else tuple(
                b[ridx] for b in win_box)
            return scan_merge_recover(
                match_map, rx, ry, ryaw, scan_dist, alive, cfg,
                event=state.step // cfg.engine.merge_every, n_global=n,
                fail_count=fail_loc, id0=shard * n_loc,
                band_row0=band_row0, band_col0=band_col0, win_bounds=wb)

        m, att, rec = jax.lax.cond(
            do_merge, run_merge,
            lambda _: (merge_zero(n_loc), jnp.zeros((n_loc,), bool),
                       jnp.zeros((n_loc,), bool)), None)
        upd = m.ok & alive
        # full correction to THIS step's raster; damped fraction persists
        # (mirrors engine.sim._ingest_batched: FULL correction to this
        # step's raster insert, only the persistent increment is clamped
        # — see the ghost-wall note there)
        fdx, fdy, fdth, cdx, cdy, cdth = merge_increments(
            m, upd, rec, cfg)
        if cfg.slam.merge_frame_gain > 0.0:
            # stationarity damping (mirrors engine.sim._ingest_batched)
            still = frame_loc.ax * frame_loc.ax + \
                frame_loc.ay * frame_loc.ay < \
                cfg.slam.merge_frame_still_m ** 2
            sdamp = jnp.where(still, cfg.slam.merge_frame_still_damp,
                              1.0)
            cdx = cdx * sdamp
            cdy = cdy * sdamp
            cdth = cdth * sdamp
        rx = rx + fdx
        ry = ry + fdy
        ryaw = ryaw + fdth
        if cfg.slam.merge_bias_alpha > 0.0:
            from swarm_tpu.slam.livemerge import merge_bias_update
            fold, rate_d_loc, mark_d_loc = merge_bias_update(
                srv.merge_yaw_rate[ridx], srv.merge_dist_mark[ridx],
                state.total_dist, m, upd, cfg,
                quant_resid=wrap_pi(yaw_q - odom.yaw_est))
            cdth = cdth + fold
        new_fail_loc = merge_fail_update(fail_loc, m, att, rec, alive,
                                         cfg)
        if cfg.slam.merge_frame_gain > 0.0:
            # event innovation; the innovation delta applies AFTER the
            # advance delta (same float grouping as the fused engine,
            # so decompositions stay bit-equal)
            from swarm_tpu.slam.livemerge import frame_innovate
            inno_d = frame_innovate(frame_loc, gate_yaw, m, upd,
                                    cdx, cdy, cfg, recovered=rec)
        n_merges_loc = jnp.sum(upd.astype(jnp.int32))
        merge_fitsum_loc = jnp.sum(jnp.where(upd, m.fitness, 0.0))
        # logged fix stream gates on peak distinctness (mirrors
        # engine.sim._ingest_batched — all-True when the gate is off)
        merge_ok_loc = upd & m.distinct
        merge_fit_loc = jnp.where(upd, m.fitness, 0.0)

    angles = ryaw[:, None] + jnp.asarray(sens.angles, rx.dtype)[None, :]
    hit_valid = (dist4 > sens.min_range) & (dist4 <= sens.max_range)
    rng = jnp.where(hit_valid, dist4, sens.max_range)
    hx = rx[:, None] + rng * jnp.cos(angles)
    hy = ry[:, None] + rng * jnp.sin(angles)
    rays = RayBatch(
        ox=jnp.repeat(rx, 4), oy=jnp.repeat(ry, 4),
        hx=hx.reshape(-1), hy=hy.reshape(-1),
        hit_valid=hit_valid.reshape(-1), active=jnp.repeat(alive, 4))
    if cfg.engine.scan_rays > 0:
        if not beam_mode:
            # line mode: scan beams join the per-ray scatter batch
            r_scan = cfg.engine.scan_rays
            sa = ryaw[:, None] + scan_angles(r_scan, rx.dtype)[None, :]
            sv = (scan_dist > sens.min_range) & \
                (scan_dist <= sens.max_range)
            sr = jnp.where(sv, scan_dist, sens.max_range)
            shx = rx[:, None] + sr * jnp.cos(sa)
            shy = ry[:, None] + sr * jnp.sin(sa)
            rays = RayBatch(
                ox=jnp.concatenate([rays.ox, jnp.repeat(rx, r_scan)]),
                oy=jnp.concatenate([rays.oy, jnp.repeat(ry, r_scan)]),
                hx=jnp.concatenate([rays.hx, shx.reshape(-1)]),
                hy=jnp.concatenate([rays.hy, shy.reshape(-1)]),
                hit_valid=jnp.concatenate([rays.hit_valid,
                                           sv.reshape(-1)]),
                active=jnp.concatenate([rays.active,
                                        jnp.repeat(alive, r_scan)]))
    # grid decomposition: replicated (each shard's full-grid evidence
    # psum'd), spatially row-sharded (grid_rows: each shard owns a
    # horizontal band and its agents are band-contained by the static
    # check in make_sharded_sim_step — the map needs NO collective), or
    # 2-D tile-sharded (tiles: each device owns a [size/R, size/C] tile
    # and rasters into an extended tile whose halo ring is exchanged
    # with the 4 neighbours via ppermute — SURVEY §2 "grid tiles =
    # shards" with border exchange).
    band = None
    band_cols = None
    band_esc_loc = jnp.zeros((), jnp.int32)
    if grid_rows:
        from swarm_tpu.ops.beam_raster import reach_cells as _reach_cells
        band_rows = srv.logodds.shape[0]       # local band height
        band = (shard * band_rows, band_rows)
        # Runtime band-escape guard: the static
        # containment proof budgets 1 m of odometry drift; if an agent's
        # drift-corrected ESTIMATE wanders far enough that its evidence
        # rows could leave this device's band, bit-identity with the
        # replicated decomposition is gone. Count those agents per step
        # so the failure is loud (StepMetrics.band_escapes) instead of a
        # silent map divergence.
        reach_g = _reach_cells(cfg)
        ay_cell = (ry - cfg.grid.origin_y) / cfg.grid.resolution
        if guard_box is not None:
            # Drift-budget guard matching the STATIC proof's semantics:
            # evidence is wall-limited relative to the TRUE pose, offset
            # by drift = est - true, so evidence leaves the proven
            # per-agent box iff the drift budget is exhausted — i.e. the
            # ESTIMATE leaves the padded box. The earlier pose+/-reach
            # band test was stricter than the proof and false-fired for
            # agents validly hugging band-edge walls.
            rmin_a = guard_box[0][ridx]
            rmax_a = guard_box[1][ridx]
            in_band = (ay_cell >= rmin_a) & (ay_cell <= rmax_a)
        else:
            in_band = ((ay_cell - reach_g >= band[0]) &
                       (ay_cell + reach_g <= band[0] + band_rows))
        band_esc_loc = jnp.sum((~in_band & alive).astype(jnp.int32))
    elif tiles is not None:
        from swarm_tpu.ops.beam_raster import reach_cells as _reach_cells
        core_r, core_c = srv.logodds.shape
        band = (tr * core_r - halo_r, core_r + 2 * halo_r)
        band_cols = (tc * core_c - halo_c, core_c + 2 * halo_c)
        # Tile-escape guard (rows-mode analogue, both dims): evidence
        # must stay exchangeable — within the tile's halo ring minus the
        # raster-window alignment slack (see make_sharded_sim_step's
        # static proof for the margins).
        reach_g = _reach_cells(cfg)
        ay_cell = (ry - cfg.grid.origin_y) / cfg.grid.resolution
        ax_cell = (rx - cfg.grid.origin_x) / cfg.grid.resolution
        r_lo, r_hi = tr * core_r, (tr + 1) * core_r
        c_lo, c_hi = tc * core_c, (tc + 1) * core_c
        if guard_box is not None:
            # drift-budget semantics (see the rows guard above)
            in_band = ((ay_cell >= guard_box[0][ridx]) &
                       (ay_cell <= guard_box[1][ridx]) &
                       (ax_cell >= guard_box[2][ridx]) &
                       (ax_cell <= guard_box[3][ridx]))
        else:
            in_band = ((ay_cell - reach_g >= r_lo - halo_r) &
                       (ay_cell + reach_g <= r_hi + halo_r - 8) &
                       (ax_cell - reach_g >= c_lo - halo_c) &
                       (ax_cell + reach_g <= c_hi + halo_c))
        band_esc_loc = jnp.sum((~in_band & alive).astype(jnp.int32))
    def merge(x):
        """This decomposition's map collective on local evidence: the
        full-grid psum (replicated), nothing (rows: each band is owned by
        one device), or the halo exchange (tiles)."""
        if tiles is not None:
            return _halo_exchange(x, R, C, halo_r, halo_c,
                                  srv.logodds.shape[0],
                                  srv.logodds.shape[1], axis_r, axis_c)
        if grid_rows:
            return x
        return jax.lax.psum(x, axis)

    def clip(lo):
        return jnp.clip(lo, -cfg.grid.logodds_clamp, cfg.grid.logodds_clamp)

    if beam_mode:
        from swarm_tpu.ops.beam_raster import (
            BeamSpec, beams_from_4way, beams_from_scan, endpoint_rays,
            reach_cells)
        from swarm_tpu.ops.fast_raster import (apply_counts, count_scale,
                                               fan_counts)
        reach = reach_cells(cfg)
        if tiles is not None:
            # raster into the EXTENDED tile (core + halo ring)
            ext_shape = (srv.logodds.shape[0] + 2 * halo_r,
                         srv.logodds.shape[1] + 2 * halo_c)
        else:
            ext_shape = srv.logodds.shape
        logodds = srv.logodds
        writes_loc = jnp.zeros((), jnp.int32)
        axy_l = jnp.stack([rx, ry], axis=-1)
        fans = []
        if cfg.engine.raster_4way or cfg.engine.scan_rays == 0:
            # 4-way fan through the SAME fast path as the fused engine —
            # the line-scatter here used to diverge from make_sim_step with
            # identical cfg (round-1 advisor finding). Fan order matches
            # _ingest_batched (4-way first), and so does the per-fan clamp.
            fans.append((BeamSpec.four_way(),
                         beams_from_4way(dist4, sens.max_range,
                                         sens.min_range)))
        if cfg.engine.scan_rays > 0:
            fans.append((BeamSpec.scan(cfg.engine.scan_rays),
                         beams_from_scan(scan_dist, sens.max_range,
                                         sens.min_range)))
        for spec_b, (db, tb) in fans:
            ngr = (spec_b.n_beams if cfg.engine.beam_groups <= 0
                   else min(cfg.engine.beam_groups, spec_b.n_beams))
            # integer counts: the collective is exact, so every
            # decomposition applies the same per-cell totals as the fused
            # engine
            n_free, n_hit, painted = fan_counts(
                ext_shape, axy_l, ryaw, db, alive, spec_b, cfg.grid,
                n_groups=ngr,
                trusted=tb if cfg.engine.kernel_endpoints else None,
                reach=reach, tail_weight=cfg.engine.beam_tail_weight,
                band=band, band_cols=band_cols)
            logodds = apply_counts(
                logodds, merge(n_free),
                None if n_hit is None else merge(n_hit), cfg.grid,
                count_scale(spec_b, ngr))
            writes_loc = writes_loc + jnp.sum(
                jnp.round(painted).astype(jnp.int32))
            if not cfg.engine.kernel_endpoints and cfg.engine.endpoint_hits:
                ep_delta, w_ep = logodds_delta(
                    endpoint_rays(axy_l, ryaw, db, tb, alive, spec_b),
                    cfg.grid, k_max=1, band=band, band_cols=band_cols)
                logodds = clip(logodds + merge(ep_delta))
                writes_loc = writes_loc + w_ep.astype(jnp.int32)
    else:
        delta, writes_loc = logodds_delta(rays, cfg.grid, band=band,
                                          band_cols=band_cols)
        logodds = clip(srv.logodds + merge(delta))
    writes = jax.lax.psum(writes_loc, axis)

    # gather this step's packets (a few floats per agent)
    def g(a):
        return jax.lax.all_gather(a, axis, tiled=True)
    rx_a, ry_a, lm_a, alive_a = g(rx), g(ry), g(lm), g(alive)
    hx_a, hy_a, hv_a = g(hx), g(hy), g(hit_valid)

    agents_all = jnp.arange(n, dtype=jnp.int32)
    if cfg.slam.closure_scanmatch and scan_dist is not None:
        # measured closures need the sweeps on every device: one
        # [N, R] all_gather per step (740 KB at 1024 x 181 — noise
        # next to the map psum); the matcher itself runs replicated
        # under its any-closure lax.cond, so closure-free steps pay
        # only the gather
        yaw_a, scan_a = g(ryaw), g(scan_dist)
    else:
        yaw_a, scan_a = None, None
    closure, closed_a, _, _ = closure_add_poses_batch(
        srv.closure, rx_a, ry_a, agents_all, lm_a, cfg.slam,
        valid=alive_a, yaws=yaw_a, scans=scan_a,
        grid=cfg.grid, sens=sens)

    zone = zone_observe_rows(
        srv.zone,
        jnp.concatenate([rx_a[:, None], hx_a], axis=1),
        jnp.concatenate([ry_a[:, None], hy_a], axis=1),
        jnp.concatenate([alive_a[:, None], hv_a & alive_a[:, None]],
                        axis=1))

    last_packet_t = jnp.where(alive_a, state.t, srv.last_packet_t)
    pkt_counts = srv.pkt_counts + alive_a.astype(jnp.int32)
    online = heartbeat_update(last_packet_t, state.t,
                              cfg.coord.heartbeat_timeout_s)
    agent_xy = jnp.stack([rx_a, ry_a], axis=-1)

    zone_every = max(1, round(cfg.coord.zone_interval_s / dt))
    do_zone = (state.step % zone_every) == 0
    boxes, active = zones_for_agents(zone, agent_xy, online)
    zone_boxes = jnp.where(do_zone, boxes, srv.zone_boxes)
    zone_active = jnp.where(do_zone, active, srv.zone_active)

    no_targets = (jnp.zeros((n, 2), jnp.float32), jnp.zeros((n,), bool))
    if cfg.engine.compute_frontiers:
        target_every = max(1, round(cfg.coord.target_interval_s / dt))
        do_target = (state.step % target_every) == 0

        def recompute(_):
            # gather the band only on refresh steps (the predicate is the
            # replicated step counter, so every device takes this branch
            # together and the collective matches)
            if tiles is not None:
                lo_full = jax.lax.all_gather(
                    jax.lax.all_gather(logodds, axis_r, axis=0,
                                       tiled=True),
                    axis_c, axis=1, tiled=True)
            elif grid_rows:
                lo_full = jax.lax.all_gather(logodds, axis, tiled=True)
            else:
                lo_full = logodds
            tri = tri_state_view(lo_full, cfg.grid)
            cents, _, cnt = (frontier_clusters if cfg.grid.size <= 512
                             else frontier_targets_coarse)(
                                 tri, cfg.grid, cfg.coord)
            if enable_targets:
                # replicated assignment (same inputs on every device)
                afn = (greedy_assign_rooms
                       if room_boxes is not None and
                       n >= cfg.coord.assign_rooms_min_agents
                       else greedy_assign)
                tg, has = afn(agent_xy, online, cents, cnt,
                              cfg.coord, room_boxes=room_boxes)
            else:
                tg, has = no_targets
            return cents, cnt, tg, has

        def keep(_):
            return (srv.frontier_centroids, srv.n_frontiers) + no_targets

        cents, n_fr, new_targets, new_has = jax.lax.cond(
            do_target, recompute, keep, None)
    else:
        cents, n_fr = srv.frontier_centroids, srv.n_frontiers
        new_targets, new_has = no_targets

    anchor = srv.anchor
    if cfg.slam.merge_anchor and cfg.engine.merge_every > 0:
        do_anch = (state.step % cfg.engine.merge_every) == \
            (cfg.engine.merge_every - 1)
        if cfg.slam.merge_anchor_freeze_steps > 0:
            do_anch = do_anch & (
                state.step < cfg.slam.merge_anchor_freeze_steps)
        anchor = jax.lax.cond(
            do_anch,
            lambda _: jnp.where(
                (jnp.abs(srv.anchor) < 0.5) &
                (jnp.abs(logodds) >= cfg.slam.merge_anchor_thresh),
                logodds, srv.anchor),
            lambda _: srv.anchor, None)

    new_srv = MapState(
        grid=srv.grid, logodds=logodds, closure=closure, zone=zone,
        last_packet_t=last_packet_t, pkt_counts=pkt_counts,
        zone_boxes=zone_boxes, zone_active=zone_active,
        frontier_centroids=cents, n_frontiers=n_fr,
        total_writes=writes_accumulate(srv.total_writes,
                                       writes.astype(jnp.int32)),
        merge_dx=(srv.merge_dx + g(adv_x)) + g(cdx),
        merge_dy=(srv.merge_dy + g(adv_y)) + g(cdy),
        merge_dyaw=srv.merge_dyaw + g(cdth),
        anchor=anchor,
        merge_fail=g(new_fail_loc),
        merge_yaw_rate=srv.merge_yaw_rate + g(rate_d_loc),
        merge_dist_mark=srv.merge_dist_mark + g(mark_d_loc),
        frame=frame_add(frame_add(srv.frame, jax.tree.map(g, adv_d)),
                        jax.tree.map(g, inno_d)))

    # TARG delivery (local rows of the replicated assignment; mirrors
    # engine.sim.sim_step — server frame back into the odometry frame)
    nav_in = state.nav
    if enable_targets:
        tgt_local = new_targets[ridx] - jnp.stack(
            [p.x_offset + closure.drift_dx[ridx] + new_srv.merge_dx[ridx],
             closure.drift_dy[ridx] + new_srv.merge_dy[ridx]], axis=-1)
        nav_in = navm.assign_target(nav_in, tgt_local,
                                    new_has[ridx] & alive)

    # 5. navigate (local; zone boxes back into the agent's odometry frame)
    est_pose = jnp.stack([odom.x_est, odom.y_est, odom.yaw_est], axis=-1)
    zb = zone_boxes[ridx]
    zone_local = zb - jnp.stack(
        [p.x_offset, jnp.zeros((n_loc,)), p.x_offset,
         jnp.zeros((n_loc,))], axis=-1)
    nav, cmd = navm.nav_step(
        nav_in,
        navm.NavParams(wall_side=p.wall_side, motor_pwm=p.motor_pwm,
                       return_style=p.return_style,
                       home_x=p.home_x, home_y=p.home_y),
        dist4, est_pose, state.total_dist, zone_local,
        zone_active[ridx], dt, navc)

    drive = jnp.where(alive, cmd.drive_m, 0.0)
    turn = jnp.where(alive, cmd.turn_cmd_rad, 0.0)
    steer = jnp.where(alive, cmd.steer_rad, 0.0)

    # raw-estimate telemetry snapshot (PRE-motion, same timing as rx —
    # `odom` is rebound post-motion in stage 7 below); feeds the offline
    # pose-graph chain
    est_x_loc = odom.x_est + p.x_offset
    est_y_loc = odom.y_est
    est_yaw_loc = odom.yaw_est

    # 6. physics (local; steering = displacement arc, heading changes only
    #    via turns — see engine.sim.sim_step stage 6)
    yaw_true = wrap_pi(state.pose_true[:, 2] + turn)
    move_dir = yaw_true + steer
    clear = cast_rays(state.pose_true[:, :2], move_dir, walls)
    drive = jnp.minimum(drive, jnp.maximum(clear - 0.08, 0.0))
    x_true = state.pose_true[:, 0] + drive * jnp.cos(move_dir)
    y_true = state.pose_true[:, 1] + drive * jnp.sin(move_dir)
    pose_true = jnp.stack([x_true, y_true, yaw_true], axis=-1)
    total_dist = state.total_dist + drive

    # 7. odometry + EKF (local)
    odom = jax.vmap(
        lambda k, o, d, r, ts, yb: drift_integrate(k, o, d, r, ts, yb,
                                                   cfg.noise))(
        k_drift, odom, drive, turn, p.trans_scale, p.yaw_bias_per_m)
    t_new = state.t + dt
    omega = turn / dt
    v = drive / dt
    ekf = ekf_step_batch(state.ekf, omega, v, jnp.full((n_loc,), t_new),
                         cfg.ekf)

    # v1 EKF-yaw personality (mirrors engine.sim.sim_step stage 7)
    odom = odom._replace(yaw_est=jnp.where(
        p.ekf_yaw, wrap_pi(ekf.x[:, 2]), odom.yaw_est))

    err = jnp.sqrt((rx - p.x_offset - x_true) ** 2 + (ry - y_true) ** 2)

    # v2v over gathered TRUE positions (pre-motion, matching sim_step);
    # both reference semantics — distance-in-cm or the firmware's
    # cumulative received-broadcast counter (AgentParams.v2v_count)
    from swarm_tpu.engine.sim import v2v_stats
    txy_a = jnp.stack([g(state.pose_true[:, 0] + p.x_offset),
                       g(state.pose_true[:, 1])], axis=-1)
    v2v_cm_a, v2v_n_a = v2v_stats(txy_a, alive_a,
                                  cfg.sensors.v2v_range_m)
    dt_tick = cfg.nav.drive_tick_s + cfg.nav.settle_tick_s
    rx_tick_loc = jnp.round(
        v2v_n_a[ridx].astype(jnp.float32) *
        cfg.sensors.v2v_broadcast_hz * dt_tick).astype(jnp.int32)
    v2v_total = state.v2v_total + jnp.where(alive, rx_tick_loc, 0)
    v2v = jnp.where(g(p.v2v_count), g(v2v_total), v2v_cm_a)

    new_state = SimState(
        t=t_new, step=state.step + 1, key=key,
        pose_true=pose_true, odom=odom, ekf=ekf, nav=nav,
        total_dist=total_dist, v2v_total=v2v_total, srv=new_srv)

    metrics = StepMetrics(
        writes=writes.astype(jnp.int32),
        closures=jnp.sum(closed_a.astype(jnp.int32)),
        online=jnp.sum(online.astype(jnp.int32)),
        n_frontiers=n_fr,
        pose_err=jax.lax.psum(jnp.sum(jnp.where(alive, err, 0.0)), axis) / n,
        mission_done=jax.lax.psum(
            jnp.sum(nav.mission_complete.astype(jnp.int32)), axis),
        merges=jax.lax.psum(n_merges_loc, axis),
        merge_fitness=(jax.lax.psum(merge_fitsum_loc, axis) /
                       jnp.maximum(jax.lax.psum(n_merges_loc, axis),
                                   1).astype(jnp.float32)),
        band_escapes=jax.lax.psum(band_esc_loc, axis),
        t=state.t,
        srv_x=rx_a, srv_y=ry_a, srv_yaw=g(ryaw), yaw_q=g(yaw_q),
        est_x=g(est_x_loc), est_y=g(est_y_loc), est_yaw=g(est_yaw_loc),
        merge_ok=g(merge_ok_loc), merge_fit=g(merge_fit_loc),
        encoder=g(enc_tot), v2v=v2v,
        dist_m=g(dist4), landmark=lm_a,
        hits=jnp.stack([hx_a, hy_a], axis=-1),
        hit_valid=hv_a & alive_a[:, None],
        alive=alive_a)
    return new_state, metrics


def make_sharded_sim_step(cfg: SwarmConfig, walls, params: AgentParams, mesh,
                          faults: Optional[FaultSchedule] = None,
                          enable_targets: bool = False, donate: bool = True,
                          grid_sharding: str = "replicated",
                          walls_grouped=None, room_of_agent=None):
    """Build the jitted multi-chip step. `cfg.n_agents` must be divisible by
    the mesh size and `cfg.engine.parity_mode` must be False. The
    bfloat16 grid knob (GridConfig.logodds_dtype) is a fused-engine
    memory lever and is rejected here.

    The beam raster always runs the fast path (ops/fast_raster.py) on
    the decomposition's grid window, and the collectives move its integer
    counts.

    grid_sharding:
      "replicated" — each shard computes full-grid evidence, merged with
        one psum.
      "rows" — the grid row-band-sharded over the (1-D) mesh: zero map
        collectives; requires `walls_grouped`/`room_of_agent` so each
        agent's possible evidence rows can be statically proven to lie
        in its device's band (tiled per-row room layouts satisfy this).
      "tiles" — 2-D (rows x cols) tile decomposition over a 2-D mesh
        with HALO EXCHANGE (SURVEY §2 "grid tiles = shards"): each
        device rasters its agents into its tile plus a halo ring;
        border-crossing evidence is shipped to the owning neighbour via
        ppermute (row phase then column phase). The static proof only
        requires each agent's evidence box to stay within its tile's
        exchangeable region (tile + halo, minus window-alignment slack)
        — agents MAY paint across tile borders, unlike "rows"."""
    if cfg.grid.logodds_dtype != "float32":
        raise ValueError("sharded decompositions keep a float32 grid; "
                         "logodds_dtype=bfloat16 is a fused-engine knob")
    if cfg.engine.parity_mode:
        raise ValueError("sharded step requires throughput mode "
                         "(cfg.engine.parity_mode=False)")
    if grid_sharding not in ("replicated", "rows", "tiles"):
        raise ValueError(f"unknown grid_sharding {grid_sharding!r}")
    guard_box = None      # per-agent static evidence box (runtime guard)
    grid_tiles = grid_sharding == "tiles"
    if grid_tiles:
        if mesh.devices.ndim != 2 or len(mesh.axis_names) != 2:
            raise ValueError("grid_sharding='tiles' needs a 2-D mesh "
                             "(rows axis x cols axis)")
        axis = tuple(mesh.axis_names)
    else:
        axis = mesh.axis_names[0]
    d = mesh.devices.size
    if cfg.n_agents % d != 0:
        raise ValueError(f"n_agents={cfg.n_agents} not divisible by "
                         f"mesh size {d}")
    grid_rows = grid_sharding == "rows"
    tiles = None
    if grid_tiles:
        import numpy as np
        from swarm_tpu.ops.beam_raster import patch_dims, reach_cells
        R, C = mesh.devices.shape
        size = cfg.grid.size
        if size % R or size % C:
            raise ValueError(f"grid size {size} not divisible by mesh "
                             f"({R}, {C})")
        wr, wc = size // R, size // C
        reach = reach_cells(cfg)
        pr, pc = patch_dims(size, reach)
        if pc >= size:
            raise ValueError("tiles sharding needs size >= 512 (windowed "
                             "raster patches; smaller grids fit one chip)")
        if wc % 128:
            raise ValueError(f"tile width {wc} not 128-aligned")
        halo_c = 128
        if reach > halo_c:
            raise ValueError(f"beam reach {reach} exceeds the {halo_c}-"
                             "column halo")
        # smallest 8-aligned row halo whose extended tile provably holds
        # every in-tile agent's raster window (alignment included)
        halo_r = -(-reach // 8) * 8
        while 8 * ((halo_r - reach) // 8) + pr > 2 * halo_r:
            halo_r += 8
        if wr < max(halo_r, pr - 2 * halo_r) or wc < halo_c:
            raise ValueError(f"tile [{wr}, {wc}] too small for halo "
                             f"[{halo_r}, {halo_c}] / window {pr} rows")
        if cfg.engine.merge_every > 0:
            from swarm_tpu.slam.livemerge import merge_window_side
            side = merge_window_side(cfg)
            if wr < side or wc < side:
                raise ValueError(
                    f"tile [{wr}, {wc}] cannot hold the {side}-cell "
                    "scan-merge window (shrink slam.merge_window_cells "
                    "or use grid_sharding='replicated')")
        if walls_grouped is None or room_of_agent is None:
            raise ValueError("grid_sharding='tiles' needs walls_grouped "
                             "+ room_of_agent for the static containment "
                             "proof")
        rmin, rmax, cmin, cmax = agent_evidence_box(
            walls_grouped, room_of_agent, cfg)
        guard_box = tuple(jnp.asarray(a, jnp.float32)
                          for a in (rmin, rmax, cmin, cmax))
        dev = np.arange(cfg.n_agents) // (cfg.n_agents // d)
        dr, dc = dev // C, dev % C
        bad = ((rmin < dr * wr - halo_r) |
               (rmax > (dr + 1) * wr + halo_r - 8) |
               (cmin < dc * wc - halo_c) |
               (cmax > (dc + 1) * wc + halo_c))
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())} agents' evidence boxes escape their "
                "device tile's exchangeable region — order agent blocks "
                "device-major over the (rows, cols) tile grid")
        tiles = (R, C, halo_r, halo_c)
    if grid_rows:
        import numpy as np
        from swarm_tpu.ops.beam_raster import patch_dims, reach_cells
        if cfg.grid.size % d:
            raise ValueError(f"grid size {cfg.grid.size} not divisible by "
                             f"mesh size {d}")
        band = cfg.grid.size // d
        pr, _ = patch_dims(cfg.grid.size, reach_cells(cfg))
        if band < pr:
            raise ValueError(f"band of {band} rows cannot hold the "
                             f"{pr}-row raster window")
        if cfg.engine.merge_every > 0:
            from swarm_tpu.slam.livemerge import merge_window_side
            side = merge_window_side(cfg)
            if band < side:
                raise ValueError(
                    f"band of {band} rows cannot hold the {side}-row "
                    "scan-merge window (shrink slam.merge_window_cells "
                    "or use grid_sharding='replicated')")
        if walls_grouped is None or room_of_agent is None:
            raise ValueError("grid_sharding='rows' needs walls_grouped + "
                             "room_of_agent for the static band-"
                             "containment proof")
        rmin, rmax = agent_evidence_rows(walls_grouped, room_of_agent, cfg)
        guard_box = tuple(jnp.asarray(a, jnp.float32)
                          for a in (rmin, rmax))
        dev = np.arange(cfg.n_agents) // (cfg.n_agents // d)
        lo = dev * band
        bad = (rmin < lo) | (rmax > lo + band)
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())} agents' evidence rows escape their "
                "device's grid band — reorder agents/rooms so each "
                "device's rooms fill whole bands (tiled per_row layouts)")
    if faults is None:
        faults = no_faults()
    walls = jnp.asarray(walls)

    # Static per-agent merge-window bounds: whenever the room layout is
    # known, the scan-merge window start is clamped into each agent's
    # TILE-SNAPPED room box (merge_window_box — agent-centered placement
    # with a near-no-op clamp) — the SAME global placement in every
    # decomposition (see slam.livemerge.scan_merge win_bounds). Required
    # for the banded/tiled grids' bit-equality with the replicated
    # reference; applied in replicated mode too so the two sides agree.
    # The snapped box must sit INSIDE the local band/tile so the
    # capacity clamp never binds — proven below.
    win_box = None
    if (cfg.engine.merge_every > 0 and walls_grouped is not None
            and room_of_agent is not None):
        import numpy as np

        brmin, brmax, bcmin, bcmax = merge_window_box(
            walls_grouped, room_of_agent, cfg)
        dev = np.arange(cfg.n_agents) // (cfg.n_agents // d)
        if grid_rows:
            band = cfg.grid.size // d
            bad = (brmin < dev * band) | (brmax > (dev + 1) * band)
            if bad.any():
                raise ValueError(
                    f"{int(bad.sum())} agents' tile-snapped room boxes "
                    "cross their device's grid band — the merge window "
                    "cannot be placed decomposition-invariantly (bands "
                    "must own whole 128-row raster tiles)")
        if grid_tiles:
            R, C = mesh.devices.shape
            wr, wc = cfg.grid.size // R, cfg.grid.size // C
            dr, dc = dev // C, dev % C
            bad = ((brmin < dr * wr) | (brmax > (dr + 1) * wr) |
                   (bcmin < dc * wc) | (bcmax > (dc + 1) * wc))
            if bad.any():
                raise ValueError(
                    f"{int(bad.sum())} agents' tile-snapped room boxes "
                    "cross their device's CORE tile — the scan-merge "
                    "window can only read the core tile, so "
                    "decomposition-invariant placement needs each room's "
                    "raster tile inside one device tile")
        win_box = tuple(jnp.asarray(a, jnp.int32)
                        for a in (brmin, brmax, bcmin, bcmax))

    room_boxes = None
    if enable_targets and walls_grouped is not None \
            and room_of_agent is not None:
        # same reachability restriction as the fused engine (sim_step):
        # frontier targets only from the agent's own room
        from swarm_tpu.geom.world import agent_room_boxes
        # host numpy, NOT jnp: greedy_assign_rooms needs concrete boxes
        # for its host-side room grouping (see engine.sim.sim_step)
        room_boxes = agent_room_boxes(walls_grouped, room_of_agent)
    body = functools.partial(
        _sharded_step_body, cfg=cfg, walls=walls, params=params,
        faults=faults, enable_targets=enable_targets, axis=axis,
        grid_rows=grid_rows, tiles=tiles,
        guard_box=guard_box, win_box=win_box, room_boxes=room_boxes)
    specs = state_specs(axis, grid_rows,
                        lo_spec=P(*mesh.axis_names) if grid_tiles
                        else None)
    if not cfg.slam.merge_anchor:
        # anchor is a [1, 1] placeholder — replicated, not grid-sharded
        specs = specs._replace(srv=specs.srv._replace(anchor=P()))
    mspec = StepMetrics(*([P()] * len(StepMetrics._fields)))
    # check_vma off: coordination outputs are replicated by construction
    # (derived from all_gather/psum results), which the static VMA check
    # cannot see through.
    f = shard_map(body, mesh=mesh, in_specs=(specs,),
                  out_specs=(specs, mspec), check_vma=False)
    return jax.jit(f, donate_argnums=(0,) if donate else ())

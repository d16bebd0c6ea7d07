"""The fused closed-loop swarm simulation: ONE jitted step for everything.

This is the batched replacement for the reference's entire distributed
system — N robots' firmware loops (AgentFirmware_Bot1.ino:689-712: read IMU,
EKF predict, navigate) plus the central mapping server
(dual_bot_mapper.py:796-1002) — as a single pure function over batched
state. The UDP/ESP-NOW hops become array dataflow; packet-level
imperfections (loss via the alive mask, per-agent drift, sensor noise)
remain explicit, seedable models.

Per tick (one `navigate()` cycle, ~0.4 s of robot time:
drive 300 ms + settle 100 ms, ino:477-479):

  1. sense     — 4-way ultrasonic cast from the TRUE pose + noise
                 (generate_fake_dual_session.py:93-108 semantics: sensors see
                 truth, telemetry reports the drifted estimate)
  2. landmark  — geometric signature (ino:152-169 / sim :113-129)
  3. telemetry — per-agent QuasarPacket fields (est pose, encoder, v2v)
  4. server    — drift-corrected ingest: batched ray raster into the
                 occupancy grid, loop closures, territory AABBs, heartbeat,
                 frontier/target cadences (dual_bot_mapper.py:814-996)
  5. navigate  — the 6-state FSM step -> motion command (ino:393-607)
  6. physics   — apply command to the true pose with wall-collision clamp
  7. odometry  — drifted dead-reckoning integrate + EKF predict/update

Every stage is batched over [N] agents; the raster is one [N*4]-ray scatter;
closures run either as an exact sequential scan (parity mode) or one
batched match (throughput mode). `sim_rollout` wraps the step in `lax.scan`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from swarm_tpu.config import SwarmConfig
from swarm_tpu.coord.assign import greedy_assign, greedy_assign_rooms
from swarm_tpu.coord.heartbeat import heartbeat_update
from swarm_tpu.coord.zones import ZoneState, zone_init, zone_observe_rows, zones_for_agents
from swarm_tpu.models import nav as navm
from swarm_tpu.models.ekf import EkfState, ekf_init, ekf_step_batch
from swarm_tpu.models.landmarks import detect_landmark_sim
from swarm_tpu.models.odometry import OdomState, drift_integrate, encoder_emit, odom_init, quantize_yaw_deg
from swarm_tpu.models.sensors import sense_4way
from swarm_tpu.ops.frontier import frontier_clusters, frontier_targets_coarse
from swarm_tpu.ops.raster import RayBatch, logodds_raster, parity_raster, tri_state_view
from swarm_tpu.slam.livemerge import FrameState, frame_init
from swarm_tpu.slam.closure import (
    ClosureState, closure_add_pose, closure_add_poses_batch, closure_init)
from swarm_tpu.utils.angles import wrap_pi


class AgentParams(NamedTuple):
    """Per-agent static parameters as batched arrays — the batched
    replacement for the reference's forked firmware directories
    (AgentFirmware_Bot1/ vs AgentFirmware_Bot2/, SURVEY §2 row 14)."""
    wall_side: jnp.ndarray       # [N] +1 left-follower (Bot1) / -1 right (Bot2)
    motor_pwm: jnp.ndarray       # [N] MOTOR_SPEED (205 / 190)
    return_style: jnp.ndarray    # [N] navm.RETURN_STYLE_*
    home_x: jnp.ndarray          # [N] start x (0 for Bot1, separation for Bot2)
    home_y: jnp.ndarray
    yaw0: jnp.ndarray            # [N] start yaw (0 / pi, Bot2.ino:192)
    trans_scale: jnp.ndarray     # [N] odometry scale bias (0.998 / 1.002)
    yaw_bias_per_m: jnp.ndarray  # [N] signed yaw drift (-0.008 / +0.008)
    x_offset: jnp.ndarray        # [N] server-side separation offset (:851-852)
    ekf_yaw: jnp.ndarray         # [N] bool — v1 firmware personality: the
    #                               EKF yaw DRIVES robot_yaw every loop
    #                               (AgentFirmware.ino.ino:429-436), unlike
    #                               Bot1/Bot2's commanded-yaw convention
    #                               (AgentFirmware_Bot1.ino:704-707)
    v2v_count: jnp.ndarray       # [N] bool — firmware v2v personality: the
    #                               telemetry v2v field is the cumulative
    #                               ESP-NOW received-broadcast COUNT
    #                               (AgentFirmware_Bot1.ino:211-215, fed at
    #                               20 Hz by SensorNode.ino:37-70) instead
    #                               of the sim generator's distance-in-cm
    #                               (generate_fake_dual_session.py:466)


def make_agent_params(n: int, separation: float = 5.0,
                      spacing: float = 0.6,
                      cfg: SwarmConfig = SwarmConfig()) -> AgentParams:
    """Alternating Bot1/Bot2 personalities. For n == 2 this reproduces the
    reference's dual-bot setup exactly (Bot1 at origin facing +x following
    the left wall; Bot2 at `separation`, yaw pi, right wall). Larger swarms
    stagger starts along y by `spacing` within the same personality split."""
    i = jnp.arange(n)
    is_b2 = (i % 2) == 1
    row = (i // 2).astype(jnp.float32)
    return AgentParams(
        wall_side=jnp.where(is_b2, -1, 1).astype(jnp.int32),
        motor_pwm=jnp.where(is_b2, 190, 205).astype(jnp.int32),
        return_style=jnp.where(is_b2, navm.RETURN_STYLE_GOHOME,
                               navm.RETURN_STYLE_STRAIGHT).astype(jnp.int32),
        home_x=jnp.where(is_b2, 0.0, 0.0).astype(jnp.float32),
        home_y=(row * spacing).astype(jnp.float32),
        yaw0=jnp.where(is_b2, jnp.pi, 0.0).astype(jnp.float32),
        trans_scale=jnp.where(is_b2, 1.002, 0.998).astype(jnp.float32),
        yaw_bias_per_m=jnp.where(is_b2, 0.008, -0.008).astype(jnp.float32),
        x_offset=jnp.where(is_b2, separation, 0.0).astype(jnp.float32),
        ekf_yaw=jnp.zeros((n,), bool),
        v2v_count=jnp.zeros((n,), bool))


class FaultSchedule(NamedTuple):
    """Deterministic agent-kill windows (SURVEY §5 failure injection: the
    scripted stuck-bot fault, generate_fake_dual_session.py:331-350, and the
    heartbeat-failover test path, dual_bot_mapper.py:804-812)."""
    agent: jnp.ndarray   # [F] int32 (-1 = unused slot)
    t_start: jnp.ndarray  # [F] seconds
    t_end: jnp.ndarray    # [F]


def no_faults(capacity: int = 4) -> FaultSchedule:
    return FaultSchedule(agent=jnp.full((capacity,), -1, jnp.int32),
                         t_start=jnp.zeros((capacity,), jnp.float32),
                         t_end=jnp.zeros((capacity,), jnp.float32))


def alive_mask(faults: FaultSchedule, n: int, t) -> jnp.ndarray:
    hit = (faults.agent[None, :] == jnp.arange(n)[:, None]) & \
        (t >= faults.t_start[None, :]) & (t < faults.t_end[None, :])
    return ~jnp.any(hit, axis=1)


def v2v_stats(txy, alive, radio_range_m: float = 10.0,
              chunk: int = 1024):
    """Pairwise V2V link statistics, chunked (no [N, N] materialization
    above 2*chunk agents — one [chunk, N] block live at a time under
    lax.scan; the monolithic matrix is >1 GB of device memory at 16,384 agents).

    Returns (nearest_cm [N] int32, in_range [N] int32):
      nearest_cm — distance to the nearest OTHER live agent in integer cm
        (the sim generator's link model, generate_fake_dual_session
        .py:466); 0 when no other live agent exists.
      in_range — number of other live agents within `radio_range_m` (the
        ESP-NOW broadcast neighbourhood feeding the firmware's
        received-packet counter, AgentFirmware_Bot1.ino:211-215)."""
    n = txy.shape[0]
    r2 = radio_range_m * radio_range_m

    def block_stats(rows_xy, row_ids):
        d2 = jnp.sum((rows_xy[:, None, :] - txy[None, :, :]) ** 2, -1)
        self_or_dead = (jnp.arange(n)[None, :] == row_ids[:, None]) | \
            ~alive[None, :]
        d2 = jnp.where(self_or_dead, jnp.inf, d2)
        return jnp.min(d2, axis=1), jnp.sum((d2 <= r2).astype(jnp.int32),
                                            axis=1)

    if n <= 2 * chunk or n % chunk != 0:
        d2min, cnt = block_stats(txy, jnp.arange(n, dtype=jnp.int32))
    else:
        def body(_, i):
            ids = i * chunk + jnp.arange(chunk, dtype=jnp.int32)
            return None, block_stats(txy[ids], ids)

        _, (mins, cnts) = jax.lax.scan(
            body, None, jnp.arange(n // chunk, dtype=jnp.int32))
        d2min = mins.reshape(n)
        cnt = cnts.reshape(n)
    cm = jnp.where(jnp.isfinite(d2min),
                   jnp.sqrt(d2min) * 100.0, 0.0).astype(jnp.int32)
    return cm, cnt


def v2v_nearest_cm(txy, alive, chunk: int = 1024) -> jnp.ndarray:
    """Nearest-other-live-agent distance in cm (see v2v_stats)."""
    return v2v_stats(txy, alive, chunk=chunk)[0]


class MapState(NamedTuple):
    """Server-side mapping + coordination state (dual_bot_mapper.py:755-789)."""
    grid: jnp.ndarray             # [S, S] int8 tri-state (parity mode)
    logodds: jnp.ndarray          # [S, S] float32 (throughput mode)
    closure: ClosureState
    zone: ZoneState
    last_packet_t: jnp.ndarray    # [N]
    pkt_counts: jnp.ndarray       # [N] int32
    zone_boxes: jnp.ndarray       # [N, 4]
    zone_active: jnp.ndarray      # [N] bool
    frontier_centroids: jnp.ndarray  # [K, 2]
    n_frontiers: jnp.ndarray      # [] int32
    # Exact big-integer write counter as an int32 (hi, lo) pair, lo in
    # [0, 2^30): a float32 total quantizes above 2^24 (the r1 weak-spot —
    # 16,384 agents write ~5.4e7 cells/STEP) and int64 needs x64 mode.
    # Use writes_accumulate / total_writes_value.
    total_writes: jnp.ndarray     # [2] int32 (hi, lo)
    # accumulated scan-merge corrections (slam/livemerge.py) — the merge
    # analogue of closure.drift_dx/dy (dual_bot_mapper.py:854-857)
    merge_dx: jnp.ndarray         # [N] float32
    merge_dy: jnp.ndarray         # [N]
    merge_dyaw: jnp.ndarray       # [N]
    # frozen first-evidence anchor map for drift-stable scan matching
    # (SlamConfig.merge_anchor); [1, 1] placeholder when disabled
    anchor: jnp.ndarray           # [S, S] (or [1, 1]) lo_dtype
    # consecutive failed/railing merge events per agent — the escalation
    # trigger for SlamConfig.merge_recover_after (slam/livemerge.py)
    merge_fail: jnp.ndarray       # [N] int32
    # online per-agent yaw-rate-bias estimate (rad/m) + the total_dist
    # value at its last rebase (SlamConfig.merge_bias_alpha;
    # slam/livemerge.py merge_bias_ff / merge_bias_update)
    merge_yaw_rate: jnp.ndarray   # [N] float32
    merge_dist_mark: jnp.ndarray  # [N] float32
    # online per-agent FRAME tracker (SlamConfig.merge_frame_gain;
    # slam/livemerge.py FrameState / frame_advance / frame_innovate)
    frame: "FrameState"


WRITES_RADIX = 1 << 30


def writes_accumulate(tw, w):
    """tw [2] int32 (hi, lo) + w int32 (one step's writes, < 2^30 by the
    per-step int32 metrics bound) -> exact running total."""
    lo = tw[1] + w
    carry = lo // WRITES_RADIX
    return jnp.stack([tw[0] + carry, lo - carry * WRITES_RADIX])


def writes_delta(tw_new, tw_old):
    """One step's writes from two counter states (int32-exact: a single
    step never exceeds the radix)."""
    return (tw_new[0] - tw_old[0]) * WRITES_RADIX + (tw_new[1] - tw_old[1])


def total_writes_value(tw) -> int:
    """Host-side exact value of the (hi, lo) counter."""
    import numpy as np
    a = np.asarray(tw).astype(np.int64)
    return int(a[0]) * WRITES_RADIX + int(a[1])


class SimState(NamedTuple):
    """Complete swarm-world state — one pytree, checkpointable as-is."""
    t: jnp.ndarray                # [] seconds
    step: jnp.ndarray             # [] int32
    key: jnp.ndarray              # PRNG key
    pose_true: jnp.ndarray        # [N, 3] ground truth (x, y, yaw)
    odom: OdomState               # drifted estimate ([N] leaves)
    ekf: EkfState                 # [N, 6] / [N, 6, 6]
    nav: navm.NavState            # [N] leaves
    total_dist: jnp.ndarray       # [N] true metres travelled
    v2v_total: jnp.ndarray        # [N] int32 cumulative ESP-NOW broadcasts
    #                               received (firmware counter,
    #                               AgentFirmware_Bot1.ino:211-215)
    srv: MapState


class StepMetrics(NamedTuple):
    """Per-step observability + telemetry (SURVEY §5 metrics: the jitted
    step returns a metrics pytree instead of printing; the per-agent fields
    are the QuasarPacket v2 columns, so a rollout's stacked metrics convert
    straight into a reference-schema session log via proto.csvio)."""
    writes: jnp.ndarray        # [] grid cell writes this step
    closures: jnp.ndarray      # [] closures fired this step
    online: jnp.ndarray        # [] agents online
    n_frontiers: jnp.ndarray   # [] frontier clusters known
    pose_err: jnp.ndarray      # [] mean |est+corr - true| position error
    mission_done: jnp.ndarray  # [] agents finished
    merges: jnp.ndarray        # [] scan-merge corrections applied this step
    merge_fitness: jnp.ndarray  # [] mean fitness of applied merges (0 if none)
    band_escapes: jnp.ndarray  # [] agents whose raster evidence could leave
    #                               their device's grid band this step (rows-
    #                               sharded engine only; always 0 elsewhere).
    #                               Nonzero = the static drift budget of
    #                               parallel.sharded.agent_evidence_rows is
    #                               exhausted and rows-vs-replicated bit
    #                               identity is no longer guaranteed.
    # --- telemetry (per agent, server frame) -------------------------------
    t: jnp.ndarray             # [] packet timestamp
    srv_x: jnp.ndarray         # [N] drift-corrected + offset pose (rx)
    srv_y: jnp.ndarray         # [N]
    srv_yaw: jnp.ndarray       # [N] corrected reported yaw — the raster
    #                               frame (yaw_q + merge corrections)
    yaw_q: jnp.ndarray         # [N] quantised reported yaw (radians)
    # --- offline-refinement observables ---------------
    est_x: jnp.ndarray         # [N] RAW drifted estimate + x_offset (no
    #                               corrections — the smooth odometry
    #                               chain for the offline pose graph)
    est_y: jnp.ndarray         # [N]
    est_yaw: jnp.ndarray       # [N] unquantised estimate yaw
    merge_ok: jnp.ndarray      # [N] bool — this agent's scan-merge match
    #                               was applied this step; (srv_x, srv_y,
    #                               srv_yaw) is then an ABSOLUTE pose
    #                               observation in the anchor frame
    merge_fit: jnp.ndarray     # [N] fitness of that match (0 if none)
    encoder: jnp.ndarray       # [N] int32 totals
    v2v: jnp.ndarray           # [N] int32 cm to nearest other live agent
    dist_m: jnp.ndarray        # [N, 4] reported ranges (metres)
    landmark: jnp.ndarray      # [N] int32
    hits: jnp.ndarray          # [N, 4, 2] world hit points
    hit_valid: jnp.ndarray     # [N, 4] trust-filter mask
    alive: jnp.ndarray         # [N] packet-sent mask


def sim_init(cfg: SwarmConfig, params: AgentParams,
             key: Optional[jnp.ndarray] = None) -> SimState:
    n = cfg.n_agents
    s = cfg.grid.size
    if key is None:
        key = jax.random.PRNGKey(42)   # ref seed (generate_fake_dual_session.py:319)
    x0 = params.home_x
    y0 = params.home_y
    pose_true = jnp.stack([x0, y0, params.yaw0], axis=-1)
    ekf0 = jax.vmap(lambda x, y, yaw: ekf_init(
        jnp.array([x, y, yaw, 0.0, 0.0, 0.0])))(x0, y0, params.yaw0)
    if cfg.grid.logodds_dtype != "float32":
        if cfg.engine.parity_mode or cfg.engine.raster_mode != "beam":
            raise ValueError(
                "logodds_dtype=bfloat16 is supported by the fused beam "
                "tiers only")
    srv = MapState(
        grid=jnp.full((s, s), cfg.grid.unknown, jnp.int8),
        logodds=jnp.zeros((s, s), cfg.grid.lo_dtype),
        closure=closure_init(
            n, cfg.slam,
            scan_rays=(cfg.engine.scan_rays
                       if cfg.slam.closure_scanmatch else 0)),
        zone=zone_init(n),
        last_packet_t=jnp.zeros((n,), jnp.float32),
        pkt_counts=jnp.zeros((n,), jnp.int32),
        zone_boxes=jnp.tile(jnp.array([999.0, 999.0, -999.0, -999.0],
                                      jnp.float32), (n, 1)),
        zone_active=jnp.zeros((n,), bool),
        frontier_centroids=jnp.zeros((cfg.coord.max_frontiers, 2), jnp.float32),
        n_frontiers=jnp.zeros((), jnp.int32),
        total_writes=jnp.zeros((2,), jnp.int32),
        merge_dx=jnp.zeros((n,), jnp.float32),
        merge_dy=jnp.zeros((n,), jnp.float32),
        merge_dyaw=jnp.zeros((n,), jnp.float32),
        anchor=jnp.zeros((s, s) if cfg.slam.merge_anchor else (1, 1),
                         cfg.grid.lo_dtype),
        merge_fail=jnp.zeros((n,), jnp.int32),
        merge_yaw_rate=jnp.zeros((n,), jnp.float32),
        merge_dist_mark=jnp.zeros((n,), jnp.float32),
        # initial RAW reported positions (est = home at t0, plus the
        # separation offset) so the tracker's first step sees a real
        # delta; a zero-init (checkpoint migration, live server) is
        # caught by the teleport guard instead
        frame=frame_init(n, px=params.home_x + params.x_offset,
                         py=params.home_y))
    state = SimState(
        t=jnp.zeros(()), step=jnp.zeros((), jnp.int32), key=key,
        pose_true=pose_true,
        odom=odom_init(x0, y0, params.yaw0),
        ekf=ekf0,
        nav=navm.nav_init(n),
        total_dist=jnp.zeros((n,)),
        v2v_total=jnp.zeros((n,), jnp.int32),
        srv=srv)
    # force every leaf onto its own buffer: JAX deduplicates identical
    # constants (all the zeros above), and a donating step (the default,
    # donate=True) rejects the same buffer appearing twice in Execute()
    return jax.tree.map(lambda x: jnp.array(x, copy=True), state)


def _ingest_batched(srv: MapState, est_x, est_y, est_yaw, dist4, lm_types,
                    alive, t, step, cfg: SwarmConfig, params: AgentParams,
                    enable_targets: bool, scan_dist=None,
                    merge_win_box=None, room_boxes=None,
                    total_dist=None, yaw_quant_resid=None):
    """One step's N packets into the mapping server, fully batched.

    Reproduces dual_bot_mapper.py:814-996 semantics with the step-cadence
    versions of the 2 s / 3 s wall-clock timers (zone every
    round(2/dt) steps etc. — equivalent at the fixed tick rate)."""
    n = cfg.n_agents
    sens = cfg.sensors

    # separation offset + accumulated SLAM drift correction (:851-857)
    # + accumulated scan-merge correction (slam/livemerge.py)
    merge_dx, merge_dy, merge_dyaw = srv.merge_dx, srv.merge_dy, \
        srv.merge_dyaw
    frame = srv.frame
    gate_yaw = est_yaw
    if cfg.slam.merge_frame_gain > 0.0:
        # continuous frame-tracked velocity correction (every step):
        # de-rotate + re-scale this step's RAW reported delta by the
        # per-agent estimates before any matching happens; theta itself
        # advances by the learned per-meter rate (slam/livemerge.py
        # FrameState docs)
        from swarm_tpu.slam.livemerge import (
            frame_add, frame_advance, frame_theta_q)
        adx, ady, fd = frame_advance(
            frame, est_x + params.x_offset, est_y, alive, cfg)
        merge_dx = merge_dx + adx
        merge_dy = merge_dy + ady
        frame = frame_add(frame, fd)
    rx = est_x + params.x_offset + srv.closure.drift_dx + merge_dx
    ry = est_y + srv.closure.drift_dy + merge_dy
    ryaw = est_yaw + merge_dyaw
    if cfg.slam.merge_frame_gain > 0.0:
        # scans project at the de-rotated yaw: the frame rotation the
        # tracker estimates from positions IS the yaw-estimate error
        # (drift_integrate moves along the biased yaw). De-rotation is
        # QUANTIZED (frame_theta_q docs).
        # turn gate signal: the REPORTED quantized yaw only. Folding the
        # de-rotation quantum in gated a fast-drifting agent's own
        # corrective innovations (quantum flips every ~10 events at
        # rail rate) — measured runaway: theta 0.55->3.2 while true e
        # reached 2.0. A quantum flip's match-bias step (~0.1 rad x
        # scan centroid ~ 0.15 m) is tolerable accumulation noise.
        ryaw = ryaw - frame_theta_q(frame.theta, cfg)
        gate_yaw = est_yaw
    if cfg.slam.merge_bias_alpha > 0.0 and total_dist is not None:
        from swarm_tpu.slam.livemerge import merge_bias_ff
        ryaw = ryaw + merge_bias_ff(srv.merge_yaw_rate,
                                    srv.merge_dist_mark, total_dist, cfg)

    # continuous map merge at cadence (reference merger runs on every
    # incoming submap, map_merger.py:35-62): match this step's scan
    # against the map as of the PREVIOUS step, damp-accumulate the
    # correction, and raster this step at the corrected pose — the
    # insertion is the merge.
    merge_yaw_rate, merge_dist_mark = srv.merge_yaw_rate, \
        srv.merge_dist_mark
    n_merges = jnp.zeros((), jnp.int32)
    merge_fit = jnp.zeros((), jnp.float32)
    merge_ok_agent = jnp.zeros((n,), bool)
    merge_fit_agent = jnp.zeros((n,), jnp.float32)
    merge_fail = srv.merge_fail
    if cfg.engine.merge_every > 0 and scan_dist is not None and \
            not cfg.engine.parity_mode:
        # (parity mode has no log-odds accumulator to match against, and
        # pose corrections would break reference bit-parity by design)
        from swarm_tpu.slam.livemerge import (
            merge_fail_update, merge_increments, merge_zero,
            scan_merge_recover)
        do_merge = (step % cfg.engine.merge_every) == \
            (cfg.engine.merge_every - 1)
        def run_merge(_):
            if cfg.slam.merge_anchor:
                # drift-stable matching target: frozen first evidence
                # where anchored, live map elsewhere (SlamConfig
                # .merge_anchor). Built INSIDE the cond branch so the
                # full-grid select costs nothing on non-merge steps.
                match_map = jnp.where(jnp.abs(srv.anchor) >= 0.5,
                                      srv.anchor, srv.logodds)
            else:
                match_map = srv.logodds
            return scan_merge_recover(
                match_map, rx, ry, ryaw, scan_dist, alive, cfg,
                event=step // cfg.engine.merge_every, n_global=n,
                fail_count=srv.merge_fail, win_bounds=merge_win_box)

        m, att, rec = jax.lax.cond(
            do_merge, run_merge,
            lambda _: (merge_zero(n), jnp.zeros((n,), bool),
                       jnp.zeros((n,), bool)), None)
        upd = m.ok & alive
        # FULL correction to THIS step's raster pose (the scan's evidence
        # is inserted aligned — map_merger.py:87-127's re-rasterisation;
        # clamping here would insert residually-offset evidence whose
        # ghost walls self-confirm on the next match: measured, a 0.34 m
        # slip then stalls at ~0.26 m instead of recovering). Only the
        # PERSISTENT increment is clamped — one bad match may pollute a
        # single scan insert but cannot move the agent's frame more than
        # merge_max_step_m (recover clamps when escalated); the next good
        # match restores it.
        fdx, fdy, fdth, inc_dx, inc_dy, inc_dth = merge_increments(
            m, upd, rec, cfg)
        if cfg.slam.merge_frame_gain > 0.0:
            # stationarity damping (SlamConfig.merge_frame_still_m): a
            # parked agent re-matching the same scan carries near-zero
            # new information, and repeated false matches ratchet
            still = frame.ax * frame.ax + frame.ay * frame.ay < \
                cfg.slam.merge_frame_still_m ** 2
            sdamp = jnp.where(still, cfg.slam.merge_frame_still_damp,
                              1.0)
            inc_dx = inc_dx * sdamp
            inc_dy = inc_dy * sdamp
            inc_dth = inc_dth * sdamp
        rx = rx + fdx
        ry = ry + fdy
        ryaw = ryaw + fdth
        merge_dx = merge_dx + inc_dx
        merge_dy = merge_dy + inc_dy
        merge_dyaw = merge_dyaw + inc_dth
        if cfg.slam.merge_bias_alpha > 0.0 and total_dist is not None:
            from swarm_tpu.slam.livemerge import merge_bias_update
            fold, rate_d, mark_d = merge_bias_update(
                srv.merge_yaw_rate, srv.merge_dist_mark, total_dist, m,
                upd, cfg, quant_resid=yaw_quant_resid)
            merge_dyaw = merge_dyaw + fold
            merge_yaw_rate = merge_yaw_rate + rate_d
            merge_dist_mark = merge_dist_mark + mark_d
        merge_fail = merge_fail_update(srv.merge_fail, m, att, rec,
                                       alive, cfg)
        if cfg.slam.merge_frame_gain > 0.0:
            from swarm_tpu.slam.livemerge import frame_add, frame_innovate
            frame = frame_add(frame, frame_innovate(
                frame, gate_yaw, m, upd, inc_dx, inc_dy, cfg,
                recovered=rec))
        n_merges = jnp.sum(upd.astype(jnp.int32))
        merge_fit = jnp.sum(jnp.where(upd, m.fitness, 0.0)) / \
            jnp.maximum(n_merges, 1).astype(jnp.float32)
        # the LOGGED fix stream (merge_ok -> offline calibration unary
        # observations) thresholds the raw peak gap with its OWN margin
        # (merge_distinct_log_margin, default 0 = log all verified
        # events): the tracker's 0.05 margin passes ~0.1% of events at
        # swarm density, starving the offline robust calibration whose
        # IRLS absorbs the false fixes. The applied increments above
        # keep plain `upd` (bounded + recoverable by design).
        if cfg.slam.merge_distinct_log_margin > 0.0:
            merge_ok_agent = upd & (m.distinct_gap >=
                                    cfg.slam.merge_distinct_log_margin)
        else:
            merge_ok_agent = upd
        merge_fit_agent = jnp.where(upd, m.fitness, 0.0)

    last_packet_t = jnp.where(alive, t, srv.last_packet_t)
    pkt_counts = srv.pkt_counts + alive.astype(jnp.int32)

    # 4-ray world projection with the trust filter (:881-904)
    angles = ryaw[:, None] + jnp.asarray(sens.angles, rx.dtype)[None, :]
    hit_valid = (dist4 > sens.min_range) & (dist4 <= sens.max_range)
    rng = jnp.where(hit_valid, dist4, sens.max_range)
    hx = rx[:, None] + rng * jnp.cos(angles)
    hy = ry[:, None] + rng * jnp.sin(angles)
    def line_rays():
        rays = RayBatch(
            ox=jnp.repeat(rx, 4), oy=jnp.repeat(ry, 4),
            hx=hx.reshape(-1), hy=hy.reshape(-1),
            hit_valid=hit_valid.reshape(-1),
            active=jnp.repeat(alive, 4))
        if scan_dist is None:
            return rays
        # servo-sweep beams projected from the reported pose, the way the
        # bridge maps LaserScan against /agent_N/odom (udp_bridge.py:123-138)
        from swarm_tpu.models.scan import scan_angles
        r_scan = scan_dist.shape[-1]
        sa = ryaw[:, None] + scan_angles(r_scan, rx.dtype)[None, :]
        sv = (scan_dist > sens.min_range) & (scan_dist <= sens.max_range)
        sr = jnp.where(sv, scan_dist, sens.max_range)
        shx = rx[:, None] + sr * jnp.cos(sa)
        shy = ry[:, None] + sr * jnp.sin(sa)
        return RayBatch(
            ox=jnp.concatenate([rays.ox, jnp.repeat(rx, r_scan)]),
            oy=jnp.concatenate([rays.oy, jnp.repeat(ry, r_scan)]),
            hx=jnp.concatenate([rays.hx, shx.reshape(-1)]),
            hy=jnp.concatenate([rays.hy, shy.reshape(-1)]),
            hit_valid=jnp.concatenate([rays.hit_valid, sv.reshape(-1)]),
            active=jnp.concatenate([rays.active, jnp.repeat(alive, r_scan)]))

    if cfg.engine.parity_mode:
        grid, writes = parity_raster(srv.grid, line_rays(), cfg.grid)
        logodds = srv.logodds
        tri = grid
    elif cfg.engine.raster_mode == "off":
        # profiling mode: no mapping at all (isolates the raster cost)
        grid, logodds = srv.grid, srv.logodds
        tri = srv.grid
        writes = jnp.zeros((), jnp.int32)
    elif cfg.engine.raster_mode == "beam":
        from swarm_tpu.ops.beam_raster import (
            BeamSpec, beam_raster_reference, beams_from_4way,
            beams_from_scan)
        axy = jnp.stack([rx, ry], axis=-1)
        logodds = srv.logodds
        writes = jnp.zeros((), jnp.int32)
        # evidence reach in cells: ties the kernel window sizes /
        # dense-fan shortcut to the ACTUAL sensor range
        from swarm_tpu.ops.beam_raster import reach_cells
        reach = reach_cells(cfg)
        specs_and_beams = []
        if cfg.engine.raster_4way or scan_dist is None:
            specs_and_beams.append(
                (BeamSpec.four_way(),
                 beams_from_4way(dist4, sens.max_range, sens.min_range)))
        if scan_dist is not None:
            specs_and_beams.append(
                (BeamSpec.scan(scan_dist.shape[-1]),
                 beams_from_scan(scan_dist, sens.max_range, sens.min_range)))
        for spec_b, (db, tb) in specs_and_beams:
            if cfg.engine.fast_raster:
                # fast path: order-free counts raster of the free space
                # (and the endpoint ring with kernel_endpoints), clamped
                # once per fan; otherwise EXACT endpoint hits via the
                # sparse scatter (ops/beam_raster.py rationale)
                from swarm_tpu.ops.beam_raster import endpoint_rays
                from swarm_tpu.ops.fast_raster import free_raster_fast
                from swarm_tpu.ops.raster import logodds_delta
                n_groups = (spec_b.n_beams if cfg.engine.beam_groups <= 0
                            else min(cfg.engine.beam_groups,
                                     spec_b.n_beams))
                logodds, w_cnt = free_raster_fast(
                    logodds, axy, ryaw, db, alive, spec_b, cfg.grid,
                    n_groups=n_groups,
                    trusted=(tb if cfg.engine.kernel_endpoints else None),
                    reach=reach, tail_weight=cfg.engine.beam_tail_weight,
                    pack8=cfg.engine.beam_pack8)
                if cfg.engine.kernel_endpoints:
                    # endpoint-ring cells are inside the painted counter
                    w_ep = jnp.zeros((), jnp.int32)
                elif cfg.engine.endpoint_hits:
                    ep_delta, w_ep = logodds_delta(
                        endpoint_rays(axy, ryaw, db, tb, alive, spec_b),
                        cfg.grid, k_max=1)
                    logodds = jnp.clip(
                        logodds.astype(jnp.float32) + ep_delta,
                        -cfg.grid.logodds_clamp,
                        cfg.grid.logodds_clamp).astype(logodds.dtype)
                else:
                    w_ep = jnp.zeros((), jnp.int32)
                # painted counter: the crossing-count-weighted cells the
                # raster actually painted. Per-agent counts rounded to
                # int32 BEFORE summing so the per-step total stays exact
                # at swarm scale (a f32 sum drifts past 2^24 updates).
                w_free = jnp.sum(jnp.round(w_cnt).astype(jnp.int32))
                writes = writes + w_free + w_ep.astype(jnp.int32)
            else:
                db = jnp.where(alive[:, None], db, 0.0)
                logodds, w = beam_raster_reference(logodds, axy, ryaw, db,
                                                   tb & alive[:, None],
                                                   spec_b, cfg.grid,
                                                   reach=reach)
                writes = writes + w.astype(jnp.int32)  # exact per-beam tier
        grid = srv.grid
        tri = tri_state_view(logodds, cfg.grid)
    else:
        logodds, writes = logodds_raster(srv.logodds, line_rays(), cfg.grid)
        grid = srv.grid
        tri = tri_state_view(logodds, cfg.grid)

    # territory AABBs fold the path point + valid hits (:930-940 running
    # form); row-structured — one row per agent, no scatter
    agents = jnp.arange(n, dtype=jnp.int32)
    zone = zone_observe_rows(
        srv.zone,
        jnp.concatenate([rx[:, None], hx], axis=1),
        jnp.concatenate([ry[:, None], hy], axis=1),
        jnp.concatenate([alive[:, None], hit_valid & alive[:, None]],
                        axis=1))

    # loop closure (:907-919)
    if cfg.engine.parity_mode:
        def one(cl, pkt):
            px, py, pa, plm, pv = pkt
            cl, closed, _, _ = closure_add_pose(cl, px, py, pa, plm,
                                                cfg.slam, valid=pv)
            return cl, closed
        closure, closed = jax.lax.scan(
            one, srv.closure, (rx, ry, agents, lm_types, alive))
    else:
        closure, closed, _, _ = closure_add_poses_batch(
            srv.closure, rx, ry, agents, lm_types, cfg.slam, valid=alive,
            yaws=ryaw, scans=scan_dist, grid=cfg.grid, sens=sens)

    online = heartbeat_update(last_packet_t, t, cfg.coord.heartbeat_timeout_s)
    agent_xy = jnp.stack([rx, ry], axis=-1)

    # zone snapshot cadence (2 s, :921-945)
    dt = cfg.nav.drive_tick_s + cfg.nav.settle_tick_s
    zone_every = max(1, round(cfg.coord.zone_interval_s / dt))
    do_zone = (step % zone_every) == 0
    boxes, active = zones_for_agents(zone, agent_xy, online)
    zone_boxes = jnp.where(do_zone, boxes, srv.zone_boxes)
    zone_active = jnp.where(do_zone, active, srv.zone_active)

    # frontier cadence (3 s, :947-996)
    target_every = max(1, round(cfg.coord.target_interval_s / dt))
    do_target = (step % target_every) == 0

    def recompute(_):
        ffn = (frontier_clusters if cfg.grid.size <= 512
               else frontier_targets_coarse)
        # tri-state view built INSIDE the branch: as a cond operand it
        # would be a full-grid pass EVERY step (NOTES r3 gotcha), not
        # just at the 3 s cadence
        tri_f = tri if cfg.engine.parity_mode or \
            cfg.engine.raster_mode == "off" else \
            tri_state_view(logodds, cfg.grid)
        cents, _, cnt = ffn(tri_f, cfg.grid, cfg.coord)
        if enable_targets:
            afn = (greedy_assign_rooms
                   if room_boxes is not None and
                   n >= cfg.coord.assign_rooms_min_agents
                   else greedy_assign)
            tg, has = afn(agent_xy, online, cents, cnt, cfg.coord,
                          room_boxes=room_boxes)
        else:
            tg = jnp.zeros((n, 2), jnp.float32)
            has = jnp.zeros((n,), bool)
        return cents, cnt, tg, has

    def keep(_):
        return (srv.frontier_centroids, srv.n_frontiers,
                jnp.zeros((n, 2), jnp.float32), jnp.zeros((n,), bool))

    if cfg.engine.compute_frontiers:
        cents, n_fr, new_targets, new_has_target = jax.lax.cond(
            do_target, recompute, keep, None)
    else:
        cents, n_fr, new_targets, new_has_target = keep(None)

    anchor = srv.anchor
    if cfg.slam.merge_anchor and cfg.engine.merge_every > 0 and \
            not cfg.engine.parity_mode:
        # freeze newly confident cells at merge cadence — their CURRENT
        # evidence becomes the permanent matching target (cond-gated:
        # the full-grid pass runs only on merge steps)
        do_anch = (step % cfg.engine.merge_every) == \
            (cfg.engine.merge_every - 1)
        if cfg.slam.merge_anchor_freeze_steps > 0:
            do_anch = do_anch & (
                step < cfg.slam.merge_anchor_freeze_steps)
        anchor = jax.lax.cond(
            do_anch,
            lambda _: jnp.where(
                (jnp.abs(srv.anchor) < 0.5) &
                (jnp.abs(logodds) >= cfg.slam.merge_anchor_thresh),
                logodds, srv.anchor),
            lambda _: srv.anchor, None)

    new_srv = MapState(
        grid=grid, logodds=logodds, closure=closure, zone=zone,
        last_packet_t=last_packet_t, pkt_counts=pkt_counts,
        zone_boxes=zone_boxes, zone_active=zone_active,
        frontier_centroids=cents, n_frontiers=n_fr,
        total_writes=writes_accumulate(srv.total_writes,
                                       writes.astype(jnp.int32)),
        merge_dx=merge_dx, merge_dy=merge_dy, merge_dyaw=merge_dyaw,
        anchor=anchor, merge_fail=merge_fail,
        merge_yaw_rate=merge_yaw_rate, merge_dist_mark=merge_dist_mark,
        frame=frame)
    return new_srv, closed, online, new_targets, new_has_target, \
        (rx, ry, ryaw, hx, hy, hit_valid), \
        (n_merges, merge_fit, merge_ok_agent, merge_fit_agent)


def sim_step(state: SimState, cfg: SwarmConfig, walls, params: AgentParams,
             faults: Optional[FaultSchedule] = None,
             enable_targets: bool = False,
             walls_grouped=None, room_of_agent=None):
    """Advance the whole swarm world by one tick. Pure; jit over (cfg, walls
    static by closure). Returns (new_state, StepMetrics).

    walls_grouped [G, S_g, 4] + room_of_agent [N]: optional culled-casting
    geometry — each agent intersects only its own room's segments (exact
    for closed rooms; O(S_g) instead of O(all walls) per ray)."""
    n = cfg.n_agents
    navc = cfg.nav
    dt = navc.drive_tick_s + navc.settle_tick_s
    if faults is None:
        faults = no_faults()
    alive = alive_mask(faults, n, state.t)

    # per-agent wall sets: the whole world, or just the agent's room
    if walls_grouped is not None:
        walls_agent = walls_grouped[room_of_agent]       # [N, S_g, 4]
    else:
        walls_agent = jnp.broadcast_to(
            walls, (n,) + walls.shape)

    # Static per-agent merge-window bounds — the SAME placement rule the
    # sharded builder applies (parallel.sharded.make_sharded_sim_step):
    # the window start is clamped into the agent's TILE-SNAPPED room box
    # (parallel.sharded.merge_window_box — agent-centered placement, the
    # clamp a near-no-op), so fused and sharded engines stay
    # bit-comparable with rooms + merge ON (see slam.livemerge.scan_merge
    # win_bounds). Trace-free numpy on the closure-constant room
    # geometry; skipped if the geometry is traced.
    merge_win_box = None
    if (cfg.engine.merge_every > 0 and walls_grouped is not None
            and room_of_agent is not None
            and not isinstance(walls_grouped, jax.core.Tracer)
            and not isinstance(room_of_agent, jax.core.Tracer)):
        from swarm_tpu.parallel.sharded import merge_window_box
        merge_win_box = tuple(
            jnp.asarray(a, jnp.int32)
            for a in merge_window_box(walls_grouped, room_of_agent, cfg))

    # Static per-agent room AABBs restrict frontier-target assignment to
    # the agent's own (reachable) room — GO_TO_TARGET drives straight at
    # its target (ino:556-605, no path planner), so a frontier in another
    # closed room is unreachable by construction.
    room_boxes = None
    if (enable_targets and walls_grouped is not None
            and room_of_agent is not None):
        if (isinstance(walls_grouped, jax.core.Tracer)
                or isinstance(room_of_agent, jax.core.Tracer)):
            # Falling back to UNRESTRICTED assignment here would be the
            # exact mode measured to crater coverage (0.40 vs 0.59,
            # tools/bench_coverage.py) — with no signal. Refuse instead:
            # callers must close over the room geometry as constants
            # (every current call site does).
            raise ValueError(
                "enable_targets with traced walls_grouped/room_of_agent: "
                "the room-reachability restriction needs the geometry as "
                "trace-time constants (close over numpy arrays, don't "
                "pass them as jit arguments)")
        from swarm_tpu.geom.world import agent_room_boxes
        # MUST stay host numpy: inside a jit/scan trace jnp.asarray
        # stages the constant as a tracer, and greedy_assign_rooms
        # needs the CONCRETE boxes for its host-side room grouping
        # (measured: bench.py --frontiers at 1024 agents — above
        # assign_rooms_min_agents — raised TracerArrayConversionError;
        # the 16-agent CI path uses plain greedy_assign and never hit it)
        room_boxes = agent_room_boxes(walls_grouped, room_of_agent)

    # Per-agent counter-based RNG streams: fold the step key by GLOBAL agent
    # id, so results are identical under any agent sharding (SURVEY §7
    # "hard parts" — RNG strategy for bit-comparability).
    key, k_step = jax.random.split(state.key)
    agent_ids = jnp.arange(n, dtype=jnp.uint32)
    k_agents = jax.vmap(lambda i: jax.random.fold_in(k_step, i))(agent_ids)
    k_sense = jax.vmap(lambda k: jax.random.fold_in(k, 0))(k_agents)
    k_drift = jax.vmap(lambda k: jax.random.fold_in(k, 1))(k_agents)

    # 1. sense from TRUE pose (noise model: generate_fake_dual_session.py:100-108)
    dist4 = jax.vmap(lambda k, p, w: sense_4way(k, p, w, cfg.sensors))(
        k_sense, state.pose_true, walls_agent)
    scan_dist = None
    if cfg.engine.scan_rays > 0:
        from swarm_tpu.models.scan import sense_scan
        k_scan = jax.vmap(lambda k: jax.random.fold_in(k, 2))(k_agents)
        scan_dist = jax.vmap(
            lambda k, p, w: sense_scan(k, p, w, cfg.engine.scan_rays,
                                       cfg.sensors))(
            k_scan, state.pose_true, walls_agent)

    # 2. landmark signature (sim thresholds, :113-129)
    lm = detect_landmark_sim(dist4[:, 0], dist4[:, 1], dist4[:, 3],
                             navc.lm_sim_close_m, cfg.sensors.max_range)
    lm = jnp.where(alive, lm, 0)

    # 3. telemetry fields from the DRIFTED estimate (pre-motion, ino:284-313)
    odom, encoder_total = encoder_emit(state.odom, cfg.noise)
    yaw_q = jnp.radians(quantize_yaw_deg(odom.yaw_est,
                                         cfg.noise.yaw_quantize_deg))

    # 4. server ingest (batched packets)
    srv, closed, online, new_targets, new_has, proj, merge_m = \
        _ingest_batched(
            state.srv, odom.x_est, odom.y_est, yaw_q, dist4, lm, alive,
            state.t, state.step, cfg, params, enable_targets,
            scan_dist=scan_dist, merge_win_box=merge_win_box,
            room_boxes=room_boxes, total_dist=state.total_dist,
            yaw_quant_resid=wrap_pi(yaw_q - odom.yaw_est))
    rx_t, ry_t, ryaw_t, hx_t, hy_t, hv_t = proj
    n_merges, merge_fit, merge_ok_a, merge_fit_a = merge_m
    # raw-estimate telemetry snapshot (PRE-motion, same timing as srv_x —
    # `odom` is rebound post-motion in stage 7 below)
    est_x_t = odom.x_est + params.x_offset
    est_y_t = odom.y_est
    est_yaw_t = odom.yaw_est

    # TARG delivery (ino:126-139, enabled behind the flag)
    nav = state.nav
    if enable_targets:
        # targets arrive in server frame; agents navigate in odometry frame
        tgt_local = new_targets - jnp.stack(
            [params.x_offset + srv.closure.drift_dx + srv.merge_dx,
             srv.closure.drift_dy + srv.merge_dy], axis=-1)
        nav = navm.assign_target(nav, tgt_local, new_has & alive)

    # 5. navigate (est pose drives the FSM, the firmware convention)
    est_pose = jnp.stack([odom.x_est, odom.y_est, odom.yaw_est], axis=-1)
    zone_local = srv.zone_boxes - jnp.stack(
        [params.x_offset, jnp.zeros((n,)),
         params.x_offset, jnp.zeros((n,))], axis=-1)
    nav, cmd = navm.nav_step(nav, navm.NavParams(
        wall_side=params.wall_side, motor_pwm=params.motor_pwm,
        return_style=params.return_style,
        home_x=params.home_x, home_y=params.home_y),
        dist4, est_pose, state.total_dist, zone_local,
        srv.zone_active, dt, navc)

    drive = jnp.where(alive, cmd.drive_m, 0.0)
    turn = jnp.where(alive, cmd.turn_cmd_rad, 0.0)
    steer = jnp.where(alive, cmd.steer_rad, 0.0)

    # 6. physics: discrete turns rotate the heading; P-control steering is a
    #    displacement ARC during the burst (the firmware's symmetric wheel
    #    differential straightens out by burst end, so the persistent
    #    heading changes only via turn() — the same convention that makes
    #    commanded-yaw odometry viable, ino:704-707). Wall-collision clamp:
    #    the sim world's walls are solid.
    yaw_true = wrap_pi(state.pose_true[:, 2] + turn)
    move_dir = yaw_true + steer
    from swarm_tpu.geom.world import cast_rays
    clear = jax.vmap(lambda p, a, w: cast_rays(p, a, w))(
        state.pose_true[:, :2], move_dir, walls_agent)
    drive = jnp.minimum(drive, jnp.maximum(clear - 0.08, 0.0))
    x_true = state.pose_true[:, 0] + drive * jnp.cos(move_dir)
    y_true = state.pose_true[:, 1] + drive * jnp.sin(move_dir)
    pose_true = jnp.stack([x_true, y_true, yaw_true], axis=-1)
    total_dist = state.total_dist + drive

    # 7. odometry drift integrate (est pose; yaw changes only via turns —
    #    the firmware's commanded-yaw convention, ino:704-707)
    odom = jax.vmap(
        lambda k, o, d, r, ts, yb: drift_integrate(k, o, d, r, ts, yb,
                                                   cfg.noise))(
        k_drift, odom, drive, turn, params.trans_scale, params.yaw_bias_per_m)

    #    EKF predict/update alongside (ekf.cpp:26-92), vmapped; the gyro
    #    sees net rotation = the turns (the steering arc integrates to ~0)
    t_new = state.t + dt
    omega = turn / dt
    v = drive / dt
    ekf = ekf_step_batch(state.ekf, omega, v, jnp.full((n,), t_new), cfg.ekf)

    # v1 firmware personality: EKF yaw drives robot_yaw each loop
    # (AgentFirmware.ino.ino:429-436) — close the loop for flagged agents;
    # Bot1/Bot2 agents keep the commanded-yaw odometry (ino:704-707).
    odom = odom._replace(yaw_est=jnp.where(
        params.ekf_yaw, wrap_pi(ekf.x[:, 2]), odom.yaw_est))

    corr_x = odom.x_est + params.x_offset + srv.closure.drift_dx + \
        srv.merge_dx
    corr_y = odom.y_est + srv.closure.drift_dy + srv.merge_dy
    true_x = pose_true[:, 0] + params.x_offset
    err = jnp.sqrt((corr_x - true_x) ** 2 + (corr_y - pose_true[:, 1]) ** 2)

    # v2v: both reference semantics, selected per agent (AgentParams
    # .v2v_count): the sim generator's nearest-other-live-agent distance
    # in cm (generate_fake_dual_session.py:466), or the firmware's
    # cumulative received-broadcast counter (AgentFirmware_Bot1.ino:
    # 211-215; transmitters broadcast at 20 Hz, SensorNode.ino:37-70)
    txy = state.pose_true[:, :2] + jnp.stack(
        [params.x_offset, jnp.zeros((n,))], axis=-1)
    v2v_cm, v2v_n = v2v_stats(txy, alive, cfg.sensors.v2v_range_m)
    rx_per_tick = jnp.round(
        v2v_n.astype(jnp.float32) * cfg.sensors.v2v_broadcast_hz * dt
    ).astype(jnp.int32)
    v2v_total = state.v2v_total + jnp.where(alive, rx_per_tick, 0)
    v2v = jnp.where(params.v2v_count, v2v_total, v2v_cm)

    new_state = SimState(
        t=t_new, step=state.step + 1, key=key,
        pose_true=pose_true, odom=odom, ekf=ekf, nav=nav,
        total_dist=total_dist, v2v_total=v2v_total, srv=srv)

    metrics = StepMetrics(
        writes=writes_delta(srv.total_writes, state.srv.total_writes),
        closures=jnp.sum(closed.astype(jnp.int32)),
        online=jnp.sum(online.astype(jnp.int32)),
        n_frontiers=srv.n_frontiers,
        pose_err=jnp.mean(jnp.where(alive, err, 0.0)),
        mission_done=jnp.sum(nav.mission_complete.astype(jnp.int32)),
        merges=n_merges,
        merge_fitness=merge_fit,
        band_escapes=jnp.zeros((), jnp.int32),
        t=state.t,
        srv_x=rx_t, srv_y=ry_t, srv_yaw=ryaw_t, yaw_q=yaw_q,
        est_x=est_x_t, est_y=est_y_t, est_yaw=est_yaw_t,
        merge_ok=merge_ok_a, merge_fit=merge_fit_a,
        encoder=encoder_total, v2v=v2v,
        dist_m=dist4, landmark=lm,
        hits=jnp.stack([hx_t, hy_t], axis=-1),
        hit_valid=hv_t & alive[:, None],
        alive=alive)
    return new_state, metrics


def sim_rollout(state: SimState, n_steps: int, cfg: SwarmConfig, walls,
                params: AgentParams, faults: Optional[FaultSchedule] = None,
                enable_targets: bool = False,
                walls_grouped=None, room_of_agent=None):
    """n_steps of the fused step under lax.scan.
    Returns (final state, stacked StepMetrics)."""
    def body(s, _):
        return sim_step(s, cfg, walls, params, faults, enable_targets,
                        walls_grouped=walls_grouped,
                        room_of_agent=room_of_agent)
    return jax.lax.scan(body, state, None, length=n_steps)


def make_sim_step(cfg: SwarmConfig, walls, params: AgentParams,
                  faults: Optional[FaultSchedule] = None,
                  enable_targets: bool = False, donate: bool = True,
                  walls_grouped=None, room_of_agent=None):
    """A jitted single-argument step closure — the deployable engine."""
    f = functools.partial(sim_step, cfg=cfg, walls=jnp.asarray(walls),
                          params=params, faults=faults,
                          enable_targets=enable_targets,
                          walls_grouped=walls_grouped,
                          room_of_agent=room_of_agent)
    return jax.jit(f, donate_argnums=(0,) if donate else ())

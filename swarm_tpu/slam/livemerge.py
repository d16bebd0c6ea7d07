"""Continuous in-engine map merging — scan-to-map realignment at a cadence.

The reference's merger is a *continuously running* node: every incoming
per-agent submap is re-aligned against the global map with ICP and folded
in if fitness >= 0.6 (server_nodes/map_merger.py:35-62). The fused engine's
equivalent: at a step cadence, each agent's CURRENT scan is correlatively
matched (slam/scanmatch.match_scan_window — rotation x translation
hypotheses scored as one batched matmul) against a window of the global map as of
the previous step, and the resulting rigid correction is (a) accumulated
into a per-agent drift correction applied to all subsequent ingest (like
the loop-closure corrections, dual_bot_mapper.py:854-857) and (b) applied
to THIS step's raster, so the scan's evidence is inserted at the aligned
pose — the insertion *is* the merge (map_merger.py:87-127's
re-rasterisation, fused with the mapping pass).

Everything is batched over agents and fixed-shape; the whole stage lives
inside a `lax.cond` on the merge cadence, so off-cadence steps pay nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from swarm_tpu.config import SwarmConfig
from swarm_tpu.slam.scanmatch import WindowMatch, match_scan_window


def merge_window_side(cfg: SwarmConfig) -> int:
    """Full side length of the cropped global-map window, in cells."""
    return cfg.slam.merge_window_cells + 2 * cfg.slam.merge_search_cells


def scan_merge(logodds, rx, ry, ryaw, scan_dist, alive,
               cfg: SwarmConfig, band_row0: int | None = None,
               band_col0: int | None = None,
               win_bounds=None, n_theta: int | None = None,
               theta_range: float | None = None,
               theta_prior_scale: float | None = None) -> WindowMatch:
    """Batched scan-to-map matching of every agent's current servo sweep
    against `logodds` (the global map BEFORE this step's raster — a scan
    must never match its own evidence).

    rx, ry, ryaw: [N] reported pose (server frame, all corrections already
      applied). scan_dist: [N, R] sweep ranges. Returns per-agent residual
      corrections ([N] leaves); `ok` gates on the reference's 0.6 fitness
      (map_merger.py:52-56) plus a minimum-trusted-points floor.

    band_row0: row offset of `logodds` inside the full grid when the grid
      is row-band sharded (parallel.sharded grid_sharding="rows"); the
      window then crops in band-local rows. Band containment of agent
      evidence (agent_evidence_rows) keeps all relevant mass inside the
      band, so edge clamping only recentres the window, never loses it.
    band_col0: the column analogue, for the 2-D tile decomposition
      (grid_sharding="tiles" — `logodds` is then the device's core tile).
    win_bounds: optional (rmin, rmax, cmin, cmax) per-agent static
      window bounds, [N] int32 each, in GLOBAL grid cells (the agent's
      unpadded room box, parallel.sharded.agent_evidence_box with
      drift_margin_m=0). When given, the window is clamped into this box
      instead of the local array edges — making window PLACEMENT
      decomposition-invariant (the sharded builders statically prove the
      box sits inside every band/tile that clamps against it). Without
      it, a band-sharded crop near a band edge recentres the window a
      few rows off the replicated crop and the corrections diverge.

    All placement arithmetic happens in GLOBAL integer cells; the band/
      tile offset enters only through the integer slice start and the
      r0/c0 bounds of the capacity clamp (both exact), so every FLOAT
      expression below is structurally identical across decompositions —
      XLA compiles the same fp graph and the matches stay bit-equal
      (measured: the previous band-local float chain `gy - band_row0`
      gave the compiler a structurally different graph whose simplified
      form differed by 1 ulp, silently breaking rows/tiles-vs-replicated
      map equality at the first merge event).
    """
    slam = cfg.slam
    grid = cfg.grid
    sens = cfg.sensors
    inner = slam.merge_window_cells
    search = slam.merge_search_cells
    side = inner + 2 * search
    res = grid.resolution

    from swarm_tpu.models.scan import scan_angles
    r_scan = scan_dist.shape[-1]
    rel = scan_angles(r_scan, rx.dtype)
    valid = ((scan_dist > sens.min_range) & (scan_dist <= sens.max_range)
             & alive[:, None])
    ang = ryaw[:, None] + rel[None, :]
    off_x = scan_dist * jnp.cos(ang)
    off_y = scan_dist * jnp.sin(ang)

    # occupancy mass in [0, 1] (~saturates at 2 endpoint hits)
    mass = jnp.clip(logodds / (2.0 * grid.logodds_hit), 0.0, 1.0)
    n_rows, n_cols = mass.shape

    gx = (rx - grid.origin_x) / res                     # float cell coords
    gy = (ry - grid.origin_y) / res
    r0 = jnp.int32(0 if band_row0 is None else band_row0)
    c0 = jnp.int32(0 if band_col0 is None else band_col0)
    # global placement, clamped to the local array's capacity interval
    sxg = jnp.clip(jnp.floor(gx).astype(jnp.int32) - side // 2,
                   c0, c0 + (n_cols - side))
    syg = jnp.clip(jnp.floor(gy).astype(jnp.int32) - side // 2,
                   r0, r0 + (n_rows - side))
    if win_bounds is not None:
        rmin, rmax, cmin, cmax = win_bounds
        lo_r = jnp.clip(rmin, r0, r0 + (n_rows - side))
        hi_r = jnp.clip(rmax - side, lo_r, r0 + (n_rows - side))
        lo_c = jnp.clip(cmin, c0, c0 + (n_cols - side))
        hi_c = jnp.clip(cmax - side, lo_c, c0 + (n_cols - side))
        syg = jnp.clip(syg, lo_r, hi_r)
        sxg = jnp.clip(sxg, lo_c, hi_c)
    sx = sxg - c0                       # local slice starts (exact int)
    sy = syg - r0

    # Trusted-point floor, capped by the scan density: the absolute 16
    # was tuned for the 181-ray sweep; a wall-follower with a sparse fan
    # (37-61 rays over 181 deg) sees only ~10 in-trust points along a
    # straight wall and would NEVER pass the gate — its drift then runs
    # unbounded (the 5k-step soak's escaping agents). A quarter of the
    # fan keeps the same selectivity across ray counts.
    min_pts = min(slam.merge_min_points, max(6, r_scan // 4))

    def one(sx_i, sy_i, sxg_i, syg_i, gx_i, gy_i, ox, oy, v):
        win = jax.lax.dynamic_slice(
            mass, (sy_i, sx_i), (side, side)).astype(jnp.float32)
        # agent float coords inside the INNER region, from GLOBAL
        # coordinates (decomposition-invariant fp graph); -0.5 aligns the
        # splat's integer-centred cells with the raster's floor() binning
        ax = gx_i - sxg_i - search - 0.5
        ay = gy_i - syg_i - search - 0.5
        return match_scan_window(
            ox, oy, v, win, (ax, ay), inner, search,
            n_theta=(slam.merge_angles if n_theta is None else n_theta),
            theta_range=(slam.merge_angle_range if theta_range is None
                         else theta_range),
            resolution=res,
            inlier_radius_cells=slam.merge_inlier_radius_cells,
            fitness_min=slam.merge_fitness_min,
            min_points=min_pts,
            prior_weight=slam.merge_prior_weight,
            theta_prior_scale=(slam.merge_theta_prior_scale
                               if theta_prior_scale is None
                               else theta_prior_scale),
            distinct_margin=slam.merge_distinct_margin,
            distinct_radius=slam.merge_distinct_radius)

    return jax.vmap(one)(sx, sy, sxg, syg, gx, gy, off_x, off_y, valid)


def chunk_attempt(cfg: SwarmConfig, event, n_global: int, n_loc: int,
                  id0=None):
    """Which local agents does merge event `event` attempt to match?

    Returns (full, lstart, sl, mask): `full` (static bool) — chunking
    disabled, every agent is attempted; otherwise `mask` [n_loc] is the
    attempted set and [lstart, lstart+sl) its local slice. Shared by
    scan_merge_chunked and the recovery fail-counter so the "attempted"
    definition cannot drift between them."""
    c = cfg.slam.merge_chunk
    full = (c <= 0 or c >= n_global or n_global % c != 0 or
            (n_loc < n_global and
             (c % n_loc != 0 if c > n_loc else n_loc % c != 0)))
    if full:
        return True, None, None, jnp.ones((n_loc,), bool)
    k = n_global // c
    g0 = (event % k) * c
    sl = min(c, n_loc)
    base = jnp.zeros((), jnp.int32) if id0 is None else id0
    lstart = jnp.clip(g0 - base, 0, n_loc - sl)
    gids = base + jnp.arange(n_loc, dtype=jnp.int32)
    mask = (gids >= g0) & (gids < g0 + c)
    return False, lstart, sl, mask


def scan_merge_chunked(logodds, rx, ry, ryaw, scan_dist, alive,
                       cfg: SwarmConfig, event, n_global: int, id0=None,
                       band_row0=None, band_col0=None,
                       win_bounds=None, n_theta=None,
                       theta_range=None,
                       theta_prior_scale: float | None = None) -> WindowMatch:
    """Rotating-chunk scan merge: merge event `e` matches only the
    global-agent chunk [(e mod K)*c, ...+c), c = slam.merge_chunk,
    K = n_global/c — mirroring the reference merger's one-submap-at-a-
    time cadence (map_merger.py:35-62) and amortising the match cost at
    swarm scale. Returns a full-local-length WindowMatch with ok=False
    outside the chunk.

    Chunk membership is defined on GLOBAL agent ids (sharded callers
    pass id0 = shard * n_local), so the merged set per step is identical
    across mesh sizes. Falls back to the full-fleet match when c covers
    the fleet or sizes don't divide evenly (small-swarm configs)."""
    n_loc = rx.shape[0]
    full, lstart, sl, mask = chunk_attempt(cfg, event, n_global, n_loc,
                                           id0)
    if full:
        return scan_merge(logodds, rx, ry, ryaw, scan_dist, alive, cfg,
                          band_row0, band_col0, win_bounds,
                          n_theta=n_theta, theta_range=theta_range,
                          theta_prior_scale=theta_prior_scale)

    def sub(a):
        return jax.lax.dynamic_slice_in_dim(a, lstart, sl, 0)

    wb = None if win_bounds is None else tuple(
        sub(b) for b in win_bounds)
    m = scan_merge(logodds, sub(rx), sub(ry), sub(ryaw), sub(scan_dist),
                   sub(alive), cfg, band_row0, band_col0, wb,
                   n_theta=n_theta, theta_range=theta_range,
                   theta_prior_scale=theta_prior_scale)

    def put(v):
        return jax.lax.dynamic_update_slice_in_dim(
            jnp.zeros((n_loc,), v.dtype), v, lstart, 0)

    return WindowMatch(ddx=put(m.ddx), ddy=put(m.ddy),
                       ddtheta=put(m.ddtheta), fitness=put(m.fitness),
                       ok=put(m.ok) & mask,
                       ddtheta_meas=put(m.ddtheta_meas),
                       distinct=put(m.distinct),
                       distinct_gap=put(m.distinct_gap))


def merge_zero(n: int) -> WindowMatch:
    """The no-op result for off-cadence steps (lax.cond partner)."""
    z = jnp.zeros((n,), jnp.float32)
    return WindowMatch(ddx=z, ddy=z, ddtheta=z, fitness=z,
                       ok=jnp.zeros((n,), bool), ddtheta_meas=z,
                       distinct=jnp.zeros((n,), bool),
                       distinct_gap=z)


def scan_merge_recover(match_map, rx, ry, ryaw, scan_dist, alive,
                       cfg: SwarmConfig, event, n_global: int,
                       fail_count, id0=None, band_row0=None,
                       band_col0=None, win_bounds=None):
    """Chunked scan merge with escalating re-acquisition (recover-and-
    continue, the reference's failover philosophy —
    dual_bot_mapper.py:804-812 — applied to the merge matcher).

    Agents whose consecutive-failure counter (`fail_count`, maintained
    by merge_fail_update) has reached slam.merge_recover_after get a
    SECOND match with the wide rotation capture range when the normal
    one rejects them. The wide pass is itself cond-gated on any such
    agent existing, so healthy fleets never pay for it. Same window
    footprint, so sharded containment proofs are unaffected.

    Returns (m, attempted, recovered):
      m          WindowMatch [n_loc] — wide-pass results adopted where
                 the normal pass failed and the wide one verified
      attempted  [n_loc] bool — agents this event tried to match
      recovered  [n_loc] bool — escalated agents whose correction should
                 persist under the wider merge_recover_max_step_* clamps
                 (wide-pass adoptions AND normal matches that rail while
                 escalated)
    """
    n_loc = rx.shape[0]
    slam = cfg.slam
    m = scan_merge_chunked(match_map, rx, ry, ryaw, scan_dist, alive,
                           cfg, event=event, n_global=n_global, id0=id0,
                           band_row0=band_row0, band_col0=band_col0,
                           win_bounds=win_bounds)
    _, _, _, attempted = chunk_attempt(cfg, event, n_global, n_loc, id0)
    recovered = jnp.zeros((n_loc,), bool)
    if slam.merge_recover_after <= 0:
        return m, attempted, recovered

    esc = fail_count >= slam.merge_recover_after
    need = jnp.any(esc & attempted & alive & ~m.ok)

    def wide(_):
        # multi-hypothesis placement: the centre window plus a ring of
        # translation offsets (merge_recover_offset_m) — matching "as
        # if the agent were there" and folding the offset back into the
        # returned correction. Window placement still clamps into
        # win_bounds (the agent's room box), so the sharded containment
        # proofs are unaffected; the effective translation capture
        # grows to offset + merge_search_cells.
        offs = [(0.0, 0.0)]
        r_off = slam.merge_recover_offset_m
        if r_off > 0.0:
            offs += [(r_off, 0.0), (-r_off, 0.0), (0.0, r_off),
                     (0.0, -r_off), (r_off, r_off), (r_off, -r_off),
                     (-r_off, r_off), (-r_off, -r_off)]
        best = None
        for ox, oy in offs:
            mk = scan_merge_chunked(
                match_map, rx + ox, ry + oy, ryaw, scan_dist, alive,
                cfg, event=event, n_global=n_global, id0=id0,
                band_row0=band_row0, band_col0=band_col0,
                win_bounds=win_bounds,
                n_theta=slam.merge_recover_angles,
                theta_range=slam.merge_recover_angle_range,
                theta_prior_scale=slam.merge_recover_theta_prior_scale)
            mk = mk._replace(ddx=mk.ddx + ox, ddy=mk.ddy + oy)
            if best is None:
                best = mk
            else:
                sc_b = jnp.where(best.ok, best.fitness, -1.0)
                sc_k = jnp.where(mk.ok, mk.fitness, -1.0)
                sel = sc_k > sc_b
                best = WindowMatch(*(jnp.where(sel, nk, nb) for nk, nb
                                     in zip(mk, best)))
        return best

    mw = jax.lax.cond(need, wide, lambda _: merge_zero(n_loc), None)
    take = esc & ~m.ok & mw.ok & alive & \
        (mw.fitness >= slam.merge_recover_fit_min)
    rail = m.ok & ((jnp.abs(m.ddx) > slam.merge_max_step_m) |
                   (jnp.abs(m.ddy) > slam.merge_max_step_m) |
                   (jnp.abs(m.ddtheta) > slam.merge_max_step_rad))
    recovered = take | (esc & rail & alive)
    m = WindowMatch(ddx=jnp.where(take, mw.ddx, m.ddx),
                    ddy=jnp.where(take, mw.ddy, m.ddy),
                    ddtheta=jnp.where(take, mw.ddtheta, m.ddtheta),
                    fitness=jnp.where(take, mw.fitness, m.fitness),
                    ok=m.ok | take,
                    ddtheta_meas=jnp.where(take, mw.ddtheta_meas,
                                           m.ddtheta_meas),
                    distinct=jnp.where(take, mw.distinct, m.distinct),
                    distinct_gap=jnp.where(take, mw.distinct_gap,
                                           m.distinct_gap))
    return m, attempted, recovered


def merge_fail_update(fail_count, m: WindowMatch, attempted, recovered,
                      alive, cfg: SwarmConfig):
    """Consecutive-failure counter driving the escalation trigger.

    An attempted live agent's event is BAD when the match was rejected,
    or applied but railing at the persistent clamp without the recovery
    path claiming it — both mean the frame error is outrunning the
    normal capture range. Bad increments; an attempted good event (or a
    recovery) resets; unattempted agents carry their count."""
    slam = cfg.slam
    rail = m.ok & ((jnp.abs(m.ddx) > slam.merge_max_step_m) |
                   (jnp.abs(m.ddy) > slam.merge_max_step_m) |
                   (jnp.abs(m.ddtheta) > slam.merge_max_step_rad))
    bad = ~m.ok | (rail & ~recovered)
    tried = attempted & alive
    return jnp.where(tried,
                     jnp.where(bad & ~recovered, fail_count + 1, 0),
                     fail_count)


def merge_bias_ff(yaw_rate, dist_mark, total_dist, cfg: SwarmConfig):
    """Continuous feed-forward yaw correction accrued since the agent's
    last rate rebase (SlamConfig.merge_bias_alpha): the estimated per-
    meter yaw-rate bias times the distance travelled since the mark.
    Added to the corrected yaw every step — the level state
    (merge_dyaw) stays event-driven. Elementwise [N] (or local-shard
    [n_loc] on gathered leaves), so fused and sharded engines compute
    bit-identical values."""
    if cfg.slam.merge_bias_alpha <= 0.0:
        return jnp.zeros_like(total_dist)
    led = jnp.minimum(total_dist - dist_mark, cfg.slam.merge_bias_ff_max_m)
    return yaw_rate * led


def merge_bias_update(yaw_rate, dist_mark, total_dist, m: WindowMatch,
                      upd, cfg: SwarmConfig, quant_resid=None):
    """Per-agent yaw-rate-bias update at a verified merge event.

    Observation: the RAW-map rotation re-measurement `m.ddtheta_meas`
    (scanmatch.match_scan_window) — NOT the pose-correction `m.ddtheta`,
    which is rotation-blind below ~2 cells of tangential misalignment
    (the dilation plateau + zero-motion prior resolve small rotations
    to "no change"; measured forensics: ddtheta ~= 0 on every verified
    event while the true frame error ramped to 0.3 rad, so the debiased
    residual degenerated to exactly the quantisation sawtooth and the
    rate estimate railed on it).

    The measured residual accumulated over `led` metres (distance since
    the agent's last rebase) observes the REMAINING rate error: under
    feed-forward rate r and true bias b the frame yaw error grows at
    (b + r) rad/m and the matcher measures ddtheta_meas ~=
    -(accumulated error), so rate' = rate + alpha * ddtheta_meas / led
    converges on r = -b (integral action; the level term keeps the
    accumulated part bounded so the quotient tracks the slope).

    quant_resid [N]: the reported-yaw QUANTISATION residual
    (yaw_q - unquantised estimate, wrapped) at this step. The raster
    frame uses the firmware's 15-degree-grid reported yaw, so the
    measurement contains -(quant_resid + drift + corr); the +/-7.5 deg
    residual is piecewise-CONSTANT between turns (NOT zero-mean per
    event — consecutive observations re-measure the same offset) and
    would swamp the ~0.01 rad/window drift signal. It is exactly known
    on the agent (its own odometry minus what it reported — firmware-
    side calibration knowledge, like gyro bias calibration), so the
    update debiases with it.

    Updates apply only where the observation window is meaningful
    (led >= merge_bias_min_dist): near-stationary re-verifications
    divide a noise-sized residual by a tiny distance.

    Returns DELTAS so sharded callers can all-gather them like the
    merge_dx/dy/dyaw increments:
      fold        [N] — accrued feed-forward (rate x led, extrapolation-
                  bounded) + the level step, folded into merge_dyaw at
                  the rebase so the total correction is continuous
                  across the mark reset
      rate_delta  [N] — change to merge_yaw_rate
      mark_delta  [N] — change to merge_dist_mark (= led where rebased)
    """
    slam = cfg.slam
    if slam.merge_bias_alpha <= 0.0:
        z = jnp.zeros_like(yaw_rate)
        return z, z, z
    led = total_dist - dist_mark
    # the ACCRUED feed-forward to fold must mirror merge_bias_ff's
    # extrapolation bound, or the rebase would fold more yaw into the
    # level than was ever applied
    led_ff = jnp.minimum(led, slam.merge_bias_ff_max_m)
    dth = m.ddtheta_meas if quant_resid is None else \
        m.ddtheta_meas + quant_resid
    # PI structure on the integrator plant e' = b + r: the level term
    # (merge_bias_level_damp) cancels the accumulated frame-yaw error,
    # the slow integral (merge_bias_alpha) absorbs its per-meter slope
    # into the feed-forward rate.
    dth_c = jnp.clip(dth, -slam.merge_bias_level_cap,
                     slam.merge_bias_level_cap)
    level = slam.merge_bias_level_damp * dth_c
    # clipped numerator for the rate too: one recovery-scale event
    # (|dth| up to merge_recover_angle_range) must not kick the
    # estimate by more than alpha x cap / min_dist
    rate_obs = dth_c / jnp.maximum(led, slam.merge_bias_min_dist)
    new_rate = jnp.clip(yaw_rate + slam.merge_bias_alpha * rate_obs,
                        -slam.merge_bias_max, slam.merge_bias_max)
    # level: every verified event (a parked agent can still carry frame
    # error from an earlier kick); rate + rebase: only meaningful
    # observation windows
    gate = upd & (led >= slam.merge_bias_min_dist)
    fold = jnp.where(upd, level, 0.0) + \
        jnp.where(gate, yaw_rate * led_ff, 0.0)
    rate_delta = jnp.where(gate, new_rate - yaw_rate, 0.0)
    mark_delta = jnp.where(gate, led, 0.0)
    return fold, rate_delta, mark_delta


class FrameState(NamedTuple):
    """Per-agent online frame-tracker state (SlamConfig.merge_frame_gain;
    one MapState leaf group — all [N] float32).

    The tracker estimates each agent's reported-frame rotation `theta`
    (the yaw-bias drift, generate_fake_dual_session.py:407-444), its
    per-meter growth `rate`, and the velocity scale `scale_dev`
    (s_hat - 1) from position-fix innovations, and de-rotates every
    step's reported velocity with them — drift correction at the SOURCE
    rate, so the event matcher's capture range and persistent clamp
    never bind (the r3 soak's escape mechanism)."""
    theta: jnp.ndarray      # estimated frame rotation (rad)
    scale_dev: jnp.ndarray  # estimated velocity scale - 1
    rate: jnp.ndarray       # per-meter frame-yaw rate (rad/m)
    px: jnp.ndarray         # last RAW reported position (velocity tap)
    py: jnp.ndarray
    ax: jnp.ndarray         # corrected path since last verified event
    ay: jnp.ndarray
    lx: jnp.ndarray         # leftover carry (un-persisted correction)
    ly: jnp.ndarray
    qy: jnp.ndarray         # projection-rotation quantum at last event
    nacc: jnp.ndarray       # accumulated -cross(a, r) innovation numerator
    dacc: jnp.ndarray       # accumulated |a|^2 lever arm
    sacc: jnp.ndarray       # accumulated dot(a, r) scale numerator
    gskip: jnp.ndarray      # consecutive turn-gate discards (starvation
    #                         override, SlamConfig.merge_frame_turn_starve)


def frame_init(n: int, px=None, py=None) -> FrameState:
    z = jnp.zeros((n,), jnp.float32)
    return FrameState(
        theta=z, scale_dev=z, rate=z,
        px=z if px is None else jnp.asarray(px, jnp.float32),
        py=z if py is None else jnp.asarray(py, jnp.float32),
        ax=z, ay=z, lx=z, ly=z, qy=z, nacc=z, dacc=z, sacc=z, gskip=z)


def frame_add(fs: FrameState, d: FrameState) -> FrameState:
    """leaf + delta, leafwise — BOTH engines apply updates through this
    exact expression so decompositions stay bit-equal."""
    return jax.tree.map(jnp.add, fs, d)


def frame_theta_q(theta, cfg: SwarmConfig):
    """Scan-projection de-rotation, QUANTIZED (see SlamConfig
    .merge_frame_derot_quant): continuous de-rotation couples the
    estimate into its own observation — a theta error rotates the
    projected scan and the matcher's zero-rotation prior makes the
    TRANSLATION absorb the rotation bias (~theta_err x scan radius,
    comparable to the drift signal), so the innovation loop can lock
    onto a wrong theta (measured: 3/8 agents wrong-sign/2x). Quantized
    de-rotation keeps the scan's residual rotation inside the matcher's
    +/-merge_angle_range capture (where its rotation SEARCH, not the
    translation, compensates), changes rarely, and each change gates
    that window's innovation exactly like a turn."""
    dq = cfg.slam.merge_frame_derot_quant
    if dq <= 0.0:
        return theta
    return jnp.round(theta / dq) * dq


def frame_advance(fs: FrameState, raw_x, raw_y, alive,
                  cfg: SwarmConfig):
    """Per-step continuous frame correction (SlamConfig.merge_frame_gain).

    Drift model (models/odometry.py drift_integrate): the agent
    integrates displacement along its biased yaw with a scaled length,
    so each step's REPORTED delta is D_rep = s_rep R(e) D_true, where e
    is the (growing) frame-yaw error and s_rep the translation scale.
    The server de-rotates every reported step with its current
    estimates: D_corr = (1 + scale_dev) R(-theta) D_rep. Applied as a
    merge_dx/dy increment, this corrects drift at the rate it accrues —
    the event matcher then only trims residual noise. `theta` itself
    advances by the learned per-meter rate (feed-forward), so it tracks
    drift growth between innovations.

    raw_x/y: this step's RAW reported position (est + separation
    offset, NO corrections — the closure/merge corrections are level
    shifts that must not enter the velocity).

    Returns (add_x, add_y, deltas: FrameState) — merge_dx/dy increments
    plus tracker-state DELTAS to apply via frame_add.
    """
    slam = cfg.slam
    dpx = raw_x - fs.px
    dpy = raw_y - fs.py
    # teleport/gap/first-packet guard: a zero-init px (fresh server,
    # checkpoint migration) or a respawn makes one oversized delta —
    # skip the correction and the accumulator, rebase only
    ok = alive & (dpx * dpx + dpy * dpy <=
                  slam.merge_frame_max_step_m ** 2)
    c = jnp.cos(fs.theta)
    s = jnp.sin(fs.theta)
    sc = 1.0 + fs.scale_dev
    cdx = sc * (c * dpx + s * dpy)      # R(-theta) @ D_rep, scaled
    cdy = sc * (c * dpy - s * dpx)
    add_x = jnp.where(ok, cdx - dpx, 0.0)
    add_y = jnp.where(ok, cdy - dpy, 0.0)
    z = jnp.zeros_like(dpx)
    deltas = FrameState(
        theta=jnp.where(ok, fs.rate * jnp.sqrt(cdx * cdx + cdy * cdy),
                        0.0),
        scale_dev=z, rate=z, px=dpx, py=dpy,
        ax=jnp.where(ok, cdx, 0.0), ay=jnp.where(ok, cdy, 0.0),
        lx=z, ly=z, qy=z, nacc=z, dacc=z, sacc=z, gskip=z)
    return add_x, add_y, deltas


def frame_innovate(fs: FrameState, gate_yaw, m: WindowMatch, upd,
                   inc_dx, inc_dy, cfg: SwarmConfig,
                   recovered=None) -> FrameState:
    """Event-time innovation for the frame tracker. Returns DELTAS.

    With a = the corrected path accumulated since the last verified
    event and r = the residual the drift accrued over THAT window,
    first-order in the estimate errors (delta = e - theta,
    ds = 1/s_rep - (1+scale_dev)):

        r = sum[(1/s_rep) R(-e) - s_hat R(-theta)] D_rep
          ~= (ds I - delta J) a          (J = 90-degree rotation)

    so delta = -cross(a, r)/|a|^2 and ds = dot(a, r)/|a|^2. One window
    is noise-dominated (the matcher's 2-cell dilation plateau puts
    ~0.1 m on r against a ~0.01 rad x 1.6 m signal — measured: per-event
    innovations agreed with the true theta gap only 48% of the time),
    so windows ACCUMULATE: nacc += -cross, sacc += dot, dacc += |a|^2,
    and the estimates update only when the accumulated lever dacc
    reaches merge_frame_inno_path_m^2 (noise ~1/sqrt(windows), signal
    constant). The per-meter rate learns from the same averaged
    innovation, divided by the lever distance (second-order loop, small
    gain: it integrates over the whole run and a railed rate was
    MEASURED to drag theta 2.5x past truth).

    Window gates (corrupted windows are DISCARDED, not accumulated):
      * merge_frame_fit_min — false matches cluster at the 0.6 floor;
      * the TURN gate (gate_yaw vs the stored quantum qy): the raster
        frame uses the firmware's 15-degree-quantized yaw MINUS the
        quantized de-rotation; each quantum change step-changes the
        match's rotation-projection bias by ~0.2 m, a spike riding
        exactly on turn windows;
      * the sub-window lever floor merge_frame_min_path_m.

    lx/ly — the LEFTOVER carry: merge_increments persists only
    damping x clip(residual) into merge_dx/dy, so the unabsorbed part
    of each event's measured correction reappears in the NEXT event's
    measurement; subtracting it keeps window residuals unbiased
    (without it the scale estimate railed at 30x the true deviation).
    The accumulator, leftover, and quantum re-baseline at every
    verified event regardless of the gates.
    """
    from swarm_tpu.utils.angles import wrap_pi
    slam = cfg.slam
    rx = m.ddx - fs.lx
    ry = m.ddy - fs.ly
    a2 = fs.ax * fs.ax + fs.ay * fs.ay
    if slam.merge_frame_turn_gate > 0.0:
        straight_raw = (jnp.abs(wrap_pi(gate_yaw - fs.qy)) <=
                        slam.merge_frame_turn_gate)
        if slam.merge_frame_turn_starve > 0:
            # starvation override: an agent turning at nearly every
            # window never passes the gate and outruns the evidence
            # band (149 escapes measured in the 181-ray 2000-step
            # soak) — accept one window per `turn_starve` consecutive
            # discards; the dacc lever averages its ~0.2 m spike down
            starved = fs.gskip >= slam.merge_frame_turn_starve
            straight = straight_raw | starved
        else:
            straight = straight_raw
    else:
        straight_raw = straight = jnp.ones_like(upd)
    # m.distinct: peak-distinctness verdict (all-True when the gate is
    # off) — ambiguous-peak matches (wall-hugging/symmetric-room false
    # verifications) must not innovate the frame estimates
    sub_ok = upd & straight & m.distinct & \
        (a2 >= slam.merge_frame_min_path_m ** 2) & \
        (m.fitness >= slam.merge_frame_fit_min)
    if recovered is not None:
        # a re-acquisition residual is a LEVEL jump, not drift accrued
        # over this window — it must re-baseline (upd path below) but
        # never enter the drift estimate
        sub_ok = sub_ok & ~recovered
    nacc = fs.nacc + jnp.where(sub_ok, -(fs.ax * ry - fs.ay * rx), 0.0)
    sacc = fs.sacc + jnp.where(sub_ok, fs.ax * rx + fs.ay * ry, 0.0)
    dacc = fs.dacc + jnp.where(sub_ok, a2, 0.0)
    fire = dacc >= slam.merge_frame_inno_path_m ** 2
    inv = 1.0 / jnp.maximum(dacc, 1e-9)
    d_th = jnp.clip(nacc * inv,
                    -slam.merge_frame_inno_clamp / jnp.maximum(
                        slam.merge_frame_gain, 1e-6),
                    slam.merge_frame_inno_clamp / jnp.maximum(
                        slam.merge_frame_gain, 1e-6))
    th_step = jnp.clip(slam.merge_frame_gain * d_th,
                       -slam.merge_frame_inno_clamp,
                       slam.merge_frame_inno_clamp)
    new_theta = wrap_pi(fs.theta + th_step)
    new_scale = jnp.clip(
        fs.scale_dev + slam.merge_frame_scale_gain * sacc * inv,
        -slam.merge_frame_scale_clamp, slam.merge_frame_scale_clamp)
    new_rate = jnp.clip(
        fs.rate + slam.merge_frame_rate_gain * d_th / jnp.sqrt(
            jnp.maximum(dacc, slam.merge_frame_min_path_m ** 2)),
        -slam.merge_frame_rate_max, slam.merge_frame_rate_max)
    z = jnp.zeros_like(fs.theta)
    return FrameState(
        theta=jnp.where(fire, new_theta - fs.theta, 0.0),
        scale_dev=jnp.where(fire, new_scale - fs.scale_dev, 0.0),
        rate=jnp.where(fire, new_rate - fs.rate, 0.0),
        px=z, py=z,
        ax=jnp.where(upd, -fs.ax, 0.0),
        ay=jnp.where(upd, -fs.ay, 0.0),
        lx=jnp.where(upd, (m.ddx - inc_dx) - fs.lx, 0.0),
        ly=jnp.where(upd, (m.ddy - inc_dy) - fs.ly, 0.0),
        qy=jnp.where(upd, gate_yaw - fs.qy, 0.0),
        nacc=jnp.where(fire, -fs.nacc, jnp.where(sub_ok, nacc - fs.nacc,
                                                 0.0)),
        dacc=jnp.where(fire, -fs.dacc, jnp.where(sub_ok, dacc - fs.dacc,
                                                 0.0)),
        sacc=jnp.where(fire, -fs.sacc, jnp.where(sub_ok, sacc - fs.sacc,
                                                 0.0)),
        # turn-gate discard counter: +1 on a turn-discarded verified
        # window, reset whenever the turn dimension passes (raw or via
        # the override); other-gate failures leave it unchanged
        gskip=jnp.where(upd & ~straight, 1.0,
                        jnp.where(upd & straight, -fs.gskip, 0.0)))


def merge_increments(m: WindowMatch, upd, recovered, cfg: SwarmConfig):
    """Persistent correction increments (merge_dx/dy/dyaw deltas) with
    the recovery-aware clamps. `upd` = m.ok & alive (the applied set).

    Normal events keep the tight merge_max_step_* clamps (one bad match
    cannot jump the frame); recovered events use the wider
    merge_recover_max_step_* so re-acquisition lands in one bite, and
    their yaw increment persists under merge_damping even when
    merge_yaw_damping is 0 (a re-acquired rotation must stick, or the
    next event needs the wide pass again). With recovery disabled the
    arithmetic is IDENTICAL to the pre-recovery engines' inline code."""
    slam = cfg.slam
    fdx = jnp.where(upd, m.ddx, 0.0)
    fdy = jnp.where(upd, m.ddy, 0.0)
    fdth = jnp.where(upd, m.ddtheta, 0.0)
    cmx = slam.merge_max_step_m
    cmr = slam.merge_max_step_rad
    if slam.merge_recover_after <= 0:
        inc_dx = slam.merge_damping * jnp.clip(fdx, -cmx, cmx)
        inc_dy = slam.merge_damping * jnp.clip(fdy, -cmx, cmx)
        inc_dth = slam.merge_yaw_damping * jnp.clip(fdth, -cmr, cmr)
        return fdx, fdy, fdth, inc_dx, inc_dy, inc_dth
    cmx_a = jnp.where(recovered, slam.merge_recover_max_step_m, cmx)
    cmr_a = jnp.where(recovered, slam.merge_recover_max_step_rad, cmr)
    yaw_damp = jnp.where(recovered, slam.merge_damping,
                         slam.merge_yaw_damping)
    inc_dx = slam.merge_damping * jnp.clip(fdx, -cmx_a, cmx_a)
    inc_dy = slam.merge_damping * jnp.clip(fdy, -cmx_a, cmx_a)
    inc_dth = yaw_damp * jnp.clip(fdth, -cmr_a, cmr_a)
    return fdx, fdy, fdth, inc_dx, inc_dy, inc_dth

"""Correlative grid-to-grid scan matching — the matmul replacement for the
reference's Open3D point-to-point ICP (server_nodes/map_merger.py:45-62:
threshold 1.0 m, 30 iterations, reject fitness < 0.6).

ICP is a data-dependent loop over nearest-neighbour queries — hostile to
XLA. The batched formulation is exhaustive correlation: score every
(rotation, translation) hypothesis in a window at once, where the score of
all translations for one rotation is a single 2-D cross-correlation of the
rotated local map against the global map — i.e. `lax.conv` with the local
map as the kernel, which XLA maps onto matrix units. A parabolic fit
around the peak gives sub-cell refinement. Fitness = matched fraction of
occupied cells, with the reference's 0.6 rejection gate.

Everything is fixed-shape: batch over agents with `vmap`, over rotation
hypotheses via the conv feature dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from swarm_tpu.config import GridConfig, SlamConfig


class MatchResult(NamedTuple):
    dx: jnp.ndarray        # [] metres, translation of local -> global
    dy: jnp.ndarray
    dtheta: jnp.ndarray    # [] radians
    score: jnp.ndarray     # [] raw correlation peak
    fitness: jnp.ndarray   # [] matched fraction of occupied mass
    ok: jnp.ndarray        # [] bool — fitness gate (ref: >= 0.6)


def _rotated_mass_stack(local_occ, thetas, k_points: int):
    """All rotation hypotheses of a sparse occupancy-mass image at once:
    extract the top-`k_points` cells, rotate their COORDINATES, and
    bilinear-splat into [A, S, S]. Occupancy grids are mostly zero, so
    this replaces the dense bilinear gather (`_rotate_grid`, which is
    gather-bound).
    The splat itself is a separable one-hot MATMUL (bilinear stamp =
    outer product of a y-stamp and an x-stamp, so the image is
    Yv^T @ X — see match_scan_window's splat) rather than a scatter.
    Forward splat is the adjoint of backward sampling; mass
    is conserved exactly per rotation (out-of-window taps drop because
    the one-hot compare never fires)."""
    s = local_occ.shape[0]
    c = (s - 1) / 2.0
    dtype = local_occ.dtype
    k_points = min(k_points, local_occ.size)   # small submaps
    vals, idx = jax.lax.top_k(local_occ.reshape(-1), k_points)
    py = (idx // s).astype(dtype)
    px = (idx % s).astype(dtype)

    def one(t):
        ct, st = jnp.cos(t), jnp.sin(t)
        x = c + (px - c) * ct - (py - c) * st
        y = c + (px - c) * st + (py - c) * ct
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        ii = jnp.arange(s, dtype=jnp.int32)[None, :]
        yv = ((ii == y0[:, None]) * (1.0 - fy) +
              (ii == y0[:, None] + 1) * fy) * vals[:, None]
        xv = ((ii == x0[:, None]) * (1.0 - fx) +
              (ii == x0[:, None] + 1) * fx)
        # HIGHEST: bilinear weights are not exact in bf16/TF32
        return jnp.dot(yv.astype(dtype).T, xv.astype(dtype),
                       precision=jax.lax.Precision.HIGHEST)

    return jax.vmap(one)(thetas)


def _rotate_grid(occ, theta, cfg: GridConfig):
    """Rotate an occupancy-mass image about the grid centre by theta,
    bilinear. occ: [S, S] float. Pure gather."""
    s = occ.shape[0]
    c = (s - 1) / 2.0
    yy, xx = jnp.meshgrid(jnp.arange(s, dtype=occ.dtype),
                          jnp.arange(s, dtype=occ.dtype), indexing="ij")
    ct, st = jnp.cos(-theta), jnp.sin(-theta)
    sx = c + (xx - c) * ct - (yy - c) * st
    sy = c + (xx - c) * st + (yy - c) * ct
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    fx = sx - x0
    fy = sy - y0

    def at(yi, xi):
        ok = (xi >= 0) & (xi < s) & (yi >= 0) & (yi < s)
        v = occ[jnp.clip(yi, 0, s - 1), jnp.clip(xi, 0, s - 1)]
        return jnp.where(ok, v, 0.0)

    return (at(y0, x0) * (1 - fx) * (1 - fy) +
            at(y0, x0 + 1) * fx * (1 - fy) +
            at(y0 + 1, x0) * (1 - fx) * fy +
            at(y0 + 1, x0 + 1) * fx * fy)


def match_grids(local_occ, global_occ, cfg: GridConfig = GridConfig(),
                slam: SlamConfig = SlamConfig(),
                fitness_min: float = 0.6,
                icp_threshold_m: float = 1.0) -> MatchResult:
    """Find the rigid transform aligning `local_occ` into `global_occ`.

    local_occ, global_occ: [S, S] occupancy mass in [0, 1] (e.g. tri-state
    OCCUPIED -> 1.0, or clipped positive log-odds). Search window:
    +/- `slam.scanmatch_window_cells` cells, `slam.scanmatch_angles`
    rotations over +/- `slam.scanmatch_angle_range` rad.

    Returns the transform FROM local TO global frame (apply to local map
    points: p' = R(dtheta) (p - centre) + centre + (dx, dy)).
    """
    w = slam.scanmatch_window_cells
    a = slam.scanmatch_angles
    dtype = jnp.float32
    local_occ = local_occ.astype(dtype)
    global_occ = global_occ.astype(dtype)

    thetas = jnp.linspace(-slam.scanmatch_angle_range,
                          slam.scanmatch_angle_range, a, dtype=dtype)
    rot = _rotated_mass_stack(local_occ, thetas,
                              slam.scanmatch_points)              # [A,S,S]

    # Correlation of every rotation against the global map: one conv call.
    # global as NCHW [1, 1, S+2w, S+2w] (padded), kernels [A, 1, S, S].
    g = jnp.pad(global_occ, w)[None, None]
    k = rot[:, None]
    scores = jax.lax.conv_general_dilated(
        g, k, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32)[0]            # [A, 2w+1, 2w+1]

    flat = jnp.argmax(scores)
    ai, rest = flat // ((2 * w + 1) ** 2), flat % ((2 * w + 1) ** 2)
    di, dj = rest // (2 * w + 1), rest % (2 * w + 1)
    score = scores.reshape(-1)[flat]

    # Parabolic sub-cell refinement along each translation axis.
    def refine(idx, axis_len, line):
        c = line[idx]
        lo = line[jnp.clip(idx - 1, 0, axis_len - 1)]
        hi = line[jnp.clip(idx + 1, 0, axis_len - 1)]
        denom = lo - 2 * c + hi
        off = jnp.where(jnp.abs(denom) > 1e-6,
                        0.5 * (lo - hi) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    row = scores[ai, di, :]
    col = scores[ai, :, dj]
    off_j = refine(dj, 2 * w + 1, row)
    off_i = refine(di, 2 * w + 1, col)

    # conv VALID with pad w: output index (di, dj) means the kernel (local)
    # was shifted by (di - w, dj - w) in the padded global — i.e. local
    # content at row r aligns with global row r + (di - w).
    dy_cells = di.astype(dtype) - w + off_i
    dx_cells = dj.astype(dtype) - w + off_j

    # Fitness = ICP's inlier fraction (map_merger.py:52-56: fraction of
    # source points with a correspondence within `icp_threshold_m`):
    # correlate the chosen rotated local map against the global map
    # DILATED by the threshold radius (separable max-pool), normalised by
    # the local mass.
    th_cells = max(1, int(round(icp_threshold_m / cfg.resolution)))
    dil = global_occ
    dil = jax.lax.reduce_window(dil, -jnp.inf, jax.lax.max,
                                (2 * th_cells + 1, 1), (1, 1), "SAME")
    dil = jax.lax.reduce_window(dil, -jnp.inf, jax.lax.max,
                                (1, 2 * th_cells + 1), (1, 1), "SAME")
    dil_p = jnp.pad(dil, w)
    s = global_occ.shape[0]
    window = jax.lax.dynamic_slice(dil_p, (di, dj), (s, s))
    inliers = jnp.sum(rot[ai] * window)
    mass = jnp.sum(rot[ai])
    fitness = jnp.where(mass > 0, inliers / jnp.maximum(mass, 1e-6), 0.0)
    fitness = jnp.minimum(fitness, 1.0)
    return MatchResult(
        dx=dx_cells * cfg.resolution,
        dy=dy_cells * cfg.resolution,
        dtheta=thetas[ai],
        score=score,
        fitness=fitness,
        ok=(fitness >= fitness_min) & (mass > 0))


def match_grids_batch(local_occs, global_occ, cfg: GridConfig = GridConfig(),
                      slam: SlamConfig = SlamConfig(),
                      fitness_min: float = 0.6) -> MatchResult:
    """vmap over N agents' submaps against one global map — the reference's
    per-agent `map_callback` ICP loop (map_merger.py:35-43) as one batched
    call ('EP-like' fan-out over independent solves, SURVEY §2)."""
    return jax.vmap(lambda l: match_grids(l, global_occ, cfg, slam,
                                          fitness_min))(local_occs)


class WindowMatch(NamedTuple):
    """Result of one scan-to-window alignment (residual correction of the
    reported pose)."""
    ddx: jnp.ndarray       # [] metres — add to the reported x
    ddy: jnp.ndarray
    ddtheta: jnp.ndarray   # [] radians — add to the reported yaw
    fitness: jnp.ndarray   # [] matched fraction of scan points
    ok: jnp.ndarray        # [] bool — fitness gate (ref: >= 0.6)
    # Rotation re-measured on the UNDILATED map at the chosen
    # translation, with no zero-motion prior. The pose-correction
    # ddtheta above is deliberately rotation-blind below ~2 cells of
    # tangential misalignment (the dilation plateau + prior resolve
    # small rotations to "no change" — the anti-runaway design); this
    # field exists for the yaw-rate-bias ESTIMATOR
    # (slam/livemerge.merge_bias_update), which needs the small
    # residual rotations the correction path intentionally ignores.
    # Never fed back into the pose directly.
    ddtheta_meas: jnp.ndarray  # [] radians
    # Peak-distinctness verdict (SlamConfig.merge_distinct_margin): the
    # raw (prior-free) correlation peak beats every hypothesis at least
    # `distinct_radius` translation cells away by margin x n_points.
    # All-True when the margin is 0 (gate off). Consumed by the
    # frame-tracker innovation gate; the bounded persistent increments
    # ignore it by design.
    distinct: jnp.ndarray      # [] bool
    # The raw normalized peak gap the verdict thresholds:
    # (peak_raw - ring_max) / n_pts. Lets downstream consumers apply
    # their OWN margin (SlamConfig.merge_distinct_log_margin for the
    # logged fix stream — the r5 64-agent run measured the 0.05 tracker
    # margin passing only 9 of 6449 verified events, which starves the
    # offline robust calibration that exists to absorb false fixes).
    # +inf when the distinctness test is statically off.
    distinct_gap: jnp.ndarray  # [] float32


def match_scan_window(off_x, off_y, valid, window_mass, agent_cell_xy,
                      inner: int, search: int,
                      n_theta: int = 9, theta_range: float = 0.15,
                      resolution: float = 0.05,
                      inlier_radius_cells: int = 2,
                      fitness_min: float = 0.6,
                      min_points: int = 16,
                      prior_weight: float = 0.05,
                      theta_prior_scale: float = 0.1,
                      distinct_margin: float = 0.0,
                      distinct_radius: int = 3) -> WindowMatch:
    """Correlative scan-to-map matching of ONE agent's current scan against
    a window of the global map — the continuously-running realignment the
    reference's merger performs on every incoming submap
    (map_merger.py:35-62: ICP, reject fitness < 0.6), reformulated as
    matmuls: every (rotation, translation) hypothesis scored at once, the
    translations of one rotation being a single 2-D cross-correlation.

    off_x, off_y: [R] world-frame offsets of the scan hit points relative
      to the agent's reported position (metres); `valid` [R] masks trusted
      hits. The transform model is a rotation of the scan ABOUT THE AGENT
      by dtheta followed by a translation — matching how a pose error
      displaces the projected evidence.
    window_mass: [inner + 2*search]² occupancy mass cropped from the
      global map (previous step — the scan must not match itself).
    agent_cell_xy: (ax, ay) float cell coords of the agent INSIDE the
      window's inner region (normally its centre; off-centre after edge
      clamping).

    Returns the residual correction: reported pose + (ddx, ddy, ddtheta)
    aligns the scan with the map. Fitness = fraction of scan mass landing
    within `inlier_radius_cells` of occupied map mass — ICP's inlier
    fraction (map_merger.py:52-56).
    """
    dtype = jnp.float32
    w = search
    s_in = inner
    ax, ay = agent_cell_xy
    vf = valid.astype(dtype)
    n_pts = jnp.sum(vf)

    thetas = jnp.linspace(-theta_range, theta_range, n_theta, dtype=dtype)
    px = off_x.astype(dtype) / resolution
    py = off_y.astype(dtype) / resolution

    def splat(t):
        # Bilinear point splat as a separable one-hot MATMUL: the stamp
        # of point p is an outer product (wy0*e_y0 + wy1*e_y1) x
        # (wx0*e_x0 + wx1*e_x1), so the whole image is Yv^T @ X with
        # Yv[p, :] = valid_p * y-stamp and X[p, :] = x-stamp — one
        # [S, P] @ [P, S] contraction instead of 4 scatter-adds per
        # point. Out-of-
        # window taps drop automatically (the one-hot compare never
        # fires), matching the scatter's mode="drop" per-corner.
        ct, st = jnp.cos(t), jnp.sin(t)
        x = ax + px * ct - py * st
        y = ay + px * st + py * ct
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        ii = jnp.arange(s_in, dtype=jnp.int32)[None, :]
        yv = ((ii == y0[:, None]) * (1.0 - fy) +
              (ii == y0[:, None] + 1) * fy) * vf[:, None]
        xv = ((ii == x0[:, None]) * (1.0 - fx) +
              (ii == x0[:, None] + 1) * fx)
        # HIGHEST: bilinear weights are not exact in bf16/TF32
        return jnp.dot(yv.astype(dtype).T, xv.astype(dtype),
                       precision=jax.lax.Precision.HIGHEST)

    rot = jax.vmap(splat)(thetas)                          # [A, s_in, s_in]

    # Score against the DILATED map mass (radius = the inlier radius).
    # Rationale: the raster's free-space carving erodes the room side of a
    # wall's mass (long-noise beams carve through it) while short-noise
    # hits pile up behind it — the surviving mass centroid sits ~1 cell
    # behind the true surface, and correlating against the raw mass pulls
    # every match toward the wall (a runaway once corrections feed the
    # raster). Dilation widens the wall plateau symmetrically over the
    # true surface, the peak becomes a tie across the plateau, and the
    # zero-motion prior resolves the tie to "no correction" — only real
    # misalignments beyond the radius (>= 2 cells = 0.1 m here; the
    # reference ICP gated at 1.0 m, map_merger.py:46) move the pose.
    r = inlier_radius_cells
    dil = jax.lax.reduce_window(window_mass.astype(dtype), -jnp.inf,
                                jax.lax.max, (2 * r + 1, 1), (1, 1), "SAME")
    dil = jax.lax.reduce_window(dil, -jnp.inf, jax.lax.max,
                                (1, 2 * r + 1), (1, 1), "SAME")

    # Translation scoring as an im2col MATMUL instead of a conv: under
    # the per-agent vmap the conv becomes a 128-group grouped
    # convolution with per-example 80x80 kernels, which lowers poorly.
    # Stacking the (2w+1)^2 shifted views and contracting
    # [A_theta, s_in^2] @ [s_in^2, (2w+1)^2] is one well-shaped batched
    # matmul (K = s_in^2 = 6400).
    side_s = 2 * w + 1
    patches = jnp.stack(
        [dil[di:di + s_in, dj:dj + s_in].reshape(-1)
         for di in range(side_s) for dj in range(side_s)], axis=1)
    # HIGHEST: both operands are fractional masses (bilinear splat, map
    # mass), so bf16/TF32 inputs would round the scores whose argmax
    # picks the correction; f32 keeps the GPU on the CPU's numbers
    scores = jnp.dot(rot.reshape(n_theta, -1), patches,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32).reshape(
        n_theta, side_s, side_s)                           # [A, 2w+1, 2w+1]

    # Zero-motion prior: straight walls constrain only their normal (the
    # aperture problem) — the score is flat along the wall and a bare
    # argmax snaps to the window edge. Penalising hypotheses by distance
    # from zero correction resolves degenerate directions to "no change"
    # while a real misalignment (score step ~ O(n_pts)) still wins.
    ii = jnp.arange(2 * w + 1, dtype=dtype) - w
    pen_xy = (ii[:, None] ** 2 + ii[None, :] ** 2) / max(w, 1) ** 2
    # The theta prior normalizes by an ABSOLUTE scale, not theta_range:
    # a prior that weakens as the search widens lets extreme rotation
    # hypotheses absorb pure-translation misalignments (at 0.9 m range a
    # 0.2 rad rotation shifts points ~3.6 cells laterally with near-zero
    # penalty) — measured: a 0.34 m injected slip then stalls ~0.26 m
    # with the wrong-sign lateral correction instead of recovering.
    # `theta_prior_scale` is that absolute scale: the RECOVERY pass
    # (slam/livemerge.scan_merge_recover) raises it — at the default 0.1
    # a TRUE 0.4 rad frame error pays 16x prior_weight x n_pts and can
    # never win, which is the point in steady state but defeats
    # re-acquisition after yaw drift has outrun the normal capture range.
    pen_t = (thetas / theta_prior_scale) ** 2
    scores_raw = scores    # prior-free copy for the distinctness test
    scores = scores - prior_weight * n_pts * (
        pen_xy[None] + pen_t[:, None, None])

    flat = jnp.argmax(scores)
    side = 2 * w + 1
    ai, rest = flat // (side * side), flat % (side * side)
    di, dj = rest // side, rest % side

    def refine(idx, line):
        c = line[idx]
        lo = line[jnp.clip(idx - 1, 0, side - 1)]
        hi = line[jnp.clip(idx + 1, 0, side - 1)]
        denom = lo - 2 * c + hi
        off = jnp.where(jnp.abs(denom) > 1e-6,
                        0.5 * (lo - hi) / denom, 0.0)
        # an argmax ON the boundary has no parabola: the clip above
        # duplicates the centre into the missing neighbour, which
        # yields off = ±0.5 (a systematic half-step bias toward the
        # interior) instead of "cannot refine"
        off = jnp.where((idx > 0) & (idx < side - 1), off, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    off_j = refine(dj, scores[ai, di, :])
    off_i = refine(di, scores[ai, :, dj])
    dy_cells = di.astype(dtype) - w + off_i
    dx_cells = dj.astype(dtype) - w + off_j

    # Parabolic sub-step refinement along THETA as well: the reported
    # yaw carries a 15-degree quantisation (+/-0.13 rad,
    # generate_fake_dual_session.py:468), so rotation must be resolved
    # well below the hypothesis spacing — a residual rotation aliases
    # into translation noise proportional to range (~0.2 m at room
    # scale per 0.1 rad), which random-walks the accumulated correction.
    def refine_t(idx, line):
        c = line[idx]
        lo = line[jnp.clip(idx - 1, 0, n_theta - 1)]
        hi = line[jnp.clip(idx + 1, 0, n_theta - 1)]
        denom = lo - 2 * c + hi
        off = jnp.where(jnp.abs(denom) > 1e-6,
                        0.5 * (lo - hi) / denom, 0.0)
        # boundary argmax: no parabola (see refine() above)
        off = jnp.where((idx > 0) & (idx < n_theta - 1), off, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    dth_step = (thetas[1] - thetas[0]) if n_theta > 1 else jnp.float32(0.0)
    off_a = refine_t(ai, scores[:, di, dj])
    ddtheta = thetas[ai] + off_a * dth_step

    # inlier fraction against the same threshold-dilated map
    win = jax.lax.dynamic_slice(dil, (di, dj), (s_in, s_in))
    inliers = jnp.sum(rot[ai] * jnp.minimum(win, 1.0))
    fitness = jnp.where(n_pts > 0, inliers / jnp.maximum(n_pts, 1e-6), 0.0)
    fitness = jnp.minimum(fitness, 1.0)

    # Rotation re-measurement for the bias estimator: score every theta
    # hypothesis against the RAW (undilated) mass at the chosen
    # translation and refine the prior-free peak. The dilated surface is
    # flat for tangential displacements under ~inlier_radius cells, so
    # `ddtheta` above cannot see the per-window drift increment
    # (~0.01 rad) the yaw-rate estimator needs; the raw wall profile
    # (1-2 cells wide) still has curvature there. One [A, s_in^2] @
    # [s_in^2] matvec — negligible next to the translation scoring.
    win_raw = jax.lax.dynamic_slice(window_mass.astype(dtype), (di, dj),
                                    (s_in, s_in))
    t_line = jnp.dot(rot.reshape(n_theta, -1), win_raw.reshape(-1),
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    ai_r = jnp.argmax(t_line)
    off_r = refine_t(ai_r, t_line)
    ddtheta_meas = thetas[ai_r] + off_r * dth_step

    # Peak distinctness (SlamConfig.merge_distinct_margin): the chosen
    # peak must beat every hypothesis >= `distinct_radius` translation
    # cells away (Chebyshev, any rotation) by margin x n_pts — on the
    # PRIOR-FREE scores (the zero-motion prior fabricates exactly the
    # centre-favouring slope this test must not see). Wall-hugging scans
    # (score flat along the wall — the aperture problem) and symmetric-
    # room aliases (a second in-window peak within the margin) fail it;
    # those are the measured false-verified geometries (21-31% of
    # fitness-verified events).
    if distinct_margin > 0.0:
        jj_g = jnp.arange(side, dtype=jnp.int32)
        far = (jnp.abs(jj_g[:, None] - di) >= distinct_radius) | \
            (jnp.abs(jj_g[None, :] - dj) >= distinct_radius)
        ring_max = jnp.max(jnp.where(far[None, :, :], scores_raw,
                                     -jnp.inf))
        peak_raw = scores_raw[ai, di, dj]
        gap = (peak_raw - ring_max) / jnp.maximum(n_pts, 1.0)
        distinct = gap >= distinct_margin
    else:
        gap = jnp.full((), jnp.inf, jnp.float32)
        distinct = jnp.ones((), bool)

    return WindowMatch(
        ddx=dx_cells * resolution,
        ddy=dy_cells * resolution,
        ddtheta=ddtheta,
        fitness=fitness,
        ok=(fitness >= fitness_min) & (n_pts >= min_points),
        ddtheta_meas=ddtheta_meas,
        distinct=distinct,
        distinct_gap=gap)


def occupancy_mass(tri_grid, cfg: GridConfig = GridConfig()):
    """Tri-state grid -> occupancy mass in [0, 1] (OCCUPIED cells only,
    matching map_merger's > 50 threshold, map_merger.py:67)."""
    return (tri_grid == cfg.occupied).astype(jnp.float32)

"""Scan-to-scan closure measurement (SlamConfig.closure_scanmatch).

The reference's loop closure is a landmark POSITION coincidence: the
matcher only knows both robots stood within 0.6 m of the same spot
(dual_bot_mapper.py:292-326), so the best possible edge is a ~0.3 m
"same place" constraint — measurably too weak to beat raw odometry at
short horizons (tools/bench_accuracy.py weight sweep). This module
upgrades the edge to a real SE(2) measurement: the landmark ring stores
the detecting robot's servo sweep (slam/closure.py lm_scan/lm_yaw), and
when a closure fires the CURRENT scan is correlatively matched against
a window splatted from the STORED scan — same matmul formulation as the
map merge (slam/scanmatch.py::match_scan_window), the "map" here being
one remembered scan instead of the global grid.

Both scans project through their agents' ESTIMATED world yaw, so the
rotation search only has to cover the relative yaw DRIFT (a few tenths
of a radian), not the arbitrary heading difference between the two
visits. Fitness gates low-overlap pairs (two sides of the same corner
see different walls) back to the coincidence fallback.

The resulting measurement is an estimate of the PHYSICAL relative pose
of the two nodes, so it is trajectory-independent: edges logged during
a closure-snapping run refine the raw (or any other) trajectory of the
same nodes (tools/bench_accuracy.py's refined tier relies on this).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from swarm_tpu.config import SlamConfig, GridConfig, SensorConfig
from swarm_tpu.slam.scanmatch import WindowMatch, match_scan_window
from swarm_tpu.utils.angles import wrap_pi


def splat_points_window(px, py, valid, side: int):
    """Bilinear splat of points (cell coords in the window frame) into a
    [side, side] mass image — the separable one-hot MATMUL of
    match_scan_window's splat (one [S, P] @ [P, S] contraction instead
    of 4 scatter-adds per point; out-of-window taps drop because the
    one-hot compare never fires).

    NOTE: this is the rotation-free sibling of the splats inside
    scanmatch.py (match_scan_window's splat(), _rotated_mass_stack's
    one()) — a numerics change to the one-hot/bilinear scheme must be
    applied to all three."""
    dtype = jnp.float32
    vf = valid.astype(dtype)
    x0 = jnp.floor(px).astype(jnp.int32)
    y0 = jnp.floor(py).astype(jnp.int32)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    ii = jnp.arange(side, dtype=jnp.int32)[None, :]
    yv = ((ii == y0[:, None]) * (1.0 - fy) +
          (ii == y0[:, None] + 1) * fy) * vf[:, None]
    xv = ((ii == x0[:, None]) * (1.0 - fx) +
          (ii == x0[:, None] + 1) * fx)
    # HIGHEST: bilinear weights are not exact in bf16/TF32
    return jnp.dot(yv.astype(dtype).T, xv.astype(dtype),
                   precision=jax.lax.Precision.HIGHEST)


def match_scan_pair(cur_dist, cur_pose, stored_dist, stored_pose,
                    slam: SlamConfig, grid: GridConfig,
                    sens: SensorConfig):
    """One closure pair -> (WindowMatch, meas [3]).

    cur_pose / stored_pose: (x, y, yaw) ESTIMATED poses (any shared
    frame — only their difference matters). The window is centred on
    the stored pose; the current scan is matched with the residual
    transform model (rotate about the current agent, then translate).

    meas is the SE(2) edge measurement for posegraph edge
    (i=stored node, j=current node):
        meas_t  = R(yaw_i)^T (p_j_aligned - p_i)
        meas_th = wrap(yaw_j + ddtheta - yaw_i)
    where p_j_aligned = p_j + (ddx, ddy). Use WindowMatch.ok to gate.
    """
    res = grid.resolution
    inner = slam.closure_match_window
    search = slam.closure_match_search
    side = inner + 2 * search

    from swarm_tpu.models.scan import scan_angles
    r_scan = stored_dist.shape[-1]
    rel = scan_angles(r_scan, jnp.float32)

    sx, sy, syaw = stored_pose
    cx, cy, cyaw = cur_pose

    # ---- window: splat the STORED scan's endpoints, centred on the ----
    # stored pose (float cell coords; -0.5 aligns integer-centred splat
    # cells with the raster's floor() binning, as in livemerge)
    match_max = slam.closure_match_max_range
    s_valid = (stored_dist > sens.min_range) & (stored_dist <= match_max)
    s_ang = syaw + rel
    spx = (sx + stored_dist * jnp.cos(s_ang) - grid.origin_x) / res
    spy = (sy + stored_dist * jnp.sin(s_ang) - grid.origin_y) / res
    sgx = (sx - grid.origin_x) / res
    sgy = (sy - grid.origin_y) / res
    ox = jnp.floor(sgx).astype(jnp.int32) - side // 2   # window origin
    oy = jnp.floor(sgy).astype(jnp.int32) - side // 2
    win = splat_points_window(spx - ox - 0.5, spy - oy - 0.5, s_valid, side)
    # saturate like the map mass (~2 endpoint hits = full confidence)
    win = jnp.clip(win, 0.0, 1.0)

    # ---- current scan: offsets about the current agent ----------------
    c_valid = (cur_dist > sens.min_range) & (cur_dist <= match_max)
    c_ang = cyaw + rel
    off_x = cur_dist * jnp.cos(c_ang)
    off_y = cur_dist * jnp.sin(c_ang)
    cgx = (cx - grid.origin_x) / res
    cgy = (cy - grid.origin_y) / res
    ax = cgx - ox - search - 0.5      # inside the INNER region
    ay = cgy - oy - search - 0.5
    # Drop points whose zero-hypothesis position falls outside the inner
    # window BEFORE counting them: the splat's one-hot never fires for
    # them, but leaving them in n_pts deflates the inlier fraction for
    # exactly the offset rendezvous pairs the gate must verify (the
    # current agent sits up to the cross radius off-centre, so a
    # crescent of far hits lies beyond the window edge).
    pxc = ax + off_x / res
    pyc = ay + off_y / res
    c_valid = c_valid & (pxc >= 0) & (pxc < inner - 1) & \
        (pyc >= 0) & (pyc < inner - 1)

    min_pts = min(slam.merge_min_points, max(6, r_scan // 4))
    m = match_scan_window(
        off_x, off_y, c_valid, win, (ax, ay), inner, search,
        n_theta=slam.closure_match_angles,
        theta_range=slam.closure_match_angle_range,
        resolution=res,
        inlier_radius_cells=slam.closure_match_inlier_radius,
        fitness_min=slam.merge_fitness_min,
        min_points=min_pts,
        prior_weight=slam.closure_match_prior_weight,
        distinct_margin=slam.merge_distinct_margin,
        distinct_radius=slam.merge_distinct_radius)

    # ---- SE(2) edge measurement --------------------------------------
    dxw = (cx + m.ddx) - sx
    dyw = (cy + m.ddy) - sy
    ct, st = jnp.cos(syaw), jnp.sin(syaw)
    meas = jnp.stack([ct * dxw + st * dyw,
                      -st * dxw + ct * dyw,
                      wrap_pi((cyaw + m.ddtheta) - syaw)])
    return m, meas


def match_scan_pairs_batch(cur_dist, cur_poses, stored_dist, stored_poses,
                           slam: SlamConfig, grid: GridConfig,
                           sens: SensorConfig):
    """Batched pair matching: cur_dist [M, R], cur_poses ([M], [M], [M]),
    stored likewise. Returns (WindowMatch with [M] leaves, meas [M, 3]).

    Memory-bounded: match_scan_window's im2col patch tensor is
    inner_side^2 x (2*search+1)^2 floats (~70 MB at the closure-match
    defaults), so a flat vmap over a swarm-scale batch would reserve
    tens of GB inside the engine's lax.cond branch. Pairs are processed
    in `closure_match_chunk`-sized vmap chunks under lax.map — peak
    temp = chunk x one window, wall time still one fused loop."""
    m = cur_dist.shape[0]
    chunk = max(1, slam.closure_match_chunk)

    def one(args):
        cd, cx, cy, cw, sd, sx, sy, sw = args
        return jax.vmap(
            lambda cd_, cx_, cy_, cw_, sd_, sx_, sy_, sw_: match_scan_pair(
                cd_, (cx_, cy_, cw_), sd_, (sx_, sy_, sw_),
                slam, grid, sens)
        )(cd, cx, cy, cw, sd, sx, sy, sw)

    leaves = (cur_dist, *cur_poses, stored_dist, *stored_poses)
    if m <= chunk:
        return one(leaves)
    pad = (-m) % chunk
    k = (m + pad) // chunk

    def shape_in(x):
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]) \
            if pad else x
        return x.reshape((k, chunk) + x.shape[1:])

    out = jax.lax.map(one, tuple(shape_in(x) for x in leaves))
    return jax.tree.map(
        lambda x: x.reshape((k * chunk,) + x.shape[2:])[:m], out)

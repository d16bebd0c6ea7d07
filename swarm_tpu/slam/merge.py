"""Cross-agent map merging — the full map_merger.py replacement.

The reference merges per-agent occupancy grids by converting occupied
cells to point clouds, aligning with Open3D ICP, and re-rasterising into a
dynamically-sized global grid (map_merger.py:35-127). Here:

  * alignment = correlative scan matching as matmuls (slam/scanmatch.py),
    batched over agents, with the same fitness-rejection gate;
  * merging = a bilinear affine warp of the whole LOG-ODDS field into the
    global frame followed by an add — evidence from all agents combines
    additively instead of overwriting, and free-space evidence merges too
    (ICP point clouds kept only occupied cells).

`merge_local_maps` is one jittable call: N local grids in, one global
grid + per-agent transforms out.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from swarm_tpu.config import GridConfig, SlamConfig
from swarm_tpu.slam.scanmatch import MatchResult, match_grids


def warp_grid(grid, dx_cells, dy_cells, theta, fill: float = 0.0):
    """Bilinear affine warp about the grid centre: output(p) =
    grid(R(-theta) (p - c - t) + c), i.e. the grid rotated by theta then
    translated by (dx, dy) cells. Pure gather."""
    s = grid.shape[0]
    c = (s - 1) / 2.0
    yy, xx = jnp.meshgrid(jnp.arange(s, dtype=grid.dtype),
                          jnp.arange(s, dtype=grid.dtype), indexing="ij")
    px = xx - c - dx_cells
    py = yy - c - dy_cells
    ct, st = jnp.cos(-theta), jnp.sin(-theta)
    sx = c + px * ct - py * st
    sy = c + px * st + py * ct
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    fx = sx - x0
    fy = sy - y0

    def at(yi, xi):
        ok = (xi >= 0) & (xi < s) & (yi >= 0) & (yi < s)
        v = grid[jnp.clip(yi, 0, s - 1), jnp.clip(xi, 0, s - 1)]
        return jnp.where(ok, v, fill)

    return (at(y0, x0) * (1 - fx) * (1 - fy) +
            at(y0, x0 + 1) * fx * (1 - fy) +
            at(y0 + 1, x0) * (1 - fx) * fy +
            at(y0 + 1, x0 + 1) * fx * fy)


class MergeResult(NamedTuple):
    global_logodds: jnp.ndarray    # [S, S]
    transforms: MatchResult        # per-agent ([N] leaves)
    merged: jnp.ndarray            # [N] bool — passed the fitness gate


def merge_local_maps(local_logodds, cfg: GridConfig = GridConfig(),
                     slam: SlamConfig = SlamConfig(),
                     fitness_min: float = 0.6,
                     occ_thresh: float = 0.3) -> MergeResult:
    """Align + merge N per-agent log-odds grids.

    Anchor = agent 0's map (the reference anchors the first received map,
    map_merger.py:37-41). Each subsequent map is matched against the
    RUNNING global occupancy and folded in if fitness passes; rejected
    maps are skipped, like ICP rejections (:52-56).
    """
    n = local_logodds.shape[0]
    res = cfg.resolution

    def occ_of(lo):
        return (lo >= occ_thresh).astype(jnp.float32)

    def fold(carry, lo):
        glob = carry
        m = match_grids(occ_of(lo), occ_of(glob), cfg, slam, fitness_min)
        warped = warp_grid(lo, m.dx / res, m.dy / res, m.dtheta)
        glob = jnp.where(m.ok, glob + warped, glob)
        glob = jnp.clip(glob, -cfg.logodds_clamp, cfg.logodds_clamp)
        return glob, (m, m.ok)

    glob0 = local_logodds[0]
    glob, (ms, oks) = jax.lax.scan(fold, glob0, local_logodds[1:])

    # prepend the anchor's identity transform
    def pre(x0, xs):
        return jnp.concatenate([jnp.asarray(x0)[None], xs])

    transforms = MatchResult(
        dx=pre(0.0, ms.dx), dy=pre(0.0, ms.dy), dtheta=pre(0.0, ms.dtheta),
        score=pre(jnp.inf, ms.score), fitness=pre(1.0, ms.fitness),
        ok=pre(True, ms.ok))
    return MergeResult(global_logodds=glob, transforms=transforms,
                       merged=transforms.ok)


# --------------------------------------------------------------------------
# Dynamic-extent offline merge — the reference's publish_global_map
# semantics (map_merger.py:87-127): per-agent submaps carry their OWN
# origin/size metadata, and the merged global map is re-rasterised into a
# grid whose extent is recomputed from the merged cloud's bounds each time.
# merge_local_maps above assumes same-size, same-frame local grids; this
# path accepts differently-sized, offset submaps.
# --------------------------------------------------------------------------

def submap_points(grid, origin_xy, resolution: float,
                  occ_thresh: float = 0.3):
    """Occupied cells of one submap -> world-frame points [P, 2].

    Mirrors the reference's grid_to_pcd (map_merger.py:64-85): a cell is
    occupied if its value exceeds the threshold (`> 50` for int8 tri-state
    occupancy; `>= occ_thresh` for a log-odds field), and its point is the
    cell's origin-anchored coordinate (row * res + origin_y, col * res +
    origin_x)."""
    import numpy as np
    g = np.asarray(grid)
    occ = g > 50 if g.dtype.kind in "iu" else g >= occ_thresh
    ys, xs = np.nonzero(occ)
    return np.stack([xs * resolution + origin_xy[0],
                     ys * resolution + origin_xy[1]], axis=-1)


def global_map_from_points(points, resolution: float):
    """Bounds-fitted global occupancy grid from a merged point cloud —
    the reference's publish_global_map re-rasterisation
    (map_merger.py:94-110): extent = ceil(cloud bounds / res) + 1,
    UNKNOWN (-1) everywhere, occupied cells 100, origin = cloud min.

    Returns (grid int8 [H, W], (origin_x, origin_y))."""
    import numpy as np
    pts = np.asarray(points, np.float64)
    if pts.size == 0:
        return np.full((1, 1), -1, np.int8), (0.0, 0.0)
    min_x, min_y = pts[:, 0].min(), pts[:, 1].min()
    max_x, max_y = pts[:, 0].max(), pts[:, 1].max()
    width = int(np.ceil((max_x - min_x) / resolution)) + 1
    height = int(np.ceil((max_y - min_y) / resolution)) + 1
    grid = np.full((height, width), -1, np.int8)
    xi = np.clip(((pts[:, 0] - min_x) / resolution).astype(int),
                 0, width - 1)
    yi = np.clip(((pts[:, 1] - min_y) / resolution).astype(int),
                 0, height - 1)
    grid[yi, xi] = 100
    return grid, (float(min_x), float(min_y))


def _voxel_downsample(points, resolution: float):
    """Open3D voxel_down_sample equivalent at the map resolution
    (map_merger.py:60): one representative point (the voxel mean) per
    occupied voxel."""
    import numpy as np
    if len(points) == 0:
        return points
    keys = np.floor(points / resolution).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), 2), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(points.dtype)


def merge_submaps_dynamic(submaps, resolution: float,
                          slam: SlamConfig = SlamConfig(),
                          fitness_min: float = 0.6,
                          occ_thresh: float = 0.3,
                          icp_threshold_m: float = 1.0):
    """Merge differently-sized, offset submaps into a bounds-fitted global
    map — the full map_callback -> publish_global_map pipeline
    (map_merger.py:35-127) with the ICP stage replaced by the
    correlative matcher (match_scan_window).

    submaps: list of (grid, (origin_x, origin_y)) — per-map extent
    metadata like the reference's per-agent OccupancyGrid messages.
    The first non-empty submap seeds the global cloud (map_merger.py:40-43);
    each later submap's occupied points are matched against a window
    rasterised from the running global cloud, folded in when fitness
    clears `fitness_min` and dropped otherwise (:52-56), then the cloud is
    voxel-downsampled at the map resolution (:60).

    Returns (global_grid int8 [H, W], (origin_x, origin_y),
             per-submap dicts {ok, fitness, dx, dy, dtheta}).
    """
    import numpy as np

    search = slam.scanmatch_window_cells
    cloud = None
    reports = []
    for grid, origin in submaps:
        pts = submap_points(grid, origin, resolution, occ_thresh)
        if len(pts) == 0:
            reports.append({"ok": False, "fitness": 0.0,
                            "dx": 0.0, "dy": 0.0, "dtheta": 0.0,
                            "reason": "empty"})
            continue
        if cloud is None:
            cloud = pts.astype(np.float64)
            reports.append({"ok": True, "fitness": 1.0,
                            "dx": 0.0, "dy": 0.0, "dtheta": 0.0})
            continue

        # window covering this submap's extent (+ search margin),
        # rasterised from the running global cloud; centred on the
        # submap centroid. Sizes are bucketed (multiple of 32) so
        # repeated merges share compiled matchers.
        centroid = pts.mean(axis=0)
        ext = np.abs(pts - centroid).max() / resolution
        inner = int(np.ceil((2 * ext + 8) / 32)) * 32
        side = inner + 2 * search
        # window start so the centroid sits at the inner-region centre
        wx0 = centroid[0] - (side / 2.0) * resolution
        wy0 = centroid[1] - (side / 2.0) * resolution
        cx = ((cloud[:, 0] - wx0) / resolution).astype(int)
        cy = ((cloud[:, 1] - wy0) / resolution).astype(int)
        okc = (cx >= 0) & (cx < side) & (cy >= 0) & (cy < side)
        win = np.zeros((side, side), np.float32)
        win[cy[okc], cx[okc]] = 1.0

        # pad points to a pow2 capacity bucket (shared compiles)
        p_cap = 1 << max(6, int(len(pts) - 1).bit_length())
        off = np.zeros((p_cap, 2), np.float32)
        off[:len(pts)] = pts - centroid
        valid = np.zeros((p_cap,), bool)
        valid[:len(pts)] = True
        ax = ay = (inner - 1) / 2.0  # centroid cell inside the inner crop

        # Transform search with a SHARP (2-cell) scoring radius — the
        # reference's 1.0 m ICP threshold is a correspondence gate, not
        # an alignment tolerance (ICP still converges to the true
        # alignment); dilating the score by the full threshold would make
        # every sub-threshold offset invisible (the zero-motion prior
        # then resolves the plateau to "no correction").
        m = _window_matcher(
            inner, search, slam.scanmatch_angles,
            slam.scanmatch_angle_range, resolution, 2, 0.0)(
            jnp.asarray(off[:, 0]), jnp.asarray(off[:, 1]),
            jnp.asarray(valid), jnp.asarray(win),
            jnp.float32(ax), jnp.float32(ay))
        ddx, ddy, ddth = float(m.ddx), float(m.ddy), float(m.ddtheta)
        ct, st = np.cos(ddth), np.sin(ddth)
        rel = pts - centroid
        moved = np.stack(
            [centroid[0] + rel[:, 0] * ct - rel[:, 1] * st + ddx,
             centroid[1] + rel[:, 0] * st + rel[:, 1] * ct + ddy],
            axis=-1)
        # Reference-style fitness: fraction of this submap's (aligned)
        # points with a global-cloud correspondence within
        # icp_threshold_m (map_merger.py:46-56).
        th_cells = max(1, int(round(icp_threshold_m / resolution)))

        def shift(a, s, axis):
            # non-wrapping shift (np.roll would wrap dilation mass
            # across the window edges)
            out = np.zeros_like(a)
            src = [slice(None)] * 2
            dst = [slice(None)] * 2
            dst[axis] = slice(s, None) if s > 0 else slice(None, s)
            src[axis] = slice(None, -s) if s > 0 else slice(-s, None)
            out[tuple(dst)] = a[tuple(src)]
            return out

        dil = win.astype(bool)
        for axis in (0, 1):
            acc = dil.copy()
            for sdist in range(1, th_cells + 1):
                acc |= shift(dil, sdist, axis)
                acc |= shift(dil, -sdist, axis)
            dil = acc
        mx = ((moved[:, 0] - wx0) / resolution).astype(int)
        my = ((moved[:, 1] - wy0) / resolution).astype(int)
        okm = (mx >= 0) & (mx < side) & (my >= 0) & (my < side)
        inl = dil[np.clip(my, 0, side - 1), np.clip(mx, 0, side - 1)] & okm
        fit = float(inl.sum()) / max(len(pts), 1)
        if fit < fitness_min:
            reports.append({"ok": False, "fitness": fit,
                            "dx": 0.0, "dy": 0.0, "dtheta": 0.0,
                            "reason": "fitness"})
            continue
        cloud = _voxel_downsample(
            np.concatenate([cloud, moved], axis=0), resolution)
        reports.append({"ok": True, "fitness": fit,
                        "dx": ddx, "dy": ddy, "dtheta": ddth})

    if cloud is None:
        return (np.full((1, 1), -1, np.int8), (0.0, 0.0), reports)
    grid, origin = global_map_from_points(cloud, resolution)
    return grid, origin, reports


@functools.lru_cache(maxsize=None)
def _window_matcher(inner, search, n_theta, theta_range, resolution,
                    inlier_radius_cells, fitness_min):
    """Compiled point-set-to-window matcher, cached on the static window
    geometry so repeated same-bucket merges share one executable."""
    from swarm_tpu.slam.scanmatch import match_scan_window

    def run(ox, oy, valid, win, ax, ay):
        return match_scan_window(
            ox, oy, valid, win, (ax, ay), inner, search,
            n_theta=n_theta, theta_range=theta_range,
            resolution=resolution,
            inlier_radius_cells=inlier_radius_cells,
            fitness_min=fitness_min, min_points=1, prior_weight=0.02)

    return jax.jit(run)

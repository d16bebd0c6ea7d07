"""JAX rasterizer — the framework's L4: the reference's PyGame/matplotlib
views (MapRenderer, dual_bot_mapper.py:345-668; generate_topdown_map.py:13-72;
render_bedroom_map.py:53-173) as pure array programs.

Instead of a 30 FPS event loop drawing rects one by one (:519-527, :563-572)
the whole frame is ONE fused device computation: grid colormap + point
scatter + path scatter + robot markers composited into an RGB uint8 image,
jittable and batchable (render every K-th step of a rollout in one call).
Host side only encodes PNGs.

Color scheme mirrors the reference's dark theme (MapRenderer colors,
dual_bot_mapper.py:350-377): dark background, soft grid-free tint,
per-agent point-cloud colors, white robot markers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from swarm_tpu.config import GridConfig


class RenderTheme(NamedTuple):
    """RGB uint8 palette (defaults after dual_bot_mapper.py:350-377)."""
    background: tuple = (15, 18, 24)       # UNKNOWN
    free: tuple = (34, 40, 49)             # FREE cells
    occupied: tuple = (120, 200, 255)      # OCCUPIED cells (ref skips these
                                           # in the live view, :519-520 — we
                                           # draw them; parity quirk doc'd)
    agent_colors: tuple = ((255, 120, 90), (90, 200, 255), (170, 255, 120),
                           (255, 210, 80), (220, 130, 255), (130, 255, 220))
    path_dim: float = 0.45                 # path = dimmed agent color
    robot: tuple = (255, 255, 255)
    zone: tuple = (255, 80, 80)
    frontier: tuple = (255, 255, 0)


def _scatter_color(img, gx, gy, valid, color, size_px: int = 1):
    """Scatter `color` at integer pixel coords into img [H, W, 3]."""
    h, w, _ = img.shape
    col = jnp.asarray(color, img.dtype)
    offs = jnp.arange(-(size_px // 2), size_px // 2 + 1)
    for dy in offs:
        for dx in offs:
            px = gx + dx
            py = gy + dy
            ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
            flat = jnp.where(ok, py * w + px, h * w)
            img = img.reshape(-1, 3).at[flat].set(col, mode="drop") \
                     .reshape(h, w, 3)
    return img


def world_to_px(wx, wy, cfg: GridConfig, scale: int):
    """World metres -> image pixels. Row 0 = TOP of the image = max y
    (image convention; the grid itself is row=gy upward)."""
    gx = ((wx - cfg.origin_x) / cfg.resolution * scale).astype(jnp.int32)
    gy = ((wy - cfg.origin_y) / cfg.resolution * scale).astype(jnp.int32)
    return gx, (cfg.size * scale - 1) - gy


def render_map(grid, cfg: GridConfig = GridConfig(), scale: int = 2,
               points_xy=None, points_agent=None, points_valid=None,
               paths_xy=None, paths_agent=None, paths_valid=None,
               poses=None, poses_valid=None,
               zones=None, zones_active=None,
               frontiers=None, n_frontiers=None,
               theme: RenderTheme = RenderTheme()):
    """Composite one frame. All inputs optional beyond the grid.

    grid: [S, S] tri-state int8 (grid[gy, gx], like the reference).
    points_xy: [P, 2] world hits; points_agent: [P] 0-based (colors).
    paths_xy / paths_agent: [Q, 2]/[Q] trajectory samples.
    poses: [N, 3] robot (x, y, yaw) — drawn as a dot + heading tick.
    zones: [N, 4] AABBs, drawn as outlines where zones_active.
    frontiers: [K, 2] centroids, first n_frontiers drawn.
    Returns [S*scale, S*scale, 3] uint8.
    """
    s = grid.shape[0]
    # grid colormap, upscaled (kron with ones = pixel-doubling)
    base = jnp.asarray(theme.background, jnp.uint8)
    img = jnp.tile(base, (s, s, 1))
    img = jnp.where((grid == 0)[..., None],
                    jnp.asarray(theme.free, jnp.uint8), img)
    img = jnp.where((grid == 100)[..., None],
                    jnp.asarray(theme.occupied, jnp.uint8), img)
    img = img[::-1]                            # row 0 = max y
    if scale != 1:
        img = jnp.repeat(jnp.repeat(img, scale, 0), scale, 1)

    colors = jnp.asarray(theme.agent_colors, jnp.uint8)
    nc = colors.shape[0]

    if paths_xy is not None:
        px, py = world_to_px(paths_xy[:, 0], paths_xy[:, 1], cfg, scale)
        c = (colors[paths_agent % nc].astype(jnp.float32)
             * theme.path_dim).astype(jnp.uint8)
        valid = (jnp.ones(paths_xy.shape[0], bool)
                 if paths_valid is None else paths_valid)
        h, w, _ = img.shape
        ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        flat = jnp.where(ok, py * w + px, h * w)
        img = img.reshape(-1, 3).at[flat].set(c, mode="drop").reshape(h, w, 3)

    if points_xy is not None:
        px, py = world_to_px(points_xy[:, 0], points_xy[:, 1], cfg, scale)
        c = colors[points_agent % nc]
        valid = (jnp.ones(points_xy.shape[0], bool)
                 if points_valid is None else points_valid)
        h, w, _ = img.shape
        ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        flat = jnp.where(ok, py * w + px, h * w)
        img = img.reshape(-1, 3).at[flat].set(c, mode="drop").reshape(h, w, 3)

    if zones is not None:
        # AABB outlines as sampled edge points
        t = jnp.linspace(0.0, 1.0, 64)
        for i in range(zones.shape[0]):
            x0, y0, x1, y1 = zones[i, 0], zones[i, 1], zones[i, 2], zones[i, 3]
            ex = jnp.concatenate([x0 + t * (x1 - x0), x0 + t * (x1 - x0),
                                  jnp.full_like(t, x0), jnp.full_like(t, x1)])
            ey = jnp.concatenate([jnp.full_like(t, y0), jnp.full_like(t, y1),
                                  y0 + t * (y1 - y0), y0 + t * (y1 - y0)])
            gx, gy = world_to_px(ex, ey, cfg, scale)
            act = (zones_active[i] if zones_active is not None
                   else jnp.asarray(True))
            img = _scatter_color(img, gx, gy,
                                 jnp.full(ex.shape, act, bool), theme.zone)

    if frontiers is not None:
        k = frontiers.shape[0]
        idx = jnp.arange(k)
        nf = k if n_frontiers is None else n_frontiers
        gx, gy = world_to_px(frontiers[:, 0], frontiers[:, 1], cfg, scale)
        img = _scatter_color(img, gx, gy, idx < nf, theme.frontier,
                             size_px=3)

    if poses is not None:
        valid = (jnp.ones(poses.shape[0], bool)
                 if poses_valid is None else poses_valid)
        gx, gy = world_to_px(poses[:, 0], poses[:, 1], cfg, scale)
        img = _scatter_color(img, gx, gy, valid, theme.robot, size_px=3)
        # heading tick (reference draws oriented triangles, :585-600)
        for r in (2, 3, 4):
            tx = poses[:, 0] + r * cfg.resolution / scale * scale * jnp.cos(poses[:, 2])
            ty = poses[:, 1] + r * cfg.resolution / scale * scale * jnp.sin(poses[:, 2])
            hx, hy = world_to_px(tx, ty, cfg, scale)
            img = _scatter_color(img, hx, hy, valid, theme.robot)

    return img


def render_points(points_xy, points_agent, cfg: GridConfig = GridConfig(),
                  scale: int = 2, theme: RenderTheme = RenderTheme()):
    """Point-cloud-only view (generate_topdown_map.py:41-69 style)."""
    s = cfg.size
    img = jnp.tile(jnp.asarray(theme.background, jnp.uint8),
                   (s * scale, s * scale, 1))
    px, py = world_to_px(points_xy[:, 0], points_xy[:, 1], cfg, scale)
    colors = jnp.asarray(theme.agent_colors, jnp.uint8)
    c = colors[points_agent % colors.shape[0]]
    h, w, _ = img.shape
    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat = jnp.where(ok, py * w + px, h * w)
    return img.reshape(-1, 3).at[flat].set(c, mode="drop").reshape(h, w, 3)


def save_png(img, path: str) -> str:
    """Host-side PNG encode (the only non-array step): an 8-bit RGB image
    [H, W, 3] as one zlib-compressed IDAT chunk, no filtering."""
    import struct
    import zlib

    a = np.ascontiguousarray(np.asarray(img, np.uint8))
    h, w = a.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          a.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
    return path


def render_ascii(grid, x_slice=None, y_slice=None) -> str:
    """Terminal map view for quick diagnostics (chars: '.' unknown,
    ' ' free, '#' occupied)."""
    g = np.asarray(grid)
    if y_slice:
        g = g[y_slice]
    if x_slice:
        g = g[:, x_slice]
    chars = {-1: ".", 0: " ", 100: "#"}
    return "\n".join("".join(chars.get(int(v), "?") for v in row)
                     for row in g[::-1])

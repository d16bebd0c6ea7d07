"""World geometry: wall segments and batched exact ray casting.

The reference casts one ray against one segment at a time in Python
(simulation_tools/generate_fake_dual_session.py:67-90). Here a single fused
computation intersects *every* ray of *every* agent against *every* wall
segment at once — the [R, S] intersection tensor is pure elementwise work that XLA
fuses into the surrounding sensing step. Semantics match the reference
exactly: parallel rays rejected at |denom| < 1e-10, hits accepted for
t > 1e-3 and u in [0, 1], missing rays reported as 99.0 m
(generate_fake_dual_session.py:83-90).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Default bedroom: 6 m x 4 m rectangular hall, x in [-0.5, 5.5],
# y in [-2, 2]. Ref: generate_fake_dual_session.py:41-54.
BEDROOM_WALLS = np.array(
    [
        [-0.5, -2.0, 5.5, -2.0],   # bottom
        [5.5, -2.0, 5.5, 2.0],     # right
        [5.5, 2.0, -0.5, 2.0],     # top
        [-0.5, 2.0, -0.5, -2.0],   # left
    ],
    dtype=np.float32,
)

RAY_MISS = 99.0        # sentinel for "no wall within 50 m" (ref :90)
RAY_MAX_VALID = 50.0


def make_rect_room(x0: float, y0: float, x1: float, y1: float) -> np.ndarray:
    """Axis-aligned rectangular room as 4 wall segments [4, 4]."""
    return np.array(
        [
            [x0, y0, x1, y0],
            [x1, y0, x1, y1],
            [x1, y1, x0, y1],
            [x0, y1, x0, y0],
        ],
        dtype=np.float32,
    )


def make_multi_room(n_rooms: int, room_w: float = 6.0, room_h: float = 4.0,
                    gap: float = 2.0, per_row: int = 32) -> np.ndarray:
    """Tile n_rooms copies of the bedroom on a grid — the world for large
    swarms (64 / 1024 agents). Each room hosts a sub-swarm; segments stay a
    single flat [S, 4] array so ray casting stays one batched op."""
    rooms = []
    for i in range(n_rooms):
        r, c = divmod(i, per_row)
        ox = c * (room_w + gap)
        oy = r * (room_h + gap)
        rooms.append(make_rect_room(ox - 0.5, oy - 2.0,
                                    ox + room_w - 0.5, oy + room_h - 2.0))
    return np.concatenate(rooms, axis=0)


TILE_ROWS = 128          # grid-tile room pitch (cells): 6.4 m x 12.8 m
TILE_COLS = 256


def make_tiled_rooms(n_rooms: int, per_row: int, res: float = 0.05,
                     room_w: float = 6.0, room_h: float = 4.0):
    """Rooms laid out so each room sits inside ONE [TILE_ROWS, TILE_COLS]
    grid tile (origin at world (0,0)) — rooms never straddle a tile
    border, so whole tile rows (or tiles) can be owned by one device of
    the sharded engine. Returns (walls [n_rooms*4, 4], room_origin_xy [n_rooms, 2])."""
    pitch_x = TILE_COLS * res
    pitch_y = TILE_ROWS * res
    mx = (pitch_x - room_w) / 2.0
    my = (pitch_y - room_h) / 2.0
    rooms = []
    origins = []
    for i in range(n_rooms):
        r, c = divmod(i, per_row)
        ox = c * pitch_x
        oy = r * pitch_y
        rooms.append(make_rect_room(ox + mx, oy + my,
                                    ox + mx + room_w, oy + my + room_h))
        origins.append((ox + mx, oy + my))
    return (np.concatenate(rooms, axis=0),
            np.asarray(origins, np.float32))


def make_tiled_rooms_blocks(dev_rows: int, dev_cols: int, size: int,
                            res: float = 0.05, room_w: float = 6.0,
                            room_h: float = 4.0):
    """Tiled rooms emitted in DEVICE-MAJOR order for a (dev_rows x
    dev_cols) tile mesh over a [size, size] grid: device (dr, dc) owns
    the contiguous block of room tiles inside its grid tile, and rooms
    are listed device by device, so the natural agent order (agents
    2k, 2k+1 -> room k) lands each device's agent block inside its own
    tile — the layout the 2-D "tiles" grid decomposition's static
    containment proof requires. Returns (walls [n_rooms*4, 4],
    origins [n_rooms, 2]); n_rooms = (size/128) * (size/256)."""
    tiles_r, tiles_c = size // TILE_ROWS, size // TILE_COLS
    if tiles_r % dev_rows or tiles_c % dev_cols:
        raise ValueError(f"{tiles_r}x{tiles_c} room tiles do not split "
                         f"over a ({dev_rows}, {dev_cols}) device grid")
    k_r, k_c = tiles_r // dev_rows, tiles_c // dev_cols
    pitch_x, pitch_y = TILE_COLS * res, TILE_ROWS * res
    mx, my = (pitch_x - room_w) / 2.0, (pitch_y - room_h) / 2.0
    rooms, origins = [], []
    for dr in range(dev_rows):
        for dc in range(dev_cols):
            for jr in range(k_r):
                for jc in range(k_c):
                    tr, tc = dr * k_r + jr, dc * k_c + jc
                    ox, oy = tc * pitch_x, tr * pitch_y
                    rooms.append(make_rect_room(ox + mx, oy + my,
                                                ox + mx + room_w,
                                                oy + my + room_h))
                    origins.append((ox + mx, oy + my))
    return np.concatenate(rooms, axis=0), np.asarray(origins, np.float32)


def walls_by_group(walls: np.ndarray, segs_per_group: int = 4) -> np.ndarray:
    """[S, 4] flat segments -> [G, segs_per_group, 4] grouped view for
    culled casting (rooms are emitted contiguously by make_multi_room)."""
    s = walls.shape[0]
    assert s % segs_per_group == 0
    return walls.reshape(s // segs_per_group, segs_per_group, 4)


def agent_room_boxes(walls_grouped, room_of_agent) -> np.ndarray:
    """Per-agent room AABB in world meters: [N, 4] (x0, y0, x1, y1).
    Trace-free numpy on the closure-constant geometry; used to restrict
    frontier-target assignment to reachable (same-room) frontiers."""
    wg = np.asarray(walls_grouped)
    roa = np.asarray(room_of_agent)
    xs = wg[..., [0, 2]].reshape(wg.shape[0], -1)
    ys = wg[..., [1, 3]].reshape(wg.shape[0], -1)
    return np.stack([xs.min(1)[roa], ys.min(1)[roa],
                     xs.max(1)[roa], ys.max(1)[roa]], -1).astype(np.float32)


def cast_rays_grouped(origins, angles, walls_grouped, group_of_ray):
    """Culled ray casting: each ray intersects only its own group's
    segments — exact when groups are closed rooms (no cross-room
    visibility), and O(segs_per_group) instead of O(all segments).

    origins: [..., 2]; angles: [...]; walls_grouped: [G, S_g, 4];
    group_of_ray: [...] int32. Returns [...] distances (RAY_MISS on miss).
    """
    walls = walls_grouped[group_of_ray]           # [..., S_g, 4]
    dx = jnp.cos(angles)
    dy = jnp.sin(angles)
    sx1 = walls[..., 0]
    sy1 = walls[..., 1]
    dsx = walls[..., 2] - sx1
    dsy = walls[..., 3] - sy1
    ox = origins[..., 0:1]
    oy = origins[..., 1:2]
    dxe = dx[..., None]
    dye = dy[..., None]
    denom = dxe * dsy - dye * dsx
    rx = sx1 - ox
    ry = sy1 - oy
    safe = jnp.where(jnp.abs(denom) < 1e-10, 1.0, denom)
    t = (rx * dsy - ry * dsx) / safe
    u = (rx * dye - ry * dxe) / safe
    valid = (jnp.abs(denom) >= 1e-10) & (t > 1e-3) & (u >= 0.0) & (u <= 1.0)
    d = jnp.min(jnp.where(valid, t, jnp.inf), axis=-1)
    return jnp.where(d < RAY_MAX_VALID, d, RAY_MISS)


def ray_segment_t(ox, oy, dx, dy, walls):
    """Parametric hit distances of rays against every wall segment.

    ox, oy, dx, dy: [...] ray origins and unit directions (broadcastable).
    walls: [S, 4] segments as (x1, y1, x2, y2).
    Returns t: [..., S] with +inf where the ray misses that segment.

    Matches generate_fake_dual_session.py:67-80: rejects |denom| < 1e-10,
    requires t > 0.001 and 0 <= u <= 1.
    """
    sx1, sy1 = walls[:, 0], walls[:, 1]
    dsx = walls[:, 2] - sx1
    dsy = walls[:, 3] - sy1

    ox = ox[..., None]
    oy = oy[..., None]
    dx = dx[..., None]
    dy = dy[..., None]

    denom = dx * dsy - dy * dsx
    rx = sx1 - ox
    ry = sy1 - oy
    # Guard the division; invalid lanes are masked out below.
    safe = jnp.where(jnp.abs(denom) < 1e-10, 1.0, denom)
    t = (rx * dsy - ry * dsx) / safe
    u = (rx * dy - ry * dx) / safe

    valid = (jnp.abs(denom) >= 1e-10) & (t > 1e-3) & (u >= 0.0) & (u <= 1.0)
    return jnp.where(valid, t, jnp.inf)


def cast_rays(origins, angles, walls):
    """Distance to the nearest wall for each ray.

    origins: [..., 2] world positions; angles: [...] world headings.
    Returns [...] distances, RAY_MISS (99.0) where nothing is hit within
    50 m (ref cast_ray, generate_fake_dual_session.py:83-90).
    """
    dx = jnp.cos(angles)
    dy = jnp.sin(angles)
    t = ray_segment_t(origins[..., 0], origins[..., 1], dx, dy, walls)
    d = jnp.min(t, axis=-1)
    return jnp.where(d < RAY_MAX_VALID, d, RAY_MISS)


def make_vertical_rooms(n_rooms: int):
    """One tiled room per grid-tile ROW (per_row=1): room r occupies tile
    row r, so an n_rooms-device mesh can own one 128-row band each — the
    canonical layout for spatially row-sharded grids (parallel.sharded
    grid_sharding="rows"). Returns (walls [n_rooms*4, 4],
    origins [n_rooms, 2], grid_size)."""
    walls, origins = make_tiled_rooms(n_rooms, per_row=1)
    size = -(-max(256, n_rooms * TILE_ROWS) // 256) * 256
    return walls, origins, size

"""Occupancy-grid rasterisation kernels.

Two modes, per the north star:

* `parity_raster` — bit-comparable to the CPU reference. The reference
  applies rays strictly in packet order with last-write-wins cell semantics
  (`update_ray`, dual_bot_mapper.py:136-156: path cells FREE, endpoint
  OCCUPIED if the hit passed the trust filter). A naive parallel scatter
  would be order-nondeterministic; instead we scatter-MAX each write's
  global sequence id into two planes (free-writes, occupied-writes) — an
  associative, deterministic reduction — and reconstruct the final state:
  a cell is OCCUPIED iff the latest write touching it was an endpoint write
  (ties impossible across rays; within a ray the endpoint is written last,
  so OCCUPIED wins ties at equal sequence id).

* `logodds_raster` — the high-throughput path: order-independent
  scatter-add of log-odds evidence (+hit at endpoints, -miss along paths),
  clamped. The tri-state parity view is a threshold of this accumulator.

Both consume the same [R]-batched ray description and use the shared
Bresenham traversal.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from swarm_tpu.config import GridConfig
from swarm_tpu.ops.bresenham import bresenham_cells


def world_to_grid(wx, wy, cfg: GridConfig):
    """World -> cell indices with the reference's int() truncation-toward-zero
    semantics (dual_bot_mapper.py:121-125)."""
    gx = ((wx - cfg.origin_x) / cfg.resolution).astype(jnp.int32)
    gy = ((wy - cfg.origin_y) / cfg.resolution).astype(jnp.int32)
    return gx, gy


def grid_to_world(gx, gy, cfg: GridConfig):
    """Cell centre (dual_bot_mapper.py:127-131). Accepts float indices the
    way `cluster_centroid_world` passes fractional centroids (:233-237)."""
    wx = cfg.origin_x + (gx + 0.5) * cfg.resolution
    wy = cfg.origin_y + (gy + 0.5) * cfg.resolution
    return wx, wy


class RayBatch(NamedTuple):
    """An ordered batch of rays, the engine's unit of mapping work.

    ox, oy: [R] robot world position; hx, hy: [R] ray end world position
    (either a trusted hit or the max-range free-space probe,
    dual_bot_mapper.py:886-903); hit_valid: [R] bool; active: [R] bool
    (masks padding / offline agents)."""
    ox: jnp.ndarray
    oy: jnp.ndarray
    hx: jnp.ndarray
    hy: jnp.ndarray
    hit_valid: jnp.ndarray
    active: jnp.ndarray


def _traced_cells(rays: RayBatch, cfg: GridConfig, k_max: int):
    x0, y0 = world_to_grid(rays.ox, rays.oy, cfg)
    x1, y1 = world_to_grid(rays.hx, rays.hy, cfg)
    cx, cy, valid, endpoint = bresenham_cells(x0, y0, x1, y1, k_max)
    in_bounds = (cx >= 0) & (cx < cfg.size) & (cy >= 0) & (cy < cfg.size)
    valid = valid & in_bounds & rays.active[..., None]
    free = valid & ~endpoint
    occ = valid & endpoint & rays.hit_valid[..., None]
    flat = cy * cfg.size + cx      # row-major (gy, gx), ref grid[gy, gx]
    return flat, free, occ


def parity_raster(grid, rays: RayBatch, cfg: GridConfig = GridConfig(),
                  k_max: int = 32):
    """Apply an ordered ray batch to the tri-state grid, reproducing the
    reference's sequential cell states exactly.

    grid: [size, size] int8 tri-state (gy, gx). Returns the updated grid and
    the number of real cell writes (the benchmark's cell-update count).
    """
    flat, free, occ = _traced_cells(rays, cfg, k_max)
    r = jnp.shape(flat)[0]
    seq = jnp.arange(r, dtype=jnp.int32)[:, None]
    seq = jnp.broadcast_to(seq, flat.shape)

    ncells = cfg.size * cfg.size
    neg = jnp.full((ncells,), -1, jnp.int32)
    flat_r = flat.reshape(-1)
    free_seq = neg.at[flat_r].max(
        jnp.where(free, seq, -1).reshape(-1), mode="drop")
    occ_seq = neg.at[flat_r].max(
        jnp.where(occ, seq, -1).reshape(-1), mode="drop")

    touched = jnp.maximum(free_seq, occ_seq) >= 0
    # Within a ray the endpoint write happens after the path writes, so at
    # equal sequence id OCCUPIED wins (>=).
    new_flat = jnp.where(
        touched,
        jnp.where(occ_seq >= free_seq, cfg.occupied, cfg.free),
        grid.reshape(-1).astype(jnp.int32))
    writes = jnp.sum(free) + jnp.sum(occ)
    return new_flat.reshape(cfg.size, cfg.size).astype(grid.dtype), writes


def logodds_delta(rays: RayBatch, cfg: GridConfig = GridConfig(),
                  k_max: int = 32, dtype=jnp.float32, band=None,
                  band_cols=None):
    """Unclamped log-odds evidence of one ray batch, scatter-added into a
    fresh [size, size] grid. Additive and order-independent, so shards can
    compute local deltas and `psum` them over the mesh — the sharded
    replacement for funnelling all packets to one server socket
    (dual_bot_mapper.py:814-824). Returns (delta, writes).

    band=(row_offset, n_rows): restrict to a horizontal grid band and
    return a [n_rows, size] delta — the spatially-sharded grid path
    (each shard owns a band; evidence outside it is dropped AND counted
    out of `writes`, so callers with band-contained evidence get
    identical totals). band_cols=(col_offset, n_cols) restricts columns
    the same way — together they select a 2-D tile window (the tiles+halo
    grid decomposition, parallel.sharded grid_sharding='tiles')."""
    flat, free, occ = _traced_cells(rays, cfg, k_max)
    if band is not None or band_cols is not None:
        row_off, n_rows = band if band is not None else (0, cfg.size)
        col_off, n_cols = band_cols if band_cols is not None \
            else (0, cfg.size)
        row = flat // cfg.size
        col = flat - row * cfg.size
        inb = (row >= row_off) & (row < row_off + n_rows) & \
            (col >= col_off) & (col < col_off + n_cols)
        free = free & inb
        occ = occ & inb
        flat = (row - row_off) * n_cols + (col - col_off)
    else:
        n_rows = n_cols = cfg.size
    delta = jnp.where(occ, cfg.logodds_hit,
                      jnp.where(free, cfg.logodds_miss, 0.0)).astype(dtype)
    flat_r = jnp.where((free | occ), flat, 0).reshape(-1)
    out = jnp.zeros((n_rows * n_cols,), dtype).at[flat_r].add(
        delta.reshape(-1), mode="drop")
    writes = jnp.sum(free) + jnp.sum(occ)
    return out.reshape(n_rows, n_cols), writes


def logodds_raster(logodds, rays: RayBatch, cfg: GridConfig = GridConfig(),
                   k_max: int = 32):
    """Order-independent log-odds evidence accumulation (throughput path).

    logodds: [size, size] float32. Returns (new_logodds, writes)."""
    delta, writes = logodds_delta(rays, cfg, k_max, logodds.dtype)
    upd = jnp.clip(logodds + delta, -cfg.logodds_clamp, cfg.logodds_clamp)
    return upd, writes


# Canonical tri-state thresholds — import these instead of re-stating the
# literals (tools/bench_coverage.py measures FREE with the engine's own
# definition through FREE_THRESH; advisor r3 finding).
OCC_THRESH = 0.3
FREE_THRESH = -0.3


def tri_state_view(logodds, cfg: GridConfig = GridConfig(),
                   occ_thresh: float = OCC_THRESH,
                   free_thresh: float = FREE_THRESH):
    """Tri-state parity view of the log-odds accumulator."""
    out = jnp.full(logodds.shape, cfg.unknown, jnp.int8)
    out = jnp.where(logodds <= free_thresh, jnp.int8(cfg.free), out)
    out = jnp.where(logodds >= occ_thresh, jnp.int8(cfg.occupied), out)
    return out

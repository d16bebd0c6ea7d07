"""Order-free fast path of the fan raster (see beam_raster.free_raster_reference).

Every agent's fan is evaluated on a small square window around the agent,
all agents at once, and reduced to INTEGER per-cell crossing counts:

    n_free += cnt          on free cells      (r < r_b - 0.5)
    n_hit  += cnt * tf     on endpoint-ring cells (|r - r_b| <= 0.71)

where cnt is the line-equivalent number of beams crossing the cell. The
counts of all agents are summed with one int32 scatter-add, then ONE fused
pass applies ``clip(lo + miss * n_free + hit * n_hit)``. Integer addition
is associative, so the map bits do not depend on the order in which the
windows are added: run after run on a GPU, and across the replicated, rows
and tiles decompositions (their collectives move the same integer counts).
The grid is clamped once per fan per step.

Count scale. On the per-beam tier (n_groups == n_beams) cnt is an integer
and the trusted flag tf is 0/1, so the counts are exact at scale 1. The
grouped tier (n_groups < n_beams) carries a fractional trusted fraction
(k of `per` beams) and a weak tail carve of weight `tail_weight`; both are
exact in fixed point at scale q = 4 * per when tail_weight is a multiple of
1/4 (the default is 0.25).

Cell coordinates are GLOBAL in every decomposition (band/band_cols only
place the window inside a local row band or 2-D tile), so the float math of
a cell is the same whichever array it lands in.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from swarm_tpu.config import GridConfig
from swarm_tpu.ops.beam_raster import (BeamSpec, REACH_CELLS,
                                       group_range_stats,
                                       quantize_ranges_cells,
                                       quantize_ranges_cells8)

TAIL_QUANT = 4          # tail weights are exact multiples of 1/TAIL_QUANT


def window_size(reach: int) -> int:
    """Side of the square per-agent window. Evidence is limited to
    r <= reach, so every painted cell lies in [floor(a) - reach,
    floor(a) + reach] along each axis."""
    return 2 * reach + 1


def count_scale(spec: BeamSpec, n_groups: int) -> int:
    """Fixed-point scale of the counts: 1 on the per-beam tier, 4 * beams
    per group on the grouped tier."""
    if n_groups >= spec.n_beams:
        return 1
    return TAIL_QUANT * (-(-spec.n_beams // n_groups))


def _window_origin(a_cell, win: int, reach: int, off, n):
    """Global window origin along one axis: floor(agent) - reach, clamped
    into the target's global interval [off, off + n - win]."""
    o = jnp.floor(a_cell).astype(jnp.int32) - reach
    return jnp.clip(o, off, off + n - win)


def _tables(dist_m, trusted, spec: BeamSpec, cfg: GridConfig, n_groups: int,
            pack8: bool):
    """Per-agent lookup tables [N, G]: (carve range, tail range, ring
    weight) — ranges in cells, ring weight in count units."""
    quant = quantize_ranges_cells8 if pack8 else quantize_ranges_cells
    ranges = quant(dist_m / cfg.resolution)
    n = ranges.shape[0]
    if n_groups >= spec.n_beams:
        rb = ranges
        rt = ranges                     # tail carve is empty per beam
        ring = (jnp.zeros(ranges.shape, jnp.int32) if trusted is None
                else trusted.astype(jnp.int32))
        return rb, rt, ring
    per = -(-spec.n_beams // n_groups)
    rb, rt = group_range_stats(ranges, n_groups)
    if trusted is None:
        ring = jnp.zeros((n, n_groups), jnp.int32)
    else:
        t = jnp.pad(trusted.astype(jnp.int32),
                    ((0, 0), (0, n_groups * per - spec.n_beams)))
        ring = TAIL_QUANT * t.reshape(n, n_groups, per).sum(-1)
    return rb, rt, ring


def _cell_counts(cy, cx, ax, ay, yaw, act, rb_g, rt_g, rw_g, *,
                 spec: BeamSpec, n_groups: int, reach: int, q: int,
                 w_tail: int, paint_hits: bool, grid_guard: int):
    """Free and ring counts (int32, scale q) of the cells at global centres
    (cy, cx) for one agent at (ax, ay, yaw) in cells, whose tables [G] are
    rb_g (carve range), rt_g (tail range) and rw_g (ring weight)."""
    group_dtheta = spec.dtheta * (-(-spec.n_beams // n_groups))
    dx = cx - ax
    dy = cy - ay
    r = jnp.sqrt(dx * dx + dy * dy)
    theta = jnp.arctan2(dy, dx)
    rel = (theta - yaw - spec.theta0 - group_dtheta / 2.0
           + spec.dtheta / 2.0)
    rel = (rel + jnp.pi) % (2 * jnp.pi) - jnp.pi
    g = jnp.floor(rel / group_dtheta + 0.5).astype(jnp.int32)
    if spec.wrap:
        g = jnp.mod(g, n_groups)
        in_fan = r >= 0.0
    else:
        in_fan = (rel >= -group_dtheta / 2.0) & \
            (rel < (n_groups - 0.5) * group_dtheta)
        g = jnp.clip(g, 0, n_groups - 1)
    resid = rel - g.astype(jnp.float32) * group_dtheta
    rb = rb_g[g]
    rinv = 1.0 / jnp.maximum(r, 1e-3)
    covered = rinv >= spec.dtheta * 0.999
    cnt = jnp.maximum(1.0, jnp.round(rinv / spec.dtheta)).astype(
        jnp.int32) * act
    on_any = covered | (jnp.abs(r * resid) <= 0.6)
    base_ok = in_fan & on_any & (r > 1e-3) & (r <= reach)
    if grid_guard:
        # tile windows can extend past the GLOBAL grid at edge tiles; the
        # halo merge discards those ghost cells, so they paint nothing
        base_ok = base_ok & (cy >= 0.0) & (cy < grid_guard) & \
            (cx >= 0.0) & (cx < grid_guard)
    free = base_ok & (r < rb - 0.5)
    n_free = jnp.where(free, cnt * q, 0)
    if w_tail:
        tail = base_ok & ~free & (r < rt_g[g] - 0.5)
        n_free = n_free + jnp.where(tail, cnt * w_tail, 0)
    if paint_hits:
        on_ring = base_ok & (jnp.abs(r - rb) <= 0.71)
        n_hit = jnp.where(on_ring, cnt * rw_g[g], 0)
    else:
        n_hit = jnp.zeros_like(n_free)
    return n_free, n_hit


def fan_counts(shape, agent_xy, yaw, dist_m, active, spec: BeamSpec,
               cfg: GridConfig = GridConfig(), n_groups: int = 16,
               trusted=None, reach: int = REACH_CELLS,
               tail_weight: float = 0.0, band=None, band_cols=None,
               pack8: bool = False):
    """Integer crossing counts of one fan for all agents, summed over agents.

    shape: (rows, cols) of the target array — the full grid, a row band
    (band=(global_row_offset, rows)) or an extended tile (plus
    band_cols=(global_col_offset, cols)); offsets may be traced.
    trusted [N, B] turns on endpoint-ring painting. pack8 quantizes ranges
    to 1/4 cell (clipped at 31.75 cells) instead of 1/256 cell.

    Returns (n_free, n_hit, painted): two [rows, cols] int32 count planes
    at scale count_scale(spec, n_groups) (n_hit is None without
    `trusted`) and each agent's painted count [N] float32 — its
    line-equivalent cell updates (free, tail and ring cells), an integer
    on the per-beam tier."""
    if pack8 and reach > 31:
        # hard error (not assert — must survive `python -O`): clipping
        # ranges at 31.75 cells would silently under-carve free space
        raise ValueError(
            f"pack8 range field (31.75 cells) cannot cover the beam "
            f"reach ({reach} cells); use --no-pack8 or a shorter "
            f"sensors.max_range")
    n_groups = min(n_groups, spec.n_beams)
    q = count_scale(spec, n_groups)
    if n_groups < spec.n_beams:
        if tail_weight * TAIL_QUANT != round(tail_weight * TAIL_QUANT):
            raise ValueError(f"tail_weight {tail_weight} is not a multiple "
                             f"of 1/{TAIL_QUANT}")
        w_tail = round(tail_weight * TAIL_QUANT) * (q // TAIL_QUANT)
    else:
        w_tail = 0
    paint_hits = trusted is not None
    rows, cols = shape
    row_off = 0 if band is None else band[0]
    col_off = 0 if band_cols is None else band_cols[0]
    win = window_size(reach)
    wr, wc = min(win, rows), min(win, cols)

    res = cfg.resolution
    ax = (agent_xy[:, 0] - cfg.origin_x) / res
    ay = (agent_xy[:, 1] - cfg.origin_y) / res
    r0 = _window_origin(ay, wr, reach, row_off, rows)
    c0 = _window_origin(ax, wc, reach, col_off, cols)
    rb, rt, ring_w = _tables(dist_m, trusted, spec, cfg, n_groups, pack8)

    cell_kw = dict(spec=spec, n_groups=n_groups, reach=reach, q=q,
                   w_tail=w_tail, paint_hits=paint_hits,
                   grid_guard=cfg.size if band_cols is not None else 0)

    def one(a, b, y, act, r0_a, c0_a, rb_a, rt_a, rw_a):
        cy = (r0_a + jax.lax.broadcasted_iota(jnp.int32, (wr, wc), 0)
              ).astype(jnp.float32) + 0.5
        cx = (c0_a + jax.lax.broadcasted_iota(jnp.int32, (wr, wc), 1)
              ).astype(jnp.float32) + 0.5
        return _cell_counts(cy, cx, a, b, y, act, rb_a, rt_a, rw_a,
                            **cell_kw)

    nf, nh = jax.vmap(one)(ax, ay, yaw, active.astype(jnp.int32), r0, c0,
                           rb, rt, ring_w)
    painted = (nf.sum((1, 2)) + nh.sum((1, 2))).astype(jnp.float32) \
        * jnp.float32(1.0 / q)
    starts = jnp.stack([r0 - row_off, c0 - col_off], axis=-1)
    dnums = jax.lax.ScatterDimensionNumbers(
        update_window_dims=(1, 2), inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0, 1))

    def scatter(upd):
        # int32 scatter-add of every agent's window: order-free
        return jax.lax.scatter_add(
            jnp.zeros((rows, cols), jnp.int32), starts, upd, dnums,
            mode=jax.lax.GatherScatterMode.CLIP)

    return (scatter(nf), scatter(nh) if paint_hits else None, painted)


def apply_counts(logodds, n_free, n_hit, cfg: GridConfig, q: int = 1):
    """One fused pass: clip(lo + (miss * n_free + hit * n_hit) / q), with
    the sum taken in float32 and stored in the grid's dtype."""
    d = n_free.astype(jnp.float32) * jnp.float32(cfg.logodds_miss / q)
    if n_hit is not None:
        d = d + n_hit.astype(jnp.float32) * jnp.float32(cfg.logodds_hit / q)
    return jnp.clip(logodds.astype(jnp.float32) + d, -cfg.logodds_clamp,
                    cfg.logodds_clamp).astype(logodds.dtype)


def free_raster_fast(logodds, agent_xy, yaw, dist_m, active, spec: BeamSpec,
                     cfg: GridConfig = GridConfig(), n_groups: int = 16,
                     trusted=None, reach: int = REACH_CELLS,
                     tail_weight: float = 0.0, band=None, band_cols=None,
                     pack8: bool = False):
    """Fan counts applied to `logodds` (see fan_counts). Returns
    (new_logodds, painted [N] float32)."""
    n_groups = min(n_groups, spec.n_beams)
    q = count_scale(spec, n_groups)
    n_free, n_hit, painted = fan_counts(
        logodds.shape, agent_xy, yaw, dist_m, active, spec, cfg,
        n_groups=n_groups, trusted=trusted, reach=reach,
        tail_weight=tail_weight, band=band, band_cols=band_cols,
        pack8=pack8)
    return apply_counts(logodds, n_free, n_hit, cfg, q), painted

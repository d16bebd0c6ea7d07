"""Polar beam-model occupancy update — the scatter-free raster path.

The line-raster path (`ops.raster.logodds_delta`) scatter-adds every
ray-cell individually. This module exploits the sensor geometry instead:
ALL of an agent's beams share one origin and are UNIFORM in angle (4-way ultrasonics at 90 deg spacing,
AgentFirmware_Bot1.ino:26-34; the 181-beam servo sweep at 1 deg,
esp32_firmware/src/main.cpp:33), so the update of each cell in the agent's
reach is a pure function of the cell's polar coordinates and that beam's
measured range — the classic inverse sensor model:

    r_c, theta_c = polar(cell - agent)
    b            = nearest beam to theta_c
    on_beam      = |r_c * sin(theta_c - theta_b)| <= 0.5 cell
    FREE  if on_beam and r_c < R_b - 0.5
    HIT   if on_beam and |r_c - R_b| <= 0.5 and beam trusted

Per agent this is a dense [ROWS, COLS] vectorized computation over a local
patch around the agent; the patch then read-modify-writes the global grid.
`beam_raster_reference` (nearest-beam evidence) and `free_raster_reference`
(line-equivalent crossing counts, the semantics of the fast path) add the
agents' patches one after another — the plain references. The order-free
fast path is ops/fast_raster.py.

Semantics vs the line raster: each cell in reach is updated ONCE per agent
per step (by its nearest beam) instead of once per crossing ray — an
equally valid evidence model (it is the standard lidar one), kept as a
separate mode (`raster_mode="beam"`, `EngineConfig.fast_raster`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp

from swarm_tpu.config import GridConfig

PATCH_ROWS = 80         # legacy defaults (patch_dims computes from reach)
PATCH_COLS = 384
REACH_CELLS = 26        # max beam reach: 1.2 m trust / 5 cm + ring margin

# Beam ranges are quantized to 1/256 cell (0.2 mm at the 5 cm grid) and
# clipped to < 128 cells (6.4 m — 5x the 1.2 m sensor trust range) before
# ANY fast-tier carve, identically in the fast path and the reference
# (tests/test_beam_raster.py::test_banded_window_kernel_bit_exact). Both
# the quantization step and the 2^-8 scale are exact in float32, and
# round() is monotone, so group minima/medians of quantized ranges ==
# quantized group minima/medians.
RANGE_QUANT = 256.0
RANGE_MAX_CELLS = 127.0 + 255.0 / 256.0

# Coarse quantization (EngineConfig.beam_pack8): ranges in 1/4-cell fixed
# point (<= 1/8-cell = 6 mm quantization error vs the 0.5-cell carve
# margin), clipped below 32 cells. 1/4 cell is an exact multiple of the
# 1/256-cell shared quant, so pre-quantizing ranges with
# quantize_ranges_cells8 reproduces the coarse tier bit-exactly
# (tests/test_beam_raster.py::test_pack8_*).
RANGE_QUANT8 = 4.0
RANGE_MAX_CELLS8 = 31.0 + 3.0 / 4.0


def quantize_ranges_cells(ranges_cells):
    """Quantize beam ranges (cells) to the shared fast-tier fixed point."""
    return jnp.round(jnp.clip(ranges_cells, 0.0, RANGE_MAX_CELLS)
                     * RANGE_QUANT) * jnp.float32(1.0 / RANGE_QUANT)


def quantize_ranges_cells8(ranges_cells):
    """Quantize beam ranges (cells) to the 8-bit quad-packed fixed point
    (1/4 cell, clipped to < 32 cells — covers the 28-cell scan reach)."""
    return jnp.round(jnp.clip(ranges_cells, 0.0, RANGE_MAX_CELLS8)
                     * RANGE_QUANT8) * jnp.float32(1.0 / RANGE_QUANT8)


@dataclasses.dataclass(frozen=True)
class BeamSpec:
    """A uniform fan of beams: world angle of beam b = yaw + theta0 +
    b * dtheta."""
    n_beams: int
    theta0: float          # first beam, relative to heading
    dtheta: float          # spacing
    wrap: bool             # True: fan covers the full circle (4-way)

    @staticmethod
    def four_way() -> "BeamSpec":
        # front, left, back, right (sensors.SensorConfig.angles order)
        return BeamSpec(n_beams=4, theta0=0.0, dtheta=math.pi / 2, wrap=True)

    @staticmethod
    def scan(n: int = 181) -> "BeamSpec":
        return BeamSpec(n_beams=n, theta0=-math.pi / 2,
                        dtheta=math.pi / (n - 1), wrap=False)


def reach_cells(cfg) -> int:
    """Evidence reach in cells for a SwarmConfig: sensor range + the
    endpoint-ring margin. THE single definition — the engine, the sharded
    body, and the band-containment validator must all use the same value
    or the window/dense-fan assumptions silently diverge."""
    import math as _math
    return int(_math.ceil(cfg.sensors.max_range / cfg.grid.resolution)) + 2


def patch_dims(size: int, reach: int = REACH_CELLS,
               row_align: int = 8) -> Tuple[int, int]:
    """Agent-window shape guaranteeing >= `reach` cells of margin on every
    side with ALIGNED origins (rows `row_align`, cols 128):
    rows = roundup(2*reach + align, align), cols = roundup(2*reach + 128,
    128) — [64, 256] for the default 1.2 m sonar reach. Small grids
    (< 512) span the full width instead."""
    rows = min(-(-(2 * reach + row_align) // row_align) * row_align,
               (size // row_align) * row_align)
    if size < 512:
        cols = size
    else:
        cols = min(-(-(2 * reach + 128) // 128) * 128,
                   (size // 128) * 128)
    return rows, cols


def patch_origin(ax_cell, ay_cell, size: int,
                 rows: int = 64, cols: int = 256,
                 reach: int = REACH_CELLS, n_rows: int = None,
                 n_cols: int = None, row_align: int = 8,
                 row_off: int = 0, col_off: int = 0):
    """Aligned window origin (row0, col0): floor-based asymmetric placement
    origin = align_down(agent - reach) guarantees >= reach margin on the
    low side by construction and >= reach on the high side by the
    patch_dims sizing; clamped to the grid (or, when the target is a
    band / tile window, into the window's GLOBAL capacity interval
    [row_off, row_off + n_rows - rows] — ax/ay arrive in GLOBAL cells
    and the returned origin is GLOBAL too; the caller subtracts the
    integer offset only at the dynamic-slice start, so every FLOAT
    expression downstream is decomposition-invariant)."""
    w = size if n_cols is None else n_cols
    row0 = ((jnp.floor(ay_cell).astype(jnp.int32) - reach)
            // row_align) * row_align
    row0 = jnp.clip(row0, row_off,
                    row_off + (size if n_rows is None else n_rows) - rows)
    if cols >= w:
        col0 = jnp.full_like(row0, col_off)
    else:
        col0 = ((jnp.floor(ax_cell).astype(jnp.int32) - reach) // 128) * 128
        col0 = jnp.clip(col0, col_off, col_off + w - cols)
    return row0, col0


def _patch_delta(ax, ay, yaw, ranges_cells, trusted, row0, col0,
                 spec: BeamSpec, hit: float, miss: float, max_range_cells,
                 rows_n: int = PATCH_ROWS, cols_n: int = PATCH_COLS):
    """Evidence delta for one agent's [PATCH_ROWS, PATCH_COLS] patch.

    ax, ay: agent position in CELL units (fractional, grid frame).
    ranges_cells: [B] measured ranges in cells (already range-limited).
    trusted: [B] bool — trust-window pass (endpoint evidence allowed).
    """
    rows = jax.lax.broadcasted_iota(jnp.int32, (rows_n, cols_n), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (rows_n, cols_n), 1)
    cy = (row0 + rows).astype(jnp.float32) + 0.5
    cx = (col0 + cols).astype(jnp.float32) + 0.5
    dx = cx - ax
    dy = cy - ay
    r = jnp.sqrt(dx * dx + dy * dy)
    theta = jnp.arctan2(dy, dx)

    rel = theta - yaw - spec.theta0
    rel = (rel + jnp.pi) % (2 * jnp.pi) - jnp.pi
    b_f = rel / spec.dtheta
    b = jnp.round(b_f).astype(jnp.int32)
    if spec.wrap:
        b = jnp.mod(b, spec.n_beams)
        in_fan = jnp.ones_like(r, dtype=bool)
    else:
        in_fan = (b >= 0) & (b < spec.n_beams)
        b = jnp.clip(b, 0, spec.n_beams - 1)

    rb = ranges_cells[b]                      # gather from [B] table
    tb = trusted[b]
    resid = rel - b.astype(jnp.float32) * spec.dtheta
    # Perpendicular half-width 0.6 and endpoint tolerance 0.71 (~cell
    # half-diagonal): a line passing exactly between two cell rows still
    # paints one of them, like the integer Bresenham does.
    on_beam = jnp.abs(r * jnp.sin(resid)) <= 0.6
    near = (r > 1e-3) & (r <= max_range_cells + 1.0) & in_fan & on_beam

    free = near & (r < rb - 0.5)
    occ = near & tb & (jnp.abs(r - rb) <= 0.71)
    return jnp.where(occ, hit, jnp.where(free, miss, 0.0)), free, occ


def beam_raster_reference(logodds, agent_xy, yaw, dist_m, trusted,
                          spec: BeamSpec, cfg: GridConfig = GridConfig(),
                          reach: int = REACH_CELLS):
    """XLA implementation: vmap the patch computation over agents, then
    sequentially add patches into the grid with dynamic-slice updates
    (a lax.scan of dense [80, 256] adds — no element scatter).

    agent_xy: [N, 2] world; yaw: [N]; dist_m: [N, B] measured (untrusted
    readings still limit free space at max_range); trusted: [N, B].
    Returns (new_logodds, writes).
    """
    res = cfg.resolution
    ax = (agent_xy[:, 0] - cfg.origin_x) / res
    ay = (agent_xy[:, 1] - cfg.origin_y) / res
    ranges_cells = dist_m / res
    pr, pc = patch_dims(cfg.size, reach)
    row0, col0 = patch_origin(ax, ay, cfg.size, pr, pc, reach)

    deltas, free, occ = jax.vmap(
        lambda a, b, y, rc, tr, r0, c0: _patch_delta(
            a, b, y, rc, tr, r0, c0, spec,
            cfg.logodds_hit, cfg.logodds_miss,
            jnp.max(rc), pr, pc))(ax, ay, yaw, ranges_cells, trusted,
                                  row0, col0)

    def add_one(g, args):
        d, r0, c0 = args
        patch = jax.lax.dynamic_slice(g, (r0, c0), (pr, pc))
        upd = (patch.astype(jnp.float32) + d).astype(g.dtype)
        g = jax.lax.dynamic_update_slice(g, upd, (r0, c0))
        return g, None

    out, _ = jax.lax.scan(add_one, logodds, (deltas, row0, col0))
    out = jnp.clip(out, -cfg.logodds_clamp,
                   cfg.logodds_clamp).astype(logodds.dtype)
    writes = jnp.sum(free) + jnp.sum(occ)
    return out, writes


def group_range_stats(ranges_cells, n_groups: int):
    """[N, B] per-beam ranges -> (carve [N, G], tail [N, G]) group range
    statistics for the fast free-space pass:

    carve = the group's SECOND-smallest range — full-strength free space.
      The plain minimum is hostile to the reference's 6 % spurious-short
      sensor noise (generate_fake_dual_session.py:100-108): ONE spurious
      beam collapses its whole sector's carve and sustains the phantom
      endpoint it painted. The second-min tolerates one outlier per group
      while staying conservative for real geometry (walls are continuous,
      so true minima have a similar-range neighbour); an isolated true
      short endpoint still survives via its +hit endpoint evidence
      (hit > |miss|).
    tail = the group's MEDIAN range — weak-evidence limit (see
      free_raster_reference `tail_weight`), robust to the same outliers.
    """
    n, b = ranges_cells.shape
    per = -(-b // n_groups)
    pad = n_groups * per - b
    r = jnp.pad(ranges_cells, ((0, 0), (0, pad)), mode="edge")
    s = jnp.sort(r.reshape(n, n_groups, per), axis=-1)
    carve = s[..., min(1, per - 1)]
    tail = s[..., per // 2]
    return carve, tail


def group_range_stats_rotated(ranges_cells, n_groups: int, phase,
                              tail_margin: float = 1.5):
    """Group range statistics with a ROTATED group partition: group g
    covers beams [phase + g*per, phase + (g+1)*per) (mod padded length).

    Rotating `phase` through [0, per) across steps (step % per) makes the
    group-min carve CONVERGE to the exact per-beam carve: a cell whose own
    beam reads r_b is under-carved only on phases where its group contains
    a shorter beam; every phase that excludes that beam carves it at full
    strength, so systematically under-carved cells (the r2 quality
    finding — IoU plateau ~0.75-0.83) accumulate to FREE over ~per
    observations at ZERO extra per-step cost. With rotation the carve is
    the plain group MIN (conservative: never carves past the nearest
    in-group wall; the legacy second-min outlier tolerance is no longer
    needed because a spurious-short beam only blanks the phases whose
    group contains it).

    Returns (carve [N, G], tail [N, G]) like `group_range_stats`; tail is
    the carve (window MIN) plus `tail_margin` cells — weak evidence that
    closes the NOISE annulus: the exact per-beam model marks boundary
    cells FREE on occasional noise-high readings (one miss crosses the
    tri-state threshold), while a window min is biased low by ~the noise
    sigma; the weak tail lets those cells accumulate over a few steps at
    a rate comparable to the exact model's own noise-driven carve, while
    staying anchored to the window min so it cannot carve through a
    nearby wall (a max- or median-based tail can, across an in-window
    depth discontinuity). `phase` may be traced (shapes static)."""
    n, b = ranges_cells.shape
    per = -(-b // n_groups)
    pad = n_groups * per - b
    r = jnp.pad(ranges_cells, ((0, 0), (0, pad)), mode="edge")
    r = jnp.roll(r, -phase, axis=1)
    mn = r.reshape(n, n_groups, per).min(axis=-1)
    return mn, mn + tail_margin


ROT_TAIL_MARGIN = 1.5   # cells past the window max (~2 sigma of the
#                         3.5 cm ultrasonic noise at 5 cm resolution)


def free_raster_reference(logodds, agent_xy, yaw, dist_m, active,
                          spec: BeamSpec, cfg: GridConfig = GridConfig(),
                          n_groups: int = 16,
                          line_equivalent: bool = True,
                          reach: int = REACH_CELLS, band=None,
                          band_cols=None, tail_weight: float = 0.25,
                          phase=None, trusted=None, pack8: bool = False):
    """Plain reference of the FAST free-space pass (what the fast path
    computes): free cells from GROUP-MIN ranges (conservative — never
    carves past the nearest wall in the sector), evidence scaled by the
    analytic beam-crossing count when line_equivalent. Endpoint hits are
    painted only as the ring below (`trusted`); otherwise the engine
    applies them exactly via the endpoint scatter. Returns (new_logodds,
    writes) where writes counts the line-equivalent ray-cell updates applied (tail cells at tail_weight).

    tail_weight > 0 adds WEAK free evidence (miss * tail_weight) in the
    annulus between the group min and the group MEAN range: the group-min
    carve alone leaves every cell between the sector's nearest wall and
    the per-beam ranges unobserved (free-space IoU vs the exact per-beam
    model plateaus ~0.75 — the r2 quality finding); the weak tail
    accumulates those cells to FREE over ~1/tail_weight observations
    while wall cells, repainted by endpoint hits (+hit per step), shrug
    off the occasional weak miss.

    phase (traced scalar or None) rotates the group partition by `phase`
    beams (see `group_range_stats_rotated`): cycling it across steps makes
    the group carve converge to the exact per-beam carve with no extra
    per-step cost. With phase set the carve is the rotated group MIN and
    the per-cell sector lookup goes through the cell's own BEAM index.

    trusted [N, B] paints the endpoint ring: cells with |r - r_g| <= 0.71
    get hit * cnt * tf, tf the trusted fraction of the group's beams (0/1
    per beam). pack8 quantizes ranges to 1/4 cell instead of 1/256 cell.
    Evidence is limited to r <= reach, so the result does not depend on
    where the window sits. Agents add their windows one after another in
    float32; the grid is clamped once at the end."""
    res = cfg.resolution
    # ax/ay stay GLOBAL in every decomposition. band=(row_offset_cells,
    # n_rows) / band_cols=(col_offset_cells, n_cols) say `logodds` is a
    # local row band / tile window of the global grid; the offset enters
    # ONLY through integer placement clamps and the integer slice start
    # below. Subtracting it from the float coords here (the old scheme)
    # is mathematically exact but hands XLA a structurally DIFFERENT fp
    # graph (cx - (ax - c0) vs cx - ax), whose simplified form differed
    # by 1 ulp on CPU — silently breaking rows/tiles-vs-replicated map
    # bit-equality (observed: one free-carve flip after 48 soak steps).
    ax = (agent_xy[:, 0] - cfg.origin_x) / res
    ay = (agent_xy[:, 1] - cfg.origin_y) / res
    row_off = 0 if band is None else band[0]
    col_off = 0 if band_cols is None else band_cols[0]
    ranges_cells = (quantize_ranges_cells8 if pack8
                    else quantize_ranges_cells)(dist_m / res)
    per = -(-spec.n_beams // n_groups)
    if trusted is None:
        tfrac = jnp.zeros((ranges_cells.shape[0], n_groups), jnp.float32)
    else:
        # zero-pad then mean: padded beams count as untrusted
        tfrac = jnp.pad(trusted.astype(jnp.float32),
                        ((0, 0), (0, n_groups * per - spec.n_beams))
                        ).reshape(-1, n_groups, per).mean(axis=-1)
    if phase is not None and per > 1:
        gmins, gtails = group_range_stats_rotated(ranges_cells, n_groups,
                                                  phase)
    else:
        phase = None
        gmins, gtails = group_range_stats(ranges_cells, n_groups)
    pr, pc = patch_dims(cfg.size, reach)
    # a band or tile narrower than the window takes a window of its size
    pr, pc = min(pr, logodds.shape[0]), min(pc, logodds.shape[1])
    row0, col0 = patch_origin(ax, ay, cfg.size, pr, pc, reach,
                              n_rows=None if band is None else band[1],
                              n_cols=None if band_cols is None
                              else band_cols[1],
                              row_off=row_off, col_off=col_off)
    group_dtheta = spec.dtheta * (-(-spec.n_beams // n_groups))
    gspec = BeamSpec(n_beams=n_groups, theta0=spec.theta0,
                     dtheta=group_dtheta, wrap=spec.wrap)

    def one(a, b, y, gm, gmean, tf_a, act, r0, c0):
        rows = jax.lax.broadcasted_iota(jnp.int32, (pr, pc), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (pr, pc), 1)
        cy = (r0 + rows).astype(jnp.float32) + 0.5
        cx = (c0 + cols).astype(jnp.float32) + 0.5
        dx = cx - a
        dy = cy - b
        r = jnp.sqrt(dx * dx + dy * dy)
        theta = jnp.arctan2(dy, dx)
        if phase is not None:
            # rotated partition: cell -> own BEAM index -> rotated group
            relb = theta - y - spec.theta0
            relb = (relb + jnp.pi) % (2 * jnp.pi) - jnp.pi
            bi = jnp.round(relb / spec.dtheta).astype(jnp.int32)
            if spec.wrap:
                bi = jnp.mod(bi, spec.n_beams)
                in_fan = jnp.ones_like(r, bool)
            else:
                in_fan = (bi >= 0) & (bi < spec.n_beams)
                bi = jnp.clip(bi, 0, spec.n_beams - 1)
            slot = jnp.mod(bi - phase, n_groups * per)
            g = (slot.astype(jnp.float32) *
                 jnp.float32(1.0 / per)).astype(jnp.int32)
            resid = relb - bi.astype(jnp.float32) * spec.dtheta
        else:
            # static partition: group centre = mean beam angle
            rel = (theta - y - spec.theta0 - group_dtheta / 2.0
                   + spec.dtheta / 2.0)
            rel = (rel + jnp.pi) % (2 * jnp.pi) - jnp.pi
            g = jnp.floor(rel / group_dtheta + 0.5).astype(jnp.int32)
            if spec.wrap:
                g = jnp.mod(g, n_groups)
                in_fan = jnp.ones_like(r, bool)
            else:
                in_fan = (rel >= -group_dtheta / 2.0) & \
                    (rel < (n_groups - 0.5) * group_dtheta)
                g = jnp.clip(g, 0, n_groups - 1)
            resid = rel - g.astype(jnp.float32) * group_dtheta
        rb = gm[g]
        # a cell is on SOME beam when the fan is dense enough locally;
        # count = crossing beams (>=1 within the fan's angular support).
        # Small-angle forms match the kernel: 2*atan(0.5/r) ~ 1/r,
        # sin(resid) ~ resid.
        rinv = 1.0 / jnp.maximum(r, 1e-3)
        covered = rinv >= spec.dtheta * 0.999
        cnt = (jnp.maximum(1.0, jnp.round(rinv / spec.dtheta))
               if line_equivalent else jnp.ones_like(r))
        # sparse fans (4-way): only cells within a beam's half-cell width
        on_any = covered | (jnp.abs(r * resid) <= 0.6)
        base_ok = in_fan & on_any & (r > 1e-3) & (r <= reach)
        if band_cols is not None:
            # tile windows can extend past the GLOBAL grid at edge tiles
            # (the halo ring); ghost cells there are discarded by the
            # halo merge, so don't count or paint them — keeps `writes`
            # identical to the replicated decomposition's in-grid total
            # (cy/cx are already global cell centres)
            base_ok = base_ok & (cy >= 0.0) & (cy < cfg.size) & \
                (cx >= 0.0) & (cx < cfg.size)
        free = base_ok & (r < rb - 0.5)
        delta = jnp.where(free, cfg.logodds_miss * cnt, 0.0) * act
        w = jnp.sum(jnp.where(free, cnt, 0.0))
        if tail_weight > 0:
            rt = gmean[g]
            tail = base_ok & ~free & (r < rt - 0.5)
            delta = delta + jnp.where(
                tail, cfg.logodds_miss * tail_weight * cnt, 0.0) * act
            w = w + tail_weight * jnp.sum(jnp.where(tail, cnt, 0.0))
        if trusted is not None:
            ring = base_ok & (jnp.abs(r - rb) <= 0.71)
            tf = tf_a[g]
            delta = delta + jnp.where(
                ring, cfg.logodds_hit * cnt * tf, 0.0) * act
            w = w + jnp.sum(jnp.where(ring, cnt * tf, 0.0))
        return delta, w * act

    deltas, writes = jax.vmap(one)(ax, ay, yaw, gmins, gtails, tfrac,
                                   active.astype(jnp.float32), row0, col0)

    def add_one(gr, args):
        # global origin -> exact integer local slice start
        d, r0, c0 = args
        patch = jax.lax.dynamic_slice(gr, (r0, c0), (pr, pc))
        upd = (patch.astype(jnp.float32) + d).astype(gr.dtype)
        return jax.lax.dynamic_update_slice(gr, upd, (r0, c0)), None

    out, _ = jax.lax.scan(add_one, logodds,
                          (deltas, row0 - row_off, col0 - col_off))
    out = jnp.clip(out, -cfg.logodds_clamp,
                   cfg.logodds_clamp).astype(logodds.dtype)
    return out, jnp.sum(writes)


def endpoint_rays(agent_xy, yaw, dist_m, trusted, active, spec: BeamSpec):
    """Trusted beam endpoints as zero-length rays for the exact endpoint
    scatter (ops.raster.logodds_delta with k_max=1)."""
    from swarm_tpu.ops.raster import RayBatch

    n, b = dist_m.shape
    ang = yaw[:, None] + spec.theta0 + \
        jnp.arange(b, dtype=dist_m.dtype)[None, :] * spec.dtheta
    hx = agent_xy[:, 0:1] + dist_m * jnp.cos(ang)
    hy = agent_xy[:, 1:2] + dist_m * jnp.sin(ang)
    ok = trusted & active[:, None]
    return RayBatch(ox=hx.reshape(-1), oy=hy.reshape(-1),
                    hx=hx.reshape(-1), hy=hy.reshape(-1),
                    hit_valid=ok.reshape(-1), active=ok.reshape(-1))


def beams_from_4way(dist4_m, sens_max_range: float, sens_min_range: float):
    """4-way readings -> (range-limited distances, trusted mask)."""
    trusted = (dist4_m > sens_min_range) & (dist4_m <= sens_max_range)
    return jnp.where(trusted, dist4_m, sens_max_range), trusted


def beams_from_scan(scan_m, sens_max_range: float, sens_min_range: float):
    trusted = (scan_m > sens_min_range) & (scan_m <= sens_max_range)
    return jnp.where(trusted, scan_m, sens_max_range), trusted

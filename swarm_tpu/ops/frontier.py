"""Frontier detection + clustering as convolutions and label propagation.

Reference: `OccupancyGrid.get_frontiers` scans all 40k cells in Python and
`cluster_frontiers` BFS-flood-fills clusters (dual_bot_mapper.py:181-231).
Here the frontier mask is four shifted compares (one fused elementwise pass) and
clustering is iterative min-label propagation under `lax.while_loop` —
converging to exactly the same 4-connected components. Cluster ordering
matches the reference's discovery order (row-major first cell), because the
component root is the minimum flat index.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from swarm_tpu.config import CoordConfig, GridConfig
from swarm_tpu.ops.raster import grid_to_world

BIG = jnp.int32(2 ** 30)


def frontier_mask(grid, cfg: GridConfig = GridConfig()):
    """FREE cells 4-adjacent to an UNKNOWN cell, interior only
    (the reference scans y, x in 1..size-2, dual_bot_mapper.py:187-188)."""
    free = grid == cfg.free
    unk = grid == cfg.unknown

    def shift(a, dy, dx):
        return jnp.roll(a, (dy, dx), axis=(0, 1))

    near_unknown = (shift(unk, 0, -1) | shift(unk, 0, 1) |
                    shift(unk, -1, 0) | shift(unk, 1, 0))
    mask = free & near_unknown
    # zero out the border ring
    mask = mask.at[0, :].set(False).at[-1, :].set(False)
    mask = mask.at[:, 0].set(False).at[:, -1].set(False)
    return mask


def label_components(mask):
    """4-connected component labels by min-propagation.

    Returns int32 [S, S]: for masked cells the component id (the minimum
    flat row-major index in the component), BIG elsewhere."""
    s = mask.shape[0]
    flat_ids = jnp.arange(s * s, dtype=jnp.int32).reshape(s, s)
    init = jnp.where(mask, flat_ids, BIG)

    def shift_min(lbl):
        padded = jnp.pad(lbl, 1, constant_values=BIG)
        n = jnp.minimum(
            jnp.minimum(padded[:-2, 1:-1], padded[2:, 1:-1]),
            jnp.minimum(padded[1:-1, :-2], padded[1:-1, 2:]))
        return jnp.where(mask, jnp.minimum(lbl, n), BIG)

    def cond(carry):
        lbl, changed = carry
        return changed

    def body(carry):
        lbl, _ = carry
        new = shift_min(lbl)
        # Two hops per iteration halves the convergence length.
        new = shift_min(new)
        return new, jnp.any(new != lbl)

    lbl, _ = jax.lax.while_loop(cond, body, (init, jnp.asarray(True)))
    return lbl


def frontier_targets_coarse(grid, cfg: GridConfig = GridConfig(),
                            coord: CoordConfig = CoordConfig(),
                            block: int = 8):
    """Swarm-scale frontier targets: block-pooled frontier density + greedy
    non-max suppression instead of exact connected components.

    The exact label propagation needs O(component length) sweeps over the
    full grid — fine for the reference's 200x200 (frontier_clusters), not
    for multi-room swarm grids. Here the frontier mask is pooled into
    [S/block]^2 counts; the K densest blocks (>= frontier_min_cluster
    cells), greedily suppressed within the frontier-separation radius,
    become targets with within-block centroid refinement. Same contract
    as frontier_clusters: (centroids_world [K, 2], sizes [K], count).
    """
    s = grid.shape[0]
    nb = s // block
    k_max = coord.max_frontiers
    # int8 dx-weights below bound the per-row-segment offset sum by
    # block*(block-1)/2 <= 120
    assert block <= 16, "int8 pooling bound"

    # Block pooling as int8 matmuls with int32 accumulation: the natural
    # reshape(nb, b, nb, b).sum((1, 3)) is a strided cross-lane reduce
    # that is costly to materialize at 4096 grids. Pooling with
    # block-indicator matrices is a matrix product instead:
    # R = mask @ [B | Bdx] pools columns (counts and within-block
    # x-offset sums), then B^T @ R pools rows — BIT-EQUAL stats on every
    # backend (integer products need no precision setting). Global
    # coordinate sums come back from the block base: sum_x = block*bx*count + sum(dx), likewise sum_y.
    s_c = nb * block
    mask8 = frontier_mask(grid, cfg)[:s_c, :s_c].astype(jnp.int8)
    ii = jnp.arange(s_c, dtype=jnp.int32)
    sel_b = ii[:, None] // block == jnp.arange(nb, dtype=jnp.int32)[None, :]
    b8 = sel_b.astype(jnp.int8)                              # [s_c, nb]
    bdx8 = (sel_b * (ii % block)[:, None]).astype(jnp.int8)
    dn = (((1,), (0,)), ((), ()))
    rcat = jax.lax.dot_general(
        mask8, jnp.concatenate([b8, bdx8], axis=1), dn,
        preferred_element_type=jnp.int32)                    # [s_c, 2 nb]
    r8 = rcat.astype(jnp.int8)          # <= block*(block-1)/2 = 28
    counts_i = jax.lax.dot_general(b8.T, r8[:, :nb], dn,
                                   preferred_element_type=jnp.int32)
    sdx = jax.lax.dot_general(b8.T, r8[:, nb:], dn,
                              preferred_element_type=jnp.int32)
    sdy = jax.lax.dot_general(bdx8.T, r8[:, :nb], dn,
                              preferred_element_type=jnp.int32)
    counts = counts_i.astype(jnp.float32)
    base = jnp.arange(nb, dtype=jnp.float32) * block
    sum_x = counts * base[None, :] + sdx.astype(jnp.float32)
    sum_y = counts * base[:, None] + sdy.astype(jnp.float32)

    sep_blocks = max(1, int(round(coord.frontier_separation_m /
                                  (cfg.resolution * block))))

    # Data-parallel PEAK NMS (r4): a block is a target iff it is the
    # unique lexicographic maximum — (count, lowest-flat-index) — of its
    # (2 sep+1)^2 neighborhood and count >= frontier_min_cluster.
    # Pairwise separation is preserved EXACTLY (two blocks within each
    # other's window have ordered keys, so only one can be a peak); the
    # one semantic divergence from the former sequential greedy is on
    # long frontier "ridges", where greedy's cascading suppression could
    # surface a runner-up that is not a local maximum — bounded by the
    # exact-vs-coarse divergence test on engine maps.
    #
    # NO top_k anywhere: lax.top_k over the [nb^2]=262k block keys is a
    # full sort. Instead:
    # peaks via a separable shifted-slice window max (XLA fuses the
    # (4 sep+2) 1 MB slice maxes), then compaction of the <= k_max
    # surviving peaks in ROW-MAJOR order with a cumsum + one-hot matmul.
    # Row-major capping matches the exact path:
    # frontier_clusters also truncates to the k_max LOWEST root ids
    # (discovery order), so both tiers share cap semantics.
    flat = jnp.arange(nb * nb, dtype=jnp.int32).reshape(nb, nb)
    # counts <= block^2 (64): key fits i32 comfortably
    key = counts_i * (nb * nb) + (nb * nb - 1 - flat)
    lowest = jnp.int32(-(2 ** 31) + 1)
    padk = jnp.pad(key, sep_blocks, constant_values=lowest)
    rowm = padk[:, sep_blocks:sep_blocks + nb]
    for d in range(1, sep_blocks + 1):
        rowm = jnp.maximum(rowm, jnp.maximum(
            padk[:, sep_blocks - d:sep_blocks - d + nb],
            padk[:, sep_blocks + d:sep_blocks + d + nb]))
    neigh = rowm[sep_blocks:sep_blocks + nb, :]
    for d in range(1, sep_blocks + 1):
        neigh = jnp.maximum(neigh, jnp.maximum(
            rowm[sep_blocks - d:sep_blocks - d + nb, :],
            rowm[sep_blocks + d:sep_blocks + d + nb, :]))
    peak = (key == neigh) & (counts >= coord.frontier_min_cluster)

    pk = peak.reshape(-1)
    pki = pk.astype(jnp.int32)
    pos = jnp.cumsum(pki) - pki                    # exclusive prefix
    slot = jnp.where(pk & (pos < k_max), pos, k_max)
    onehot = (slot[None, :] ==
              jnp.arange(k_max, dtype=jnp.int32)[:, None])
    vals = jnp.stack([counts.reshape(-1), sum_x.reshape(-1),
                      sum_y.reshape(-1)], axis=-1)         # [nb^2, 3]
    # HIGHEST: the one-hot side is exact in any precision, but the
    # coordinate sums reach 2^18 and TF32 keeps only 11 bits
    sel = jnp.matmul(onehot.astype(jnp.float32), vals,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)   # [K, 3]
    n_found = jnp.minimum(jnp.sum(pki), k_max)
    oks = jnp.arange(k_max) < n_found
    cnts = sel[:, 0]
    cxs = sel[:, 1] / jnp.maximum(cnts, 1.0)
    cys = sel[:, 2] / jnp.maximum(cnts, 1.0)
    wx, wy = grid_to_world(cxs, cys, cfg)
    centroids = jnp.stack([jnp.where(oks, wx, 0.0),
                           jnp.where(oks, wy, 0.0)], axis=-1)
    sizes = jnp.where(oks, cnts, 0.0).astype(jnp.int32)
    return centroids, sizes, n_found


def frontier_clusters(grid, cfg: GridConfig = GridConfig(),
                      coord: CoordConfig = CoordConfig()):
    """Full frontier pipeline: mask -> components -> filtered centroids.

    Returns (centroids_world [K, 2] float32, sizes [K] int32, count int32)
    with clusters of size >= frontier_min_cluster, ordered by discovery
    (reference BFS order), padded with zeros beyond `count`."""
    s = grid.shape[0]
    k_max = coord.max_frontiers
    mask = frontier_mask(grid, cfg)
    lbl = label_components(mask)

    flat_lbl = jnp.where(mask, lbl, BIG).reshape(-1)
    safe_lbl = jnp.where(flat_lbl == BIG, 0, flat_lbl)
    ones = jnp.where(flat_lbl == BIG, 0, 1)
    gx = jnp.tile(jnp.arange(s, dtype=jnp.float32), (s,))         # x = col
    gy = jnp.repeat(jnp.arange(s, dtype=jnp.float32), s)          # y = row
    gx = jnp.where(flat_lbl == BIG, 0.0, gx)
    gy = jnp.where(flat_lbl == BIG, 0.0, gy)

    n = s * s
    sizes = jnp.zeros((n,), jnp.int32).at[safe_lbl].add(ones)
    sum_x = jnp.zeros((n,), jnp.float32).at[safe_lbl].add(gx)
    sum_y = jnp.zeros((n,), jnp.float32).at[safe_lbl].add(gy)

    # roots, ordered by flat id = reference discovery order
    flat_ids = jnp.arange(n, dtype=jnp.int32)
    is_root = (sizes >= coord.frontier_min_cluster)
    root_order = jnp.where(is_root, flat_ids, BIG)
    topk = jnp.sort(root_order)[:k_max]
    found = topk != BIG
    topk_safe = jnp.where(found, topk, 0)

    csize = jnp.where(found, sizes[topk_safe], 0)
    cx = sum_x[topk_safe] / jnp.maximum(csize, 1)
    cy = sum_y[topk_safe] / jnp.maximum(csize, 1)
    wx, wy = grid_to_world(cx, cy, cfg)
    centroids = jnp.stack([jnp.where(found, wx, 0.0),
                           jnp.where(found, wy, 0.0)], axis=-1)
    return centroids, csize, jnp.sum(found.astype(jnp.int32))

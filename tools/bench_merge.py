"""Map-merge solve latency: correlative
grid-to-grid scan matching (the map_merger.py ICP replacement,
slam/scanmatch.py) and batched pose-graph Gauss-Newton (slam/posegraph.py)
on the current backend.

Timing uses the amortized-scan pattern (one host fetch per K chained
solves), so per-call dispatch and host sync do not count — see
tools/profile_step.py.

Usage: python tools/bench_merge.py [--inner 32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, carry0, inner, reps=3):
    def scanned(c0):
        def f(c, _):
            return fn(c), ()
        c, _ = jax.lax.scan(f, c0, jnp.arange(inner, dtype=jnp.uint32))
        return sum(jnp.sum(l.astype(jnp.float32))
                   for l in jax.tree_util.tree_leaves(c))
    g = jax.jit(scanned)
    g(carry0).item()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        g(carry0).item()
        best = min(best, time.perf_counter() - t0)
    return best / inner


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inner", type=int, default=16)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from swarm_tpu.config import GridConfig, SlamConfig
    from swarm_tpu.slam.posegraph import gauss_newton, graph_from_trajectory
    from swarm_tpu.slam.scanmatch import match_grids

    rng = np.random.default_rng(0)

    # --- correlative scan match: reference 200x200 map pair ----------------
    cfg = GridConfig(size=256)     # reference 200^2 padded to a tile multiple
    slam = SlamConfig()
    occ = (rng.random((256, 256)) < 0.02).astype(np.float32)
    local = jnp.asarray(np.roll(occ, (3, -4), axis=(0, 1)))
    glob = jnp.asarray(occ)

    def one_match(c):
        m = match_grids(local + c * 1e-9, glob, cfg, slam)
        return c + m.score * 1e-9
    t_match = timed(one_match, jnp.zeros(()), args.inner)

    # --- pose-graph GN: 1024-node trajectory, 64 closures, 10 iters --------
    n = 1024
    t = np.linspace(0, 20 * np.pi, n)
    poses = np.stack([np.cos(t) * 3, np.sin(t) * 3, t % (2 * np.pi)], -1)
    poses += rng.normal(0, 0.05, poses.shape)
    ci = rng.integers(0, n - 200, 64)
    cj = ci + rng.integers(100, 199, 64)
    g = graph_from_trajectory(
        jnp.asarray(poses, jnp.float32), n,
        jnp.asarray(ci, jnp.int32), jnp.asarray(cj, jnp.int32),
        jnp.asarray(np.zeros((64, 3)), jnp.float32), 64)

    def one_gn(gg):
        out, _costs = gauss_newton(gg, iterations=10)
        return gg._replace(poses=gg.poses + (out.poses - gg.poses) * 1e-9)
    t_gn = timed(one_gn, g, args.inner)

    # structured chain+closures solver (slam/tridiag.py): same graph
    from swarm_tpu.slam.tridiag import structured_gn

    def one_sgn(gg):
        out, _costs = structured_gn(gg, n_chain=n - 1, iterations=10)
        return gg._replace(poses=gg.poses + (out.poses - gg.poses) * 1e-9)
    t_sgn = timed(one_sgn, g, args.inner)

    print(json.dumps({
        "scanmatch_ms": round(t_match * 1e3, 3),
        "posegraph_gn_1024n_10it_ms": round(t_gn * 1e3, 3),
        "posegraph_structured_gn_1024n_10it_ms": round(t_sgn * 1e3, 3),
        "platform": jax.devices()[0].platform,
        "detail": {"scanmatch": "256^2 pair, 17 rotations, +/-16 cells",
                   "gn": "1024 nodes, 1023 odom + 64 closure edges; "
                         "structured = block cyclic reduction + Woodbury"},
    }))


if __name__ == "__main__":
    main()

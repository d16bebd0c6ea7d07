"""Exploration-efficiency benchmark: coverage of reachable free space
over time, wall-following vs frontier-target assignment.

The reference SHIPS its frontier engine but the assignment + TARG send is
commented out on both ends (dual_bot_mapper.py:959-996 server-side,
AgentFirmware_Bot1.ino:126-139 firmware-side) — so the reference swarm
explores by wall-following alone and its designed sensing trust window
(0.05-1.20 m, dual_bot_mapper.py:57-58) means a perimeter-hugging robot
can never observe the interior of a room wider than ~2.4 m: that space
stays UNKNOWN forever. This tool measures what the disabled feature is
worth: it runs the same closed-loop engine twice — wall-following only,
then with frontier detection + greedy assignment + GO_TO_TARGET delivery
enabled (our implementation of the commented-out reference algorithm) —
and reports the coverage-vs-steps curve for each.

coverage(t) = |cells mapped FREE at t  ∩  reachable| / |reachable|

where `reachable` is the ground-truth set of grid cells whose centers lie
strictly inside a room (rooms are closed rectangles in these worlds, so
reachable free space = the union of room interiors, computed analytically
from the wall segments). The numerator uses the engine's own tri-state
FREE view (ops/raster.py::tri_state_view thresholds). Coverage is
accumulated ON DEVICE per step (one masked reduction over the log-odds
grid inside the rollout scan), so the curve has per-step resolution at
any swarm size.

Usage: python tools/bench_coverage.py [--agents 64] [--steps 1500]
       [--platform cpu] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def reachable_mask(walls, grid_cfg, inset_cells: int = 1):
    """Ground-truth reachable free space: cells whose centers lie inside a
    room rectangle inset by `inset_cells` (wall-line cells excluded).
    Rooms are 4 consecutive segments from make_rect_room."""
    res = grid_cfg.resolution
    s = grid_cfg.size
    mask = np.zeros((s, s), bool)
    rects = np.asarray(walls, np.float64).reshape(-1, 4, 4)
    for seg in rects:
        xs = np.concatenate([seg[:, 0], seg[:, 2]])
        ys = np.concatenate([seg[:, 1], seg[:, 3]])
        x0, x1 = xs.min(), xs.max()
        y0, y1 = ys.min(), ys.max()
        pad = inset_cells * res
        cx0 = int(np.ceil((x0 + pad - grid_cfg.origin_x) / res))
        cx1 = int(np.floor((x1 - pad - grid_cfg.origin_x) / res))
        cy0 = int(np.ceil((y0 + pad - grid_cfg.origin_y) / res))
        cy1 = int(np.floor((y1 - pad - grid_cfg.origin_y) / res))
        cx0, cy0 = max(cx0, 0), max(cy0, 0)
        cx1, cy1 = min(cx1, s - 1), min(cy1, s - 1)
        if cx1 >= cx0 and cy1 >= cy0:
            mask[cy0:cy1 + 1, cx0:cx1 + 1] = True
    return mask


def run_variant(cfg, walls, params, rooms, steps, chunk, reach,
                enable_targets, seed: int = 42):
    """Chunked rollout returning the per-step coverage fraction [steps]."""
    import jax
    import jax.numpy as jnp

    from swarm_tpu.engine.sim import sim_init, sim_step

    from swarm_tpu.ops.raster import FREE_THRESH

    if steps % chunk != 0:
        raise ValueError(
            f"--steps {steps} must be a multiple of --chunk {chunk} "
            "(range(steps // chunk) would silently drop the remainder "
            "and report a step count that did not run)")
    walls_j = jnp.asarray(walls)
    reach_j = jnp.asarray(reach)
    denom = float(reach.sum())
    wg, roa = rooms
    free_thresh = FREE_THRESH   # the engine's own FREE definition

    def body(s, _):
        s2, m = sim_step(s, cfg, walls_j, params,
                         enable_targets=enable_targets,
                         walls_grouped=wg, room_of_agent=roa)
        covered = jnp.sum(
            jnp.where((s2.srv.logodds <= free_thresh) & reach_j, 1, 0),
            dtype=jnp.int32)
        return s2, (covered, m.n_frontiers)

    @jax.jit
    def chunk_fn(s):
        return jax.lax.scan(body, s, None, length=chunk)

    state = sim_init(cfg, params, key=jax.random.PRNGKey(seed))
    cov, nfr = [], []
    for _ in range(steps // chunk):
        state, (c, f) = chunk_fn(state)
        cov.append(np.asarray(c))
        nfr.append(np.asarray(f))
    cov = np.concatenate(cov).astype(np.float64) / denom
    return cov, np.concatenate(nfr)


def steps_to(cov, frac):
    idx = np.nonzero(cov >= frac)[0]
    return int(idx[0]) + 1 if idx.size else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--seeds", type=int, default=1,
                    help="independent replicates (distinct sim_init PRNG "
                         "keys): the closed loop is chaotic — a single "
                         "run cannot rank the variants; report "
                         "mean +/- range over N >= 5 for claims")
    args = ap.parse_args()
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from swarm_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from __graft_entry__ import _cfg_and_world

    seeds = [42 + 1000 * k for k in range(args.seeds)]
    results = {}
    curves = {}          # name -> [n_seeds, steps]
    for name, frontiers, targets in (
            ("wall_follow", False, False),
            ("frontier_targets", True, True)):
        cfg, walls, params, rooms = _cfg_and_world(
            args.agents, frontiers=frontiers, parity=False,
            raster_mode="beam", fast_raster=True, scan_rays=181,
            tiled=True)
        reach = reachable_mask(walls, cfg.grid)
        covs, nfr = [], None
        for seed in seeds:
            cov, nfr = run_variant(cfg, walls, params, rooms, args.steps,
                                   args.chunk, reach, targets, seed=seed)
            covs.append(cov)
            print(f"[{name} seed={seed}] final={cov[-1]:.3f}", flush=True)
        covs = np.stack(covs)
        curves[name] = covs
        finals = covs[:, -1]

        def agg(vals):
            vals = [v for v in vals if v is not None]
            if not vals:
                return None
            return {"mean": round(float(np.mean(vals)), 1),
                    "min": int(np.min(vals)), "max": int(np.max(vals)),
                    "n": len(vals)}

        results[name] = {
            "coverage_final_mean": round(float(finals.mean()), 4),
            "coverage_final_min": round(float(finals.min()), 4),
            "coverage_final_max": round(float(finals.max()), 4),
            "steps_to_50pct": agg([steps_to(c, 0.5) for c in covs]),
            "steps_to_70pct": agg([steps_to(c, 0.7) for c in covs]),
            "steps_to_90pct": agg([steps_to(c, 0.9) for c in covs]),
            "frontiers_final": int(nfr[-1]),
        }
        print(f"[{name}] final={finals.mean():.3f} "
              f"[{finals.min():.3f}, {finals.max():.3f}] over "
              f"{len(seeds)} seed(s)", flush=True)

    wf = curves["wall_follow"][:, -1]
    ft = curves["frontier_targets"][:, -1]
    out = {
        "metric": "coverage_final_frontier_targets",
        "value": round(float(ft.mean()), 4),
        "unit": "fraction of reachable free space",
        "vs_wall_follow": round(float(ft.mean() / max(wf.mean(), 1e-9)),
                                3),
        "detail": {
            "agents": args.agents, "steps": args.steps,
            "platform": jax.devices()[0].platform,
            "seeds": seeds,
            # per-seed paired ratio (same-seed frontier/wall pairing)
            "vs_wall_follow_per_seed": [
                round(float(f / max(w, 1e-9)), 3)
                for f, w in zip(ft, wf)],
            "reachable_cells": int(
                reachable_mask(walls, cfg.grid).sum()),
            "curve_every": args.chunk,
            # seed-mean curves (per-seed finals above carry the spread)
            "curves": {k: [round(float(v), 4)
                           for v in c.mean(0)[args.chunk - 1::args.chunk]]
                       for k, c in curves.items()},
            "finals_per_seed": {k: [round(float(v), 4) for v in c[:, -1]]
                                for k, c in curves.items()},
            **{k: v for k, v in results.items()},
        },
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

"""Sharded-engine scaling check on a virtual CPU mesh.

Measures the RELATIVE cost structure of
`parallel.sharded.make_sharded_sim_step` — agent-state DP + psum map
merge + all_gather coordination — across virtual device counts on CPU,
and asserts the sharded result stays bit-identical to the single-device
engine. Numbers are CPU numbers, not device performance; they validate
that the collective structure scales (per-device agent work shrinks linearly,
replicated server work stays constant).

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python tools/bench_sharded.py [--agents 64] [--steps 20]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    from __graft_entry__ import _cfg_and_world
    from swarm_tpu.engine.sim import sim_init, total_writes_value
    from swarm_tpu.parallel import (make_mesh, make_sharded_sim_step,
                                    shard_state)

    cfg, walls, params, _ = _cfg_and_world(args.agents, frontiers=False,
                                           parity=False)
    n_dev = len(jax.devices())
    results = {}
    for d in [1, 2, n_dev] if n_dev > 2 else [1, n_dev]:
        if args.agents % d:
            continue
        mesh = make_mesh(d)
        state = shard_state(sim_init(cfg, params), mesh)
        step = make_sharded_sim_step(cfg, walls, params, mesh, donate=False)
        state, m = step(state)          # compile + first step
        float(m.pose_err)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state)
            float(m.pose_err)           # host sync every step
        dt = (time.perf_counter() - t0) / args.steps
        results[d] = (dt, float(total_writes_value(state.srv.total_writes)))
        print(f"devices={d:2d}  {dt * 1e3:8.2f} ms/step  "
              f"writes={results[d][1]:.0f}")

    writes = {round(w) for _, w in results.values()}
    assert len(writes) == 1, f"sharded runs diverge: {results}"
    print("OK: identical writes across mesh sizes", writes.pop())


if __name__ == "__main__":
    main()

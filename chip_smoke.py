"""Smoke test of the swarm engine on one NVIDIA GPU.

    python3 chip_smoke.py                # one card: the three phases below
    python3 chip_smoke.py --four-cards   # four cards: sharded engine only

Phases on one card (all in this one process — a second JAX process could
not reserve the card's memory):

  1. raster — the order-free fast raster (ops/fast_raster.py) at the
     benchmark's width (1024 agents x 181 beams, reach 26 cells, 4096^2
     float32 grid, per-beam carve, 1/4-cell ranges, endpoint ring) against
     the plain sequential reference (beam_raster.free_raster_reference) on
     the card: equal painted counts, at most MAX_CELLS_DIFFERING cells
     apart by more than 1e-4, and bit-identical maps when the agents come
     in another order.
  2. engine — the closed-loop engine as `python bench.py` configures it,
     two 32-step chunks: every agent online, writes and merges happened,
     finite log-odds. Its rates are printed for information only.
  3. dual_bot — `run_session --preset dual_bot --steps 200`: cell writes,
     closures and agents online against the known-good CPU run.

--four-cards runs the sharded engine over four cards in its replicated,
rows and 2x2 tiles decompositions against the fused engine on one card
(__graft_entry__.check_decompositions) and nothing else.

Exits non-zero, printing no result, unless JAX's first device is a GPU.
The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# Map cells of the 1024-agent raster check allowed to differ by more than
# 1e-4 between the fast path and the reference: both evaluate the same
# float expressions, but XLA may contract them into fused multiply-adds
# differently in the two programs, which can flip a cell that sits within
# an ulp of a beam or range boundary.
MAX_CELLS_DIFFERING = 16
PAINTED_RTOL = 1e-6

# dual_bot preset, 200 steps, seed 42: the known-good CPU run. On the GPU
# the sensing and odometry sums round differently, which can move a few
# parity-raster writes; closures and agents online must match exactly.
DUAL_BOT_WRITES = 18435
DUAL_BOT_WRITES_RTOL = 0.02
DUAL_BOT_CLOSURES = 4


def check(ok: bool, res) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {res}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def phase_raster(seed: int, agents: int = 1024) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import bench_config
    from swarm_tpu.engine.sim import sim_init
    from swarm_tpu.models.scan import sense_scan
    from swarm_tpu.ops.beam_raster import (BeamSpec, beams_from_scan,
                                           free_raster_reference,
                                           reach_cells)
    from swarm_tpu.ops.fast_raster import free_raster_fast

    cfg, walls, params, rooms = bench_config(agents)
    n, rays = cfg.n_agents, cfg.engine.scan_rays
    reach = reach_cells(cfg)
    spec = BeamSpec.scan(rays)
    k_yaw, k_scan, k_lo, k_perm = jax.random.split(
        jax.random.PRNGKey(seed), 4)
    pose = sim_init(cfg, params).pose_true
    pose = pose.at[:, 2].set(jax.random.uniform(
        k_yaw, (n,), minval=-np.pi, maxval=np.pi))
    scan = jax.vmap(lambda k, p, w: sense_scan(
        k, p, w, rays, cfg.sensors))(
        jax.random.split(k_scan, n), pose, rooms[0][rooms[1]])
    db, tb = beams_from_scan(scan, cfg.sensors.max_range,
                             cfg.sensors.min_range)
    active = jnp.arange(n) % 97 != 5            # a few agents offline
    lo0 = jax.random.uniform(k_lo, (cfg.grid.size, cfg.grid.size),
                             minval=-cfg.grid.logodds_clamp,
                             maxval=cfg.grid.logodds_clamp)
    kw = dict(spec=spec, cfg=cfg.grid, n_groups=rays, trusted=tb,
              reach=reach, pack8=True)

    # every input is an argument: a closed-over input would be constant-
    # folded on the host, and the two programs would see other bits
    fast = jax.jit(lambda lo, xy, yaw, d, act, t: free_raster_fast(
        lo, xy, yaw, d, act, **{**kw, "trusted": t}))
    ref = jax.jit(lambda lo, xy, yaw, d, act, t: free_raster_reference(
        lo, xy, yaw, d, act, tail_weight=0.0, **{**kw, "trusted": t}))
    args = (lo0, pose[:, :2], pose[:, 2], db, active, tb)

    lo_f, painted = fast(*args)
    lo_f.block_until_ready()
    t0 = time.perf_counter()
    lo_f, painted = fast(*args)
    lo_f.block_until_ready()
    fast_ms = (time.perf_counter() - t0) * 1e3
    lo_r, w_ref = ref(*args)
    perm = jax.random.permutation(k_perm, n)
    lo_p, painted_p = fast(lo0, *(x[perm] for x in args[1:]))

    lo_f, lo_r, lo_p = (np.asarray(x) for x in (lo_f, lo_r, lo_p))
    w_fast = float(np.asarray(painted, np.float64).sum())
    w_ref = float(w_ref)
    res = dict(
        agents=n, beams=rays, grid=cfg.grid.size,
        painted_fast=w_fast, painted_ref=w_ref,
        cells_differing=int((np.abs(lo_f - lo_r) > 1e-4).sum()),
        max_abs_diff=float(np.abs(lo_f - lo_r).max()),
        permuted_bit_equal=bool(np.array_equal(lo_f, lo_p)),
        permuted_painted_equal=bool(np.array_equal(
            np.sort(np.asarray(painted)), np.sort(np.asarray(painted_p)))),
        finite=bool(np.isfinite(lo_f).all()),
        fast_raster_ms=fast_ms)
    check(res["finite"], res)
    check(w_fast > 0 and abs(w_fast - w_ref) <= PAINTED_RTOL * w_ref, res)
    check(res["cells_differing"] <= MAX_CELLS_DIFFERING, res)
    check(res["permuted_bit_equal"] and res["permuted_painted_equal"], res)
    return res


def phase_engine(agents: int = 1024) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import bench_config
    from swarm_tpu.engine.sim import sim_init, sim_rollout

    cfg, walls, params, rooms = bench_config(agents)
    walls = jnp.asarray(walls)
    steps = 32

    @jax.jit
    def chunk(s):
        final, ms = sim_rollout(s, steps, cfg, walls, params,
                                walls_grouped=rooms[0],
                                room_of_agent=rooms[1])
        return final, ms.writes, ms.merges, ms.online

    t0 = time.perf_counter()
    state, w1, m1, _ = chunk(sim_init(cfg, params))
    w1 = np.asarray(w1)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, w2, m2, online = chunk(state)
    w2 = np.asarray(w2)
    dt = time.perf_counter() - t0
    writes = int(w1.astype(np.int64).sum() + w2.astype(np.int64).sum())
    res = dict(
        agents=cfg.n_agents, grid=cfg.grid.size, steps=2 * steps,
        online=int(np.asarray(online)[-1]), writes=writes,
        merges=int(np.asarray(m1).sum() + np.asarray(m2).sum()),
        finite=bool(jnp.isfinite(state.srv.logodds).all()),
        first_chunk_s=first_s, steps_per_s=steps / dt,
        applied_cells_per_s=float(w2.astype(np.int64).sum()) / dt)
    check(res["online"] == cfg.n_agents, res)
    check(res["writes"] > 0 and res["merges"] > 0 and res["finite"], res)
    return res


def phase_dual_bot(seed: int) -> dict:
    from swarm_tpu.cli import run_session

    with tempfile.TemporaryDirectory() as out:
        run_session.main(["--preset", "dual_bot", "--steps", "200",
                          "--seed", str(seed), "--out", out])
        with open(os.path.join(out, "metrics.json")) as f:
            m = json.load(f)
    res = dict(writes=m["total_cell_writes"], closures=m["closures"],
               online=m["online_at_end"], writes_cpu=DUAL_BOT_WRITES,
               closures_cpu=DUAL_BOT_CLOSURES)
    check(res["online"] == 2 and res["closures"] == DUAL_BOT_CLOSURES, res)
    check(abs(res["writes"] - DUAL_BOT_WRITES) <=
          DUAL_BOT_WRITES_RTOL * DUAL_BOT_WRITES, res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engine over four cards")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX found {len(devs)}",
              file=sys.stderr)
        return 2
    from swarm_tpu.utils.cache import enable_compilation_cache

    print(card_line(), flush=True)
    enable_compilation_cache()
    if args.four_cards:
        import __graft_entry__

        phases = [("four_cards", lambda: __graft_entry__.check_decompositions(
            4, 256, steps=4, scan_rays=181, devices=devs[:4]))]
    else:
        phases = [("raster", lambda: phase_raster(args.seed)),
                  ("engine", phase_engine),
                  ("dual_bot", lambda: phase_dual_bot(args.seed))]
    for name, fn in phases:
        t0 = time.perf_counter()
        res = fn()
        print(f"{name}: {json.dumps(res)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

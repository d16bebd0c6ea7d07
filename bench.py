"""Headline benchmark: grid-cell updates/sec of the fused swarm engine.

Runs the full closed-loop step (sense -> nav FSM -> EKF -> odometry drift ->
occupancy raster -> loop closure -> zones -> heartbeat) for a 1024-agent
swarm in a 512-room world on one chip and reports sustained occupancy-grid
cell updates per second.

Baseline: the reference server's derived ceiling is ~5.8e4 cell-updates/s
(<= 600 pkt/s x 4 rays x <= 24 cells — dual_bot_mapper.py:816, 57, 87).
`vs_baseline` is the speedup over that ceiling.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp

BASELINE_CELL_UPDATES_PER_S = 5.8e4


def bench_config(agents: int = 1024, scan_rays: int = 181,
                 raster: str = "beam", frontiers: bool = False,
                 grid_dtype: str = "float32", beam_groups: int = 0,
                 kernel_endpoints: bool = True, pack8: bool = True,
                 merge_every: int = 16):
    """The benchmark's deployment: `agents` robots, two per room, in the
    tiled room world (4096^2 cells at 1024 agents), with the defaults of
    `python bench.py`. Returns (cfg, walls, params, rooms)."""
    import dataclasses

    from __graft_entry__ import _cfg_and_world

    beam = raster == "beam"
    cfg, walls, params, rooms = _cfg_and_world(
        agents, frontiers=frontiers, parity=False, raster_mode=raster,
        fast_raster=beam, scan_rays=scan_rays, tiled=beam)
    if grid_dtype != "float32":
        cfg = cfg.replace(grid=dataclasses.replace(
            cfg.grid, logodds_dtype=grid_dtype))
    if beam:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, beam_groups=beam_groups,
            kernel_endpoints=kernel_endpoints, beam_pack8=pack8,
            # scan variant maps with the lidar only (faithful to the
            # esp32 scan firmware); 4-way raster when no scan
            raster_4way=(scan_rays == 0)))
    if merge_every > 0 and scan_rays > 0:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, merge_every=merge_every))
    return cfg, walls, params, rooms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=200, help="steps per chunk")
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--platform", default=None,
                    help="force jax platform (e.g. cpu)")
    ap.add_argument("--scan-rays", type=int, default=181,
                    help="servo-scan beams per agent per step "
                         "(181 = the esp32 servo firmware variant; 0 = "
                         "4-way ultrasonics only)")
    ap.add_argument("--raster", default="beam", choices=["line", "beam"],
                    help="line = per-ray Bresenham scatter; beam = polar "
                         "inverse sensor model through the order-free fast "
                         "path (ops/fast_raster.py)")
    ap.add_argument("--pack8", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="quantize beam ranges to 1/4 cell (<= 6.25 mm "
                         "rounding, clipped at 31.75 cells); --no-pack8 "
                         "keeps the 1/256-cell step")
    ap.add_argument("--exact-endpoints", action="store_true",
                    help="endpoint hits via the exact sparse scatter "
                         "instead of endpoint-ring painting in the fast "
                         "path")
    ap.add_argument("--beam-groups", type=int, default=0,
                    help="0 = per-beam exact carve (quality default); "
                         "> 0 = grouped tier (group-min approximation)")
    ap.add_argument("--frontiers", action="store_true",
                    help="run frontier detection + greedy target assignment "
                         "at the reference's 3 s cadence (coarse swarm-scale "
                         "path for grids > 512)")
    ap.add_argument("--grid-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="log-odds grid storage dtype; bfloat16 halves "
                         "the grid's device memory (the >16k-agent "
                         "scaling lever) — evidence is applied in f32")
    ap.add_argument("--merge-every", type=int, default=16,
                    help="in-engine scan-merge cadence in steps (the "
                         "reference merger runs continuously on every "
                         "incoming submap, map_merger.py:35-62); 0 = off")
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from swarm_tpu.engine.sim import sim_init, sim_rollout
    from swarm_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg, walls, params, rooms = bench_config(
        args.agents, scan_rays=args.scan_rays, raster=args.raster,
        frontiers=args.frontiers, grid_dtype=args.grid_dtype,
        beam_groups=args.beam_groups,
        kernel_endpoints=not args.exact_endpoints, pack8=args.pack8,
        merge_every=args.merge_every)
    walls = jnp.asarray(walls)
    state = sim_init(cfg, params)

    import numpy as np

    @jax.jit
    def chunk(s):
        final, ms = sim_rollout(s, args.steps, cfg, walls, params,
                                enable_targets=args.frontiers,
                                walls_grouped=rooms[0],
                                room_of_agent=rooms[1])
        # per-step int32 counts (each < 2^31); summed in int64 on host —
        # a whole chunk overflows int32 beyond ~8k agents
        return final, ms.writes, jnp.sum(ms.merges)

    # warmup / compile; pulling the writes to the host is the sync
    state, w, _ = chunk(state)
    int(np.asarray(w).sum())

    t0 = time.perf_counter()
    total_writes = 0
    total_merges = 0
    for _ in range(args.chunks):
        state, w, nm = chunk(state)
        # per-chunk host pull = real sync
        total_writes += int(np.asarray(w).astype(np.int64).sum())
        total_merges += int(nm)
    dt = time.perf_counter() - t0

    steps = args.steps * args.chunks
    value = total_writes / dt

    # ------------------------------------------------------------------
    # Counter reconciliation: the headline counter is the applied count —
    # the sum of per-cell beam-crossing counts over the cells the fast
    # path actually painted (not an analytic claim). Cross-check it here
    # against the evidence observable
    # in the map (sum |delta| in unit updates on fresh, unclamped steps);
    # the ratio should sit near 1 (clamp saturation + same-cell free/hit
    # cancellation are the only slack).
    from swarm_tpu.engine.sim import make_sim_step
    single = make_sim_step(cfg, walls, params,
                           enable_targets=args.frontiers, donate=False,
                           walls_grouped=rooms[0], room_of_agent=rooms[1])
    # measure on a FRESH map: at steady state the log-odds clamp saturates
    # visited cells and |delta| under-counts the evidence the raster
    # applied; early steps have clamp headroom so the ratio is meaningful
    st_i = sim_init(cfg, params)
    for _ in range(2):
        st_i, _ = single(st_i)

    def ratio_window(st, k=3):
        rs = []
        for _ in range(k):
            lo0 = st.srv.logodds
            st, m1 = single(st)
            d = st.srv.logodds - lo0
            applied = (jnp.sum(jnp.maximum(-d, 0.0)) /
                       abs(cfg.grid.logodds_miss) +
                       jnp.sum(jnp.maximum(d, 0.0)) / cfg.grid.logodds_hit)
            rs.append(float(applied) / max(int(m1.writes), 1))
        return st, sum(rs) / len(rs)

    # decay curve: the ratio at the HEADLINE config,
    # measured in 3-step windows at increasing map age — the early-window
    # value near 1 pins the counter's semantics; the decay to steady
    # state is clamp saturation of repeatedly-seen cells (their |delta|
    # is 0 while the raster still performs and counts the fused update,
    # like the reference re-writing already-FREE Bresenham cells,
    # dual_bot_mapper.py:136-156), NOT counter inflation.
    adv = jax.jit(lambda s: sim_rollout(
        s, 30, cfg, walls, params, enable_targets=args.frontiers,
        walls_grouped=rooms[0], room_of_agent=rooms[1])[0])
    ratio_curve = {}
    st_i, ratio_curve["step2"] = ratio_window(st_i)
    applied_ratio = ratio_curve["step2"]
    st_i = adv(st_i)
    st_i, ratio_curve["step35"] = ratio_window(st_i)
    for _ in range(3):
        st_i = adv(st_i)
    _, ratio_curve["step128"] = ratio_window(st_i)
    ratio_curve = {k: round(v, 4) for k, v in ratio_curve.items()}
    # floor assert at bench scale: the 1024-agent headline config sits
    # well below 1 even on the earliest window — the dense start area
    # saturates within 2 steps when hundreds of agents' fans overlap (each start cell absorbs many clamped updates). A
    # fresh-window ratio below 0.6 cannot be explained by saturation and
    # means the counter stopped tracking map-observable evidence — fail
    # loudly rather than publish broken headline semantics.
    assert applied_ratio > 0.6, \
        f"fresh applied-counter ratio {applied_ratio:.3f} <= 0.6"

    # merge-solve latency, two numbers:
    #  - merge_latency_full_batch_ms: the batched scan-to-map matcher on a
    #    FULL (capped 1024-agent) batch — the standalone solver figure.
    #    Capped because the im2col scoring buffer scales with the batch
    #    (16k agents at once would be a 32 GB intermediate).
    #  - merge_cost_per_step_ms: what the ENGINE actually pays per step —
    #    one rotating slam.merge_chunk-agent chunk every merge_every
    #    steps, amortized.
    merge_latency_ms = None
    merge_event_ms = None
    merge_cost_per_step_ms = None
    mla = min(args.agents, 1024)
    chunk_n = min(cfg.slam.merge_chunk, args.agents)
    if cfg.engine.merge_every > 0:
        from swarm_tpu.slam.livemerge import scan_merge
        from swarm_tpu.models.scan import sense_scan
        k = jax.random.PRNGKey(0)
        ks = jax.random.split(k, mla)
        scan = jax.vmap(lambda kk, p, w_: sense_scan(
            kk, p, w_, cfg.engine.scan_rays, cfg.sensors))(
            ks, state.pose_true[:mla], rooms[0][rooms[1][:mla]])

        def time_match(m, inner=4):
            # amortized inside ONE jitted scan of `inner` matches
            alive = jnp.ones((m,), bool)

            def body(c, _):
                r = scan_merge(state.srv.logodds + c * 1e-20,
                               state.odom.x_est[:m], state.odom.y_est[:m],
                               state.odom.yaw_est[:m], scan[:m], alive,
                               cfg)
                return c + r.fitness.sum() * 1e-9, ()

            sm = jax.jit(lambda: jax.lax.scan(
                body, jnp.float32(0.0), None, length=inner)[0])
            float(sm())                      # compile + sync
            t1 = time.perf_counter()
            reps = 3
            for _ in range(reps):
                float(sm())                  # per-rep host pull = sync
            return (time.perf_counter() - t1) / (reps * inner) * 1e3

        merge_latency_ms = time_match(mla)
        merge_event_ms = (merge_latency_ms if chunk_n == mla
                          else time_match(chunk_n, inner=8))
        merge_cost_per_step_ms = merge_event_ms / cfg.engine.merge_every
    print(json.dumps({
        "metric": "grid_cell_updates_per_s",
        "value": value,
        "unit": "cells/s",
        "vs_baseline": value / BASELINE_CELL_UPDATES_PER_S,
        "detail": {
            "agents": args.agents,
            "steps": steps,
            "elapsed_s": round(dt, 3),
            "steps_per_s": round(steps / dt, 2),
            "agent_steps_per_s": round(steps * args.agents / dt, 1),
            "writes_per_step": round(total_writes / max(steps, 1), 1),
            "grid": cfg.grid.size,
            "grid_dtype": cfg.grid.logodds_dtype,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
            "raster": args.raster,
            "scan_rays": args.scan_rays,
            "beam_groups": args.beam_groups,
            # per_beam_exact_pack8: exact per-beam carve semantics at the
            # 1/4-cell fixed point (vs 1/256-cell for per_beam_exact)
            "carve": (("per_beam_exact_pack8" if args.pack8
                       else "per_beam_exact") if args.beam_groups <= 0
                      else "group_min"),
            "pack8": args.pack8,
            "frontiers": args.frontiers,
            # line: actual scatter writes (reference per-ray semantics).
            # beam: applied counter — per-cell beam-crossing counts summed
            # over the cells the fast path actually painted (free/tail/
            # ring, ops/fast_raster.fan_counts); endpoint-scatter writes
            # counted exactly when ring painting is off.
            "writes_semantics": ("scatter" if args.raster == "line"
                                 else "applied"),
            # reconciliation: map-observable |delta| per unit update on
            # fresh (unclamped) steps vs the in-kernel counter — near 1;
            # the shortfall is clamp saturation of often-seen cells
            "delta_ratio_fresh": round(applied_ratio, 4),
            # 3-step ratio windows at increasing map age: the decay from
            # the fresh value is clamp saturation, pinned as a curve
            # rather than a footnote
            "delta_ratio_curve": ratio_curve,
            "writes_applied_per_s": round(value, 1),
            # in-engine continuous merge (map_merger.py semantics)
            "merge_every": cfg.engine.merge_every,
            "merges_total": total_merges,
            "merge_latency_full_batch_ms": (
                round(merge_latency_ms, 3)
                if merge_latency_ms is not None else None),
            "merge_latency_batch": (mla if merge_latency_ms is not None
                                    else None),
            # amortized engine-side merge cost: one slam.merge_chunk-agent
            # chunk matched every merge_every steps
            "merge_event_chunk": (chunk_n if merge_event_ms is not None
                                  else None),
            "merge_event_ms": (round(merge_event_ms, 3)
                               if merge_event_ms is not None else None),
            "merge_cost_per_step_ms": (
                round(merge_cost_per_step_ms, 4)
                if merge_cost_per_step_ms is not None else None),
        },
    }))


if __name__ == "__main__":
    main()

"""Landmark-based loop closure — the reference's `PoseGraphSLAM`
(server_nodes/dual_bot_mapper.py:261-338) as fixed-capacity, masked array
operations.

Reference semantics reproduced exactly:
  * every packet appends a pose node; packets whose landmark_type != NONE
    are matched against ALL previously stored landmarks in insertion order
    and the FIRST hit wins (dual_bot_mapper.py:292-326);
  * a hit requires same landmark type, >= MIN_POSES_BETWEEN node-index gap
    from the matched landmark, >= MIN_POSES_BETWEEN since this agent's last
    closure, and < CLOSURE_RADIUS spatial distance;
  * the correction is 0.5x the error (damped), accumulated per agent and
    applied to all subsequent incoming odometry (dual_bot_mapper.py:854-857,
    908-919);
  * the landmark is stored AFTER matching, so a node never matches itself.

Batched form: the unbounded Python lists become ring buffers of static
capacity; "first match in insertion order" is an argmin over the masked
slot index — one vectorised pass instead of a data-dependent loop. The
whole `add_pose` is pure and scan-able over a packet stream.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from swarm_tpu.config import SlamConfig


class ClosureState(NamedTuple):
    # Landmark store (ring buffer, insertion-ordered while not wrapped).
    lm_x: jnp.ndarray        # [L]
    lm_y: jnp.ndarray        # [L]
    lm_type: jnp.ndarray     # [L] int32, 0 = empty slot
    lm_node: jnp.ndarray     # [L] int32 node index, -1 = empty
    lm_agent: jnp.ndarray    # [L] int32 storing agent, -1 = empty (used
    #                          by the same-agent matching filter below)
    lm_count: jnp.ndarray    # [] int32 (total ever stored)
    # Pose counter + per-agent closure guards.
    n_nodes: jnp.ndarray             # [] int32
    last_closure_node: jnp.ndarray   # [N] int32
    drift_dx: jnp.ndarray            # [N] cumulative correction
    drift_dy: jnp.ndarray            # [N]
    # Closure edge log (ring buffer) for slam_closures.csv parity
    # (dual_bot_mapper.py:1034-1038) and for the pose-graph optimiser.
    cl_lm_node: jnp.ndarray   # [C] int32
    cl_node: jnp.ndarray      # [C] int32
    cl_dx: jnp.ndarray        # [C]
    cl_dy: jnp.ndarray        # [C]
    cl_agent: jnp.ndarray     # [C] int32
    cl_count: jnp.ndarray     # [] int32
    # SCAN-MATCHED edge measurements (SlamConfig.closure_scanmatch,
    # slam/closurematch.py — beyond the reference). The landmark ring
    # additionally remembers the detecting robot's yaw + servo sweep
    # ([L, 1] placeholders when disabled), and a fired closure logs the
    # correlatively-matched SE(2) edge measurement in the STORED node's
    # frame plus its fitness. cl_fit < 0 = unmeasured edge (coincidence
    # only); the offline refiners gate at merge_fitness_min.
    lm_yaw: jnp.ndarray       # [L]
    lm_scan: jnp.ndarray      # [L, R] (R = 1 when disabled)
    cl_mx: jnp.ndarray        # [C] measured meas_x (frame of cl_lm_node)
    cl_my: jnp.ndarray        # [C]
    cl_mth: jnp.ndarray       # [C]
    cl_fit: jnp.ndarray       # [C] match fitness, -1 = unmeasured
    # Proximity-pair rendezvous rate limiter (SlamConfig
    # .closure_pair_budget): node index of each agent's last ATTEMPTED
    # pair match — an agent re-pairs only after closure_pair_cooldown
    # more nodes. Init far negative so the first pairs fire immediately.
    last_pair_node: jnp.ndarray   # [N] int32


def closure_init(n_agents: int, cfg: SlamConfig = SlamConfig(),
                 closure_capacity: int = 1024,
                 scan_rays: int = 0) -> ClosureState:
    L, C = cfg.landmark_capacity, closure_capacity
    R = max(1, scan_rays)
    zf = jnp.zeros
    return ClosureState(
        lm_x=zf((L,), jnp.float32), lm_y=zf((L,), jnp.float32),
        lm_type=zf((L,), jnp.int32), lm_node=jnp.full((L,), -1, jnp.int32),
        lm_agent=jnp.full((L,), -1, jnp.int32),
        lm_count=jnp.zeros((), jnp.int32),
        n_nodes=jnp.zeros((), jnp.int32),
        # ref: last_closure_idx starts at -MIN_POSES_BETWEEN (:271)
        last_closure_node=jnp.full((n_agents,), -cfg.min_poses_between, jnp.int32),
        drift_dx=zf((n_agents,), jnp.float32), drift_dy=zf((n_agents,), jnp.float32),
        cl_lm_node=jnp.full((C,), -1, jnp.int32), cl_node=jnp.full((C,), -1, jnp.int32),
        cl_dx=zf((C,), jnp.float32), cl_dy=zf((C,), jnp.float32),
        cl_agent=jnp.full((C,), -1, jnp.int32), cl_count=jnp.zeros((), jnp.int32),
        lm_yaw=zf((L,), jnp.float32), lm_scan=zf((L, R), jnp.float32),
        cl_mx=zf((C,), jnp.float32), cl_my=zf((C,), jnp.float32),
        cl_mth=zf((C,), jnp.float32),
        cl_fit=jnp.full((C,), -1.0, jnp.float32),
        last_pair_node=jnp.full((n_agents,), -(1 << 30), jnp.int32))


def closure_add_pose(state: ClosureState, x, y, agent, lm_type,
                     cfg: SlamConfig = SlamConfig(), valid=True,
                     yaw=None, scan=None):
    """Add one pose (already drift-corrected) and run the closure check.

    agent: int32 0-based agent index. valid: packet mask (padding rows
    leave the state untouched). Returns (new_state, closed, cdx, cdy).

    yaw/scan (optional): remembered with a stored landmark so later
    closures can be scan-matched; the scalar path itself logs edges
    UNMEASURED (cl_fit = -1) — measured closures are the batched
    throughput path's feature (closure_add_poses_batch), the parity
    path keeps the reference's exact semantics.
    """
    valid = jnp.asarray(valid)
    idx = state.n_nodes
    L = state.lm_x.shape[0]
    slots = jnp.arange(L, dtype=jnp.int32)

    has_lm = (lm_type != 0) & valid

    # --- batched first-match closure test (ref :292-326) --------------------
    occupied = slots < jnp.minimum(state.lm_count, L)
    same_type = state.lm_type == lm_type
    far_in_seq = (idx - state.lm_node) >= cfg.min_poses_between
    agent_ok = (idx - state.last_closure_node[agent]) >= cfg.min_poses_between
    d2 = (x - state.lm_x) ** 2 + (y - state.lm_y) ** 2
    near = d2 < cfg.closure_radius_m ** 2
    match = occupied & same_type & far_in_seq & near & agent_ok & has_lm
    if cfg.closure_same_agent_only:
        # The reference iterates ALL landmarks (:294), but its bots map
        # disjoint server-frame halves (separation offset :851-852), so
        # matching is effectively same-agent. In shared-frame swarm
        # worlds the cross-agent positional snap drags agents' drift
        # frames together and DEGRADES accuracy (tools/bench_accuracy
        # .py finding); cross-agent alignment is the scan-merge layer's
        # job (map_merger.py's role).
        match = match & (state.lm_agent == agent)

    any_match = jnp.any(match)
    first = jnp.argmin(jnp.where(match, slots, L))   # first in insertion order
    mx = state.lm_x[first]
    my = state.lm_y[first]
    cdx = jnp.where(any_match, (mx - x) * cfg.closure_correction, 0.0)
    cdy = jnp.where(any_match, (my - y) * cfg.closure_correction, 0.0)

    # --- state updates (all masked) -----------------------------------------
    last_cl = state.last_closure_node.at[agent].set(
        jnp.where(any_match, idx, state.last_closure_node[agent]))
    drift_dx = state.drift_dx.at[agent].add(jnp.where(any_match, cdx, 0.0))
    drift_dy = state.drift_dy.at[agent].add(jnp.where(any_match, cdy, 0.0))

    # closure log append
    C = state.cl_lm_node.shape[0]
    cslot = jnp.mod(state.cl_count, C)
    def put(buf, val):
        return buf.at[cslot].set(jnp.where(any_match, val, buf[cslot]))
    cl_lm_node = put(state.cl_lm_node, state.lm_node[first])
    cl_node = put(state.cl_node, idx)
    cl_dx = put(state.cl_dx, cdx)
    cl_dy = put(state.cl_dy, cdy)
    cl_agent = put(state.cl_agent, agent.astype(jnp.int32)
                   if hasattr(agent, "astype") else jnp.int32(agent))
    cl_mx = put(state.cl_mx, 0.0)
    cl_my = put(state.cl_my, 0.0)
    cl_mth = put(state.cl_mth, 0.0)
    cl_fit = put(state.cl_fit, -1.0)
    cl_count = state.cl_count + jnp.where(any_match, 1, 0)

    # landmark append AFTER matching (ref :288)
    lslot = jnp.mod(state.lm_count, L)
    lm_x = state.lm_x.at[lslot].set(jnp.where(has_lm, x, state.lm_x[lslot]))
    lm_y = state.lm_y.at[lslot].set(jnp.where(has_lm, y, state.lm_y[lslot]))
    lm_t = state.lm_type.at[lslot].set(
        jnp.where(has_lm, lm_type, state.lm_type[lslot]))
    lm_n = state.lm_node.at[lslot].set(
        jnp.where(has_lm, idx, state.lm_node[lslot]))
    lm_a = state.lm_agent.at[lslot].set(
        jnp.where(has_lm, jnp.asarray(agent, jnp.int32),
                  state.lm_agent[lslot]))
    lm_yaw = state.lm_yaw.at[lslot].set(
        jnp.where(has_lm, 0.0 if yaw is None else yaw,
                  state.lm_yaw[lslot]))
    if scan is None or not cfg.closure_scanmatch:
        lm_scan = state.lm_scan
    else:
        lm_scan = state.lm_scan.at[lslot].set(
            jnp.where(has_lm, scan, state.lm_scan[lslot]))
    lm_count = state.lm_count + jnp.where(has_lm, 1, 0)

    new = ClosureState(
        lm_x=lm_x, lm_y=lm_y, lm_type=lm_t, lm_node=lm_n, lm_agent=lm_a,
        lm_count=lm_count,
        n_nodes=idx + jnp.where(valid, 1, 0),
        last_closure_node=last_cl, drift_dx=drift_dx, drift_dy=drift_dy,
        cl_lm_node=cl_lm_node, cl_node=cl_node, cl_dx=cl_dx, cl_dy=cl_dy,
        cl_agent=cl_agent, cl_count=cl_count,
        lm_yaw=lm_yaw, lm_scan=lm_scan,
        cl_mx=cl_mx, cl_my=cl_my, cl_mth=cl_mth, cl_fit=cl_fit,
        last_pair_node=state.last_pair_node)
    return new, any_match, cdx, cdy


def closure_add_poses_batch(state: ClosureState, xs, ys, agents, lm_types,
                            cfg: SlamConfig = SlamConfig(), valid=None,
                            yaws=None, scans=None, grid=None, sens=None):
    """Throughput-mode closure: one step's worth of packets (one per agent,
    distinct agents) matched against the landmark store SIMULTANEOUSLY.

    Same guards as the reference check (dual_bot_mapper.py:292-326), with one
    documented divergence from the sequential scan: packets in the same batch
    match only against landmarks stored BEFORE the batch, never against each
    other — at the reference's >= 30-pose index gap this cannot change
    results, because same-batch landmarks are 0..N-1 indices apart.

    xs, ys: [M]; agents: [M] int32 (must be distinct); lm_types: [M] int32.
    Returns (new_state, closed [M] bool, cdx [M], cdy [M]).

    With cfg.closure_scanmatch and yaws/scans/grid/sens provided, stored
    landmarks remember the sweep, and each fired closure is scan-matched
    against its stored scan (slam/closurematch.py) — the log then carries
    a real SE(2) edge measurement + fitness (cl_mx/my/mth/fit). The whole
    matcher runs under a lax.cond gated on "any closure this step", so
    closure-free steps pay nothing.
    """
    xs = jnp.asarray(xs)
    M = xs.shape[0]
    if valid is None:
        valid = jnp.ones((M,), bool)
    base = state.n_nodes
    vi = valid.astype(jnp.int32)
    # node index of each packet = base + number of valid packets before it
    idxs = base + jnp.cumsum(vi) - vi

    has_lm = (lm_types != 0) & valid
    L = state.lm_x.shape[0]
    slots = jnp.arange(L, dtype=jnp.int32)
    occupied = slots < jnp.minimum(state.lm_count, L)

    same_type = state.lm_type[None, :] == lm_types[:, None]          # [M, L]
    far_in_seq = (idxs[:, None] - state.lm_node[None, :]) >= cfg.min_poses_between
    agent_ok = (idxs - state.last_closure_node[agents]) >= cfg.min_poses_between
    d2 = (xs[:, None] - state.lm_x[None, :]) ** 2 + \
         (ys[:, None] - state.lm_y[None, :]) ** 2
    near = d2 < cfg.closure_radius_m ** 2
    match = occupied[None, :] & same_type & far_in_seq & near & \
        (agent_ok & has_lm)[:, None]                                  # [M, L]
    if cfg.closure_same_agent_only:
        # see closure_add_pose: the effective reference behavior in
        # shared-frame swarm worlds. Filters the REFERENCE-style term
        # only — the verified rendezvous term below is an independent
        # mechanism (it exists precisely because unverified cross
        # matching is what this filter protects against).
        match = match & (state.lm_agent[None, :] == agents[:, None])
    if cfg.closure_cross_radius_m > 0 and cfg.closure_scanmatch:
        # RENDEZVOUS cross-agent closures (SlamConfig
        # .closure_cross_radius_m): another agent's stored landmark
        # within the cross radius matches with NO type equality and NO
        # time gap — independent frames make even same-time edges
        # informative, and the scan-match fitness gate (below) is the
        # false-match filter the type heuristic was standing in for.
        # DETECTION-ONLY and lower priority than the reference-style
        # term: a rendezvous event logs an edge (+ measurement) but
        # NEVER drives the online positional snap — an unverified snap
        # toward a point up to the cross radius away is exactly the
        # radius-grade noise this mechanism exists to avoid, and the
        # verification result isn't known until after the (costly,
        # cond-gated) matcher runs. It does consume the per-agent
        # cooldown (rate-limits log flooding near a roommate; can delay
        # an intra closure by up to min_poses_between — accepted).
        other = state.lm_agent[None, :] != agents[:, None]
        near_x = d2 < cfg.closure_cross_radius_m ** 2
        cross = (occupied[None, :] & other & near_x &
                 (agent_ok & has_lm)[:, None])
        intra_any = jnp.any(match, axis=1)
        snap = intra_any                    # only intra matches snap
        match = jnp.where(intra_any[:, None], match, cross)
    else:
        snap = None

    closed = jnp.any(match, axis=1)                                   # [M]
    if snap is None:
        snap = closed
    first = jnp.argmin(jnp.where(match, slots[None, :], L), axis=1)   # [M]
    mx = state.lm_x[first]
    my = state.lm_y[first]
    cdx = jnp.where(snap, (mx - xs) * cfg.closure_correction, 0.0)
    cdy = jnp.where(snap, (my - ys) * cfg.closure_correction, 0.0)

    safe_agents = jnp.where(valid, agents, 0)
    last_cl = state.last_closure_node.at[safe_agents].set(
        jnp.where(closed, idxs, state.last_closure_node[safe_agents]))
    drift_dx = state.drift_dx.at[safe_agents].add(cdx)
    drift_dy = state.drift_dy.at[safe_agents].add(cdy)

    # --- closure log append (packet order within the batch) -----------------
    C = state.cl_lm_node.shape[0]
    ci = closed.astype(jnp.int32)
    cpos = state.cl_count + jnp.cumsum(ci) - ci
    cslot = jnp.where(closed, jnp.mod(cpos, C), C)   # C = out of bounds, drop
    cl_lm_node = state.cl_lm_node.at[cslot].set(state.lm_node[first], mode="drop")
    cl_node = state.cl_node.at[cslot].set(idxs, mode="drop")
    cl_dx = state.cl_dx.at[cslot].set(cdx, mode="drop")
    cl_dy = state.cl_dy.at[cslot].set(cdy, mode="drop")
    cl_agent = state.cl_agent.at[cslot].set(agents.astype(jnp.int32), mode="drop")
    cl_count = state.cl_count + jnp.sum(ci)

    # --- scan-matched edge measurement (cond-gated off closure-free steps)
    measure_on = (cfg.closure_scanmatch and scans is not None
                  and grid is not None and sens is not None)
    if measure_on:
        from swarm_tpu.slam.closurematch import match_scan_pairs_batch
        first_safe = jnp.minimum(first, L - 1)
        K = min(M, max(1, cfg.closure_match_budget))

        def run_match(_):
            # fixed measurement budget: gather the <= K packets that
            # CLOSED (argsort puts them first) and match only those — a
            # masked full-fleet matcher would pay N windows for one
            # closing agent at swarm scale
            sel = jnp.argsort(~closed)[:K]
            f_sel = first_safe[sel]
            m, meas = match_scan_pairs_batch(
                scans[sel], (xs[sel], ys[sel], yaws[sel]),
                state.lm_scan[f_sel],
                (state.lm_x[f_sel], state.lm_y[f_sel],
                 state.lm_yaw[f_sel]),
                cfg, grid, sens)
            ok = m.ok & closed[sel]
            z = jnp.zeros_like(xs)
            return (z.at[sel].set(jnp.where(ok, meas[:, 0], 0.0)),
                    z.at[sel].set(jnp.where(ok, meas[:, 1], 0.0)),
                    z.at[sel].set(jnp.where(ok, meas[:, 2], 0.0)),
                    jnp.full_like(xs, -1.0).at[sel].set(
                        jnp.where(ok, m.fitness, -1.0)))

        def skip(_):
            z = jnp.zeros_like(xs)
            return z, z, z, jnp.full_like(xs, -1.0)

        mx_v, my_v, mth_v, fit_v = jax.lax.cond(
            jnp.any(closed), run_match, skip, None)
    else:
        z = jnp.zeros_like(xs)
        mx_v, my_v, mth_v, fit_v = z, z, z, jnp.full_like(xs, -1.0)
    cl_mx = state.cl_mx.at[cslot].set(mx_v, mode="drop")
    cl_my = state.cl_my.at[cslot].set(my_v, mode="drop")
    cl_mth = state.cl_mth.at[cslot].set(mth_v, mode="drop")
    cl_fit = state.cl_fit.at[cslot].set(fit_v, mode="drop")

    # --- proximity-pair rendezvous (SlamConfig.closure_pair_budget) ----
    # Up to K closest pairs of live agents within the cross radius get
    # their CURRENT scans matched scan-to-scan: agent j's sweep splats
    # the window, agent i's matches into it (closurematch.py), and a
    # verified match logs a measured cross edge (stored node = j's
    # current node, frame of the measurement). Needs no landmarks and no
    # global cooldown — the per-agent pair cooldown rate-limits instead.
    # Detection-only (never snaps), like the landmark rendezvous above.
    last_pair = state.last_pair_node
    pair_on = (cfg.closure_pair_budget > 0 and measure_on
               and cfg.closure_cross_radius_m > 0)
    if pair_on:
        K2 = min(cfg.closure_pair_budget, max(1, M // 2))
        d2p = (xs[:, None] - xs[None, :]) ** 2 + \
            (ys[:, None] - ys[None, :]) ** 2
        cool = (idxs - last_pair[agents]) >= cfg.closure_pair_cooldown
        lower = jnp.arange(M)[:, None] < jnp.arange(M)[None, :]   # i<j
        cand = (valid[:, None] & valid[None, :] & cool[:, None] &
                cool[None, :] & lower &
                (d2p < cfg.closure_cross_radius_m ** 2))
        neg_d2 = jnp.where(cand, -d2p, -jnp.inf)
        top_v, top_i = jax.lax.top_k(neg_d2.reshape(-1), K2)
        pi = top_i // M
        pj = top_i % M
        att2 = top_v > -jnp.inf                                  # [K2]

        def run_pair(_):
            from swarm_tpu.slam.closurematch import \
                match_scan_pairs_batch
            m2, meas2 = match_scan_pairs_batch(
                scans[pi], (xs[pi], ys[pi], yaws[pi]),
                scans[pj], (xs[pj], ys[pj], yaws[pj]),
                cfg, grid, sens)
            ok2 = m2.ok & m2.distinct & att2
            return (ok2, meas2[:, 0], meas2[:, 1], meas2[:, 2],
                    m2.fitness)

        def skip_pair(_):
            z2 = jnp.zeros((K2,), jnp.float32)
            return jnp.zeros((K2,), bool), z2, z2, z2, z2

        ok2, pmx, pmy, pmth, pfit = jax.lax.cond(
            jnp.any(att2), run_pair, skip_pair, None)

        # append verified pair edges after this step's regular edges
        p_i32 = ok2.astype(jnp.int32)
        ppos = cl_count + jnp.cumsum(p_i32) - p_i32
        pslot = jnp.where(ok2, jnp.mod(ppos, C), C)
        cl_lm_node = cl_lm_node.at[pslot].set(idxs[pj], mode="drop")
        cl_node = cl_node.at[pslot].set(idxs[pi], mode="drop")
        cl_dx = cl_dx.at[pslot].set(0.0, mode="drop")
        cl_dy = cl_dy.at[pslot].set(0.0, mode="drop")
        cl_agent = cl_agent.at[pslot].set(
            agents[pi].astype(jnp.int32), mode="drop")
        cl_mx = cl_mx.at[pslot].set(pmx, mode="drop")
        cl_my = cl_my.at[pslot].set(pmy, mode="drop")
        cl_mth = cl_mth.at[pslot].set(pmth, mode="drop")
        cl_fit = cl_fit.at[pslot].set(
            jnp.where(ok2, pfit, -1.0), mode="drop")
        cl_count = cl_count + jnp.sum(p_i32)

        # cooldown consumes on ATTEMPT (a failing stationary pair must
        # not hog the budget every step); scatter-max keeps the newest
        pa = jnp.concatenate([agents[pi], agents[pj]])
        pn = jnp.concatenate([jnp.where(att2, idxs[pi], -(1 << 30)),
                              jnp.where(att2, idxs[pj], -(1 << 30))])
        psl = jnp.where(jnp.concatenate([att2, att2]), pa,
                        last_pair.shape[0])
        last_pair = last_pair.at[psl].max(pn, mode="drop")

    # --- landmark appends AFTER matching, packet order ----------------------
    hi = has_lm.astype(jnp.int32)
    lpos = state.lm_count + jnp.cumsum(hi) - hi
    lslot = jnp.where(has_lm, jnp.mod(lpos, L), L)
    lm_x = state.lm_x.at[lslot].set(xs, mode="drop")
    lm_y = state.lm_y.at[lslot].set(ys, mode="drop")
    lm_t = state.lm_type.at[lslot].set(lm_types, mode="drop")
    lm_n = state.lm_node.at[lslot].set(idxs, mode="drop")
    lm_a = state.lm_agent.at[lslot].set(agents.astype(jnp.int32),
                                        mode="drop")
    lm_yaw = state.lm_yaw.at[lslot].set(
        jnp.zeros_like(xs) if yaws is None else yaws, mode="drop")
    if scans is None or not cfg.closure_scanmatch:
        # closure_init sized lm_scan [L, 1] when scanmatch is off
        lm_scan = state.lm_scan
    else:
        lm_scan = state.lm_scan.at[lslot].set(scans, mode="drop")
    lm_count = state.lm_count + jnp.sum(hi)

    new = ClosureState(
        lm_x=lm_x, lm_y=lm_y, lm_type=lm_t, lm_node=lm_n, lm_agent=lm_a,
        lm_count=lm_count,
        n_nodes=base + jnp.sum(vi),
        last_closure_node=last_cl, drift_dx=drift_dx, drift_dy=drift_dy,
        cl_lm_node=cl_lm_node, cl_node=cl_node, cl_dx=cl_dx, cl_dy=cl_dy,
        cl_agent=cl_agent, cl_count=cl_count,
        lm_yaw=lm_yaw, lm_scan=lm_scan,
        cl_mx=cl_mx, cl_my=cl_my, cl_mth=cl_mth, cl_fit=cl_fit,
        last_pair_node=last_pair)
    return new, closed, cdx, cdy

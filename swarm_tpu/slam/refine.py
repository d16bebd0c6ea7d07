"""Session refinement: pose-graph optimisation over logged trajectories.

The reference applies closures online as damped positional nudges and never
revisits past poses (dual_bot_mapper.py:308-326) — the map keeps whatever
drift accumulated before each closure. This module is the offline
north-star upgrade: rebuild each agent's trajectory as an SE(2) pose graph
(odometry edges from the logged estimates + closure edges from the closure
log), solve with batched Gauss-Newton (slam/posegraph.py), and re-raster
the map from the corrected poses.

Works on any reference-schema session directory (ours or the reference's),
so it also serves as the replacement for map_merger.py's offline alignment
pass.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from swarm_tpu.config import SwarmConfig
from swarm_tpu.slam.posegraph import gauss_newton, graph_from_trajectory


def _next_pow2(n: int) -> int:
    m = 64
    while m < n:
        m *= 2
    return m


def refine_agent_trajectory(xs, ys, yaws, closure_pairs,
                            iterations: int = 15,
                            closure_weight=(4.0, 4.0, 0.0),
                            closure_meas=None, meas_weight=None,
                            damping: float = 1e-3,
                            anchor_weight: float = 1e6,
                            unary=None):
    """One agent's logged estimates [T] + closure index pairs [(i, j)] ->
    optimised poses [T, 3]. Capacity-padded to a power of two so repeated
    calls share compiled solvers.

    closure_pairs: [(i, j)] with i the STORED (earlier) node and j the
    revisit — measured edges are directional (meas lives in frame i).

    closure_weight: per-component (x, y, theta) information weights for
    the closure edges (a scalar is broadcast to all three). A landmark
    revisit is a POSITION-only constraint with ~closure-radius noise
    (0.6 m, dual_bot_mapper.py:96) against ~cm-level odometry edges —
    the default therefore puts ZERO weight on theta (the reference's
    online snap is also translation-only, :308-326) and a moderate
    weight on x/y; weighting closures like odometry (25, 25, 25) was
    measured to DRAG the refined trajectory wrong by up to the revisit
    radius (tools/bench_accuracy.py).

    closure_meas: optional list aligned to closure_pairs of SE(2) edge
    measurements (mx, my, mth) in frame i — the scan-matched closures
    of SlamConfig.closure_scanmatch — with None marking coincidence
    edges; measured edges get `meas_weight` (default
    SlamConfig.closure_meas_weight's (50, 50, 10)).

    unary: optional (nodes [Q], meas [Q, 3], weight [Q, 3]) ABSOLUTE
    pose observations — fitness-verified anchored-merge matches
    (slam/livemerge.py): the matched pose is an observation in the
    anchor frame, the external reference this drift regime needs
    (drift is observable only against EXTERNAL references). Padded to a power-of-two capacity with zero
    weight so repeated calls share compiled solvers."""
    t = len(xs)
    cap = _next_pow2(t)
    poses = np.zeros((cap, 3), np.float32)
    poses[:t, 0] = xs
    poses[:t, 1] = ys
    poses[:t, 2] = yaws
    unary_j = None
    if unary is not None:
        un, um, uw = unary
        q = _next_pow2(max(1, len(un)))
        n_pad = np.zeros((q,), np.int32)
        m_pad = np.zeros((q, 3), np.float32)
        w_pad = np.zeros((q, 3), np.float32)
        n_pad[:len(un)] = un
        m_pad[:len(un)] = um
        w_pad[:len(un)] = uw
        unary_j = (jnp.asarray(n_pad), jnp.asarray(m_pad),
                   jnp.asarray(w_pad))

    # closure capacity bucketed to a power of two: per-agent closure
    # counts vary, and an exact-capacity graph would force one solver
    # compile PER AGENT (a 64-agent session refinement spent longer
    # compiling than solving before this)
    c = _next_pow2(max(1, len(closure_pairs)))
    ci = np.zeros((c,), np.int32)
    cj = np.zeros((c,), np.int32)
    if np.isscalar(closure_weight):
        closure_weight = (closure_weight,) * 3
    if meas_weight is None:
        from swarm_tpu.config import SlamConfig
        meas_weight = SlamConfig.closure_meas_weight
    meas = np.zeros((c, 3), np.float32)
    w = np.zeros((c, 3), np.float32)
    w[:len(closure_pairs)] = np.asarray(closure_weight, np.float32)
    for k, (i, j) in enumerate(closure_pairs):
        ci[k], cj[k] = i, j
        if closure_meas is not None and closure_meas[k] is not None:
            meas[k] = closure_meas[k]
            w[k] = np.asarray(meas_weight, np.float32)
    g = graph_from_trajectory(
        jnp.asarray(poses), t,
        closures_i=jnp.asarray(ci), closures_j=jnp.asarray(cj),
        closure_meas=jnp.asarray(meas),
        n_closures=len(closure_pairs),
        closure_weight=tuple(closure_weight))
    g = g._replace(weight=g.weight.at[cap - 1:].set(jnp.asarray(w)))
    if cap > 256:
        # long trajectories: the chain+closures structured solve
        # (block cyclic reduction + Woodbury, slam/tridiag.py) — the
        # dense [3M, 3M] Cholesky stops fitting/scaling past ~1k nodes
        from swarm_tpu.slam.tridiag import structured_gn
        out, costs = jax.jit(
            functools.partial(structured_gn, n_chain=cap - 1,
                              iterations=iterations, damping=damping,
                              anchor_weight=anchor_weight))(
            g, unary=unary_j)
    else:
        out, costs = jax.jit(
            functools.partial(gauss_newton, iterations=iterations,
                              damping=damping,
                              anchor_weight=anchor_weight))(
            g, unary=unary_j)
    return np.asarray(out.poses[:t]), np.asarray(costs)


def refine_session(session: Dict, closures: Optional[Tuple] = None,
                   cfg: SwarmConfig = SwarmConfig(),
                   iterations: int = 15,
                   closure_weight=(4.0, 4.0, 0.0),
                   unary: Optional[Dict] = None):
    """Refine every agent trajectory of a loaded session (proto.csvio
    .load_session dict). `closures`: (node_i, node_j, agent) arrays in
    GLOBAL packet-node indices (the slam_closures.csv columns + the
    closure log's agent ids), optionally extended with (meas [C, 3],
    fit [C]) — the scan-matched edge measurements of
    SlamConfig.closure_scanmatch; edges whose fit clears
    cfg.slam.merge_fitness_min use their measurement at
    cfg.slam.closure_meas_weight, the rest fall back to the coincidence
    weighting. If None, closures are re-detected from the telemetry with
    the reference's landmark matcher settings.

    Returns {agent (1-based): {"poses": [T,3] optimized,
                               "orig": [T,3], "idx": [T] global rows}}.
    """
    agents = np.unique(session["agent"])
    yaw_rad = np.radians(session["yaw_deg"])

    # per-agent views + global-row -> per-agent-index maps
    rows_of = {int(a): np.nonzero(session["agent"] == a)[0] for a in agents}
    inv = {}
    for a, rows in rows_of.items():
        m = np.full(len(session["t"]), -1, np.int64)
        m[rows] = np.arange(len(rows))
        inv[a] = m

    pairs = {int(a): [] for a in agents}
    pair_meas = {int(a): [] for a in agents}
    if closures is not None:
        # One parser for the (ni, nj, agent[, meas, fit]) log:
        # slam/joint.py::split_closures dedups (best-fitness duplicate
        # wins — the online detector can log one revisit hundreds of
        # times, and the pile-up drove the Woodbury cap near-singular),
        # drops self-pairs, and gates measurements at merge_fitness_min.
        # Per-agent refinement keeps the intra edges and ignores the
        # cross-agent ones (no graph spans two agents here — that is
        # joint_refine_session's job).
        from swarm_tpu.slam.joint import split_closures
        intra, intra_meas, _inter, _ = split_closures(
            session, closures, fit_min=cfg.slam.merge_fitness_min)
        pairs.update(intra)
        pair_meas.update(intra_meas)
    else:
        # re-detect: same-type landmarks within the closure radius,
        # >= min gap apart (per agent, like the online matcher but offline)
        slam = cfg.slam
        for a, rows in rows_of.items():
            lm = session["landmark"][rows]
            x = session["x"][rows]
            y = session["y"][rows]
            lm_rows = np.nonzero(lm != 0)[0]
            last = -slam.min_poses_between
            for i in lm_rows:
                if i - last < slam.min_poses_between:
                    continue
                cand = lm_rows[(lm_rows < i - slam.min_poses_between)]
                cand = cand[lm[cand] == lm[i]]
                if len(cand) == 0:
                    continue
                d2 = (x[cand] - x[i]) ** 2 + (y[cand] - y[i]) ** 2
                k = np.argmin(d2)
                if d2[k] < slam.closure_radius_m ** 2:
                    pairs[a].append((int(cand[k]), int(i)))
                    pair_meas[a].append(None)
                    last = i

    out = {}
    for a, rows in rows_of.items():
        orig = np.stack([session["x"][rows], session["y"][rows],
                         yaw_rad[rows]], axis=-1).astype(np.float32)
        if len(rows) < 2:
            out[a] = {"poses": orig, "orig": orig, "idx": rows,
                      "closures": pairs[a]}
            continue
        opt, _ = refine_agent_trajectory(
            orig[:, 0], orig[:, 1], orig[:, 2], pairs[a],
            iterations=iterations, closure_weight=closure_weight,
            closure_meas=pair_meas[a],
            meas_weight=cfg.slam.closure_meas_weight,
            unary=None if unary is None else unary.get(a))
        out[a] = {"poses": opt, "orig": orig, "idx": rows,
                  "closures": pairs[a],
                  "measured": sum(m is not None for m in pair_meas[a])}
    return out


def reraster_session(session, refined, cfg: SwarmConfig = SwarmConfig()):
    """Re-project every packet's rays from the OPTIMISED poses and build a
    fresh parity grid — the refined map. Returns (grid, stream)."""
    from swarm_tpu.engine.replay import PacketStream, replay_session

    t = session["t"]
    n = len(t)
    x = np.array(session["x"], np.float32)
    y = np.array(session["y"], np.float32)
    yaw = np.radians(session["yaw_deg"]).astype(np.float32)
    for a, r in refined.items():
        x[r["idx"]] = r["poses"][:, 0]
        y[r["idx"]] = r["poses"][:, 1]
        yaw[r["idx"]] = r["poses"][:, 2]

    stream = PacketStream(
        t=jnp.asarray(t),
        agent=jnp.asarray(session["agent"] - 1, jnp.int32),
        x=jnp.asarray(x), y=jnp.asarray(y), yaw=jnp.asarray(yaw),
        encoder=jnp.asarray(session["encoder"]),
        v2v=jnp.asarray(session["v2v"]),
        dist=jnp.asarray(session["dist_cm"] / 100.0),
        landmark=jnp.zeros((n,), jnp.int32),    # no double-closing
        valid=jnp.ones((n,), bool))
    state, _ = jax.jit(lambda s: replay_session(
        s, cfg, offsets=jnp.zeros(cfg.n_agents)))(stream)
    return np.asarray(state.grid), stream

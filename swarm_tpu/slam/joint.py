"""Joint multi-agent pose-graph refinement — the collaborative-SLAM
back-end the reference never had.

The reference's closure matcher already works ACROSS agents
(dual_bot_mapper.py:294 iterates ALL stored landmarks, any bot's), but
every correction it derives is a per-agent positional nudge; nothing
ever optimises two agents' trajectories against each other. Per-agent
refinement (slam/refine.py) inherits that limit structurally: a graph
spans one agent, so cross-agent closure edges in the log are silently
DROPPED. This module keeps them: agents connected by cross-agent
closures are solved as ONE joint SE(2) pose graph, so a well-localised
agent's trajectory pulls a badly-drifted partner's into the shared
frame through their common landmarks.

Batched structure — the joint problem is shaped to reuse the
structured solver (slam/tridiag.py) unchanged:

  * agent-major layout: agent block s owns nodes [s*S, (s+1)*S) with one
    power-of-two block size S, so the joint Hessian is ONE
    block-tridiagonal chain; chain edges that cross a block boundary or
    touch block padding get ZERO weight (contributes exactly nothing —
    the per-component weight masking is tested by
    test_zero_weight_closure_component_contributes_nothing);
  * every block's first node is anchored (swarm agents START from known
    home poses; the solver's `anchor_nodes`), so components stay
    well-posed even before any inter-agent edge fires;
  * intra- AND inter-agent closure edges enter through the same
    low-rank Woodbury fold — the solver never needs to know which
    agents an edge connects;
  * components are solved independently; identical capacity buckets
    (n_blocks, S, C) share one compiled solver. Component size bounds
    the memory: the Woodbury fold materializes U [3*k*S, 3C], so a
    64-agent component at S=2048 with ~64 verified edges is ~250 MB —
    fine; rendezvous edges connect spatial NEIGHBOURS, so components
    stay far below the fleet size in practice (a hypothetical
    fully-connected swarm would need hierarchical splitting first).

Inter-agent edges default to zero theta weight: two agents revisiting
the same landmark constrains relative POSITION only (their headings are
unrelated), and the landmark "position" is the detecting robot's pose
(slam/closure.py stores lm at the node position), so the measurement
noise is the corner-approach spread, not the sensor noise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from swarm_tpu.config import SwarmConfig
from swarm_tpu.slam.posegraph import graph_from_trajectory
from swarm_tpu.slam.refine import _next_pow2, refine_agent_trajectory
from swarm_tpu.slam.tridiag import structured_gn


def split_closures(session: Dict, closures: Tuple,
                   fit_min: float = 0.6):
    """Partition the closure log into per-agent and cross-agent edges.

    closures: (node_i, node_j, agent_j) in GLOBAL packet-row indices
    (the slam_closures.csv columns), optionally extended with
    (meas [C, 3], fit [C]) scan-matched measurements
    (SlamConfig.closure_scanmatch). node_i is the STORED (earlier)
    landmark's node — measurements live in its frame. Node OWNERSHIP is
    read from session["agent"][row]; the log's agent column only names
    the matching (current) agent, the stored landmark's owner is
    implicit in its node row.

    Returns (intra, intra_meas, inter, rows_of):
      intra: {agent: [(i, j)]} per-agent (stored, revisit) indices,
             dedup'd (best-fitness duplicate wins), self-pairs dropped;
      intra_meas: {agent: [meas|None]} aligned measurements;
      inter: [(agent_i, ii, agent_j, jj, meas|None)] cross-agent edges,
             per-agent indices, dedup'd under edge symmetry.
    """
    agents = np.unique(session["agent"])
    agent_of_row = np.asarray(session["agent"])
    rows_of = {int(a): np.nonzero(session["agent"] == a)[0] for a in agents}
    inv = {}
    for a, rows in rows_of.items():
        m = np.full(len(session["t"]), -1, np.int64)
        m[rows] = np.arange(len(rows))
        inv[a] = m

    ni, nj, _ = closures[:3]
    meas_arr = closures[3] if len(closures) > 3 else None
    fit_arr = closures[4] if len(closures) > 4 else None
    best_intra = {int(a): {} for a in agents}   # (i, j) -> (fit, meas)
    best_inter = {}                             # sym key -> (fit, edge)
    n_rows = len(agent_of_row)
    for k, (i, j) in enumerate(zip(ni, nj)):
        i, j = int(i), int(j)
        if not (0 <= i < n_rows and 0 <= j < n_rows):
            continue
        ai = int(agent_of_row[i])
        aj = int(agent_of_row[j])
        ii = int(inv[ai][i])
        jj = int(inv[aj][j])
        if ii < 0 or jj < 0:
            continue
        f = float(fit_arr[k]) if fit_arr is not None else -1.0
        m = (np.asarray(meas_arr[k], np.float32)
             if meas_arr is not None and f >= fit_min else None)
        if ai != aj and fit_arr is not None and m is None:
            # an UNMEASURED cross-agent edge from a scan-matching run is
            # a failed rendezvous verification: at the cross radius
            # (>= 2x the landmark spread) a bare coincidence edge is
            # ~radius-grade noise that measurably DRAGS the joint solve
            # (ATE 0.37 vs 0.22 raw with them kept) — drop it. Logs
            # without measurement columns (legacy 0.6 m matching) keep
            # their cross edges as coincidence.
            continue
        if ai == aj:
            if ii == jj:
                continue
            old = best_intra[ai].get((ii, jj))
            if old is None or f > old[0]:
                best_intra[ai][(ii, jj)] = (f, m)
        else:
            key = (ai, ii, aj, jj) if (ai, ii) < (aj, jj) \
                else (aj, jj, ai, ii)
            old = best_inter.get(key)
            if old is None or f > old[0]:
                best_inter[key] = (f, (ai, ii, aj, jj, m))
    intra = {a: list(d.keys()) for a, d in best_intra.items()}
    intra_meas = {a: [v[1] for v in d.values()]
                  for a, d in best_intra.items()}
    inter = [v[1] for v in best_inter.values()]
    return intra, intra_meas, inter, rows_of


def agent_components(agents, inter):
    """Union-find over agents: groups connected by >= 1 cross-agent edge.
    Returns a list of sorted agent-id tuples covering every agent."""
    parent = {int(a): int(a) for a in agents}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in inter:
        ra, rb = find(e[0]), find(e[2])
        if ra != rb:
            parent[ra] = rb
    groups: Dict[int, list] = {}
    for a in parent:
        groups.setdefault(find(a), []).append(a)
    return [tuple(sorted(g)) for g in groups.values()]


def _solve_joint_component(origs, intra, intra_meas, inter, iterations,
                           closure_weight, inter_weight, anchor_weight,
                           damping, meas_weight, unary=None):
    """One connected component -> {agent: [T, 3] optimised poses}.

    origs: {agent: [T, 3] float32 logged estimates} (insertion order =
    block order). Capacities (block size S, block count, closure count)
    are power-of-two bucketed so equally-shaped components share one
    compiled solver. Edges with a scan-matched measurement (intra_meas
    entries / inter 5th elements, frame = the stored node) use it at
    `meas_weight`; coincidence edges keep zero measurement at the
    intra/inter weights.

    unary: optional {agent: (nodes, meas [Q,3], weight [Q,3])} absolute
    pose observations in the shared frame (anchored-merge matches),
    mapped to the agent's block rows — see posegraph.unary_terms.
    """
    order = sorted(origs)
    k = len(order)
    s_cap = _next_pow2(max(len(p) for p in origs.values()))
    k_cap = 1 << max(0, (k - 1).bit_length())
    m = k_cap * s_cap
    poses = np.zeros((m, 3), np.float32)
    for s, a in enumerate(order):
        p = origs[a]
        poses[s * s_cap:s * s_cap + len(p)] = p
    slot = {a: s for s, a in enumerate(order)}

    # closure edges: (global_i, global_j, meas|None, base_weight)
    edges = []
    for a, ps in intra.items():
        base = slot[a] * s_cap
        for (i, j), mm in zip(ps, intra_meas[a]):
            edges.append((base + i, base + j, mm, closure_weight))
    for ai, ii, aj, jj, mm in inter:
        edges.append((slot[ai] * s_cap + ii, slot[aj] * s_cap + jj,
                      mm, inter_weight))
    c_cap = _next_pow2(max(1, len(edges)))
    ci = np.zeros((c_cap,), np.int32)
    cj = np.zeros((c_cap,), np.int32)
    meas = np.zeros((c_cap, 3), np.float32)
    wcl = np.zeros((c_cap, 3), np.float32)
    for e, (i, j, mm, bw) in enumerate(edges):
        ci[e], cj[e] = i, j
        if mm is not None:
            meas[e] = mm
            wcl[e] = np.asarray(meas_weight, np.float32)
        else:
            wcl[e] = np.asarray(bw, np.float32)

    g = graph_from_trajectory(
        jnp.asarray(poses), m,
        closures_i=jnp.asarray(ci), closures_j=jnp.asarray(cj),
        closure_meas=jnp.asarray(meas),
        n_closures=len(edges))

    # weight surgery (host-side, [E, 3]):
    #  - chain edges crossing a block boundary, inside padding, or in an
    #    empty block -> 0 (the blocks must stay decoupled);
    #  - closure rows -> the per-edge weights above.
    w = np.asarray(g.weight).copy()
    e_idx = np.arange(m - 1)
    blk = e_idx // s_cap
    within = e_idx % s_cap
    t_of_blk = np.zeros(k_cap, np.int64)
    for s, a in enumerate(order):
        t_of_blk[s] = len(origs[a])
    live = (within + 1 < t_of_blk[blk]) & (within + 1 < s_cap)
    w[:m - 1] *= live[:, None]
    w[m - 1:] = wcl
    g = g._replace(weight=jnp.asarray(w))

    unary_j = None
    if unary:
        gn, gm, gw = [], [], []
        for a, (un, um, uw) in unary.items():
            if a not in slot or len(un) == 0:
                continue
            gn.append(np.asarray(un, np.int64) + slot[a] * s_cap)
            gm.append(np.asarray(um, np.float32))
            gw.append(np.asarray(uw, np.float32))
        if gn:
            gn = np.concatenate(gn)
            gm = np.concatenate(gm, axis=0)
            gw = np.concatenate(gw, axis=0)
            q = _next_pow2(max(1, len(gn)))
            n_pad = np.zeros((q,), np.int32)
            m_pad = np.zeros((q, 3), np.float32)
            w_pad = np.zeros((q, 3), np.float32)
            n_pad[:len(gn)] = gn
            m_pad[:len(gn)] = gm
            w_pad[:len(gn)] = gw
            unary_j = (jnp.asarray(n_pad), jnp.asarray(m_pad),
                       jnp.asarray(w_pad))

    anchor_nodes = np.arange(k_cap, dtype=np.int32) * s_cap
    import functools
    out, costs = jax.jit(functools.partial(
        structured_gn, n_chain=m - 1, iterations=iterations,
        damping=damping, anchor_weight=anchor_weight,
        anchor_nodes=anchor_nodes))(g, unary=unary_j)
    opt = np.asarray(out.poses)
    return {a: opt[slot[a] * s_cap:slot[a] * s_cap + len(origs[a])]
            for a in order}, np.asarray(costs)


def joint_refine_session(session: Dict, closures: Optional[Tuple] = None,
                         cfg: SwarmConfig = SwarmConfig(),
                         iterations: int = 15,
                         closure_weight=(4.0, 4.0, 0.0),
                         inter_weight=(4.0, 4.0, 0.0),
                         anchor_weight: float = 1e6,
                         damping: float = 1e-3,
                         unary: Optional[Dict] = None):
    """refine_session drop-in that KEEPS cross-agent closure edges.

    Groups of agents connected by cross-agent closures solve as one
    joint graph per connected component (single-agent components fall
    back to the per-agent path — identical output). Returns the
    refine_session dict, each agent annotated with its `component` and
    the number of `inter_edges` its component used.

    unary: optional {agent (1-based): (nodes, meas [Q,3], weight [Q,3])}
    absolute pose observations (anchored-merge matches) in PER-AGENT
    node indices — see refine_agent_trajectory.
    """
    if closures is None:
        raise ValueError("joint refinement needs the logged closure "
                         "edges (re-detection is per-agent only — use "
                         "slam.refine.refine_session)")
    yaw_rad = np.radians(session["yaw_deg"])
    intra, intra_meas, inter, rows_of = split_closures(
        session, closures, fit_min=cfg.slam.merge_fitness_min)
    meas_weight = cfg.slam.closure_meas_weight

    origs = {}
    for a, rows in rows_of.items():
        origs[a] = np.stack(
            [session["x"][rows], session["y"][rows], yaw_rad[rows]],
            axis=-1).astype(np.float32)

    out = {}
    for comp in agent_components(rows_of.keys(), inter):
        comp_inter = [e for e in inter if e[0] in comp]
        if len(comp) == 1 or not comp_inter:
            for a in comp:
                orig = origs[a]
                if len(rows_of[a]) < 2:
                    opt = orig
                else:
                    opt, _ = refine_agent_trajectory(
                        orig[:, 0], orig[:, 1], orig[:, 2], intra[a],
                        iterations=iterations,
                        closure_weight=closure_weight,
                        closure_meas=intra_meas[a],
                        meas_weight=meas_weight,
                        damping=damping, anchor_weight=anchor_weight,
                        unary=None if unary is None else unary.get(a))
                out[a] = {"poses": opt, "orig": orig, "idx": rows_of[a],
                          "closures": intra[a], "component": comp,
                          "inter_edges": 0}
            continue
        solved, _ = _solve_joint_component(
            {a: origs[a] for a in comp},
            {a: intra[a] for a in comp},
            {a: intra_meas[a] for a in comp}, comp_inter,
            iterations, closure_weight, inter_weight, anchor_weight,
            damping, meas_weight,
            unary=None if unary is None else
            {a: unary[a] for a in comp if a in unary})
        for a in comp:
            out[a] = {"poses": solved[a], "orig": origs[a],
                      "idx": rows_of[a], "closures": intra[a],
                      "component": comp,
                      "inter_edges": len(comp_inter)}
    return out

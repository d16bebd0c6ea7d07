"""Greedy frontier-to-agent assignment.

The reference algorithm exists but is commented out on both ends
(server: dual_bot_mapper.py:959-996; firmware TARG handler:
AgentFirmware_Bot1.ino:126-139). Per SURVEY §7 ("reference quirks") it is
implemented here behind the engine's `enable_targets` flag: greedy
nearest-unused centroid per online agent, in agent order, rejecting
centroids within FRONTIER_SEPARATION of an already-assigned target.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from swarm_tpu.config import CoordConfig


def greedy_assign(agent_xy, online, centroids, n_centroids,
                  cfg: CoordConfig = CoordConfig(), room_boxes=None):
    """agent_xy: [N, 2]; online: [N]; centroids: [K, 2]; n_centroids: int32.
    Returns (targets [N, 2], has_target [N] bool).

    room_boxes [N, 4] (x0, y0, x1, y1), optional: restrict each agent's
    candidates to centroids inside its own box. The reference's 2-bot
    world is one shared room so every frontier is reachable by straight
    drive (GO_TO_TARGET has no path planner, ino:556-605); in multi-room
    swarm worlds an agent assigned a frontier in ANOTHER closed room
    drives at a wall forever — containment is the reachability test."""
    n = agent_xy.shape[0]
    k = centroids.shape[0]
    exists = jnp.arange(k) < n_centroids
    if room_boxes is not None:
        pad = 1e-3
        inside = ((centroids[None, :, 0] >= room_boxes[:, None, 0] - pad) &
                  (centroids[None, :, 0] <= room_boxes[:, None, 2] + pad) &
                  (centroids[None, :, 1] >= room_boxes[:, None, 1] - pad) &
                  (centroids[None, :, 1] <= room_boxes[:, None, 3] + pad))

    def per_agent(carry, i):
        used, tgts, has = carry
        ax = agent_xy[i]
        # separation check vs already-assigned targets (ref :976-983)
        sep2 = jnp.sum((centroids[:, None, :] - tgts[None, :, :]) ** 2, -1)
        too_close = jnp.any((sep2 < cfg.frontier_separation_m ** 2) &
                            has[None, :], axis=1)
        cand = exists & ~used & ~too_close
        if room_boxes is not None:
            cand = cand & inside[i]
        d2 = jnp.sum((centroids - ax[None, :]) ** 2, axis=-1)
        d2 = jnp.where(cand, d2, jnp.inf)
        best = jnp.argmin(d2)
        ok = online[i] & jnp.any(cand)
        used = used.at[best].set(used[best] | ok)
        tgts = tgts.at[i].set(jnp.where(ok, centroids[best], tgts[i]))
        has = has.at[i].set(ok)
        return (used, tgts, has), None

    init = (jnp.zeros((k,), bool), jnp.zeros((n, 2), centroids.dtype),
            jnp.zeros((n,), bool))
    (used, tgts, has), _ = jax.lax.scan(per_agent, init, jnp.arange(n))
    return tgts, has


def greedy_assign_rooms(agent_xy, online, centroids, n_centroids,
                        cfg: CoordConfig = CoordConfig(), room_boxes=None):
    """Room-parallel greedy assignment for swarm scale.

    `greedy_assign` scans agents SEQUENTIALLY (reference order,
    dual_bot_mapper.py:966-994) — at 1024 agents that is 1024 dependent
    loop iterations of tiny vector work, pure launch latency on an
    accelerator. With per-room candidate restriction the
    greedy order DECOMPOSES: agents in different rooms share no
    candidates, so only each agent's rank WITHIN its room orders the
    picks. This variant runs R = max(agents per room) vectorized rounds
    (R == 2 in the bench worlds); round r assigns every rank-r agent at
    once over [N, K] masks.

    Exactness vs `greedy_assign` (same agent set, room_boxes given):
      - identical whenever rooms' candidate sets are disjoint and no two
        picked targets in DIFFERENT rooms fall within
        frontier_separation_m of each other (cross-room suppression is
        applied between rounds, not within one);
      - a centroid lying in two agents' boxes (shared-wall corner,
        pad 1e-3) is claimed by the lowest agent index that round —
        losers go targetless instead of taking their next-best.
    Both deviations are near-wall corner cases of OUR extension (the
    reference ships this feature disabled); the engines use this path
    only above CoordConfig.assign_rooms_min_agents.

    Requires CONCRETE room_boxes (host-side grouping at trace time) —
    engines already reject traced geometry when targets are enabled.
    """
    assert room_boxes is not None
    rb = np.asarray(room_boxes)                  # raises on tracers — wanted
    n = agent_xy.shape[0]
    k = centroids.shape[0]
    _, room_id = np.unique(rb, axis=0, return_inverse=True)
    rank = np.zeros(n, np.int64)
    next_rank = {}
    for i, r in enumerate(room_id):
        rank[i] = next_rank.get(r, 0)
        next_rank[r] = int(rank[i]) + 1
    n_rounds = int(rank.max()) + 1

    exists = jnp.arange(k) < n_centroids
    pad = 1e-3
    boxes = jnp.asarray(rb, centroids.dtype)
    inside = ((centroids[None, :, 0] >= boxes[:, None, 0] - pad) &
              (centroids[None, :, 0] <= boxes[:, None, 2] + pad) &
              (centroids[None, :, 1] >= boxes[:, None, 1] - pad) &
              (centroids[None, :, 1] <= boxes[:, None, 3] + pad))
    # pairwise centroid separation (targets are always centroids, so the
    # reference's dist-to-assigned-target test reduces to this table)
    c2 = jnp.sum((centroids[:, None, :] - centroids[None, :, :]) ** 2, -1)
    near = c2 < cfg.frontier_separation_m ** 2   # [K, K]
    d2_all = jnp.sum((centroids[None, :, :] - agent_xy[:, None, :]) ** 2,
                     -1)                         # [N, K]

    used = jnp.zeros((k,), bool)
    tgts = jnp.zeros((n, 2), centroids.dtype)
    has = jnp.zeros((n,), bool)
    agent_ids = jnp.arange(n, dtype=jnp.int32)
    for r in range(n_rounds):                    # unrolled, tiny
        act = jnp.asarray(rank == r)             # static per-round mask
        too_close = jnp.any(near & used[None, :], axis=1)
        cand = (exists & ~used & ~too_close)[None, :] & inside & \
            act[:, None]
        d2 = jnp.where(cand, d2_all, jnp.inf)
        best = jnp.argmin(d2, axis=1)            # [N]
        ok = online & act & jnp.any(cand, axis=1)
        # same-round conflicts (shared-corner centroids): lowest agent
        # index wins, matching greedy order
        claim = jnp.where(ok, best, k)
        winner = jnp.full((k + 1,), n, jnp.int32).at[claim].min(agent_ids)
        win = ok & (winner[claim] == agent_ids)
        used = used | (jnp.zeros((k + 1,), bool).at[claim].max(win))[:k]
        tgts = jnp.where(win[:, None], centroids[best], tgts)
        has = has | win
    return tgts, has

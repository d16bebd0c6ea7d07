"""Territory zones: per-agent AABBs of mapped area.

Reference: every 2 s the server computes, for each bot, the bounding box of
the OTHER bot's entire accumulated point cloud + path and sends it as the
bot's forbidden zone; an offline bot's zone is lifted
(dual_bot_mapper.py:702-706, 921-945). The O(all-points) rescan becomes a
running min/max — AABB is associative, so the result is identical.

N-agent generalisation (the reference only has 2): each agent's forbidden
box is the territory AABB of its NEAREST other online agent — for N = 2
this reduces exactly to the reference's behavior. The firmware only holds
one box (AgentFirmware_Bot1.ino:65-79), so one box per agent is also what
the protocol supports.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class ZoneState(NamedTuple):
    """Running per-agent territory AABBs over hits + path."""
    min_x: jnp.ndarray   # [N]
    min_y: jnp.ndarray
    max_x: jnp.ndarray
    max_y: jnp.ndarray
    has_any: jnp.ndarray  # [N] bool


def zone_init(n_agents: int) -> ZoneState:
    big = jnp.full((n_agents,), jnp.inf, jnp.float32)
    return ZoneState(min_x=big, min_y=big, max_x=-big, max_y=-big,
                     has_any=jnp.zeros((n_agents,), bool))


def zone_observe(z: ZoneState, agent, xs, ys, valid) -> ZoneState:
    """Fold a batch of points (path positions and/or world hits) belonging
    to `agent` into its running AABB. xs, ys, valid: [...] arrays."""
    any_valid = jnp.any(valid)
    mnx = jnp.min(jnp.where(valid, xs, jnp.inf))
    mny = jnp.min(jnp.where(valid, ys, jnp.inf))
    mxx = jnp.max(jnp.where(valid, xs, -jnp.inf))
    mxy = jnp.max(jnp.where(valid, ys, -jnp.inf))
    return ZoneState(
        min_x=z.min_x.at[agent].min(mnx),
        min_y=z.min_y.at[agent].min(mny),
        max_x=z.max_x.at[agent].max(mxx),
        max_y=z.max_y.at[agent].max(mxy),
        has_any=z.has_any.at[agent].set(z.has_any[agent] | any_valid))


def zone_observe_batch(z: ZoneState, agents, xs, ys, valid) -> ZoneState:
    """Segment-reduce many agents' points at once. agents: [...] int32."""
    n = z.min_x.shape[0]
    a = jnp.where(valid, agents, 0)
    inf = jnp.inf
    mnx = jnp.full((n,), inf).at[a].min(jnp.where(valid, xs, inf))
    mny = jnp.full((n,), inf).at[a].min(jnp.where(valid, ys, inf))
    mxx = jnp.full((n,), -inf).at[a].max(jnp.where(valid, xs, -inf))
    mxy = jnp.full((n,), -inf).at[a].max(jnp.where(valid, ys, -inf))
    got = jnp.zeros((n,), bool).at[a].max(valid)
    return ZoneState(
        min_x=jnp.minimum(z.min_x, mnx), min_y=jnp.minimum(z.min_y, mny),
        max_x=jnp.maximum(z.max_x, mxx), max_y=jnp.maximum(z.max_y, mxy),
        has_any=z.has_any | got)


def zone_observe_rows(z: ZoneState, xs, ys, valid) -> ZoneState:
    """Row-structured fold: row i's points all belong to agent i.

    xs, ys, valid: [N, K]. The scatter-min/max of `zone_observe_batch`
    becomes a plain axis reduction — the layout the fused engine produces
    (one path point + the 4-way hits per agent per step), and far cheaper
    than the segment form."""
    inf = jnp.inf
    mnx = jnp.min(jnp.where(valid, xs, inf), axis=1)
    mny = jnp.min(jnp.where(valid, ys, inf), axis=1)
    mxx = jnp.max(jnp.where(valid, xs, -inf), axis=1)
    mxy = jnp.max(jnp.where(valid, ys, -inf), axis=1)
    return ZoneState(
        min_x=jnp.minimum(z.min_x, mnx), min_y=jnp.minimum(z.min_y, mny),
        max_x=jnp.maximum(z.max_x, mxx), max_y=jnp.maximum(z.max_y, mxy),
        has_any=z.has_any | jnp.any(valid, axis=1))


def zones_for_agents(z: ZoneState, agent_xy, online):
    """The ZONE each agent would be sent.

    agent_xy: [N, 2] current positions; online: [N] bool.
    Returns (boxes [N, 4] as (min_x, min_y, max_x, max_y), active [N] bool).
    An agent's forbidden box is the territory of the nearest OTHER online
    agent with any territory; inactive boxes mirror the reference's
    999/-999 lift sentinel (dual_bot_mapper.py:681)."""
    n = z.min_x.shape[0]
    cx = (z.min_x + z.max_x) * 0.5
    cy = (z.min_y + z.max_y) * 0.5
    d2 = (agent_xy[:, 0:1] - cx[None, :]) ** 2 + \
         (agent_xy[:, 1:2] - cy[None, :]) ** 2          # [N, N]
    eligible = (online & z.has_any)[None, :] & \
        ~jnp.eye(n, dtype=bool)                          # [N, N]
    d2 = jnp.where(eligible, d2, jnp.inf)
    other = jnp.argmin(d2, axis=1)                       # [N]
    active = jnp.any(eligible, axis=1)
    boxes = jnp.stack([z.min_x[other], z.min_y[other],
                       z.max_x[other], z.max_y[other]], axis=-1)
    lift = jnp.array([999.0, 999.0, -999.0, -999.0], boxes.dtype)
    boxes = jnp.where(active[:, None], boxes, lift[None, :])
    return boxes, active

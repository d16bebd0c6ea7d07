"""2-D pose-graph optimisation by batched Gauss-Newton on device.

The reference's "pose graph" never solves anything: closures apply a 50 %
damped positional nudge accumulated per agent (dual_bot_mapper.py:308-326).
This module is the north-star upgrade: a real SE(2) graph —
odometry edges between consecutive poses, closure edges between revisits —
solved by Gauss-Newton with analytic Jacobians.

Batched structure: graphs are fixed-capacity [M] pose arrays with masked
edges; the normal equations H dx = -b are built with scatter-adds into a
dense [3M, 3M] H (graphs per agent are small: M <= a few hundred), and the
solve is one batched Cholesky — `vmap` runs every agent's graph
simultaneously, which is exactly the 'EP-like fan-out over independent
solves' of SURVEY §2. A Levenberg damping term keeps H well-posed with
masked-out (padding) nodes.

Residual model for edge (i, j) with measurement (dx, dy, dth) in frame i:
    r_t = R(th_i)^T (p_j - p_i) - (dx, dy)
    r_th = wrap(th_j - th_i - dth)
Jacobians (standard SE(2) pose-graph):
    d r_t / d p_i = -R^T          d r_t / d p_j = R^T
    d r_t / d th_i = dR^T/dth (p_j - p_i)
    d r_th / d th_i = -1          d r_th / d th_j = +1
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from swarm_tpu.utils.angles import wrap_pi


class PoseGraph(NamedTuple):
    """Fixed-capacity graph. Poses [M, 3]; edges (i, j, meas, info, valid)."""
    poses: jnp.ndarray       # [M, 3] (x, y, theta) current estimates
    n_poses: jnp.ndarray     # [] int32
    ei: jnp.ndarray          # [E] int32 source node
    ej: jnp.ndarray          # [E] int32 target node
    meas: jnp.ndarray        # [E, 3] relative (dx, dy, dtheta) in frame i
    weight: jnp.ndarray      # [E, 3] per-component information weights
    e_valid: jnp.ndarray     # [E] bool


def graph_from_trajectory(poses, n_poses, closures_i, closures_j,
                          closure_meas, n_closures,
                          odom_weight=(1.0, 1.0, 1.0),
                          closure_weight=(10.0, 10.0, 10.0)) -> PoseGraph:
    """Build a graph from a trajectory: consecutive odometry edges measured
    from the CURRENT estimates (dead-reckoning chain) + closure edges.

    poses: [M, 3]; closure edges get `closure_meas` [C, 3] relative
    transforms (e.g. identity for 'same place', or a scan-match result)."""
    m = poses.shape[0]
    c = closures_i.shape[0]
    idx = jnp.arange(m - 1)
    odo_valid = idx + 1 < n_poses

    ri = poses[:-1]
    rj = poses[1:]
    ct, st = jnp.cos(ri[:, 2]), jnp.sin(ri[:, 2])
    dxw = rj[:, 0] - ri[:, 0]
    dyw = rj[:, 1] - ri[:, 1]
    odo_meas = jnp.stack([ct * dxw + st * dyw,
                          -st * dxw + ct * dyw,
                          wrap_pi(rj[:, 2] - ri[:, 2])], axis=-1)

    ci = jnp.arange(c)
    cl_valid = ci < n_closures
    ei = jnp.concatenate([idx.astype(jnp.int32), closures_i.astype(jnp.int32)])
    ej = jnp.concatenate([(idx + 1).astype(jnp.int32),
                          closures_j.astype(jnp.int32)])
    meas = jnp.concatenate([odo_meas, closure_meas], axis=0)
    w = jnp.concatenate([
        jnp.tile(jnp.asarray(odom_weight, poses.dtype), (m - 1, 1)),
        jnp.tile(jnp.asarray(closure_weight, poses.dtype), (c, 1))], axis=0)
    valid = jnp.concatenate([odo_valid, cl_valid])
    return PoseGraph(poses=poses, n_poses=jnp.asarray(n_poses, jnp.int32),
                     ei=ei, ej=ej, meas=meas, weight=w, e_valid=valid)


def _residuals_and_jac(g: PoseGraph):
    """Per-edge residuals [E, 3] and the 6 nonzero Jacobian blocks."""
    pi = g.poses[g.ei]
    pj = g.poses[g.ej]
    ct, st = jnp.cos(pi[:, 2]), jnp.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]

    r = jnp.stack([ct * dx + st * dy - g.meas[:, 0],
                   -st * dx + ct * dy - g.meas[:, 1],
                   wrap_pi(pj[:, 2] - pi[:, 2] - g.meas[:, 2])], axis=-1)

    zeros = jnp.zeros_like(ct)
    ones = jnp.ones_like(ct)
    # J_i: d r / d (x_i, y_i, th_i)  [E, 3, 3]
    Ji = jnp.stack([
        jnp.stack([-ct, -st, -st * dx + ct * dy], -1),
        jnp.stack([st, -ct, -ct * dx - st * dy], -1),
        jnp.stack([zeros, zeros, -ones], -1)], axis=-2)
    # J_j
    Jj = jnp.stack([
        jnp.stack([ct, st, zeros], -1),
        jnp.stack([-st, ct, zeros], -1),
        jnp.stack([zeros, zeros, ones], -1)], axis=-2)
    return r, Ji, Jj


def unary_terms(poses, unary):
    """Residuals + normal-equation contributions of ABSOLUTE pose factors.

    unary: (nodes [Q] int32, meas [Q, 3], weight [Q, 3]) — each factor
    observes node q's absolute pose directly (r = p_q - z_q, J = I), e.g.
    a fitness-verified anchored-merge match (slam/livemerge.py): the scan
    matched the frozen anchor map, so the matched pose IS an observation
    in the anchor (low-drift early-epoch) frame. Zero weight disables a
    slot. Returns (b_add [M, 3], d_add [M, 3] diagonal, cost)."""
    nodes, meas, w = unary
    m = poses.shape[0]
    p = poses[nodes]
    r = jnp.stack([p[:, 0] - meas[:, 0],
                   p[:, 1] - meas[:, 1],
                   wrap_pi(p[:, 2] - meas[:, 2])], axis=-1)
    wr = w * r
    b_add = jnp.zeros((m, 3), poses.dtype).at[nodes].add(wr)
    d_add = jnp.zeros((m, 3), poses.dtype).at[nodes].add(w)
    return b_add, d_add, jnp.sum(wr * r)


def gauss_newton(g: PoseGraph, iterations: int = 10, damping: float = 1e-3,
                 anchor_weight: float = 1e6, unary=None) -> PoseGraph:
    """Dense batched GN. Node 0 is anchored (gauge freedom); padding nodes
    are held by the damping. `unary` = optional absolute pose factors
    (see unary_terms). Returns the graph with optimised poses."""
    m = g.poses.shape[0]
    dtype = g.poses.dtype
    wmask = jnp.where(g.e_valid[:, None], g.weight, 0.0)

    def step(poses, _):
        gg = g._replace(poses=poses)
        r, Ji, Jj = _residuals_and_jac(gg)
        wr = wmask * r                                       # [E, 3]

        # b = J^T W r, scatter per block
        bi = jnp.einsum("eab,ea->eb", Ji, wr)
        bj = jnp.einsum("eab,ea->eb", Jj, wr)
        b = jnp.zeros((m, 3), dtype).at[g.ei].add(bi).at[g.ej].add(bj)
        u_cost = 0.0
        if unary is not None:
            b_add, d_add, u_cost = unary_terms(poses, unary)
            b = b + b_add

        # H blocks: Ji^T W Ji, Ji^T W Jj, ...
        def blk(Ja, Jb):
            return jnp.einsum("eab,ea,eac->ebc", Ja, wmask, Jb)
        Hii = blk(Ji, Ji)
        Hjj = blk(Jj, Jj)
        Hij = blk(Ji, Jj)

        H = jnp.zeros((m, 3, m, 3), dtype)
        H = H.at[g.ei, :, g.ei, :].add(Hii)
        H = H.at[g.ej, :, g.ej, :].add(Hjj)
        H = H.at[g.ei, :, g.ej, :].add(Hij)
        H = H.at[g.ej, :, g.ei, :].add(jnp.swapaxes(Hij, -1, -2))
        H = H.reshape(3 * m, 3 * m)

        # anchor node 0 + Levenberg damping (also pins padding nodes)
        diag = jnp.full((3 * m,), damping, dtype)
        diag = diag.at[:3].add(anchor_weight)
        if unary is not None:
            diag = diag + d_add.reshape(-1)   # J = I: pure diagonal
        H = H + jnp.diag(diag)

        dx = jax.scipy.linalg.solve(H, -b.reshape(-1), assume_a="pos")
        dx = dx.reshape(m, 3)
        new = poses + dx
        new = new.at[:, 2].set(wrap_pi(new[:, 2]))
        return new, jnp.sum(wr * r) + u_cost

    poses, costs = jax.lax.scan(step, g.poses, None, length=iterations)
    return g._replace(poses=poses), costs


def optimize_graphs_batch(graphs: PoseGraph, iterations: int = 10,
                          damping: float = 1e-3):
    """vmap over a batch of per-agent graphs (leading axis on every leaf)."""
    return jax.vmap(lambda gr: gauss_newton(gr, iterations, damping))(graphs)

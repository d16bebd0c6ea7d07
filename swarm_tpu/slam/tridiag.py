"""Structure-exploiting pose-graph Gauss-Newton (SURVEY §5 long-axis
parallelism).

A trajectory pose graph's Hessian is a block-tridiagonal chain (odometry
edges couple consecutive poses) plus a LOW-RANK update from loop closures
(each closure edge (i, j) contributes J_eᵀ W_e J_e with J_e nonzero only at
nodes i and j — rank ≤ 3). The dense solver (slam/posegraph.py) ignores
this and pays O(M³) Cholesky; here:

  * the chain part solves by **block cyclic reduction** — log₂(M) levels,
    each a fully-batched sweep of 3×3 inversions and [3, K] matmuls over
    the remaining blocks. This is the parallel-prefix ("sequence-parallel")
    formulation: O(M log M) tiny ops but only log-depth, so the device's
    vector units stay saturated instead of serializing a Thomas recursion;
  * closures fold in by the **Woodbury identity**:
    (T + U S Uᵀ)⁻¹ b = T⁻¹b − T⁻¹U (S⁻¹ + UᵀT⁻¹U)⁻¹ UᵀT⁻¹b,
    with U the scattered closure Jacobians ([3M, 3C]) — one tridiagonal
    solve with 3C+3 right-hand sides plus a small dense (3C, 3C) solve.

Reference analogue: the reference never solves a graph at all (closures are
a damped positional nudge, dual_bot_mapper.py:308-326); this is the
north-star upgrade path shared with slam/posegraph.py, restructured for
the hardware.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from swarm_tpu.slam.posegraph import PoseGraph, _residuals_and_jac
from swarm_tpu.utils.angles import wrap_pi


def _pad_pow2(x, m_pad, fill):
    pad = m_pad - x.shape[0]
    if pad == 0:
        return x
    shape = (pad,) + x.shape[1:]
    return jnp.concatenate([x, jnp.broadcast_to(fill, shape)], axis=0)


def block_tridiag_solve(D, O, F):
    """Solve the symmetric block-tridiagonal system T X = F by cyclic
    reduction. D: [M, 3, 3] diagonal blocks; O: [M-1, 3, 3] super-diagonal
    blocks (sub-diagonal = Oᵀ by symmetry); F: [M, 3, K] right-hand sides.
    Returns X [M, 3, K]. M is padded internally to a power of two with
    identity blocks (decoupled x = 0 equations)."""
    m = D.shape[0]
    k = F.shape[-1]
    dtype = D.dtype
    m_pad = 1 << max(1, (m - 1).bit_length())
    eye = jnp.eye(3, dtype=dtype)
    D = _pad_pow2(D, m_pad, eye)
    L = jnp.concatenate([jnp.zeros((1, 3, 3), dtype),
                         jnp.swapaxes(O, -1, -2)], axis=0)   # L_k = O_{k-1}ᵀ
    L = _pad_pow2(L, m_pad, jnp.zeros((3, 3), dtype))
    U = jnp.concatenate([O, jnp.zeros((1, 3, 3), dtype)], axis=0)
    U = _pad_pow2(U, m_pad, jnp.zeros((3, 3), dtype))
    F = _pad_pow2(F, m_pad, jnp.zeros((3, k), dtype))

    # ---- forward reduction: eliminate odd indices per level -------------
    levels = []
    while D.shape[0] > 1:
        De, Do = D[0::2], D[1::2]
        Le, Lo = L[0::2], L[1::2]
        Ue, Uo = U[0::2], U[1::2]
        Fe, Fo = F[0::2], F[1::2]
        levels.append((Do, Lo, Uo, Fo))

        Do_inv = jnp.linalg.inv(Do)
        # neighbours of even index 2t: odd 2t-1 = odds[t-1], odd 2t+1 = odds[t]
        z33 = jnp.zeros_like(Do_inv[:1])
        Dm_inv = jnp.concatenate([z33, Do_inv[:-1]], axis=0)   # odds[t-1]
        Lm = jnp.concatenate([jnp.zeros_like(Lo[:1]), Lo[:-1]], axis=0)
        Um = jnp.concatenate([jnp.zeros_like(Uo[:1]), Uo[:-1]], axis=0)
        Fm = jnp.concatenate([jnp.zeros_like(Fo[:1]), Fo[:-1]], axis=0)

        a = Le @ Dm_inv               # [S/2, 3, 3]
        c = Ue @ Do_inv
        D = De - a @ Um - c @ Lo
        L = -(a @ Lm)
        U = -(c @ Uo)
        F = Fe - a @ Fm - c @ Fo

    x = jnp.linalg.solve(D[0], F[0])[None]                    # [1, 3, K]

    # ---- back substitution ----------------------------------------------
    for Do, Lo, Uo, Fo in reversed(levels):
        # x currently holds the even-index solutions of this level
        x_next = jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], axis=0)
        rhs = Fo - Lo @ x - Uo @ x_next
        x_odd = jnp.linalg.solve(Do, rhs)
        s = x.shape[0]
        x = jnp.stack([x, x_odd], axis=1).reshape(2 * s, 3, x.shape[-1])

    return x[:m]


def solve_chain_plus_closures(D, O, b, U=None, s_inv=None):
    """Solve (T + U S Uᵀ) dx = -b for the assembled normal equations:
    T block-tridiagonal (D [M,3,3], O [M-1,3,3]), closures as the low-rank
    term (U [M, 3, 3C] scattered closure Jacobians, s_inv [3C] inverse
    weights; zero U columns = masked-out closures). Returns dx [M, 3]."""
    if U is None:
        return block_tridiag_solve(D, O, -b[:, :, None])[..., 0]
    rhs = jnp.concatenate([-b[:, :, None], U], axis=-1)
    Y = block_tridiag_solve(D, O, rhs)                 # [M, 3, 1+3C]
    y_b, Y_u = Y[..., 0], Y[..., 1:]
    cap = jnp.diag(s_inv) + jnp.einsum("mak,mac->kc", U, Y_u)
    # SPD in exact arithmetic; f32 round-off makes it slightly asymmetric,
    # which hurts the solve exactly when cap is ill-conditioned (many
    # closures sharing the same node pair stack U columns)
    cap = 0.5 * (cap + cap.T)
    uty_b = jnp.einsum("mak,ma->k", U, y_b)
    corr = jnp.linalg.solve(cap, uty_b)
    return y_b - jnp.einsum("mak,k->ma", Y_u, corr)


def structured_gn(g: PoseGraph, n_chain: int, iterations: int = 10,
                  damping: float = 1e-3, anchor_weight: float = 1e6,
                  anchor_nodes=None, unary=None):
    """Gauss-Newton on a trajectory graph exploiting the chain+closures
    structure. Requires `graph_from_trajectory`'s edge layout: the first
    `n_chain` edges form the odometry chain (ei=k, ej=k+1), the rest are
    closures. Matches `gauss_newton`'s poses; scales to thousands of
    nodes where the dense [3M, 3M] Cholesky cannot.

    Steps that fail to reduce the weighted cost (including non-finite
    solves — e.g. a Woodbury cap matrix driven near-singular by hundreds
    of closures stacked on one node pair) are REJECTED and the damping
    escalated 10x for the next attempt; an accepted step resets damping,
    so on well-conditioned graphs every step is accepted at the base
    damping and the iterates are identical to the unguarded solver.

    anchor_nodes: nodes whose absolute pose is pinned with
    `anchor_weight` (default [0] — the classic single-trajectory gauge
    anchor). A joint multi-agent graph (slam/joint.py) passes every
    agent block's first node instead: swarm agents START from known
    home poses, so each block is anchored at its start and inter-agent
    edges redistribute mid-trajectory drift.

    unary: optional absolute pose factors (nodes [Q], meas [Q, 3],
    weight [Q, 3]) — see posegraph.unary_terms. With J = I their
    Hessian contribution is a pure block-diagonal add, so they fold
    into the chain solve at zero extra structure (no Woodbury columns).
    This is how fitness-verified anchored-merge matches enter the
    offline solve as external-frame observations."""
    m = g.poses.shape[0]
    assert n_chain == m - 1, "chain edges must be the first m-1 edges"
    c = g.ei.shape[0] - n_chain
    dtype = g.poses.dtype
    wmask_all = jnp.where(g.e_valid[:, None], g.weight, 0.0)
    from swarm_tpu.slam.posegraph import unary_terms

    def cost_at(poses):
        r, _, _ = _residuals_and_jac(g._replace(poses=poses))
        cost = jnp.sum(wmask_all * r * r)
        if unary is not None:
            cost = cost + unary_terms(poses, unary)[2]
        return cost

    ci = g.ei[n_chain:]
    cj = g.ej[n_chain:]

    def step(carry, _):
        poses, lam = carry
        gg = g._replace(poses=poses)
        r, Ji, Jj = _residuals_and_jac(gg)
        wr = wmask_all * r

        # b = Jᵀ W r over ALL edges (chain + closures)
        bi = jnp.einsum("eab,ea->eb", Ji, wr)
        bj = jnp.einsum("eab,ea->eb", Jj, wr)
        b = jnp.zeros((m, 3), dtype).at[g.ei].add(bi).at[g.ej].add(bj)
        u_cost = 0.0
        if unary is not None:
            b_add, d_add, u_cost = unary_terms(poses, unary)
            b = b + b_add

        # chain Hessian: block tridiagonal
        Jic, Jjc = Ji[:n_chain], Jj[:n_chain]
        wc = wmask_all[:n_chain]

        def blk(Ja, Jb, w):
            return jnp.einsum("eab,ea,eac->ebc", Ja, w, Jb)

        Hii = blk(Jic, Jic, wc)                   # at (k, k)
        Hjj = blk(Jjc, Jjc, wc)                   # at (k+1, k+1)
        O = blk(Jic, Jjc, wc)                     # at (k, k+1)
        D = jnp.zeros((m, 3, 3), dtype)
        D = D.at[:-1].add(Hii).at[1:].add(Hjj)
        anchors = (jnp.zeros((1,), jnp.int32) if anchor_nodes is None
                   else jnp.asarray(anchor_nodes, jnp.int32))
        diag = (jnp.full((m,), 1.0, dtype) * lam).at[anchors].add(
            anchor_weight)
        D = D + diag[:, None, None] * jnp.eye(3, dtype=dtype)
        if unary is not None:
            # J = I absolute factors: per-component diagonal add
            D = D + d_add[:, :, None] * jnp.eye(3, dtype=dtype)

        if c > 0:
            # closures: U S Uᵀ with U = scattered J_eᵀ ([m, 3, 3C]),
            # S = blockdiag(W_e). Invalid closures get ZERO U columns
            # (S⁻¹ stays I there, contribution exactly 0).
            cw = wmask_all[n_chain:]                       # [C, 3]
            cval = g.e_valid[n_chain:]
            # mask per (closure, residual component): a VALID closure
            # with a zero-weight component must contribute exactly
            # nothing — leaving its U column nonzero while s_inv
            # defaults to 1 would inject a spurious unit-weight
            # Hessian term (advisor r2 finding)
            cmask = (cval[:, None] & (cw > 0))[:, None, :]
            JiT = jnp.where(cmask,
                            jnp.swapaxes(Ji[n_chain:], -1, -2), 0.0)
            JjT = jnp.where(cmask,
                            jnp.swapaxes(Jj[n_chain:], -1, -2), 0.0)
            U = jnp.zeros((m, 3, c, 3), dtype)
            U = U.at[ci, :, jnp.arange(c), :].add(JiT)
            U = U.at[cj, :, jnp.arange(c), :].add(JjT)
            U = U.reshape(m, 3, 3 * c)
            s_inv = jnp.where(cval[:, None] & (cw > 0),
                              1.0 / jnp.maximum(cw, 1e-12),
                              1.0).reshape(-1)             # [3C]
            dx = solve_chain_plus_closures(D, O, b, U, s_inv)
        else:
            dx = solve_chain_plus_closures(D, O, b)

        new = poses + dx
        new = new.at[:, 2].set(wrap_pi(new[:, 2]))
        cost_old = jnp.sum(wr * r) + u_cost
        cost_new = cost_at(new)
        # accept transient rises up to 2.5x: plain GN routinely overshoots
        # ~2x on its first step of a noisy loop graph then plummets, and
        # rejecting those would diverge from the dense solver's iterates;
        # the pathological (near-singular cap) failure grows >5x per
        # iteration and compounds, so it still gets caught within a step.
        # Tiny absolute slack keeps float-noise-level costs (converged
        # graphs hover at ~1e-12) from mass-rejecting no-op steps.
        ok = jnp.isfinite(cost_new) & (cost_new <= cost_old * 2.5 + 1e-6)
        poses_out = jnp.where(ok, new, poses)
        lam_out = jnp.where(ok, jnp.asarray(damping, dtype), lam * 10.0)
        return (poses_out, lam_out), cost_old

    (poses, _), costs = jax.lax.scan(
        step, (g.poses, jnp.asarray(damping, dtype)), None,
        length=iterations)
    return g._replace(poses=poses), costs


def structured_gn_batch(graphs: PoseGraph, n_chain: int,
                        iterations: int = 10, damping: float = 1e-3):
    """vmap over per-agent graphs — the EP-like fan-out of SURVEY §2,
    now with the structured solver inside."""
    return jax.vmap(lambda gr: structured_gn(gr, n_chain, iterations,
                                             damping))(graphs)

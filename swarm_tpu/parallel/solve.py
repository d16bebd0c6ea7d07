"""Mesh-sharded pose-graph solving: 1024-agent swarm with pose-graph
optimisation across the device mesh.

Per-agent trajectory graphs are independent solves (the 'EP-like fan-out',
SURVEY §2), so the decomposition is: shard the [N]-agent batch of graphs
over the `agents` mesh axis, run the batched dense Gauss-Newton
(slam/posegraph.py) locally on each shard — ZERO communication during the
solve — and only the final cost scalars cross the interconnect for reporting.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from swarm_tpu.slam.posegraph import PoseGraph, gauss_newton


def make_sharded_solver(mesh, iterations: int = 10, damping: float = 1e-3,
                        structured: bool = False, n_chain: int | None = None):
    """Returns solve(graphs) for a PoseGraph pytree with leading [N] agent
    axis on every leaf, N divisible by the mesh size.

    structured=True uses the chain+closures solver (slam/tridiag.py —
    log-depth cyclic reduction + Woodbury) instead of the dense Cholesky;
    requires graph_from_trajectory's edge layout and `n_chain`."""
    axis = mesh.axis_names[0]
    specs = PoseGraph(*([P(axis)] * len(PoseGraph._fields)))
    if structured:
        from swarm_tpu.slam.tridiag import structured_gn
        solver = lambda g: structured_gn(g, n_chain, iterations, damping)
    else:
        solver = lambda g: gauss_newton(g, iterations, damping)

    def body(graphs: PoseGraph):
        out, costs = jax.vmap(solver)(graphs)
        total = jax.lax.psum(jnp.sum(costs[:, -1]), axis)
        return out, costs, total

    f = shard_map(body, mesh=mesh, in_specs=(specs,),
                  out_specs=(specs, P(axis), P()), check_vma=False)
    return jax.jit(f)


def make_trajectory_sharded_gn(mesh, n_chain: int, iterations: int = 10,
                               damping: float = 1e-3,
                               anchor_weight: float = 1e6):
    """Sequence-parallel Gauss-Newton over ONE long trajectory graph
    (SURVEY §5: 'chunk the trajectory axis, shard_map the residual/
    Jacobian accumulation, psum the normal equations').

    The graph's chain edges are split into contiguous trajectory chunks,
    one per device; each device computes residuals/Jacobians for its
    chunk only and scatters them into its local copy of the
    block-tridiagonal normal equations (D, O, b), which a single `psum`
    completes. Closure edges (few) are folded in replicated, and
    the log-depth structured solve (slam/tridiag.py) runs replicated —
    the accumulation, not the solve, is what scales with trajectory
    length. Returns solve(graph) -> (graph, costs); the PoseGraph's
    leaves are replicated (edge layout from `graph_from_trajectory`)."""
    import functools as _ft

    from swarm_tpu.slam.posegraph import _residuals_and_jac
    from swarm_tpu.slam.tridiag import solve_chain_plus_closures
    from swarm_tpu.utils.angles import wrap_pi

    axis = mesh.axis_names[0]
    d = mesh.devices.size
    if n_chain % d:
        raise ValueError(f"n_chain={n_chain} not divisible by mesh size {d}")
    chunk = n_chain // d

    def body(g: PoseGraph):
        m = g.poses.shape[0]
        c = g.ei.shape[0] - n_chain
        dtype = g.poses.dtype
        shard = jax.lax.axis_index(axis)
        e0 = shard * chunk

        def sl(x):
            return jax.lax.dynamic_slice_in_dim(x, e0, chunk, axis=0)

        # local chunk of chain edges + the (replicated) closure edges
        g_loc = g._replace(
            ei=jnp.concatenate([sl(g.ei[:n_chain]), g.ei[n_chain:]]),
            ej=jnp.concatenate([sl(g.ej[:n_chain]), g.ej[n_chain:]]),
            meas=jnp.concatenate([sl(g.meas[:n_chain]), g.meas[n_chain:]]),
            weight=jnp.concatenate([sl(g.weight[:n_chain]),
                                    g.weight[n_chain:]]),
            e_valid=jnp.concatenate([sl(g.e_valid[:n_chain]),
                                     g.e_valid[n_chain:]]))
        ci = g.ei[n_chain:]
        cj = g.ej[n_chain:]
        wmask_loc = jnp.where(g_loc.e_valid[:, None], g_loc.weight, 0.0)

        def cost_at(poses):
            r2, _, _ = _residuals_and_jac(g_loc._replace(poses=poses))
            wr2 = wmask_loc * r2 * r2
            return (jax.lax.psum(jnp.sum(wr2[:chunk]), axis)
                    + jnp.sum(wr2[chunk:]))

        def step(carry, _):
            poses, lam = carry
            gg = g_loc._replace(poses=poses)
            r, Ji, Jj = _residuals_and_jac(gg)
            wmask = wmask_loc
            wr = wmask * r

            # --- local chunk contribution to b and the tridiagonal ------
            Jic, Jjc, wc = Ji[:chunk], Jj[:chunk], wmask[:chunk]
            bi = jnp.einsum("eab,ea->eb", Jic, wc * r[:chunk])
            bj = jnp.einsum("eab,ea->eb", Jjc, wc * r[:chunk])
            ei_c = gg.ei[:chunk]
            ej_c = gg.ej[:chunk]
            b = jnp.zeros((m, 3), dtype).at[ei_c].add(bi).at[ej_c].add(bj)

            def blk(Ja, Jb, w):
                return jnp.einsum("eab,ea,eac->ebc", Ja, w, Jb)

            D = jnp.zeros((m, 3, 3), dtype)
            D = D.at[ei_c].add(blk(Jic, Jic, wc))
            D = D.at[ej_c].add(blk(Jjc, Jjc, wc))
            O = jnp.zeros((m - 1, 3, 3), dtype)
            O = O.at[ei_c].add(blk(Jic, Jjc, wc))

            # one psum completes the normal equations over the mesh
            D = jax.lax.psum(D, axis)
            O = jax.lax.psum(O, axis)
            b = jax.lax.psum(b, axis)
            cost = jax.lax.psum(jnp.sum(wc * r[:chunk] * r[:chunk]), axis)

            diag = (jnp.full((m,), 1.0, dtype) * lam).at[0].add(anchor_weight)
            D = D + diag[:, None, None] * jnp.eye(3, dtype=dtype)

            # --- closures: replicated low-rank term + b ------------------
            if c > 0:
                rc, Jic2, Jjc2 = r[chunk:], Ji[chunk:], Jj[chunk:]
                wcl = wmask[chunk:]
                cval = gg.e_valid[chunk:]
                b = b.at[ci].add(jnp.einsum("eab,ea->eb", Jic2, wcl * rc))
                b = b.at[cj].add(jnp.einsum("eab,ea->eb", Jjc2, wcl * rc))
                cost = cost + jnp.sum(wcl * rc * rc)
                # per-component weight mask (advisor r2: zero-weight
                # components must contribute exactly nothing)
                cmask = (cval[:, None] & (wcl > 0))[:, None, :]
                JiT = jnp.where(cmask, jnp.swapaxes(Jic2, -1, -2), 0.0)
                JjT = jnp.where(cmask, jnp.swapaxes(Jjc2, -1, -2), 0.0)
                U = jnp.zeros((m, 3, c, 3), dtype)
                U = U.at[ci, :, jnp.arange(c), :].add(JiT)
                U = U.at[cj, :, jnp.arange(c), :].add(JjT)
                U = U.reshape(m, 3, 3 * c)
                s_inv = jnp.where(cval[:, None] & (wcl > 0),
                                  1.0 / jnp.maximum(wcl, 1e-12),
                                  1.0).reshape(-1)
                dx = solve_chain_plus_closures(D, O, b, U, s_inv)
            else:
                dx = solve_chain_plus_closures(D, O, b)

            new = poses + dx
            new = new.at[:, 2].set(wrap_pi(new[:, 2]))
            # step rejection + damping escalation (see slam/tridiag.py
            # structured_gn): identical iterates when every step is
            # accepted; recovers instead of diverging when the Woodbury
            # cap solve goes bad (e.g. duplicate-closure pile-ups)
            cost_new = cost_at(new)
            ok = jnp.isfinite(cost_new) & (cost_new <= cost * 2.5 + 1e-6)
            poses_out = jnp.where(ok, new, poses)
            lam_out = jnp.where(ok, jnp.asarray(damping, dtype), lam * 10.0)
            return (poses_out, lam_out), cost

        (poses, _), costs = jax.lax.scan(
            step, (g.poses, jnp.asarray(damping, dtype)), None,
            length=iterations)
        return g._replace(poses=poses), costs

    rep = PoseGraph(*([P()] * len(PoseGraph._fields)))
    f = shard_map(body, mesh=mesh, in_specs=(rep,),
                  out_specs=(rep, P()), check_vma=False)
    return jax.jit(f)


def shard_graphs(graphs: PoseGraph, mesh) -> PoseGraph:
    specs = PoseGraph(*([P(mesh.axis_names[0])] * len(PoseGraph._fields)))
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        graphs, specs)

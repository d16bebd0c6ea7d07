"""Structure-exploiting pose-graph GN (slam/tridiag.py + the trajectory-
axis sharded accumulation, SURVEY §5).

Correctness anchor = the dense solver (slam/posegraph.py), which is itself
oracle-tested; the structured solver must reproduce its poses while
scaling to node counts the dense [3M, 3M] Cholesky cannot.
"""

import jax
import jax.numpy as jnp
import numpy as np

from swarm_tpu.slam.posegraph import (gauss_newton, graph_from_trajectory)
from swarm_tpu.slam.tridiag import (block_tridiag_solve, structured_gn,
                                    structured_gn_batch)


def _spd_tridiag(rng, m, k=2):
    D = rng.normal(size=(m, 3, 3)).astype(np.float32)
    D = np.einsum("mab,mcb->mac", D, D) + 3 * np.eye(3, dtype=np.float32)
    O = 0.3 * rng.normal(size=(m - 1, 3, 3)).astype(np.float32)
    F = rng.normal(size=(m, 3, k)).astype(np.float32)
    T = np.zeros((3 * m, 3 * m), np.float32)
    for i in range(m):
        T[3 * i:3 * i + 3, 3 * i:3 * i + 3] = D[i]
    for i in range(m - 1):
        T[3 * i:3 * i + 3, 3 * i + 3:3 * i + 6] = O[i]
        T[3 * i + 3:3 * i + 6, 3 * i:3 * i + 3] = O[i].T
    return D, O, F, T


def test_cyclic_reduction_matches_dense_solve(rng):
    for m in (3, 8, 17, 64):
        D, O, F, T = _spd_tridiag(rng, m)
        X = block_tridiag_solve(jnp.asarray(D), jnp.asarray(O),
                                jnp.asarray(F))
        X_ref = np.linalg.solve(T.astype(np.float64),
                                F.reshape(3 * m, -1).astype(np.float64))
        np.testing.assert_allclose(np.asarray(X).reshape(3 * m, -1),
                                   X_ref, rtol=1e-3, atol=1e-4)


def _noisy_loop_graph(rng, m, closure_cap=4, n_closures=2):
    t = np.linspace(0, 4 * np.pi, m)
    truth = np.stack([np.cos(t), np.sin(t), t + np.pi / 2], -1)
    noisy = (truth + 0.05 * rng.normal(size=truth.shape)).astype(np.float32)
    noisy[0] = truth[0]
    ci = np.zeros(closure_cap, np.int32)
    cj = np.zeros(closure_cap, np.int32)
    ci[:n_closures] = rng.integers(m // 2, m - 1, n_closures)
    cj[:n_closures] = rng.integers(1, m // 4, n_closures)
    cmeas = np.zeros((closure_cap, 3), np.float32)
    return graph_from_trajectory(jnp.asarray(noisy), m, jnp.asarray(ci),
                                 jnp.asarray(cj), jnp.asarray(cmeas),
                                 n_closures)


def test_structured_gn_matches_dense(rng):
    g = _noisy_loop_graph(rng, 64)
    gd, cost_d = gauss_newton(g, iterations=10)
    gs, cost_s = structured_gn(g, n_chain=63, iterations=10)
    np.testing.assert_allclose(np.asarray(gs.poses), np.asarray(gd.poses),
                               atol=1e-3)
    assert abs(float(cost_s[-1]) - float(cost_d[-1])) < 1e-3


def test_structured_gn_no_closures(rng):
    g = _noisy_loop_graph(rng, 32, n_closures=0)
    gd, _ = gauss_newton(g, iterations=8)
    gs, _ = structured_gn(g, n_chain=31, iterations=8)
    np.testing.assert_allclose(np.asarray(gs.poses), np.asarray(gd.poses),
                               atol=1e-3)


def test_structured_gn_batch_matches_dense(rng):
    graphs = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[_noisy_loop_graph(rng, 48) for _ in range(4)])
    gd, _ = jax.vmap(lambda gr: gauss_newton(gr, 6))(graphs)
    gs, _ = structured_gn_batch(graphs, n_chain=47, iterations=6)
    np.testing.assert_allclose(np.asarray(gs.poses), np.asarray(gd.poses),
                               atol=1e-3)


def test_structured_gn_large_graph_reduces_cost(rng):
    """4096 nodes: the dense solver would build a
    12288² Hessian (600 MB) per iteration — the structured solver runs it
    and actually optimises."""
    g = _noisy_loop_graph(rng, 4096, closure_cap=8, n_closures=6)
    gs, costs = structured_gn(g, n_chain=4095, iterations=5)
    assert float(costs[-1]) < 0.2 * float(costs[0])
    assert np.isfinite(np.asarray(gs.poses)).all()


def test_trajectory_sharded_gn_matches_single(rng):
    """SURVEY §5 sequence-parallel analogue: chain-edge accumulation
    chunked over an 8-device mesh, normal equations psum'd — identical
    poses to the single-device structured solve."""
    from swarm_tpu.parallel import make_mesh
    from swarm_tpu.parallel.solve import make_trajectory_sharded_gn

    m = 257                      # chain of 256 edges over 8 devices
    g = _noisy_loop_graph(rng, m)
    gs, cost_s = structured_gn(g, n_chain=m - 1, iterations=8)

    mesh = make_mesh(8)
    solve = make_trajectory_sharded_gn(mesh, n_chain=m - 1, iterations=8)
    gp, cost_p = solve(g)
    np.testing.assert_allclose(np.asarray(gp.poses), np.asarray(gs.poses),
                               atol=1e-3)
    # costs: psum chunk order vs single-device sum -> float rounding
    np.testing.assert_allclose(np.asarray(cost_p), np.asarray(cost_s),
                               rtol=1e-3, atol=1e-5)


def test_zero_weight_closure_component_contributes_nothing():
    """Advisor r2: a VALID closure edge with one zero weight component
    must contribute exactly nothing for that component — the Woodbury
    fold used to leave its U column nonzero while s_inv defaulted to 1,
    injecting a spurious unit-weight Hessian term."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from swarm_tpu.slam.posegraph import graph_from_trajectory
    from swarm_tpu.slam.tridiag import structured_gn

    rng = np.random.default_rng(5)
    t = 64
    g = _noisy_loop_graph(rng, t, closure_cap=2, n_closures=1)
    n_chain = t - 1

    # variant A: closure weight fully zero on all components
    wz = np.asarray(g.weight).copy()
    wz[n_chain:, :] = 0.0
    ga = g._replace(weight=jnp.asarray(wz))
    out_a, _ = structured_gn(ga, n_chain, iterations=5)

    # variant B: the closure edge marked invalid
    gb = g._replace(e_valid=g.e_valid.at[n_chain:].set(False))
    out_b, _ = structured_gn(gb, n_chain, iterations=5)

    np.testing.assert_allclose(np.asarray(out_a.poses),
                               np.asarray(out_b.poses), atol=1e-6)


def _drifted_chain(rng, m):
    """Truth path + a slowly-growing frame drift (the swarm drift regime:
    near-rigid transform, unobservable from same-agent relative edges). Returns (truth [m,3], drifted est [m,3])."""
    t = np.linspace(0, 6.0, m)
    truth = np.stack([t, 0.4 * np.sin(t), 0.4 * np.cos(t)], -1)
    # drift: yaw bias accumulating with distance + scale bias
    drift_yaw = 0.04 * t
    est = truth.copy()
    est[:, 0] = truth[:, 0] * 1.01 * np.cos(drift_yaw) - \
        truth[:, 1] * np.sin(drift_yaw)
    est[:, 1] = truth[:, 0] * 1.01 * np.sin(drift_yaw) + \
        truth[:, 1] * np.cos(drift_yaw)
    est[:, 2] = truth[:, 2] + drift_yaw
    est[0] = truth[0]
    return truth.astype(np.float32), est.astype(np.float32)


def _unary_graph(rng, m):
    ci = np.zeros(1, np.int32)
    cj = np.zeros(1, np.int32)
    cmeas = np.zeros((1, 3), np.float32)
    truth, est = _drifted_chain(rng, m)
    g = graph_from_trajectory(jnp.asarray(est), m, jnp.asarray(ci),
                              jnp.asarray(cj), jnp.asarray(cmeas), 0)
    return truth, est, g


def test_unary_factors_recover_frame_drift(rng):
    """Absolute pose factors (the anchored-merge observations) must recover a slowly-growing frame drift that relative
    edges alone cannot observe: chain edges measured FROM the drifted
    estimate have zero residual, so chain-only GN is a no-op, while a
    sparse set of external-frame observations pins the frame."""
    m = 128
    truth, est, g = _unary_graph(rng, m)

    # chain-only: GN leaves the drifted estimate untouched
    g0, _ = structured_gn(g, n_chain=m - 1, iterations=8)
    ate0 = np.abs(np.asarray(g0.poses)[:, :2] - truth[:, :2]).mean()
    ate_raw = np.abs(est[:, :2] - truth[:, :2]).mean()
    assert abs(ate0 - ate_raw) < 1e-3

    # absolute observations every 16 nodes (z = truth + small noise)
    nodes = np.arange(8, m, 16, dtype=np.int32)
    meas = truth[nodes] + rng.normal(size=(len(nodes), 3)).astype(
        np.float32) * np.array([0.01, 0.01, 0.005], np.float32)
    w = np.tile(np.array([25.0, 25.0, 4.0], np.float32), (len(nodes), 1))
    unary = (jnp.asarray(nodes), jnp.asarray(meas), jnp.asarray(w))
    gs, _ = structured_gn(g, n_chain=m - 1, iterations=8, unary=unary)
    ate_u = np.abs(np.asarray(gs.poses)[:, :2] - truth[:, :2]).mean()
    assert ate_u < 0.35 * ate_raw, (ate_u, ate_raw)

    # dense solver agrees
    gd, _ = gauss_newton(g, iterations=8, unary=unary)
    np.testing.assert_allclose(np.asarray(gs.poses),
                               np.asarray(gd.poses), atol=2e-3)


def test_unary_zero_weight_is_noop(rng):
    m = 64
    _, _, g = _unary_graph(rng, m)
    nodes = jnp.asarray(np.array([5, 20, 40], np.int32))
    meas = jnp.asarray(np.ones((3, 3), np.float32))
    w = jnp.zeros((3, 3), jnp.float32)
    base, _ = structured_gn(g, n_chain=m - 1, iterations=5)
    withu, _ = structured_gn(g, n_chain=m - 1, iterations=5,
                             unary=(nodes, meas, w))
    np.testing.assert_allclose(np.asarray(withu.poses),
                               np.asarray(base.poses), atol=1e-6)


def test_structured_gn_duplicate_closure_pileup_stays_finite(rng):
    """Hundreds of closure edges stacked on ONE node pair (the online
    detector logs the same revisit repeatedly at swarm agent counts)
    drive the Woodbury cap matrix near-singular in f32; the unguarded
    solver diverged to NaN here while the dense solve converged. The
    step-rejection + damping-escalation guard must keep the solve
    finite and still massively reduce the cost."""
    cap = 1024
    th = np.cumsum(0.02 * rng.normal(size=cap)).astype(np.float32)
    xs = np.cumsum(np.cos(th) * 0.05).astype(np.float32)
    ys = np.cumsum(np.sin(th) * 0.05).astype(np.float32)
    poses = np.stack([xs, ys, th], -1).astype(np.float32)
    dup = 512
    ci = np.full(dup, 300, np.int32)
    cj = np.full(dup, 700, np.int32)
    g = graph_from_trajectory(
        jnp.asarray(poses), cap, jnp.asarray(ci), jnp.asarray(cj),
        jnp.zeros((dup, 3), jnp.float32), dup,
        closure_weight=(25.0,) * 3)
    out, costs = structured_gn(g, n_chain=cap - 1, iterations=40)
    p = np.asarray(out.poses)
    c = np.asarray(costs)
    assert np.isfinite(p).all()
    assert float(c[-1]) < 1e-3 * float(c[0])


def test_refine_session_dedups_closure_log():
    """refine_session must collapse duplicate closure detections and drop
    self-pairs before building graphs (one revisit logged N times is not
    N independent measurements — and the pile-up is the exact input that
    used to NaN the structured solver)."""
    from swarm_tpu.slam.refine import refine_session

    t_steps, n = 40, 2
    rows = t_steps * n
    rng2 = np.random.default_rng(3)
    session = {
        "t": np.repeat(np.arange(t_steps, dtype=np.float64) * 0.4, n),
        "agent": np.tile(np.arange(1, n + 1), t_steps),
        "x": rng2.normal(size=rows),
        "y": rng2.normal(size=rows),
        "yaw_deg": rng2.uniform(-180, 180, rows),
        "landmark": np.zeros(rows, np.int64),
    }
    # agents interleave in the global rows (agent 1 = even rows); the
    # closure log speaks GLOBAL packet-node indices. Agent 1: the same
    # (5, 25) per-agent pair logged 6 times + a self-pair (7, 7).
    ni = np.array([10, 10, 10, 10, 10, 10, 14, 18], np.int64)
    nj = np.array([50, 50, 50, 50, 50, 50, 14, 60], np.int64)
    ag = np.ones(8, np.int64)
    out = refine_session(session, closures=(ni, nj, ag))
    assert sorted(out[1]["closures"]) == [(5, 25), (9, 30)]
    assert out[2]["closures"] == []

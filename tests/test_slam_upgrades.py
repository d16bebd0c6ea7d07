"""Scan matching (correlative, batched matmul) + pose-graph Gauss-Newton."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swarm_tpu.config import GridConfig, SlamConfig
from swarm_tpu.slam.posegraph import gauss_newton, graph_from_trajectory
from swarm_tpu.slam.scanmatch import (match_grids, match_grids_batch,
                                      occupancy_mass)
from swarm_tpu.utils.angles import wrap_pi


def make_room_grid(cfg, shift_cells=(0, 0), theta=0.0):
    """Synthetic occupied-walls image: a rectangle outline + inner feature,
    optionally transformed."""
    s = cfg.size
    g = np.zeros((s, s), np.float32)
    g[60, 60:140] = 1.0
    g[140, 60:140] = 1.0
    g[60:140, 60] = 1.0
    g[60:141, 140] = 1.0
    g[90:95, 100] = 1.0          # asymmetric feature fixes rotation
    if theta != 0.0:
        from swarm_tpu.slam.scanmatch import _rotate_grid
        g = np.asarray(_rotate_grid(jnp.asarray(g), jnp.float32(theta), cfg))
    g = np.roll(g, shift_cells, axis=(0, 1))
    return jnp.asarray(g)


@pytest.mark.parametrize("shift", [(0, 0), (5, -3), (-8, 8)])
def test_scanmatch_recovers_translation(shift):
    cfg = GridConfig()
    slam = SlamConfig()
    glob = make_room_grid(cfg)
    loc = make_room_grid(cfg, shift_cells=(-shift[0], -shift[1]))
    # local shifted by -shift means local -> global requires +shift
    r = jax.jit(lambda a, b: match_grids(a, b, cfg, slam))(loc, glob)
    assert bool(r.ok)
    np.testing.assert_allclose(float(r.dy), shift[0] * cfg.resolution,
                               atol=cfg.resolution)
    np.testing.assert_allclose(float(r.dx), shift[1] * cfg.resolution,
                               atol=cfg.resolution)
    assert abs(float(r.dtheta)) < 0.06


def test_scanmatch_recovers_rotation():
    cfg = GridConfig()
    slam = SlamConfig()
    glob = make_room_grid(cfg)
    loc = make_room_grid(cfg, theta=-0.2)     # rotate local by -0.2
    r = match_grids(loc, glob, cfg, slam)
    assert bool(r.ok)
    assert abs(float(r.dtheta) - 0.2) < 0.06


def test_scanmatch_rejects_garbage():
    cfg = GridConfig()
    slam = SlamConfig()
    glob = make_room_grid(cfg)
    empty = jnp.zeros((cfg.size, cfg.size), jnp.float32)
    r = match_grids(empty, glob, cfg, slam)
    assert not bool(r.ok)
    noise = jnp.asarray(
        (np.random.default_rng(0).random((cfg.size, cfg.size)) < 0.002)
        .astype(np.float32))
    r2 = match_grids(noise, glob, cfg, slam)
    assert float(r2.fitness) < 0.6


def test_scanmatch_batch():
    cfg = GridConfig()
    slam = SlamConfig()
    glob = make_room_grid(cfg)
    locs = jnp.stack([make_room_grid(cfg, shift_cells=(-4, 0)),
                      make_room_grid(cfg, shift_cells=(0, 6))])
    r = match_grids_batch(locs, glob, cfg, slam)
    assert r.dx.shape == (2,)
    assert bool(r.ok[0]) and bool(r.ok[1])
    np.testing.assert_allclose(float(r.dy[0]), 4 * cfg.resolution,
                               atol=cfg.resolution)
    np.testing.assert_allclose(float(r.dx[1]), -6 * cfg.resolution,
                               atol=cfg.resolution)


def test_occupancy_mass():
    cfg = GridConfig()
    g = jnp.full((4, 4), -1, jnp.int8).at[1, 2].set(100).at[0, 0].set(0)
    m = occupancy_mass(g, cfg)
    assert float(m.sum()) == 1.0


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------

def noisy_loop_trajectory(m=64, noise=0.03, seed=0):
    """Square loop revisiting its start; returns (true [M,3], noisy [M,3])."""
    rng = np.random.default_rng(seed)
    side = m // 4
    poses = []
    x, y, th = 0.0, 0.0, 0.0
    for leg in range(4):
        for _ in range(side):
            poses.append((x, y, th))
            x += 0.2 * np.cos(th)
            y += 0.2 * np.sin(th)
        th = wrap_pi(th + np.pi / 2)
    true = np.asarray(poses, np.float32)

    # integrate noisy odometry
    noisy = [true[0]]
    for i in range(1, m):
        dd = true[i, :2] - true[i - 1, :2]
        dist = np.hypot(*dd)
        dth = wrap_pi(true[i, 2] - true[i - 1, 2]) + rng.normal(0, noise)
        th_n = wrap_pi(noisy[-1][2] + dth)
        noisy.append((noisy[-1][0] + dist * np.cos(th_n) + rng.normal(0, noise * 0.2),
                      noisy[-1][1] + dist * np.sin(th_n) + rng.normal(0, noise * 0.2),
                      th_n))
    return true, np.asarray(noisy, np.float32)


def test_gauss_newton_closes_loop():
    m = 64
    true, noisy = noisy_loop_trajectory(m)
    err_before = np.hypot(*(noisy[-1, :2] - true[-1, :2]))

    # one closure: last pose == first pose (same place, same heading)
    g = graph_from_trajectory(
        jnp.asarray(noisy), m,
        closures_i=jnp.asarray([m - 1]), closures_j=jnp.asarray([0]),
        closure_meas=jnp.zeros((1, 3)), n_closures=1,
        closure_weight=(50.0, 50.0, 50.0))
    out, costs = jax.jit(lambda gr: gauss_newton(gr, iterations=10))(g)
    opt = np.asarray(out.poses)

    # cost decreases and the loop end snaps to the start
    assert float(costs[-1]) < float(costs[0])
    end_gap = np.hypot(*(opt[-1, :2] - opt[0, :2]))
    assert end_gap < 0.1
    # global error reduced vs dead reckoning
    err_after = np.hypot(*(opt[-1, :2] - true[-1, :2]))
    assert err_after < err_before


def test_gauss_newton_identity_on_perfect_graph():
    m = 32
    true, _ = noisy_loop_trajectory(m, noise=0.0)
    g = graph_from_trajectory(
        jnp.asarray(true), m,
        closures_i=jnp.asarray([m - 1]), closures_j=jnp.asarray([0]),
        closure_meas=jnp.zeros((1, 3)), n_closures=0)   # closure masked out
    out, _ = gauss_newton(g, iterations=3)
    np.testing.assert_allclose(np.asarray(out.poses), true, atol=1e-3)


def test_gauss_newton_padding_nodes_stable():
    """Capacity > n_poses: padding nodes must not blow up the solve."""
    m = 32
    cap = 48
    true, noisy = noisy_loop_trajectory(m)
    padded = np.zeros((cap, 3), np.float32)
    padded[:m] = noisy
    g = graph_from_trajectory(
        jnp.asarray(padded), m,
        closures_i=jnp.asarray([m - 1]), closures_j=jnp.asarray([0]),
        closure_meas=jnp.zeros((1, 3)), n_closures=1)
    out, costs = gauss_newton(g, iterations=8)
    assert np.isfinite(np.asarray(out.poses)).all()
    assert float(costs[-1]) < float(costs[0])

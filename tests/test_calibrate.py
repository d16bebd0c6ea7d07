"""Offline drift calibration (slam/calibrate.py): recover the reference
drift parameters (yaw-rate bias +/-0.008 rad/m, scale 0.998/1.002 —
generate_fake_dual_session.py:407-444) from absolute fixes on a
synthetically drifted chain."""

import numpy as np

from swarm_tpu.slam.calibrate import calibrate_chains


def _drifted_chain(key, t, bias, scale, noise=0.0):
    """True L-shaped-ish random-walk path + its drifted odometry estimate.
    Returns (true_xy [T,2], est_xy [T,2], est_yaw [T])."""
    rng = np.random.default_rng(key)
    # piecewise-straight true path with occasional turns (wall-follower-ish)
    yaw = 0.0
    p = np.zeros((t, 2))
    yaws = np.zeros(t)
    for i in range(1, t):
        if rng.random() < 0.02:
            yaw += rng.choice([-1, 1]) * np.pi / 2
        p[i] = p[i - 1] + 0.07 * np.array([np.cos(yaw), np.sin(yaw)])
        yaws[i] = yaw
    # drifted estimate: integrate scaled segments rotated by -bias*dist
    # (the estimator accumulates +bias per metre, so its frame rotates
    # the TRUE motion by the accumulated bias)
    e = np.zeros((t, 2))
    ey = np.zeros(t)
    dist = 0.0
    for i in range(1, t):
        d = p[i] - p[i - 1]
        a = bias * dist
        ca, sa = np.cos(a), np.sin(a)
        seg = scale * np.array([ca * d[0] - sa * d[1],
                                sa * d[0] + ca * d[1]])
        seg += noise * rng.normal(size=2)
        e[i] = e[i - 1] + seg
        ey[i] = yaws[i] + a
        dist += float(np.hypot(*d))
    return p, e, ey


def test_recovers_reference_drift_parameters():
    t, n = 1500, 4
    biases = np.array([0.008, -0.008, 0.008, -0.008])
    scales = np.array([0.998, 1.002, 1.002, 0.998])
    ex = np.zeros((t, n)); ey_ = np.zeros((t, n)); eyaw = np.zeros((t, n))
    zx = np.zeros((t, n)); zy = np.zeros((t, n))
    mask = np.zeros((t, n), bool)
    for a in range(n):
        p, e, yw = _drifted_chain(a, t, biases[a], scales[a], noise=0.002)
        ex[:, a], ey_[:, a], eyaw[:, a] = e[:, 0], e[:, 1], yw
        # fixes every 16 steps with 5 cm noise (a verified merge's
        # residual position error)
        rng = np.random.default_rng(100 + a)
        idx = np.arange(15, t, 16)
        mask[idx, a] = True
        zx[:, a] = p[:, 0] + 0.05 * rng.normal(size=t)
        zy[:, a] = p[:, 1] + 0.05 * rng.normal(size=t)
    out = calibrate_chains(ex, ey_, eyaw, mask, zx, zy)
    # the calibrator's bias CANCELS the drift: bias_hat ~= -true bias
    np.testing.assert_allclose(out["bias"], -biases, atol=0.0015)
    np.testing.assert_allclose(out["scale"], 1.0 / scales, atol=0.004)
    # calibrated chain lands near truth at the end (raw drift is ~metres)
    for a in range(n):
        p, e, _ = _drifted_chain(a, t, biases[a], scales[a], noise=0.002)
        raw_err = np.hypot(e[-1, 0] - p[-1, 0], e[-1, 1] - p[-1, 1])
        cal_err = np.hypot(out["x"][-1, a] - p[-1, 0],
                           out["y"][-1, a] - p[-1, 1])
        assert cal_err < max(0.2, 0.2 * raw_err), (a, raw_err, cal_err)


def test_few_fixes_leave_chain_untouched():
    t, n = 200, 2
    ex = np.cumsum(np.full((t, n), 0.05), axis=0)
    ey_ = np.zeros((t, n)); eyaw = np.zeros((t, n))
    mask = np.zeros((t, n), bool)
    mask[50, 0] = True   # 1 fix < min_obs
    out = calibrate_chains(ex, ey_, eyaw, mask, ex, ey_)
    np.testing.assert_allclose(out["bias"], 0.0)
    np.testing.assert_allclose(out["scale"], 1.0)
    np.testing.assert_allclose(out["x"], ex, atol=1e-5)


def test_robust_irls_downweights_false_fixes():
    """With ~30% of fixes corrupted by 0.5-1.5 m false-match offsets
    (the measured false-verified regime), the robust
    (Geman-McClure score + Cauchy IRLS) calibration still recovers the
    drift parameters; the scale fit in particular must not rail at its
    clip band the way plain LS does."""
    t, n = 1500, 4
    biases = np.array([0.008, -0.008, 0.008, -0.008])
    scales = np.array([0.998, 1.002, 1.002, 0.998])
    ex = np.zeros((t, n)); ey_ = np.zeros((t, n)); eyaw = np.zeros((t, n))
    zx = np.zeros((t, n)); zy = np.zeros((t, n))
    mask = np.zeros((t, n), bool)
    for a in range(n):
        p, e, yw = _drifted_chain(a, t, biases[a], scales[a], noise=0.002)
        ex[:, a], ey_[:, a], eyaw[:, a] = e[:, 0], e[:, 1], yw
        rng = np.random.default_rng(100 + a)
        idx = np.arange(15, t, 16)
        mask[idx, a] = True
        zx[:, a] = p[:, 0] + 0.05 * rng.normal(size=t)
        zy[:, a] = p[:, 1] + 0.05 * rng.normal(size=t)
        bad = rng.random(len(idx)) < 0.30
        bidx = idx[bad]
        off = rng.uniform(0.5, 1.5, (len(bidx), 2)) * \
            rng.choice([-1, 1], (len(bidx), 2))
        zx[bidx, a] += off[:, 0]
        zy[bidx, a] += off[:, 1]
    out = calibrate_chains(ex, ey_, eyaw, mask, zx, zy,
                           robust_c=0.25, irls_rounds=2)
    np.testing.assert_allclose(out["bias"], -biases, atol=0.0015)
    np.testing.assert_allclose(out["scale"], 1.0 / scales, atol=0.006)

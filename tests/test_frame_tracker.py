"""Online per-agent frame tracker (SlamConfig.merge_frame_gain;
slam/livemerge.py FrameState / frame_advance / frame_innovate).

The tracker estimates each agent's reported-frame rotation (the yaw-
bias drift, generate_fake_dual_session.py:407-444), its per-meter
growth rate, and the velocity scale from position-fix innovations, and
corrects every step's reported velocity with them — drift correction at
the SOURCE rate, so the event matcher's capture range and persistent
clamp never bind.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from swarm_tpu.config import SwarmConfig
from swarm_tpu.slam.livemerge import (
    FrameState, frame_add, frame_advance, frame_init, frame_innovate)
from swarm_tpu.slam.scanmatch import WindowMatch


def _cfg(gain=0.4, **kw):
    c = SwarmConfig(n_agents=2)
    return c.replace(slam=dataclasses.replace(
        c.slam, merge_frame_gain=gain, **kw))


def _match(ddx, ddy, ok, fit=0.9):
    z = jnp.zeros_like(ddx)
    return WindowMatch(ddx=ddx, ddy=ddy, ddtheta=z,
                       fitness=jnp.where(ok, fit, 0.0), ok=ok,
                       ddtheta_meas=z,
                       distinct=jnp.ones_like(ok, bool),
                       distinct_gap=jnp.full_like(ddx, jnp.inf))


def _drift_loop(cfg, steps=800, every=16, bias=(0.008, -0.008),
                scale=(0.998, 1.002), fix_noise=0.0, seed=0):
    """Synthetic closed loop: truth walks a rectangle; the reported
    chain drifts with a per-meter yaw bias + translation scale (the
    reference's parametric drift). Server runs the tracker with perfect
    (or noisy) position fixes every `every` steps, persisting only a
    damped fraction of each fix (merge_increments semantics). Returns
    max corrected position error, final state, true frame yaw/scale."""
    rng = np.random.default_rng(seed)
    n = 2
    step_len = 0.08
    fs = frame_init(n)
    dx = dy = jnp.zeros((n,), jnp.float32)          # merge_dx/dy
    true_pos = np.zeros((n, 2))
    rep_pos = np.zeros((n, 2))
    e = np.zeros((n,))                               # frame yaw error
    bias = np.asarray(bias)
    scale = np.asarray(scale)
    alive = jnp.ones((n,), bool)
    zero_yaw = jnp.zeros((n,), jnp.float32)
    max_err = 0.0
    for t in range(steps):
        heading = (t // 50 % 4) * (np.pi / 2)
        d_true = step_len * np.array([np.cos(heading), np.sin(heading)])
        d_true = np.broadcast_to(d_true, (n, 2))
        true_pos = true_pos + d_true
        e = e + bias * step_len                      # frame error grows
        c, s = np.cos(e), np.sin(e)
        d_rep = scale[:, None] * np.stack(
            [c * d_true[:, 0] - s * d_true[:, 1],
             s * d_true[:, 0] + c * d_true[:, 1]], axis=-1)
        rep_pos = rep_pos + d_rep
        adx, ady, fd = frame_advance(
            fs, jnp.asarray(rep_pos[:, 0], jnp.float32),
            jnp.asarray(rep_pos[:, 1], jnp.float32), alive, cfg)
        fs = frame_add(fs, fd)
        dx = dx + adx
        dy = dy + ady
        corr = rep_pos + np.stack([np.asarray(dx), np.asarray(dy)],
                                  axis=-1)
        err = np.hypot(*(corr - true_pos).T)
        max_err = max(max_err, float(err.max()))
        if (t + 1) % every == 0:
            fix = true_pos + fix_noise * rng.normal(size=(n, 2))
            r = fix - corr                           # matcher residual
            m = _match(jnp.asarray(r[:, 0], jnp.float32),
                       jnp.asarray(r[:, 1], jnp.float32),
                       jnp.ones((n,), bool))
            damp = 0.5
            inc_x = damp * jnp.asarray(r[:, 0], jnp.float32)
            inc_y = damp * jnp.asarray(r[:, 1], jnp.float32)
            fs = frame_add(fs, frame_innovate(
                fs, zero_yaw, m, m.ok, inc_x, inc_y, cfg))
            dx = dx + inc_x
            dy = dy + inc_y
    return max_err, fs, e, scale


def test_frame_tracker_converges_on_parametric_drift():
    """theta tracks the true frame yaw error; scale_dev tracks the
    translation scale; corrected position error stays bounded while the
    raw drift grows unboundedly (64 m of travel x 0.008 rad/m = 0.5 rad
    of frame yaw by the end); the rate estimate converges on the true
    per-meter bias."""
    cfg = _cfg(gain=0.4)
    max_err, fs, e_true, scale = _drift_loop(cfg)
    np.testing.assert_allclose(np.asarray(fs.theta), e_true, atol=0.06)
    np.testing.assert_allclose(1.0 + np.asarray(fs.scale_dev),
                               1.0 / scale, atol=0.004)
    # the rate must have learned the sign and rough magnitude of the
    # per-meter bias (feed-forward carries theta between innovations)
    rate = np.asarray(fs.rate)
    assert (np.sign(rate) == np.sign([0.008, -0.008])).all(), rate
    assert (np.abs(rate) <= 0.012).all()
    assert max_err < 0.15, max_err


def test_frame_tracker_bounded_under_fix_noise():
    cfg = _cfg(gain=0.4)
    max_err, fs, e_true, _ = _drift_loop(cfg, fix_noise=0.05, seed=3)
    np.testing.assert_allclose(np.asarray(fs.theta), e_true, atol=0.12)
    assert max_err < 0.3, max_err


def test_frame_advance_teleport_guard():
    """An oversized reported delta (respawn / first packet after a
    zero-init px) must not enter the correction or the accumulator —
    only rebase px/py."""
    cfg = _cfg()
    fs = frame_init(2)._replace(theta=jnp.asarray([0.3, 0.3], jnp.float32))
    z = jnp.zeros((2,), jnp.float32)
    raw_x = jnp.asarray([5.0, 0.1], jnp.float32)   # 5 m jump vs 0.1 m
    adx, ady, fd = frame_advance(fs, raw_x, z, jnp.ones((2,), bool), cfg)
    assert float(adx[0]) == 0.0 and float(fd.ax[0]) == 0.0
    assert float(fd.px[0]) == 5.0                  # rebased regardless
    assert float(adx[1]) != 0.0 and float(fd.ax[1]) != 0.0


def test_frame_innovate_gates_and_accumulation():
    """Sub-windows below the lever floor or on rejected events do not
    accumulate; the estimate fires only once the accumulated lever
    passes merge_frame_inno_path_m^2; the path accumulator resets at
    every VERIFIED event regardless."""
    cfg = _cfg(gain=0.4, merge_frame_inno_path_m=1.0)
    z = jnp.zeros((3,), jnp.float32)
    fs = frame_init(3)._replace(
        ax=jnp.asarray([1.0, 0.1, 1.0], jnp.float32))
    ok = jnp.asarray([True, True, False])
    m = _match(z, jnp.asarray([-0.2, -0.2, -0.2], jnp.float32), ok)
    fd = frame_innovate(fs, z, m, ok, z, z, cfg)
    # agent 0: lever 1.0 >= inno_path 1.0 -> fires; -cross/|a|^2 * gain
    # = 0.08, clamped at merge_frame_inno_clamp
    assert float(fd.theta[0]) == pytest.approx(0.05)
    assert float(fd.theta[1]) == 0.0 and float(fd.theta[2]) == 0.0
    assert float(fd.ax[0]) == -1.0
    assert float(fd.ax[1]) == pytest.approx(-0.1)   # reset (verified)
    assert float(fd.ax[2]) == 0.0                   # rejected: kept
    # zero persisted increment: the whole residual becomes leftover
    assert float(fd.ly[0]) == pytest.approx(-0.2)
    assert float(fd.ly[2]) == 0.0


def test_frame_innovate_fitness_gate_and_leftover():
    """A low-fitness verified event accumulates NO innovation but still
    re-baselines the accumulator and the leftover; the leftover carry
    subtracts the unabsorbed previous correction from the next window's
    innovation (unbiased under clamped/damped persistence)."""
    cfg = _cfg(gain=1.0, merge_frame_inno_path_m=1.0,
               merge_frame_inno_clamp=0.5)
    one = jnp.ones((1,), jnp.float32)
    z = jnp.zeros((1,), jnp.float32)
    ok = jnp.ones((1,), bool)
    fs = frame_init(1)._replace(ax=one)
    # event 1: residual 0.3 perp, fitness below the innovation floor
    m1 = _match(z, 0.3 * one, ok, fit=0.65)
    fd = frame_innovate(fs, z, m1, ok, z, 0.1 * one, cfg)
    assert float(fd.theta[0]) == 0.0                  # gated out
    assert float(fd.dacc[0]) == 0.0                   # not accumulated
    assert float(fd.ly[0]) == pytest.approx(0.2)      # 0.3 - 0.1 absorbed
    fs = frame_add(fs, fd)
    # event 2: the same 0.2 leftover reappears plus 0.1 of fresh drift;
    # the innovation must see only the fresh part
    fs = fs._replace(ax=one)
    m2 = _match(z, 0.3 * one, ok, fit=0.9)
    fd = frame_innovate(fs, z, m2, ok, z, 0.3 * one, cfg)
    # d_th = -cross(a, r_win)/|a|^2 = -(1*0.1)/1 = -0.1, gain 1.0
    assert float(fd.theta[0]) == pytest.approx(-0.1)
    assert float(fd.ly[0]) == pytest.approx(0.0 - 0.2)  # fully absorbed


def test_frame_innovate_turn_gate():
    """A window whose projection-rotation quantum changed (the agent
    turned, or the de-rotation quantum flipped) is discarded: its
    rotation-projection bias step is not a drift observation."""
    cfg = _cfg(gain=0.4, merge_frame_inno_path_m=0.5)
    one = jnp.ones((1,), jnp.float32)
    z = jnp.zeros((1,), jnp.float32)
    ok = jnp.ones((1,), bool)
    fs = frame_init(1)._replace(ax=one)               # qy = 0
    m = _match(z, -0.2 * one, ok)
    fd = frame_innovate(fs, 0.3 * one, m, ok, z, z, cfg)  # yaw moved
    assert float(fd.theta[0]) == 0.0
    assert float(fd.qy[0]) == pytest.approx(0.3)      # re-baselined
    # the discard is COUNTED toward the starvation override
    assert float(fd.gskip[0]) == 1.0


def test_frame_innovate_turn_gate_starvation_override():
    """SlamConfig.merge_frame_turn_starve (r5): an agent that turns at
    every merge window never passes the turn gate, so after `starve`
    consecutive turn-discards the next window is accepted anyway — the
    measured alternative is unbounded drift and band escapes (149 in
    the 181-ray 2000-step soak with the gate alone). The acceptance
    resets the counter."""
    import dataclasses
    cfg = _cfg(gain=0.4, merge_frame_inno_path_m=0.5)
    cfg = cfg.replace(slam=dataclasses.replace(
        cfg.slam, merge_frame_turn_starve=3))
    one = jnp.ones((1,), jnp.float32)
    z = jnp.zeros((1,), jnp.float32)
    ok = jnp.ones((1,), bool)
    m = _match(z, -0.2 * one, ok)
    fs = frame_init(1)._replace(ax=one)
    from swarm_tpu.slam.livemerge import frame_add
    for k in range(3):                       # three turn-discards
        # the quantum re-baselines at every verified event, so the
        # agent must keep turning for the gate to keep firing
        fd = frame_innovate(fs, 0.3 * (k + 1) * one, m, ok, z, z, cfg)
        assert float(fd.dacc[0]) == 0.0, k   # nothing accumulated
        fs = frame_add(fs, fd)._replace(ax=one)   # next window's lever
        assert float(fs.gskip[0]) == k + 1
    # 4th consecutive turning window: starved -> accepted (the lever
    # reaches inno_path immediately, so the estimate FIRES), counter
    # reset. Fresh residual: the leftover carry has absorbed -0.2.
    fd = frame_innovate(fs, 1.2 * one, _match(z, -0.5 * one, ok),
                        ok, z, z, cfg)
    assert float(fd.theta[0]) != 0.0         # innovation applied
    fs = frame_add(fs, fd)
    assert float(fs.gskip[0]) == 0.0
    # with the override disabled (pre-r5), the 4th window still discards
    cfg0 = cfg.replace(slam=dataclasses.replace(
        cfg.slam, merge_frame_turn_starve=0))
    fs0 = frame_init(1)._replace(ax=one, gskip=3 * one)
    fd0 = frame_innovate(fs0, 0.3 * one, m, ok, z, z, cfg0)
    assert float(fd0.dacc[0]) == 0.0


def test_fused_engine_frame_tracker_reduces_drift():
    """End-to-end fused engine: the deployable anchored-merge preset
    with the tracker ON cuts late pose error vs OFF on the same world
    (drifting odometry, models/odometry.py drift_integrate)."""
    import sys
    sys.path.insert(0, ".")
    from __graft_entry__ import _cfg_and_world

    sys.path.insert(0, "tools")
    from bench_accuracy import ate, run_variant

    base_cfg, walls, params, rooms = _cfg_and_world(
        4, frontiers=False, parity=False, raster_mode="beam",
        fast_raster=False, scan_rays=61, tiled=True)
    res = {}
    for name, gain in [("off", 0.0), ("on", 0.35)]:
        cfg = base_cfg.replace(
            slam=dataclasses.replace(base_cfg.slam,
                                     closure_correction=0.0,
                                     merge_frame_gain=gain),
            engine=dataclasses.replace(base_cfg.engine, merge_every=16))
        log, state = run_variant(cfg, walls, params, rooms, 400, 100,
                                 collect_scans=False)
        res[name] = ate(log["err"])
    # late-window error must improve with the tracker on
    assert res["on"][1] < res["off"][1], res

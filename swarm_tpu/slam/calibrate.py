"""Per-agent odometry drift calibration from absolute position fixes.

The reference's drift model (generate_fake_dual_session.py:407-444) is
dominated by two PARAMETERS per agent: a signed yaw-rate bias
(-/+0.008 rad/m — the estimated frame slowly ROTATES as the robot
travels) and a translation scale bias (x0.998 / x1.002). Neither is
observable from same-agent relative edges (the r3 finding: drift is a
near-rigid frame transform), but both are strongly observable offline
against the anchored-merge ABSOLUTE fixes the deployable preset already
produces: a yaw-rate bias delta_b bends the whole trajectory, displacing
the pose at distance-travelled D by ~delta_b * D^2 / 2 laterally — at
the reference rates that is ~0.4 m per 10 m travelled against ~0.1 m
fix noise, an SNR the per-event ONLINE theta residual (~0.01 rad signal
under ~0.07 rad quantisation sawtooth) never approaches. This module
fits (yaw-rate bias, scale) per agent by re-integrating the odometry
chain under candidate corrections and scoring against the fixes, fully
batched over agents and candidates (one [B, N, T] jit — batched
cumsums, no per-agent Python).

The calibrated chain then feeds the existing offline tiers
(slam/refine.py, slam/joint.py): with the systematic bend explained by
one explicit parameter, the pose-graph GN no longer has to pay odometry
-factor cost at every step to absorb it, and the closure/unary factors
pull the residual instead of fighting the bias.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("n_bias",))
def _score_biases(xy, w_obs, z_xy, bias_lo, bias_hi, n_bias: int,
                  inv_c2=0.0):
    """Robustified SSE of every candidate yaw-rate bias per agent.

    xy    [N, T, 2] logged estimate positions
    w_obs [N, T]    observation weights (0 where no fix)
    z_xy  [N, T, 2] absolute fixes (ignored where w_obs == 0)
    inv_c2: 1/c^2 of the Geman-McClure saturation rho(e2) = e2/(1 +
      e2/c^2) — a fix more than ~c off the candidate chain contributes
      a bounded ~c^2 instead of dominating the quadratic score (the
      measured 21-31% false-fix fraction). 0 = plain SSE.
    Returns (biases [B], score [B, N]).
    """
    biases = jnp.linspace(bias_lo, bias_hi, n_bias)
    d = jnp.diff(xy, axis=1)                          # [N, T-1, 2]
    seg = jnp.linalg.norm(d, axis=-1)                 # [N, T-1]
    # distance travelled BEFORE each segment
    dist = jnp.concatenate([jnp.zeros_like(seg[:, :1]),
                            jnp.cumsum(seg[:, :-1], axis=1)], axis=1)

    def sse_of(b):
        a = b * dist                                  # [N, T-1]
        ca, sa = jnp.cos(a), jnp.sin(a)
        rx = ca * d[..., 0] - sa * d[..., 1]
        ry = sa * d[..., 0] + ca * d[..., 1]
        px = xy[:, :1, 0] + jnp.concatenate(
            [jnp.zeros_like(rx[:, :1]), jnp.cumsum(rx, axis=1)], axis=1)
        py = xy[:, :1, 1] + jnp.concatenate(
            [jnp.zeros_like(ry[:, :1]), jnp.cumsum(ry, axis=1)], axis=1)
        e2 = (px - z_xy[..., 0]) ** 2 + (py - z_xy[..., 1]) ** 2
        rho = e2 / (1.0 + e2 * inv_c2)
        return jnp.sum(w_obs * rho, axis=1)           # [N]

    return biases, jax.lax.map(sse_of, biases)


@jax.jit
def _reintegrate(xy, yaw, bias, scale):
    """Apply per-agent (bias [N], scale [N]) to the chain [N, T, ...]."""
    d = jnp.diff(xy, axis=1)
    seg = jnp.linalg.norm(d, axis=-1)
    dist = jnp.concatenate([jnp.zeros_like(seg[:, :1]),
                            jnp.cumsum(seg[:, :-1], axis=1)], axis=1)
    a = bias[:, None] * dist
    ca, sa = jnp.cos(a), jnp.sin(a)
    rx = scale[:, None] * (ca * d[..., 0] - sa * d[..., 1])
    ry = scale[:, None] * (sa * d[..., 0] + ca * d[..., 1])
    px = xy[:, :1, 0] + jnp.concatenate(
        [jnp.zeros_like(rx[:, :1]), jnp.cumsum(rx, axis=1)], axis=1)
    py = xy[:, :1, 1] + jnp.concatenate(
        [jnp.zeros_like(ry[:, :1]), jnp.cumsum(ry, axis=1)], axis=1)
    # distance AT each pose (0 at t=0) rotates the yaw too
    dist_at = jnp.concatenate([jnp.zeros_like(seg[:, :1]),
                               jnp.cumsum(seg, axis=1)], axis=1)
    return (jnp.stack([px, py], axis=-1),
            yaw + bias[:, None] * dist_at,
            dist_at)


@jax.jit
def _fit_scale(xy_cal, w_obs, z_xy):
    """Closed-form per-agent scale given the bias-corrected chain: with
    p(s) = p0 + s * v (v = bias-rotated cumulative deltas), the LS
    scale is <z - p0, v> / <v, v> over the weighted fixes."""
    p0 = xy_cal[:, :1, :]
    v = xy_cal - p0
    num = jnp.sum(w_obs[..., None] * v * (z_xy - p0), axis=(1, 2))
    den = jnp.sum(w_obs[..., None] * v * v, axis=(1, 2))
    return num / jnp.maximum(den, 1e-9)


def calibrate_chains(ex, ey, eyaw, obs_mask, zx, zy,
                     bias_range: float = 0.015, n_bias: int = 61,
                     scale_band: float = 0.01, min_obs: int = 5,
                     robust_c: float = 0.0, irls_rounds: int = 0):
    """Fit (yaw-rate bias, translation scale) per agent and return the
    calibrated chains.

    ex, ey, eyaw [T, N]: logged raw odometry estimates (step-major, the
      tools/bench_accuracy.py log layout).
    obs_mask [T, N] bool: steps with a fitness-verified anchored-merge
      fix (slam/livemerge.py `upd`).
    zx, zy [T, N]: the fix positions (server/anchor frame) at those
      steps — e.g. the logged post-match srv_x/srv_y.

    robust_c (metres) + irls_rounds: robust estimation against false
      fixes (the measured 21-31% false-verified merge rate).
      The bias grid search scores with a Geman-McClure saturation at
      scale c; after each of `irls_rounds` passes the fix weights are
      re-derived from the calibrated chain's residuals (Cauchy IRLS,
      w = 1/(1 + e^2/c^2)) and the fit repeats — outliers that pulled
      the first fit get down-weighted out. 0/0 = the plain LS of r4.

    Returns dict with bias [N], scale [N], x/y/yaw [T, N] calibrated,
    n_obs [N]. Agents with fewer than min_obs fixes keep bias=0,
    scale=1 (nothing to calibrate against).
    """
    xy = jnp.stack([jnp.asarray(ex).T, jnp.asarray(ey).T], axis=-1)
    yaw = jnp.asarray(eyaw).T                             # [N, T]
    w0 = jnp.asarray(obs_mask).T.astype(jnp.float32)      # [N, T]
    z = jnp.stack([jnp.asarray(zx).T, jnp.asarray(zy).T], axis=-1)
    n_obs = jnp.sum(w0, axis=1)
    inv_c2 = (1.0 / (robust_c * robust_c)) if robust_c > 0.0 else 0.0

    w = w0
    for irls in range(irls_rounds + 1):
        biases, sse = _score_biases(xy, w, z, -bias_range, bias_range,
                                    n_bias, inv_c2)       # [B], [B, N]
        k = jnp.argmin(sse, axis=0)                       # [N]
        # parabolic refinement around the grid minimum (same recipe as
        # the scan matcher's sub-cell peak)
        km = jnp.clip(k - 1, 0, n_bias - 1)
        kp = jnp.clip(k + 1, 0, n_bias - 1)
        ar = jnp.arange(sse.shape[1])
        c0, cm, cp = sse[k, ar], sse[km, ar], sse[kp, ar]
        denom = cm - 2 * c0 + cp
        off = jnp.where(jnp.abs(denom) > 1e-12,
                        0.5 * (cm - cp) / denom, 0.0)
        off = jnp.where((k > 0) & (k < n_bias - 1),
                        jnp.clip(off, -0.5, 0.5), 0.0)
        step = biases[1] - biases[0]
        bias = biases[k] + off * step
        bias = jnp.where(n_obs >= min_obs, bias, 0.0)

        xy_b, yaw_b, _ = _reintegrate(xy, yaw, bias, jnp.ones_like(bias))
        scale = jnp.clip(_fit_scale(xy_b, w, z),
                         1.0 - scale_band, 1.0 + scale_band)
        scale = jnp.where(n_obs >= min_obs, scale, 1.0)
        xy_c, yaw_c, dist = _reintegrate(xy, yaw, bias, scale)

        if irls < irls_rounds:
            e2 = jnp.sum((xy_c - z) ** 2, axis=-1)        # [N, T]
            w = w0 / (1.0 + e2 * inv_c2)

    return {"bias": np.asarray(bias), "scale": np.asarray(scale),
            "n_obs": np.asarray(n_obs, np.int64),
            "x": np.asarray(xy_c[..., 0].T), "y": np.asarray(xy_c[..., 1].T),
            "yaw": np.asarray(yaw_c.T),
            "dist": np.asarray(dist.T)}


def relocalize_fixes(anchor_logodds, x, y, yaw, scans, cfg,
                     every: int = 16, n_theta: int = 15,
                     theta_range: float = 0.3,
                     theta_prior_scale: float = 0.3):
    """Offline re-localization against the frozen anchor map: match each
    agent's logged scan, projected at the (calibrated) pose, against the
    anchor at a step cadence — the offline analogue of the reference
    merger's submap re-alignment (map_merger.py:35-62), free of the
    online pass's real-time constraints.

    The ONLINE fixes are only as good as the live correction loop that
    produced them (measured: 0.25 m median / 0.8 m p90 error vs truth at
    64 agents / 2000 steps — the matcher's search window saturates once
    drift outruns it, biasing the calibration toward the drifted chain).
    Re-matching from an already-calibrated chain re-centres every search
    window near truth, so the second-round fixes are capture-unsaturated.

    anchor_logodds [S, S]; x/y/yaw/scans step-major [T, N(, R)].
    Returns (mask [T, N] bool, zx, zy [T, N]) — fitness-verified fixes.
    """
    from swarm_tpu.slam.livemerge import scan_merge

    anchor = jnp.asarray(anchor_logodds)
    match_map = jnp.where(jnp.abs(anchor) >= 0.5, anchor, 0.0)
    t_steps, n = np.shape(x)[:2]
    alive = jnp.ones((n,), bool)

    @jax.jit
    def one(rx, ry, ryaw, sd):
        m = scan_merge(match_map, rx, ry, ryaw, sd, alive, cfg,
                       n_theta=n_theta, theta_range=theta_range,
                       theta_prior_scale=theta_prior_scale)
        # distinct: all-True unless cfg.slam.merge_distinct_margin > 0 —
        # offline re-localization wants the ambiguous-peak filter ON
        # (pass a cfg with the margin set)
        return m.ok & m.distinct, rx + m.ddx, ry + m.ddy

    mask = np.zeros((t_steps, n), bool)
    zx = np.zeros((t_steps, n), np.float32)
    zy = np.zeros((t_steps, n), np.float32)
    for t in range(every - 1, t_steps, every):
        ok, fx, fy = one(jnp.asarray(x[t]), jnp.asarray(y[t]),
                         jnp.asarray(yaw[t]), jnp.asarray(scans[t]))
        mask[t] = np.asarray(ok)
        zx[t] = np.asarray(fx)
        zy[t] = np.asarray(fy)
    return mask, zx, zy


def calibrate_reloc(ex, ey, eyaw, obs_mask, zx, zy, anchor_logodds,
                    scans, cfg, rounds: int = 2, every: int = 16,
                    **cal_kw):
    """Calibrate, then iterate (re-localize fixes from the calibrated
    chain -> re-calibrate the RAW chain on them) `rounds` times.
    Returns (cal dict, mask, zx, zy) — the final calibration and the
    final fix set (for downstream pose-graph unary factors)."""
    cal = calibrate_chains(ex, ey, eyaw, obs_mask, zx, zy, **cal_kw)
    mask, fx, fy = obs_mask, zx, zy
    for _ in range(rounds):
        mask, fx, fy = relocalize_fixes(
            anchor_logodds, cal["x"], cal["y"], cal["yaw"], scans, cfg,
            every=every)
        cal = calibrate_chains(ex, ey, eyaw, mask, fx, fy, **cal_kw)
    return cal, mask, fx, fy

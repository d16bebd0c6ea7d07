"""6-state extended Kalman filter, written for vmap over thousands of agents.

Reproduces the reference firmware filter (AgentFirmware_Bot1/ekf.{h,cpp}):
state [x, y, theta, v, omega, bias_omega]; `predict` integrates gyro-z with
bias correction through a unicycle motion model and propagates covariance
through the analytic Jacobian (ekf.cpp:26-68); `update` fuses an encoder
(v, omega) measurement with the standard Kalman gain (ekf.cpp:70-92).

Batched departures from the C++:
  * No Eigen `S.inverse()` — S is 2x2, inverted in closed form (ekf.cpp:86).
  * All matrices are fixed [6, 6]; under `jax.vmap` the whole swarm's
    covariance propagation becomes one batched [N, 6, 6] einsum that XLA
    fuses with the surrounding step.
  * `initialized_` / `dt <= 0` guards (ekf.cpp:27-31) become `jnp.where`
    masks so the function stays pure and branch-free.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from swarm_tpu.config import EkfConfig
from swarm_tpu.utils.angles import wrap_pi

# State indices — ref ekf.h:38-44.
IDX_X, IDX_Y, IDX_THETA, IDX_V, IDX_OMEGA, IDX_BIAS = 0, 1, 2, 3, 4, 5
STATE_DIM = 6


class EkfState(NamedTuple):
    x: jnp.ndarray       # [..., 6] mean
    P: jnp.ndarray       # [..., 6, 6] covariance
    last_t: jnp.ndarray  # [...] seconds


def ekf_init(x0=None, t0=0.0, dtype=jnp.float32) -> EkfState:
    """Single-agent initial state (P = I, ref ekf.cpp:7). vmap to batch."""
    x = jnp.zeros((STATE_DIM,), dtype) if x0 is None else jnp.asarray(x0, dtype)
    return EkfState(x=x, P=jnp.eye(STATE_DIM, dtype=dtype),
                    last_t=jnp.asarray(t0, dtype))


def _q_matrix(cfg: EkfConfig, dtype):
    return jnp.diag(jnp.asarray(cfg.q_diag, dtype))


def ekf_predict(state: EkfState, omega_measured, t, cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Gyro-driven predict step. Ref ekf.cpp:26-68.

    omega_measured: gyro-z (rad/s), already bias-calibrated at boot the way
    the firmware does (AgentFirmware_Bot1.ino:625-633) — the filter still
    estimates the residual bias in state[5].
    """
    x, P, last_t = state
    dtype = x.dtype
    dt = t - last_t
    valid = dt > 0.0                       # ref ekf.cpp:30 guard
    dt = jnp.where(valid, dt, 0.0)

    theta = x[IDX_THETA]
    v = x[IDX_V]
    bias = x[IDX_BIAS]
    omega_c = omega_measured - bias

    x_new = x.at[IDX_X].add(v * jnp.cos(theta) * dt)
    x_new = x_new.at[IDX_Y].add(v * jnp.sin(theta) * dt)
    x_new = x_new.at[IDX_THETA].set(wrap_pi(theta + omega_c * dt))
    x_new = x_new.at[IDX_OMEGA].set(omega_c)

    # Analytic Jacobian, ref ekf.cpp:55-65.
    jac = jnp.eye(STATE_DIM, dtype=dtype)
    jac = jac.at[IDX_X, IDX_THETA].set(-v * jnp.sin(theta) * dt)
    jac = jac.at[IDX_X, IDX_V].set(jnp.cos(theta) * dt)
    jac = jac.at[IDX_Y, IDX_THETA].set(v * jnp.cos(theta) * dt)
    jac = jac.at[IDX_Y, IDX_V].set(jnp.sin(theta) * dt)
    jac = jac.at[IDX_THETA, IDX_BIAS].set(-dt)
    jac = jac.at[IDX_OMEGA, IDX_OMEGA].set(0.0)
    jac = jac.at[IDX_OMEGA, IDX_BIAS].set(-1.0)

    # Full-precision propagation: covariance is 6x6 and numerically
    # sensitive — never let a matrix unit downcast it (TF32 on the GPU).
    P_new = jnp.einsum("ij,jk,lk->il", jac, P, jac,
                       precision=jax.lax.Precision.HIGHEST) + _q_matrix(cfg, dtype)

    # dt <= 0 is a no-op, including last_t (ref ekf.cpp:30-31).
    x = jnp.where(valid, x_new, x)
    P = jnp.where(valid, P_new, P)
    new_t = jnp.where(valid, t, last_t)
    return EkfState(x=x, P=P, last_t=new_t)


def ekf_update(state: EkfState, v_meas, omega_meas, cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Encoder (v, omega) measurement update. Ref ekf.cpp:70-92.

    H selects rows (v, omega), so H P H^T is just the 2x2 block of P at
    indices (3, 4) — no general matmul needed, and the 2x2 inverse is closed
    form instead of Eigen's `S.inverse()`.
    """
    x, P, last_t = state
    dtype = x.dtype
    r0, r1 = cfg.r_odom_diag

    iv, iw = IDX_V, IDX_OMEGA
    # S = H P H^T + R  — 2x2 block.
    s00 = P[iv, iv] + r0
    s01 = P[iv, iw]
    s10 = P[iw, iv]
    s11 = P[iw, iw] + r1
    det = s00 * s11 - s01 * s10
    inv00, inv01 = s11 / det, -s01 / det
    inv10, inv11 = -s10 / det, s00 / det

    # K = P H^T S^{-1}  — [6, 2]; P H^T is columns (v, omega) of P.
    pht = jnp.stack([P[:, iv], P[:, iw]], axis=-1)          # [6, 2]
    s_inv = jnp.stack([jnp.stack([inv00, inv01]),
                       jnp.stack([inv10, inv11])]).astype(dtype)
    K = jnp.matmul(pht, s_inv,
                   precision=jax.lax.Precision.HIGHEST)       # [6, 2]

    innov = jnp.stack([v_meas - x[iv], omega_meas - x[iw]]).astype(dtype)
    x_new = x + jnp.matmul(K, innov, precision=jax.lax.Precision.HIGHEST)

    # P = (I - K H) P; K H is [6, 6] with only columns (v, omega) non-zero.
    KH = jnp.zeros((STATE_DIM, STATE_DIM), dtype)
    KH = KH.at[:, iv].set(K[:, 0])
    KH = KH.at[:, iw].set(K[:, 1])
    P_new = jnp.matmul(jnp.eye(STATE_DIM, dtype=dtype) - KH, P,
                       precision=jax.lax.Precision.HIGHEST)
    return EkfState(x=x_new, P=P_new, last_t=last_t)


def ekf_predict_batch(state: EkfState, omega_measured, t,
                      cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Swarm-batched predict: state is [N, 6] / [N, 6, 6] / [N].

    Same math as `ekf_predict` (ref ekf.cpp:26-68) but written as
    elementwise work: the Jacobian is I plus six sparse entries, so
    F P Fᵀ unrolls into row and column combinations over [N, 6] slices —
    all elementwise FMAs over the agent axis, no batched tiny matmuls and
    no per-agent dynamic-update-slices (which the vmapped form lowers
    to). Exact f32 throughout, so no precision pin is needed; agrees with vmap(ekf_predict) to float addition-order."""
    x, P, last_t = state
    dt = t - last_t
    valid = dt > 0.0                       # ref ekf.cpp:30 guard
    dt = jnp.where(valid, dt, 0.0)

    theta = x[:, IDX_THETA]
    v = x[:, IDX_V]
    bias = x[:, IDX_BIAS]
    omega_c = omega_measured - bias
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)

    x_new = jnp.stack([
        x[:, IDX_X] + v * cos_t * dt,
        x[:, IDX_Y] + v * sin_t * dt,
        wrap_pi(theta + omega_c * dt),
        x[:, IDX_V],
        omega_c,
        x[:, IDX_BIAS]], axis=-1)

    # F = I + {(0,2): a, (0,3): b, (1,2): c, (1,3): d, (2,5): e,
    #          (4,4): -1 (i.e. row4 = -e5), (4,5): -1} — ref ekf.cpp:55-65.
    a = (-v * sin_t * dt)[:, None]
    b = (cos_t * dt)[:, None]
    c = (v * cos_t * dt)[:, None]
    d = (sin_t * dt)[:, None]
    e = (-dt)[:, None]

    # FP = F P: rows of P combined per F's sparsity ([N, 6] slices).
    fp0 = P[:, 0, :] + a * P[:, 2, :] + b * P[:, 3, :]
    fp1 = P[:, 1, :] + c * P[:, 2, :] + d * P[:, 3, :]
    fp2 = P[:, 2, :] + e * P[:, 5, :]
    fp3 = P[:, 3, :]
    fp4 = -P[:, 5, :]
    fp5 = P[:, 5, :]
    FP = jnp.stack([fp0, fp1, fp2, fp3, fp4, fp5], axis=1)

    # (FP) Fᵀ: same combination over columns.
    g0 = FP[:, :, 0] + a * FP[:, :, 2] + b * FP[:, :, 3]
    g1 = FP[:, :, 1] + c * FP[:, :, 2] + d * FP[:, :, 3]
    g2 = FP[:, :, 2] + e * FP[:, :, 5]
    g3 = FP[:, :, 3]
    g4 = -FP[:, :, 5]
    g5 = FP[:, :, 5]
    q = jnp.asarray(cfg.q_diag, x.dtype)
    P_new = jnp.stack([g0, g1, g2, g3, g4, g5], axis=2) + \
        q[None, None, :] * jnp.eye(STATE_DIM, dtype=x.dtype)[None]

    return EkfState(
        x=jnp.where(valid[:, None], x_new, x),
        P=jnp.where(valid[:, None, None], P_new, P),
        last_t=jnp.where(valid, t, last_t))


def ekf_update_batch(state: EkfState, v_meas, omega_meas,
                     cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Swarm-batched encoder update (ref ekf.cpp:70-92): 2x2 closed-form
    innovation inverse, K and (I - KH)P as broadcasted outer products over
    the agent axis. See `ekf_predict_batch` for why not vmap."""
    x, P, last_t = state
    r0, r1 = cfg.r_odom_diag
    iv, iw = IDX_V, IDX_OMEGA

    s00 = P[:, iv, iv] + r0
    s01 = P[:, iv, iw]
    s10 = P[:, iw, iv]
    s11 = P[:, iw, iw] + r1
    det = s00 * s11 - s01 * s10
    inv00, inv01 = s11 / det, -s01 / det
    inv10, inv11 = -s10 / det, s00 / det

    pht0 = P[:, :, iv]                       # [N, 6]
    pht1 = P[:, :, iw]
    k0 = pht0 * inv00[:, None] + pht1 * inv10[:, None]   # K[:, :, 0]
    k1 = pht0 * inv01[:, None] + pht1 * inv11[:, None]   # K[:, :, 1]

    innov0 = v_meas - x[:, iv]
    innov1 = omega_meas - x[:, iw]
    x_new = x + k0 * innov0[:, None] + k1 * innov1[:, None]

    # (KH)P rows: K[:, i, 0] P[v, :] + K[:, i, 1] P[omega, :].
    khp = k0[:, :, None] * P[:, iv, None, :] + \
        k1[:, :, None] * P[:, iw, None, :]
    return EkfState(x=x_new, P=P - khp, last_t=last_t)


def ekf_step_batch(state: EkfState, omega_meas, v_meas, t,
                   cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Fused predict-then-update, the firmware's per-loop sequence
    (AgentFirmware_Bot1.ino:697-702 then navigate's encoder fuse)."""
    return ekf_update_batch(
        ekf_predict_batch(state, omega_meas, t, cfg), v_meas, omega_meas, cfg)


def ekf_pose(state: EkfState):
    """(x, y, theta, v, omega) view — the firmware's getOdom() without the
    ROS message wrapper (ekf.cpp:94-116)."""
    x = state.x
    return x[IDX_X], x[IDX_Y], x[IDX_THETA], x[IDX_V], x[IDX_OMEGA]


def ekf_quaternion_z_w(state: EkfState):
    """Planar quaternion (z, w) as the reference publishes (ekf.cpp:108-110)."""
    half = state.x[IDX_THETA] / 2.0
    return jnp.sin(half), jnp.cos(half)

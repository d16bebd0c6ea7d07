"""Synthetic session generator — the reference's offline data engine
(simulation_tools/generate_fake_dual_session.py) rebuilt for this
framework.

Semantics preserved (SURVEY §3.3): scripted waypoint trajectories with a
hysteresis wall-following wiggle controller (:274-304), a scripted
stuck-bot fault (:331-350), per-bot odometry drift integration so sensors
cast from the TRUE pose while telemetry reports the DRIFTED estimate
(:387-453, :455-457), encoder ticks from estimated displacement (:460-462),
v2v = inter-bot true distance in cm (:466), 15-degree yaw quantisation
(:468), 5 % duplicate packets (:471) and the Bot-2 +/-0.08 s timestamp
jitter (:505), all under one seed.

Host/device split: trajectory scripting and the sequential drift/noise chain
are host-side numpy (inherently sequential, offline, ~600 steps); the heavy
geometry — every step's 4-ray exact cast — is ONE batched JAX call over the
whole [T, 4] trajectory (geom.world.cast_rays). The waypoint routes are
generated parametrically per room/agent (perimeter_sweep_waypoints) rather
than hand-listed per bot, so the same generator scripts N-agent scenarios.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from swarm_tpu.config import NoiseConfig, SensorConfig, SwarmConfig
from swarm_tpu.geom.world import BEDROOM_WALLS


def perimeter_sweep_waypoints(side: int, room=( -0.5, -2.0, 5.5, 2.0),
                              start: Tuple[float, float] = (0.0, 0.0),
                              mid_x: Optional[float] = None,
                              wall_gap: float = 0.3) -> List[Tuple[float, float, float]]:
    """Script a half-room perimeter sweep, the route the reference hand-lists
    as BOT1_WAYPOINTS / BOT2_WAYPOINTS (generate_fake_dual_session.py:137-222):
    north to the top band, out to the near side wall, along the top wall to
    the room centre, down the centre line, back along the bottom wall, and
    north to the start. `side` = +1 sweeps the left half (Bot1-style),
    -1 the right half (Bot2-style). Waypoints are (x, y, yaw_deg).
    """
    x0, y0, x1, y1 = room
    sx, sy = start
    top = y1 - wall_gap
    bot = y0 + wall_gap
    near_wall = (x0 + 0.3) if side > 0 else (x1 - 0.3)
    if mid_x is None:
        mid_x = (x0 + x1) / 2.0 + (-0.05 if side > 0 else 0.05) * (x1 - x0)
    out_yaw = 180 if side > 0 else 0       # toward the near side wall
    in_yaw = 0 if side > 0 else 180        # back toward the centre

    wps: List[Tuple[float, float, float]] = [(sx, sy, 90)]
    # north toward the top band in ~0.45 m bites (:141-144)
    for yy in np.arange(sy + 0.4, top - 0.35, 0.45):
        wps.append((sx, float(yy), 90))
    # jog to the near side wall, then up into the corner (:146-150)
    wps.append((sx, wps[-1][1], out_yaw))
    wps.append((near_wall, wps[-1][1], out_yaw))
    wps.append((near_wall, wps[-1][1], 90))
    wps.append((near_wall, top, 90))
    # sweep the top wall to the centre line (:152-159)
    wps.append((near_wall, top, in_yaw))
    for xx in np.linspace(near_wall + side * 0.6, mid_x, 5):
        wps.append((float(xx), top, in_yaw))
    # down the centre line (:161-168)
    wps.append((mid_x, top, -90))
    for yy in np.arange(top - 0.6, bot + 0.25, -0.6):
        wps.append((mid_x, float(yy), -90))
    wps.append((mid_x, bot, -90))
    # along the bottom wall back to the start column (:170-176)
    wps.append((mid_x, bot, out_yaw))
    for xx in np.linspace(mid_x - side * 0.65, sx, 4):
        wps.append((float(xx), bot, out_yaw))
    # north back to the start (:178-182)
    wps.append((sx, bot, 90))
    for yy in np.arange(bot + 0.6, sy - 0.2, 0.6):
        wps.append((sx, float(yy), 90))
    wps.append((sx, sy, 90))
    return wps


def interpolate_waypoints(waypoints, rng: np.random.Generator,
                          steps_per_meter: int = 25,
                          room=(-0.5, -2.0, 5.5, 2.0),
                          wall_band: float = 0.4):
    """Waypoint list -> dense TRUE pose trajectory with the reference's
    wall-following wiggle (generate_fake_dual_session.py:225-311).

    Near a wall the lateral offset follows a hysteresis controller
    (steer away past +0.15 m, toward past -0.15 m, 1.2 cm/step drift,
    +/-0.22 rad steering yaw error); in open space offsets decay and only
    small execution noise remains. Pure rotations emit 4 poses.
    """
    x0r, y0r, x1r, y1r = room
    poses = []
    lat = 0.0
    steer = 1.0
    for i in range(len(waypoints) - 1):
        xa, ya, yawa = waypoints[i]
        xb, yb, yawb = waypoints[i + 1]
        dx, dy = xb - xa, yb - ya
        dist = math.hypot(dx, dy)
        if dist < 0.05:                       # pure rotation (:246-254)
            ra, rb = math.radians(yawa), math.radians(yawb)
            dyaw = (rb - ra + math.pi) % (2 * math.pi) - math.pi
            for j in range(4):
                yaw = ra + (j / 4) * dyaw + rng.normal(0, 0.03)
                poses.append((xa, ya, yaw))
            continue
        n_steps = max(5, int(dist * steps_per_meter))
        ux, uy = dx / dist, dy / dist
        nx, ny = -uy, ux
        seg_yaw = math.atan2(dy, dx)
        for j in range(n_steps):
            t = j / n_steps
            px, py = xa + t * dx, ya + t * dy
            near_wall = (py > y1r - wall_band - 0.3) or \
                        (py < y0r + wall_band + 0.3) or \
                        (px < x0r + wall_band) or (px > x1r - wall_band)
            if near_wall:
                if lat < -0.15:
                    steer = 1.0
                elif lat > 0.15:
                    steer = -1.0
                lat += steer * 0.012 + rng.normal(0, 0.003)
                lat = max(-0.20, min(0.20, lat))
                yaw_err = -steer * 0.22 + rng.normal(0, 0.03)
                lon = rng.normal(0, 0.004)
            else:
                lat = lat * 0.9 + rng.normal(0, 0.002)
                yaw_err = rng.normal(0, 0.005)
                lon = rng.normal(0, 0.002)
            poses.append((px + lat * nx + lon * ux,
                          py + lat * ny + lon * uy,
                          seg_yaw + yaw_err))
    xf, yf, yawf = waypoints[-1]
    poses.append((xf, yf, math.radians(yawf)))
    return np.asarray(poses, np.float32)


def inject_stuck(poses: np.ndarray, rng: np.random.Generator,
                 near_xy: Tuple[float, float], heading: float,
                 n_stuck: int = 40, after: int = 40) -> np.ndarray:
    """Insert a wall-seeking wiggle loop when the trajectory first passes
    `near_xy` with ~`heading` — the reference's scripted Bot-2 corner fault
    (generate_fake_dual_session.py:331-350)."""
    out = []
    done = False
    for i, (x, y, yaw) in enumerate(poses):
        out.append((x, y, yaw))
        if not done and i > after and \
                abs(x - near_xy[0]) < 0.25 and abs(y - near_xy[1]) < 0.25 and \
                abs(((yaw - heading + math.pi) % (2 * math.pi)) - math.pi) < 0.4:
            done = True
            for k in range(n_stuck):
                wx = near_xy[0] + 0.01 * math.sin(k * 0.35) + rng.normal(0, 0.002)
                wy = near_xy[1] + 0.01 * math.cos(k * 0.25) + rng.normal(0, 0.002)
                wyaw = heading + 0.6 * math.sin(k * 0.3) + rng.normal(0, 0.05)
                out.append((wx, wy, wyaw))
    return np.asarray(out, np.float32)


def _drift_chain(poses: np.ndarray, n_live: int, scale: float,
                 yaw_bias: float, rng: np.random.Generator,
                 noise: NoiseConfig) -> np.ndarray:
    """Sequential odometry-drift integration over a TRUE trajectory
    (generate_fake_dual_session.py:395-453). Returns [T, 3] estimates."""
    est = np.empty_like(poses)
    est[0] = poses[0]
    x_e, y_e, yaw_e = map(float, poses[0])
    for i in range(1, len(poses)):
        if i >= n_live:                      # bot stopped: estimate frozen
            est[i] = (x_e, y_e, yaw_e)
            continue
        dx = poses[i, 0] - poses[i - 1, 0]
        dy = poses[i, 1] - poses[i - 1, 1]
        d_trans = math.hypot(dx, dy)
        d_rot = float(poses[i, 2] - poses[i - 1, 2])
        d_rot = (d_rot + math.pi) % (2 * math.pi) - math.pi

        d_trans_n = d_trans * scale
        if d_trans > 1e-3:
            d_trans_n += rng.normal(0, noise.trans_noise_sigma)
        d_trans_n = max(0.0, d_trans_n)

        d_rot_n = d_rot
        if d_trans > 1e-3:
            d_rot_n += d_trans * yaw_bias + rng.normal(0, noise.yaw_noise_sigma)
        elif abs(d_rot) > 0.01:
            d_rot_n += rng.normal(0, noise.yaw_noise_sigma_turning)

        yaw_e = (yaw_e + d_rot_n + math.pi) % (2 * math.pi) - math.pi
        x_e += d_trans_n * math.cos(yaw_e - d_rot_n / 2.0)
        y_e += d_trans_n * math.sin(yaw_e - d_rot_n / 2.0)
        est[i] = (x_e, y_e, yaw_e)
    return est


def _cast_all(poses: np.ndarray, walls, sens: SensorConfig) -> np.ndarray:
    """Exact 4-ray distances for a whole trajectory in one batched JAX call."""
    import jax.numpy as jnp
    from swarm_tpu.models.sensors import sense_true

    d = sense_true(jnp.asarray(poses), jnp.asarray(walls), sens)
    return np.asarray(d)


class ScenarioResult(NamedTuple):
    """Packet-level session data (reference telemetry semantics, 1-based
    agent ids) plus the ground truth the CSVs deliberately do not contain."""
    t: np.ndarray          # [P]
    agent: np.ndarray      # [P] 1-based
    x: np.ndarray          # [P] DRIFTED estimate
    y: np.ndarray
    yaw_q: np.ndarray      # [P] radians, quantised to 15 deg
    encoder: np.ndarray    # [P]
    v2v: np.ndarray        # [P] cm to nearest other bot (true poses)
    dist4: np.ndarray      # [P, 4] noisy metres
    landmark: np.ndarray   # [P]
    true_pose: np.ndarray  # [P, 3] ground truth at emit time
    est_pose: np.ndarray   # [P, 3] un-quantised estimate


def generate_session(trajectories: List[np.ndarray], walls=None,
                     seed: int = 42, cfg: SwarmConfig = SwarmConfig(),
                     jitter_agents=(2,)) -> ScenarioResult:
    """TRUE trajectories (list of [T_k, 3], one per agent) -> telemetry
    packets with the reference's full noise/channel model."""
    if walls is None:
        walls = BEDROOM_WALLS
    rng = np.random.default_rng(seed)
    noise = cfg.noise
    sens = cfg.sensors
    n_bots = len(trajectories)
    max_len = max(len(p) for p in trajectories)
    padded = [np.concatenate([p, np.repeat(p[-1:], max_len - len(p), 0)])
              if len(p) < max_len else p for p in trajectories]

    # drift chains + exact sensor casts (batched)
    scales = [1.0 - noise.trans_scale_bias if k % 2 == 0
              else 1.0 + noise.trans_scale_bias for k in range(n_bots)]
    biases = [-noise.yaw_bias_per_m if k % 2 == 0 else noise.yaw_bias_per_m
              for k in range(n_bots)]
    ests = [_drift_chain(padded[k], len(trajectories[k]), scales[k],
                         biases[k], rng, noise) for k in range(n_bots)]
    sensed = [_cast_all(padded[k], walls, sens) for k in range(n_bots)]

    rows = {k: [] for k in ["t", "agent", "x", "y", "yaw_q", "encoder",
                            "v2v", "dist4", "landmark", "true", "est"]}
    enc = [0] * n_bots
    prev = [tuple(e[0, :2]) for e in ests]
    t = 0.0
    for i in range(max_len):
        t += rng.uniform(noise.dt_lo, noise.dt_hi)
        for k in range(n_bots):
            if i >= len(trajectories[k]):
                continue
            true_d = sensed[k][i]
            # noise model (:100-108)
            d = true_d + rng.normal(0, sens.noise_sigma, 4)
            spur = rng.random(4) < sens.spurious_prob
            d[spur] = rng.uniform(sens.spurious_lo, sens.spurious_hi,
                                  int(spur.sum()))
            d = np.maximum(sens.floor, d)
            # landmark from the noisy readings (:461 passes s1 readings)
            f, l, r = d[0], d[1], d[3]
            c = cfg.nav.lm_sim_close_m
            if f < c and l < c and r > c:
                lm = 1
            elif f < c and r < c and l > c:
                lm = 2
            elif l < c and r < c and f > c:
                lm = 3
            elif f < c and l < c and r < c:
                lm = 4
            elif f > sens.max_range and l > sens.max_range and r > sens.max_range:
                lm = 5
            else:
                lm = 0

            ex, ey, eyaw = ests[k][i]
            d_est = math.hypot(ex - prev[k][0], ey - prev[k][1])
            enc[k] += max(0, int(d_est / noise.encoder_m_per_tick))
            prev[k] = (ex, ey)
            # v2v: true distance to nearest other bot, cm (:466)
            others = [math.hypot(padded[k][i, 0] - padded[j][i, 0],
                                 padded[k][i, 1] - padded[j][i, 1])
                      for j in range(n_bots) if j != k]
            v2v = int(min(others) * 100) if others else 0
            yaw_q = math.radians(
                round(math.degrees(eyaw) / noise.yaw_quantize_deg)
                * noise.yaw_quantize_deg)

            tp0 = t + (rng.uniform(-noise.time_jitter_s, noise.time_jitter_s)
                       if (k + 1) in jitter_agents else 0.0)
            n_dup = 2 if rng.random() < noise.duplicate_prob else 1
            for dnum in range(n_dup):
                tp = tp0 + (rng.uniform(-0.01, 0.01) if dnum else 0.0)
                rows["t"].append(tp)
                rows["agent"].append(k + 1)
                rows["x"].append(ex)
                rows["y"].append(ey)
                rows["yaw_q"].append(yaw_q)
                rows["encoder"].append(enc[k])
                rows["v2v"].append(v2v)
                rows["dist4"].append(d.copy())
                rows["landmark"].append(lm)
                rows["true"].append(padded[k][i])
                rows["est"].append(ests[k][i])

    return ScenarioResult(
        t=np.asarray(rows["t"], np.float32),
        agent=np.asarray(rows["agent"], np.int32),
        x=np.asarray(rows["x"], np.float32),
        y=np.asarray(rows["y"], np.float32),
        yaw_q=np.asarray(rows["yaw_q"], np.float32),
        encoder=np.asarray(rows["encoder"], np.int32),
        v2v=np.asarray(rows["v2v"], np.int32),
        dist4=np.asarray(rows["dist4"], np.float32),
        landmark=np.asarray(rows["landmark"], np.int32),
        true_pose=np.asarray(rows["true"], np.float32),
        est_pose=np.asarray(rows["est"], np.float32))


def generate_dual_session(seed: int = 42,
                          cfg: SwarmConfig = SwarmConfig(),
                          with_stuck_fault: bool = True) -> ScenarioResult:
    """The reference's flagship scenario (configs[0]): Bot1 sweeps the left
    half from (0,0), Bot2 the right half from (5,0) facing the same room,
    Bot2 gets stuck wiggling in the top-right corner for 40 steps."""
    rng = np.random.default_rng(seed)
    b1 = interpolate_waypoints(
        perimeter_sweep_waypoints(+1, start=(0.0, 0.0)), rng)
    b2 = interpolate_waypoints(
        perimeter_sweep_waypoints(-1, start=(5.0, 0.0)), rng)
    if with_stuck_fault:
        b2 = inject_stuck(b2, rng, near_xy=(5.2, 1.7), heading=math.pi)
    return generate_session([b1, b2], seed=seed + 1, cfg=cfg)

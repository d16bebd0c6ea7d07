"""Navigation FSM: the firmware's 6-state controller as a vmapped step.

Reproduces AgentFirmware_Bot1.ino:393-607 (left-wall follower) and the
AgentFirmware_Bot2 mirror (right-wall follower, return-home via
GO_TO_TARGET(home), Bot2.ino:417-423, 546-578) as ONE branch-free function:
per-agent parameters select the wall side / speeds / return style, and every
state's outcome is computed element-wise then masked by the current state
code — the idiomatic batched replacement for the reference's forked .ino files
and data-dependent `switch`.

A "tick" corresponds to one `navigate()` call. The firmware's blocking
real-time actions map to tick outcomes:
  * drive bursts (motor.drive + smartDelay(300), ino:453-480) -> a commanded
    travel distance and a steering yaw-rate for the tick;
  * `turn(deg, dir)` gyro turns (ino:316-356) -> an instantaneous commanded
    yaw delta, with the 15-degree command physically producing 22 degrees
    (the hardcoded map fix, ino:347-349);
  * `motor.stop()` transitions -> zero motion this tick.

The commanded odometry yaw changes ONLY via turns (the firmware's
robot_yaw convention, ino:704-707); steering bands bend the TRUE pose only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from swarm_tpu.config import NavConfig
from swarm_tpu.utils.angles import wrap_pi

# State codes — ref enum NavState (AgentFirmware_Bot1.ino:97).
FOLLOW = 0
CORNER_ROUND = 1
TURN_TO_WALL = 2
AVOID_FRONT = 3
GO_TO_TARGET = 4
RETURN_HOME_STRAIGHT = 5

NAV_STATE_NAMES = ("FOLLOW", "CORNER_ROUND", "TURN_TO_WALL", "AVOID_FRONT",
                   "GO_TO_TARGET", "RETURN_HOME_STRAIGHT")

# Return-home styles.
RETURN_STYLE_STRAIGHT = 0   # Bot1: two right bites then drive to wall (:426-434)
RETURN_STYLE_GOHOME = 1     # Bot2: GO_TO_TARGET(home) (Bot2.ino:417-423)
RETURN_STYLE_PROXIMITY = 2  # v1: no maneuver; done when back within 0.5 m of
#                             home after 1.6 m traveled, checked BEFORE the
#                             switch so motion stops the same tick
#                             (AgentFirmware.ino.ino:98-99, 253-262)


class NavState(NamedTuple):
    """Batched [...] navigation state."""
    state: jnp.ndarray            # int32 code
    corner_elapsed_s: jnp.ndarray
    returning_home: jnp.ndarray   # bool
    has_target: jnp.ndarray       # bool
    target_x: jnp.ndarray
    target_y: jnp.ndarray
    target_age_s: jnp.ndarray
    mission_complete: jnp.ndarray  # bool


class NavParams(NamedTuple):
    """Per-agent parameters (batched arrays, not forked firmware files)."""
    wall_side: jnp.ndarray     # +1 = left-wall follower (Bot1), -1 = right (Bot2)
    motor_pwm: jnp.ndarray     # MOTOR_SPEED (205 Bot1 :49; 190 Bot2)
    return_style: jnp.ndarray  # RETURN_STYLE_* int32
    home_x: jnp.ndarray
    home_y: jnp.ndarray


class NavCommand(NamedTuple):
    """Motion command for this tick, to be applied to the true pose by the
    world model and to the commanded-odometry pose by the engine."""
    turn_cmd_rad: jnp.ndarray   # commanded yaw delta (applied-deg convention)
    drive_m: jnp.ndarray        # commanded forward travel this tick
    steer_rad: jnp.ndarray      # true-pose yaw bend from differential steering
    moving: jnp.ndarray         # bool — motors driven this tick


def nav_init(n: int, return_style=None) -> NavState:
    z = jnp.zeros((n,), jnp.float32)
    return NavState(
        state=jnp.zeros((n,), jnp.int32), corner_elapsed_s=z,
        returning_home=jnp.zeros((n,), bool), has_target=jnp.zeros((n,), bool),
        target_x=z, target_y=z, target_age_s=z,
        mission_complete=jnp.zeros((n,), bool))


def _applied_turn_deg(deg, cfg: NavConfig):
    """The 15 -> 22 degree hardcoded calibration (ino:347-349)."""
    return jnp.where(deg == cfg.turn_bite_deg, cfg.turn_15_applied_deg, deg)


def nav_step(nav: NavState, params: NavParams, ranges_m, est_pose,
             total_distance, zone_box, has_zone, dt_s,
             cfg: NavConfig = NavConfig()):
    """One navigate() tick for every agent at once.

    ranges_m:  [..., 4] (front, left, back, right) metres.
    est_pose:  [..., 3] commanded-odometry pose (x, y, yaw).
    zone_box:  [..., 4] forbidden AABB (min_x, min_y, max_x, max_y).
    has_zone:  [...] bool — zone active (ZONE lift sentinel handled upstream).
    Returns (new NavState, NavCommand).
    """
    front_cm = ranges_m[..., 0] * 100.0
    left_cm = ranges_m[..., 1] * 100.0
    right_cm = ranges_m[..., 3] * 100.0
    side = params.wall_side.astype(front_cm.dtype)
    # The followed wall: left sensor for Bot1-style, right for Bot2-style.
    wall_cm = jnp.where(side > 0, left_cm, right_cm)

    x, y, yaw = est_pose[..., 0], est_pose[..., 1], est_pose[..., 2]
    st = nav.state

    v_mps = params.motor_pwm.astype(front_cm.dtype) * cfg.pwm_to_mps
    drive_burst_m = v_mps * cfg.drive_tick_s
    bite = jnp.radians(_applied_turn_deg(
        jnp.full_like(front_cm, cfg.turn_bite_deg), cfg))

    # ---- v1 proximity mission check (before the switch, v1 ino:259-262) ---
    dist_home = jnp.sqrt((x - params.home_x) ** 2 + (y - params.home_y) ** 2)
    v1_done = (~nav.mission_complete) & \
        (params.return_style == RETURN_STYLE_PROXIMITY) & \
        (total_distance > cfg.min_travel_distance_m) & \
        (dist_home < cfg.return_threshold_m)

    # ---- return-home injection (before the switch, ino:426-434) -----------
    inj_cond = (~nav.returning_home) & (~nav.mission_complete) & \
        (total_distance > cfg.return_home_min_travel_m) & \
        (jnp.abs(x - params.home_x) < cfg.return_home_x_window_m)
    inj_straight = inj_cond & (params.return_style == RETURN_STYLE_STRAIGHT)
    inj_gohome = inj_cond & (params.return_style == RETURN_STYLE_GOHOME)
    inj = inj_straight | inj_gohome

    # ---- territory override (highest priority, ino:437-445) ---------------
    lx = x + cfg.zone_lookahead_m * jnp.cos(yaw)
    ly = y + cfg.zone_lookahead_m * jnp.sin(yaw)
    m = cfg.zone_margin_m
    in_zone = has_zone & \
        (lx > zone_box[..., 0] - m) & (lx < zone_box[..., 2] + m) & \
        (ly > zone_box[..., 1] - m) & (ly < zone_box[..., 3] + m)
    zone_override = in_zone & (~inj) & (~nav.mission_complete)

    # ---- per-state outcomes (all computed, masked by state) ---------------
    front_blocked = front_cm < cfg.front_block_cm
    wall_lost = wall_cm > cfg.wall_lost_cm
    wall_close = wall_cm < cfg.wall_too_close_cm
    wall_far = wall_cm > cfg.wall_too_far_cm

    zero = jnp.zeros_like(front_cm)

    # FOLLOW (ino:453-480)
    f_next = jnp.where(front_blocked, AVOID_FRONT,
                       jnp.where(wall_lost, CORNER_ROUND, FOLLOW))
    f_drive = jnp.where(front_blocked | wall_lost, zero, drive_burst_m)
    steer_mag = cfg.steer_pwm_delta * 2 * cfg.diff_pwm_to_rad_s * cfg.drive_tick_s
    # too close -> bend away from the wall; too far -> bend toward it.
    f_steer = jnp.where(wall_close, -side * steer_mag,
                        jnp.where(wall_far, side * steer_mag, zero))
    f_steer = jnp.where(front_blocked | wall_lost, zero, f_steer)

    # CORNER_ROUND (ino:483-504)
    c_elapsed_done = nav.corner_elapsed_s >= cfg.corner_burst_s
    c_next = jnp.where(front_blocked, AVOID_FRONT,
                       jnp.where(~wall_lost, FOLLOW,
                                 jnp.where(c_elapsed_done, TURN_TO_WALL,
                                           CORNER_ROUND)))
    c_drive = jnp.where(front_blocked | ~wall_lost | c_elapsed_done,
                        zero, v_mps * cfg.corner_burst_s)

    # TURN_TO_WALL (ino:507-520): 15-degree bites TOWARD the wall.
    t_next = jnp.where(~wall_lost, FOLLOW,
                       jnp.where(front_blocked, AVOID_FRONT, TURN_TO_WALL))
    t_turn = jnp.where(~wall_lost | front_blocked, zero, side * bite)

    # AVOID_FRONT (ino:523-538): bites AWAY from the wall until front clears.
    front_clear = front_cm >= cfg.front_clear_cm
    target_fresh = nav.has_target & (nav.target_age_s < cfg.target_timeout_s)
    a_next = jnp.where(front_clear,
                       jnp.where(target_fresh, GO_TO_TARGET, FOLLOW),
                       AVOID_FRONT)
    a_turn = jnp.where(front_clear, zero, -side * bite)

    # GO_TO_TARGET (ino:556-605)
    tdx = nav.target_x - x
    tdy = nav.target_y - y
    dist_t = jnp.sqrt(tdx ** 2 + tdy ** 2)
    expired = (~nav.has_target) | (nav.target_age_s > cfg.target_timeout_s)
    reached = dist_t < cfg.target_reached_radius_m
    heading_err = wrap_pi(jnp.arctan2(tdy, tdx) - yaw)
    err_deg = jnp.abs(jnp.degrees(heading_err))
    need_turn = err_deg > cfg.turn_bite_deg
    turn_deg = jnp.clip(jnp.floor(err_deg), 5.0, 30.0)
    g_turn_cmd = jnp.sign(heading_err) * jnp.radians(
        _applied_turn_deg(turn_deg, cfg))
    g_next = jnp.where(expired | reached, FOLLOW,
                       jnp.where(front_blocked, AVOID_FRONT, GO_TO_TARGET))
    g_drive = jnp.where(expired | reached | front_blocked | need_turn,
                        zero, drive_burst_m)
    g_turn = jnp.where(expired | reached | front_blocked, zero,
                       jnp.where(need_turn, g_turn_cmd, zero))
    # Bot2-style: reaching home while returning -> mission complete
    # (Bot2.ino:546-578).
    g_done = reached & nav.returning_home & \
        (params.return_style == RETURN_STYLE_GOHOME)
    g_drop_target = expired | reached

    # RETURN_HOME_STRAIGHT (ino:541-553)
    r_done = front_blocked
    r_next = jnp.where(r_done, RETURN_HOME_STRAIGHT, RETURN_HOME_STRAIGHT)
    r_drive = jnp.where(r_done, zero, drive_burst_m)

    # ---- select by state ---------------------------------------------------
    def sel(fv, cv, tv, av, gv, rv):
        return jnp.where(st == FOLLOW, fv,
               jnp.where(st == CORNER_ROUND, cv,
               jnp.where(st == TURN_TO_WALL, tv,
               jnp.where(st == AVOID_FRONT, av,
               jnp.where(st == GO_TO_TARGET, gv, rv)))))

    next_state = sel(f_next, c_next, t_next, a_next, g_next, r_next)
    drive_m = sel(f_drive, c_drive, zero, zero, g_drive, r_drive)
    steer = sel(f_steer, zero, zero, zero, zero, zero)
    turn_cmd = sel(zero, zero, t_turn, a_turn, g_turn, zero)

    mission_done = nav.mission_complete | v1_done | \
        ((st == RETURN_HOME_STRAIGHT) & r_done) | \
        ((st == GO_TO_TARGET) & g_done)

    # corner timer: reset on entry, advance while bursting.
    corner_elapsed = jnp.where(
        (st == CORNER_ROUND) & ~c_elapsed_done & wall_lost & ~front_blocked,
        nav.corner_elapsed_s + cfg.corner_burst_s, nav.corner_elapsed_s)
    corner_elapsed = jnp.where((next_state == CORNER_ROUND) & (st != CORNER_ROUND),
                               0.0, corner_elapsed)

    has_target = nav.has_target & ~((st == GO_TO_TARGET) & g_drop_target)

    # ---- overrides (applied last, highest priority first) ------------------
    # Zone override: stop, turn 30 degrees away from the followed wall, FOLLOW
    # (ino:437-445; 30 is not 15 so no calibration quirk).
    zturn = -side * jnp.radians(jnp.full_like(front_cm, cfg.zone_avoid_turn_deg))
    next_state = jnp.where(zone_override, FOLLOW, next_state)
    turn_cmd = jnp.where(zone_override, zturn, turn_cmd)
    drive_m = jnp.where(zone_override, 0.0, drive_m)
    steer = jnp.where(zone_override, 0.0, steer)

    # Return-home injection overrides even the zone (checked first, ino:426).
    inj_turn = -2.0 * jnp.radians(jnp.full_like(front_cm, cfg.turn_15_applied_deg))
    next_state = jnp.where(inj_straight, RETURN_HOME_STRAIGHT, next_state)
    turn_cmd = jnp.where(inj_straight, inj_turn, turn_cmd)
    drive_m = jnp.where(inj_straight, 0.0, drive_m)
    steer = jnp.where(inj_straight, 0.0, steer)

    next_state = jnp.where(inj_gohome, GO_TO_TARGET, next_state)
    target_x = jnp.where(inj_gohome, params.home_x, nav.target_x)
    target_y = jnp.where(inj_gohome, params.home_y, nav.target_y)
    has_target = has_target | inj_gohome
    target_age = jnp.where(inj_gohome, 0.0, nav.target_age_s + dt_s)

    returning = nav.returning_home | inj

    # Mission-complete freeze (ino:690-693). v1 proximity completion stops
    # the motors on the SAME tick (checkMissionComplete runs first,
    # v1 ino:259-262), unlike the Bot1/Bot2 styles whose detection ticks
    # already command zero motion.
    frozen = nav.mission_complete | v1_done
    next_state = jnp.where(frozen, st, next_state).astype(jnp.int32)
    drive_m = jnp.where(frozen, 0.0, drive_m)
    turn_cmd = jnp.where(frozen, 0.0, turn_cmd)
    steer = jnp.where(frozen, 0.0, steer)

    new_nav = NavState(
        state=next_state, corner_elapsed_s=corner_elapsed,
        returning_home=returning, has_target=has_target,
        target_x=target_x, target_y=target_y, target_age_s=target_age,
        mission_complete=mission_done)
    cmd = NavCommand(turn_cmd_rad=turn_cmd, drive_m=drive_m, steer_rad=steer,
                     moving=(drive_m > 0) | (jnp.abs(turn_cmd) > 0))
    return new_nav, cmd


def assign_target(nav: NavState, target_xy, mask):
    """Server TARG packet arrival: set target + GO_TO_TARGET unless the agent
    is busy avoiding an obstacle (ino:126-139 — present but disabled in the
    reference firmware; enabled here behind the engine's `enable_targets`
    flag, see SURVEY §7 'reference quirks')."""
    take = mask & (nav.state != AVOID_FRONT) & ~nav.mission_complete
    return nav._replace(
        has_target=jnp.where(take, True, nav.has_target),
        target_x=jnp.where(take, target_xy[..., 0], nav.target_x),
        target_y=jnp.where(take, target_xy[..., 1], nav.target_y),
        target_age_s=jnp.where(take, 0.0, nav.target_age_s),
        state=jnp.where(take, GO_TO_TARGET, nav.state))

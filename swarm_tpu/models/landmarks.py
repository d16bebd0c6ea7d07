"""Geometric landmark signatures from 4-way range readings.

Two variants exist in the reference and they deliberately differ:

  * Firmware (`detectLandmark`, AgentFirmware_Bot1.ino:152-169): thresholds
    40 cm / 80 cm, priority DEAD_END > CORNER_L > CORNER_R > CORRIDOR > OPEN.
  * Simulator (`get_landmark_type`, generate_fake_dual_session.py:113-129):
    threshold 0.30 m, corners require the *other* side open, OPEN requires
    all three > max sensor range, priority CORNER_L > CORNER_R > CORRIDOR >
    DEAD_END > OPEN.

Both are pure element-wise selects — fully vmap friendly. The type codes
match the server's table (dual_bot_mapper.py:69-79)."""

from __future__ import annotations

import jax.numpy as jnp

LM_NONE = 0
LM_CORNER_L = 1
LM_CORNER_R = 2
LM_CORRIDOR = 3
LM_DEAD_END = 4
LM_OPEN = 5

LANDMARK_NAMES = {
    LM_NONE: "NONE", LM_CORNER_L: "CORNER_L", LM_CORNER_R: "CORNER_R",
    LM_CORRIDOR: "CORRIDOR", LM_DEAD_END: "DEAD_END", LM_OPEN: "OPEN",
}


def detect_landmark_fw(front_m, left_m, right_m,
                       close_cm: float = 40.0, open_cm: float = 80.0):
    """Firmware-variant classifier (AgentFirmware_Bot1.ino:152-169).

    Inputs in metres (the firmware converts to cm first); back sensor is
    read but unused by the classifier, matching the reference signature.
    Returns int32 landmark codes, broadcast over any batch shape.
    """
    close = close_cm / 100.0
    open_ = open_cm / 100.0
    f_c, l_c, r_c = front_m < close, left_m < close, right_m < close
    f_o, l_o, r_o = front_m > open_, left_m > open_, right_m > open_

    out = jnp.where(f_o & l_o & r_o, LM_OPEN, LM_NONE)
    out = jnp.where(l_c & r_c & f_o, LM_CORRIDOR, out)
    out = jnp.where(f_c & r_c, LM_CORNER_R, out)
    out = jnp.where(f_c & l_c, LM_CORNER_L, out)
    out = jnp.where(f_c & l_c & r_c, LM_DEAD_END, out)
    return out.astype(jnp.int32)


def detect_landmark_sim(front_m, left_m, right_m,
                        close_m: float = 0.30, max_range_m: float = 1.20):
    """Simulator-variant classifier (generate_fake_dual_session.py:113-129)."""
    f, l, r = front_m, left_m, right_m
    c = close_m
    out = jnp.where((f > max_range_m) & (l > max_range_m) & (r > max_range_m),
                    LM_OPEN, LM_NONE)
    out = jnp.where((f < c) & (l < c) & (r < c), LM_DEAD_END, out)
    out = jnp.where((l < c) & (r < c) & (f > c), LM_CORRIDOR, out)
    out = jnp.where((f < c) & (r < c) & (l > c), LM_CORNER_R, out)
    out = jnp.where((f < c) & (l < c) & (r > c), LM_CORNER_L, out)
    return out.astype(jnp.int32)

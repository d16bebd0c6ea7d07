"""v1 firmware EKF-yaw feedback: in the v1 firmware
the EKF yaw DRIVES robot_yaw every loop (AgentFirmware.ino.ino:429-436),
unlike Bot1/Bot2's commanded-yaw odometry (AgentFirmware_Bot1.ino:704-707).
The engine reproduces this per-agent via AgentParams.ekf_yaw."""

import jax
import jax.numpy as jnp
import numpy as np

from swarm_tpu.config import EngineConfig, GridConfig, SwarmConfig
from swarm_tpu.engine.sim import make_agent_params, make_sim_step, sim_init
from swarm_tpu.geom.world import BEDROOM_WALLS
from swarm_tpu.utils.angles import wrap_pi


def _run(flag_agent0: bool, steps=25):
    cfg = SwarmConfig(
        n_agents=2,
        grid=GridConfig(size=256, origin_x=-3.0, origin_y=-4.0),
        engine=EngineConfig(parity_mode=False, compute_frontiers=False,
                            raster_mode="beam"))
    params = make_agent_params(2, separation=2.0, cfg=cfg)
    if flag_agent0:
        params = params._replace(
            ekf_yaw=jnp.asarray([True, False]))
    step = make_sim_step(cfg, BEDROOM_WALLS, params, donate=False)
    st = sim_init(cfg, params)
    yaws, ekf_yaws = [], []
    for _ in range(steps):
        st, _ = step(st)
        yaws.append(np.asarray(st.odom.yaw_est))
        ekf_yaws.append(np.asarray(wrap_pi(st.ekf.x[:, 2])))
    return np.asarray(yaws), np.asarray(ekf_yaws)


def test_v1_yaw_tracks_ekf_and_diverges_from_commanded():
    yaw_v1, ekf_v1 = _run(flag_agent0=True)
    yaw_cm, _ = _run(flag_agent0=False)

    # flagged agent 0: reported yaw IS the EKF yaw every step
    np.testing.assert_allclose(yaw_v1[:, 0], ekf_v1[:, 0], atol=1e-6)
    # and diverges from the commanded-yaw convention's trajectory
    assert np.abs(yaw_v1[:, 0] - yaw_cm[:, 0]).max() > 0.01
    # agent 1 (unflagged) is untouched by the flag
    np.testing.assert_allclose(yaw_v1[:, 1], yaw_cm[:, 1], atol=1e-6)
    # the commanded-yaw agent does NOT track the EKF exactly
    assert np.abs(wrap_pi(yaw_cm[:, 0] - ekf_v1[:, 0])).max() > 1e-4


def test_v2v_count_personality():
    """the firmware's cumulative received-broadcast
    v2v counter (AgentFirmware_Bot1.ino:211-215; 20 Hz SensorNode
    broadcasts) as a per-agent personality next to the sim generator's
    distance-in-cm semantics."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from swarm_tpu.config import SwarmConfig
    from swarm_tpu.engine.sim import (make_agent_params, sim_init,
                                      sim_step)
    from swarm_tpu.geom.world import BEDROOM_WALLS

    cfg = SwarmConfig(n_agents=2)
    params = make_agent_params(2, separation=2.0, cfg=cfg)
    params = params._replace(v2v_count=jnp.asarray([True, False]))
    st = sim_init(cfg, params)
    walls = jnp.asarray(BEDROOM_WALLS)
    v2v = []
    for _ in range(3):
        st, m = sim_step(st, cfg, walls, params)
        v2v.append(np.asarray(m.v2v))
    v2v = np.stack(v2v)
    dt = cfg.nav.drive_tick_s + cfg.nav.settle_tick_s
    per_tick = round(cfg.sensors.v2v_broadcast_hz * dt)   # 8 at 20 Hz/0.4 s
    # agent 0 (count personality): one in-range transmitter -> +8 per tick
    np.testing.assert_array_equal(v2v[:, 0],
                                  per_tick * np.arange(1, 4))
    # agent 1 (distance personality): cm to the other agent (~2 m apart)
    assert 150 <= v2v[0, 1] <= 250
    assert (v2v[:, 1] > 50).all()

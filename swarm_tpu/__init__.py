"""swarm_tpu — a distributed multi-agent SLAM swarm simulation framework in JAX.

A ground-up re-design of the capabilities of
deevinandu/Distributed-Multi-Agent-SLAM-Swarm-Robotics-System as batched
accelerator programs: the per-robot firmware loop (sense -> EKF -> navigate -> transmit), the central
mapping server (occupancy grid, pose-graph loop closure, frontier detection,
territory zones, heartbeat failover), and the simulation toolchain (synthetic
sessions, playback, rendering) all become pure, batched JAX programs. One jitted
step advances thousands of agents; the hot mapping op is an order-free
counts raster; the global grid shards across a device mesh with `shard_map`.

Layer map (mirrors SURVEY.md section 1):
  geom     — world geometry + batched exact ray casting        (L5 world model)
  models   — EKF, nav FSM, sensors, odometry, scan, landmarks  (L0/L1 firmware)
  proto    — QuasarPacket wire formats + session CSV schemas   (L2 protocol)
  ops      — raster ops (parity/log-odds/beam + order-free fast path),
             Bresenham, frontier detection                     (L3 hot paths)
  slam     — loop closure, scan matching, pose-graph GN,
             map merging, session refinement                   (L3 server)
  coord    — heartbeat, territory zones, frontier assignment   (L3 server)
  engine   — the fused jitted swarm step, packet replay,
             checkpointing                                     (the "train step")
  sim      — synthetic scenario generation + fault injection   (L5 tooling)
  render   — JAX rasterizer, PNG/GIF/figure emitters           (L4 rendering)
  parallel — device mesh, shard_map step, collectives          (scale-out)
  server   — live UDP front-end + scan bridge                  (L2/L3 bridge)
  cli      — session runner, playback, protocol ops tools
  native   — C++ oracle library for bit-comparison tests
"""

__version__ = "0.1.0"

from swarm_tpu.config import (  # noqa: F401
    EngineConfig,
    GridConfig,
    NavConfig,
    NoiseConfig,
    SlamConfig,
    SwarmConfig,
)

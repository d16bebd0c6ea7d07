"""Device-mesh construction for the sharded swarm engine.

The reference scales by adding robots to a WiFi network and funnelling
everything into one server socket (MULTI_AGENT_SETUP_GUIDE.md:25-31). The
equivalent here is a 1-D `jax.sharding.Mesh` over an `agents` axis: agent
state shards across devices (pure data parallelism — robots are independent
except through the map), and the shared occupancy grid is merged with a
`psum` of additive log-odds evidence over the interconnect.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

AGENTS_AXIS = "agents"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = AGENTS_AXIS) -> Mesh:
    """A 1-D mesh over the first `n_devices` devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)} "
                f"(set XLA_FLAGS=--xla_force_host_platform_device_count=N "
                f"with JAX_PLATFORMS=cpu for virtual devices)")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))

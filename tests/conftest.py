"""Test harness configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding paths
(`swarm_tpu.parallel`) are exercised without an accelerator. Must run
before the first `import jax` anywhere in the test process.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # 8 virtual devices share a few host cores with the other test
    # workers, so the shards of a shard_map can reach their first
    # collective far apart; XLA's default 40 s rendezvous deadline would
    # abort the process. Give stragglers time to arrive.
    flags = (flags
             + " --xla_cpu_collective_call_terminate_timeout_seconds=900"
             ).strip()
os.environ["XLA_FLAGS"] = flags
os.environ.setdefault("JAX_ENABLE_X64", "0")

# If jax was imported before this file ran, the env var alone is too late —
# force the platform through the live config as well.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)

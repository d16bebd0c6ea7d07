"""Robustness tests for __graft_entry__.dryrun_multichip.

A caller may have initialized a JAX backend before calling
dryrun_multichip — on the wrong platform or with too few devices for the
mesh. The wrapper must recover by re-exec'ing a clean CPU subprocess
whenever the live backend is unusable.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=560)


def test_dryrun_survives_stale_backend():
    """Pre-initialize a 1-device CPU backend (insufficient for the mesh),
    then call dryrun_multichip(4): the in-process attempt must detect the
    stale backend and fall back to the subprocess re-exec."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # Strip any forced host-device count so the parent really has 1 device.
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    env.pop("_SWARM_DRYRUN_CHILD", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "n = len(jax.devices())\n"
        "assert n < 4, f'expected a 1-device parent, got {n}'\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(4)\n"
        "print('FALLBACK_OK')\n")
    r = _run(code, env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FALLBACK_OK" in r.stdout, (r.stdout, r.stderr[-2000:])


def test_dryrun_in_process_when_fresh():
    """A fresh process (backend not yet initialized) must run the dryrun
    in-process on a forced CPU platform — no subprocess needed."""
    env = dict(os.environ)
    env.pop("_SWARM_DRYRUN_CHILD", None)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(4)\n"
        "import jax\n"
        "d = jax.devices()\n"
        "assert d[0].platform == 'cpu' and len(d) >= 4, d\n"
        "print('INPROC_OK')\n")
    r = _run(code, env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "INPROC_OK" in r.stdout, (r.stdout, r.stderr[-2000:])

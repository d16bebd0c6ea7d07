"""The order-free fast raster (ops/fast_raster.py) against the sequential
reference (beam_raster.free_raster_reference), plus the GPU smoke script's
refusal to run without a GPU and the compile-cache helper."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swarm_tpu.config import GridConfig
from swarm_tpu.ops.beam_raster import BeamSpec, free_raster_reference
from swarm_tpu.ops.fast_raster import (apply_counts, count_scale, fan_counts,
                                       free_raster_fast, window_size)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = GridConfig(size=256, origin_x=0.0, origin_y=0.0)
REACH = 26


def _fans(n=12, rays=181, seed=0, spread=(3.0, 9.0)):
    """n agents crowded into a 6 m square so their fans overlap, with
    in-range readings and a random trust mask; two agents offline."""
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    xy = jax.random.uniform(k[0], (n, 2), minval=spread[0],
                            maxval=spread[1])
    yaw = jax.random.uniform(k[1], (n,), minval=-np.pi, maxval=np.pi)
    dist = jax.random.uniform(k[2], (n, rays), minval=0.1, maxval=1.2)
    trusted = jax.random.bernoulli(k[3], 0.8, (n, rays))
    active = jnp.arange(n) % 5 != 2
    return xy, yaw, dist, trusted, active


def test_fast_path_agent_permutation_bit_exact():
    """Integer counts summed in any order: permuting the agents gives the
    same map bits and the same per-agent painted counts."""
    spec = BeamSpec.scan(181)
    xy, yaw, dist, tr, act = _fans(n=24)
    lo = jax.random.uniform(jax.random.PRNGKey(5), (GRID.size, GRID.size),
                            minval=-10.0, maxval=10.0)
    kw = dict(spec=spec, cfg=GRID, n_groups=181, reach=REACH, pack8=True)
    out, painted = free_raster_fast(lo, xy, yaw, dist, act, trusted=tr, **kw)
    perm = np.random.default_rng(3).permutation(24)
    out_p, painted_p = free_raster_fast(lo, xy[perm], yaw[perm], dist[perm],
                                        act[perm], trusted=tr[perm], **kw)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out_p))
    np.testing.assert_array_equal(np.asarray(painted)[perm],
                                  np.asarray(painted_p))
    assert float(painted.sum()) > 0


WINDOWS = {
    "grid": (None, None, (GRID.size, GRID.size)),
    "band": ((jnp.int32(64), 128), None, (128, GRID.size)),
    "tile": ((jnp.int32(-32), 192), (jnp.int32(-32), 192), (192, 192)),
}


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("ring", [False, True], ids=["ring_off", "ring_on"])
@pytest.mark.parametrize("pack8", [False, True], ids=["q256", "pack8"])
def test_fast_matches_reference(window, ring, pack8):
    """181-beam per-beam tier on the full grid, a row band and a grid-edge
    tile window: equal painted counts, and maps equal up to the float
    summation order of overlapping agents (the reference adds agents one
    after another, the fast path adds integer counts)."""
    spec = BeamSpec.scan(181)
    band, band_cols, shape = WINDOWS[window]
    xy, yaw, dist, tr, act = _fans(seed=1)
    kw = dict(spec=spec, cfg=GRID, n_groups=181, reach=REACH,
              band=band, band_cols=band_cols, pack8=pack8,
              trusted=tr if ring else None)
    lo = jnp.zeros(shape, jnp.float32)
    ref, w_ref = free_raster_reference(lo, xy, yaw, dist, act,
                                       tail_weight=0.0, **kw)
    out, painted = free_raster_fast(lo, xy, yaw, dist, act, **kw)
    assert float(w_ref) > 0
    assert float(painted.sum()) == float(w_ref)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("ring", [False, True], ids=["ring_off", "ring_on"])
def test_grouped_tier_fixed_point_matches_reference(ring):
    """Grouped tier (8 groups, weak tail 0.25, trusted fraction k/per) in
    fixed point at scale 4*per: painted counts equal the reference's float
    sums, maps agree to float rounding."""
    spec = BeamSpec.scan(61)
    xy, yaw, dist, tr, act = _fans(rays=61, seed=2)
    assert count_scale(spec, 8) == 4 * 8
    kw = dict(spec=spec, cfg=GRID, n_groups=8, reach=REACH,
              tail_weight=0.25, trusted=tr if ring else None)
    lo = jnp.zeros((GRID.size, GRID.size), jnp.float32)
    ref, w_ref = free_raster_reference(lo, xy, yaw, dist, act, **kw)
    out, painted = free_raster_fast(lo, xy, yaw, dist, act, **kw)
    np.testing.assert_allclose(float(painted.sum()), float(w_ref),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-5)


def test_clamp_once_saturation():
    """The grid is clamped once per fan: a cell near +clamp that gets hit
    evidence from one agent and free evidence from another ends at
    clip(lo + sum), where clamping after each agent would have lost the
    part of the hit above the clamp. The reference clamps once too."""
    spec = BeamSpec.scan(181)
    xy, yaw, dist, tr, act = _fans(n=16, seed=4)
    act = jnp.ones_like(act)
    lo = jnp.full((GRID.size, GRID.size), 9.8, jnp.float32)
    kw = dict(spec=spec, cfg=GRID, n_groups=181, reach=REACH, trusted=tr)
    out, _ = free_raster_fast(lo, xy, yaw, dist, act, **kw)
    n_free, n_hit, _ = fan_counts(lo.shape, xy, yaw, dist, act, **kw)
    expect = np.clip(9.8 + GRID.logodds_miss * np.asarray(n_free, np.float64)
                     + GRID.logodds_hit * np.asarray(n_hit, np.float64),
                     -GRID.logodds_clamp, GRID.logodds_clamp)
    np.testing.assert_allclose(np.asarray(out), expect, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(apply_counts(lo, n_free, n_hit, GRID)))
    ref, _ = free_raster_reference(lo, xy, yaw, dist, act, tail_weight=0.0,
                                   **kw)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)

    # clamping after every agent gives another map wherever hit and free
    # evidence meet on a saturated cell
    seq = lo
    for i in range(xy.shape[0]):
        seq, _ = free_raster_fast(seq, xy[i:i + 1], yaw[i:i + 1],
                                  dist[i:i + 1], act[i:i + 1],
                                  **{**kw, "trusted": tr[i:i + 1]})
    assert (np.abs(np.asarray(seq) - np.asarray(out)) > 1e-3).any()
    assert (np.asarray(out) == GRID.logodds_clamp).any()


def test_small_target_window_and_limits():
    """A target smaller than the window (a 40x48 band of a tiny grid)
    still matches the reference; the window covers the reach disc; the
    grouped tier's tail weight and the 1/4-cell reach limit are
    enforced."""
    assert window_size(REACH) == 2 * REACH + 1
    grid = GridConfig(size=48, origin_x=0.0, origin_y=0.0)
    spec = BeamSpec.scan(181)
    xy = jnp.asarray([[1.2, 1.1], [0.7, 1.5]])
    yaw = jnp.asarray([0.4, -2.0])
    dist = jnp.full((2, 181), 0.9)
    act = jnp.ones((2,), bool)
    kw = dict(spec=spec, cfg=grid, n_groups=181, reach=REACH,
              band=(jnp.int32(4), 40))
    ref, w_ref = free_raster_reference(jnp.zeros((40, 48)), xy, yaw, dist,
                                       act, tail_weight=0.0, **kw)
    out, painted = free_raster_fast(jnp.zeros((40, 48)), xy, yaw, dist,
                                    act, **kw)
    assert float(painted.sum()) == float(w_ref) > 0
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="tail_weight"):
        fan_counts((48, 48), xy, yaw, dist, act, spec, grid, n_groups=8,
                   tail_weight=0.3)
    with pytest.raises(ValueError, match="pack8"):
        fan_counts((48, 48), xy, yaw, dist, act, spec, grid, n_groups=181,
                   reach=40, pack8=True)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result on the CPU, both
    from the checkout and copied alone into an empty directory."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    env = _cpu_env()
    if where == "alone":
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
        cwd = str(tmp_path)
        env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout, r.stdout


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "default"])
def test_compile_cache_dir(env_dir, tmp_path):
    """enable_compilation_cache uses JAX_COMPILATION_CACHE_DIR when it is
    set (and sets no other directory), else <checkout>/.jax_cache; a
    compiled program lands in the directory it names."""
    env = _cpu_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = (
        "import jax, jax.numpy as jnp, os\n"
        "from swarm_tpu.utils.cache import enable_compilation_cache\n"
        "d = enable_compilation_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.25 + 0.125)"
        "(jnp.arange(7.0)).block_until_ready()\n"
        "print(d)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "print(len(os.listdir(d)) if os.path.isdir(d) else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got, cfg_dir, n_files = r.stdout.split()[-3:]
    want = (str(tmp_path / "cache") if env_dir
            else os.path.join(REPO, ".jax_cache"))
    assert got == want and cfg_dir == want
    assert int(n_files) > 0

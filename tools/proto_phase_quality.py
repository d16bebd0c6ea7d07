"""Prototype: does phase-rotated group carving close the quality gap to
the exact per-beam model?

Accumulates maps over a random-walk rollout in the bedroom world with:
  exact  — beam_raster_reference (per-beam free + endpoint)
  static — free_raster_reference (group-min + tail) + endpoint scatter
  rot    — same with phase = step % per, tail off

and reports free-space IoU + wall displacement of each fast tier vs
exact. CPU, fast turnaround.
"""
import argparse
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, "/root/repo")

from swarm_tpu.config import GridConfig, SensorConfig  # noqa: E402
from swarm_tpu.geom.world import BEDROOM_WALLS  # noqa: E402
from swarm_tpu.models.scan import sense_scan  # noqa: E402
from swarm_tpu.ops.beam_raster import (  # noqa: E402
    BeamSpec, beam_raster_reference, beams_from_scan, endpoint_rays,
    free_raster_reference)
from swarm_tpu.ops.raster import logodds_delta, tri_state_view  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=61)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tail", type=float, default=0.25)
    args = ap.parse_args()

    grid = GridConfig(size=256, origin_x=-3.0, origin_y=-4.0)
    sens = SensorConfig()
    walls = jnp.asarray(BEDROOM_WALLS)
    spec = BeamSpec.scan(args.rays)
    per = -(-args.rays // args.groups)

    reach = int(np.ceil(sens.max_range / grid.resolution)) + 2

    key = jax.random.PRNGKey(args.seed)
    # random-walk poses inside the room interior
    k0, key = jax.random.split(key)
    pos = jax.random.uniform(k0, (args.agents, 2), minval=-1.5, maxval=1.0)
    yaw = jnp.zeros((args.agents,))
    active = jnp.ones((args.agents,), bool)

    lo_exact = jnp.zeros((grid.size, grid.size))
    lo_static = jnp.zeros_like(lo_exact)
    lo_rot = jnp.zeros_like(lo_exact)

    @jax.jit
    def step(key, pos, yaw, lo_exact, lo_static, lo_rot, phase):
        k1, k2, k3, key = jax.random.split(key, 4)
        scan = sense_scan(k1, jnp.concatenate([pos, yaw[:, None]], -1),
                          walls, args.rays, sens)
        db, tb = beams_from_scan(scan, sens.max_range, sens.min_range)
        lo_exact, _ = beam_raster_reference(
            lo_exact, pos, yaw, db, tb, spec, grid, reach=reach)
        ep, _ = logodds_delta(endpoint_rays(pos, yaw, db, tb, active, spec),
                              grid, k_max=1)
        lo_static_n, _ = free_raster_reference(
            lo_static, pos, yaw, db, active, spec, grid,
            n_groups=args.groups, reach=reach, tail_weight=args.tail)
        lo_static = jnp.clip(lo_static_n + ep, -grid.logodds_clamp,
                             grid.logodds_clamp)
        lo_rot_n, _ = free_raster_reference(
            lo_rot, pos, yaw, db, active, spec, grid,
            n_groups=args.groups, reach=reach, tail_weight=args.tail,
            phase=phase)
        lo_rot = jnp.clip(lo_rot_n + ep, -grid.logodds_clamp,
                          grid.logodds_clamp)
        # random walk: small forward step along a jittered heading
        yaw = yaw + jax.random.uniform(k2, yaw.shape, minval=-0.4,
                                       maxval=0.4)
        d = jnp.minimum(
            jax.random.uniform(k3, yaw.shape, minval=0.0, maxval=0.12),
            jnp.maximum(scan[:, args.rays // 2] - 0.3, 0.0))
        pos = pos + d[:, None] * jnp.stack([jnp.cos(yaw), jnp.sin(yaw)], -1)
        pos = jnp.clip(pos, -2.3, 1.8)
        return key, pos, yaw, lo_exact, lo_static, lo_rot

    t0 = time.time()
    for s in range(args.steps):
        key, pos, yaw, lo_exact, lo_static, lo_rot = step(
            key, pos, yaw, lo_exact, lo_static, lo_rot,
            jnp.int32(s % per))
    tri_e = np.asarray(tri_state_view(lo_exact, grid))
    for name, lo in (("static", lo_static), ("rot", lo_rot)):
        tri_f = np.asarray(tri_state_view(lo, grid))
        fe = tri_e == grid.free
        ff = tri_f == grid.free
        iou = (fe & ff).sum() / max((fe | ff).sum(), 1)
        occ_e = np.argwhere(tri_e == grid.occupied)
        occ_f = np.argwhere(tri_f == grid.occupied)
        if len(occ_f) and len(occ_e):
            dd = np.abs(occ_f[:, None, :] - occ_e[None, :, :]
                        ).max(-1).min(-1)
            p90 = np.quantile(dd, 0.9)
        else:
            p90 = np.nan
        miss_f = (fe & ~ff).sum()        # exact free, fast not
        extra_f = (ff & ~fe).sum()       # fast free, exact not
        # what the missing cells are in the fast map
        miss_unknown = (fe & (tri_f == grid.unknown)).sum()
        miss_occ = (fe & (tri_f == grid.occupied)).sum()
        print(f"{name}: IoU {iou:.3f} wall-p90 {p90:.1f} "
              f"occ_e {len(occ_e)} occ_f {len(occ_f)} "
              f"| exact-only {miss_f} (unk {miss_unknown} occ {miss_occ}) "
              f"fast-only {extra_f} of {fe.sum()} exact-free")
    print(f"({time.time() - t0:.0f}s, rays={args.rays} groups={args.groups} "
          f"per={per} steps={args.steps})")


if __name__ == "__main__":
    main()

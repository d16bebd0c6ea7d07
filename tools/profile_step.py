"""Per-component step profiler: ranks where the fused sim_step's time goes
at swarm scale.

Each component is chained K times inside ONE lax.scan per jit (carry-
threaded so nothing is hoisted or skipped), fetched once, and the
empty-scan baseline is subtracted — per-call dispatch and host sync are
amortized away, leaving the device time of the component.

Usage: python tools/profile_step.py [--agents 1024] [--inner 128]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from swarm_tpu.utils.cache import enable_compilation_cache
enable_compilation_cache()
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--inner", type=int, default=128,
                    help="scan length per timed call")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from __graft_entry__ import _cfg_and_world
    from swarm_tpu.engine.sim import sim_init
    from swarm_tpu.models.scan import scan_angles, sense_scan
    from swarm_tpu.models.sensors import sense_4way
    from swarm_tpu.models.ekf import (ekf_predict, ekf_step_batch,
                                      ekf_update)
    from swarm_tpu.models.odometry import drift_integrate
    from swarm_tpu.models import nav as navm
    from swarm_tpu.slam.closure import closure_add_poses_batch
    from swarm_tpu.coord.zones import zone_observe_batch, zone_observe_rows
    from swarm_tpu.geom.world import cast_rays

    n = args.agents
    K = args.inner
    cfg, walls, params, rooms = _cfg_and_world(
        n, frontiers=False, parity=False, raster_mode="beam",
        fast_raster=True, scan_rays=181, tiled=True)
    import dataclasses
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, raster_4way=False, kernel_endpoints=True,
        beam_pack8=True))                 # the bench defaults
    state = sim_init(cfg, params)
    walls_grouped, room_of_agent = rooms
    walls_agent = walls_grouped[room_of_agent]
    key = jax.random.PRNGKey(0)
    ks = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(n, dtype=jnp.uint32))
    pose = state.pose_true
    alive = jnp.ones((n,), bool)
    agents_ix = jnp.arange(n, dtype=jnp.int32)
    print(f"platform={jax.devices()[0].platform} agents={n} "
          f"grid={cfg.grid.size} inner={K}")

    def timed(name, body, carry0):
        """body(carry, i) -> carry; scan K times, fetch one scalar."""
        def scanned(c0):
            def f(c, i):
                return body(c, i), ()
            c, _ = jax.lax.scan(f, c0, jnp.arange(K, dtype=jnp.uint32))
            # consume EVERY carry leaf so no per-iteration work is DCE'd
            return sum(jnp.sum(l.astype(jnp.float32))
                       for l in jax.tree_util.tree_leaves(c))
        fn = jax.jit(scanned)
        fn(carry0).item()                      # compile + warm
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn(carry0).item()                  # ONE fetch = real sync
            best = min(best, time.perf_counter() - t0)
        per = (best - timed.base) / K * 1e3 if name != "baseline" else 0.0
        if name == "baseline":
            timed.base = best
            print(f"{'baseline (scan overhead)':34s} {best * 1e3:8.3f} ms total")
        else:
            print(f"{name:34s} {per:8.3f} ms")
        return per
    timed.base = 0.0

    # RTT/scan baseline: trivially small body.
    timed("baseline", lambda c, i: c + 1.0, jnp.zeros(()))

    def perturb(c):                     # cheap carry -> fresh pose tensor
        return pose + c * 1e-6

    timed("rng fold_in x3 (per step)",
          lambda c, i: c + jax.vmap(lambda kk: jax.random.fold_in(kk, 0))(
              jax.vmap(lambda ii: jax.random.fold_in(
                  jax.random.fold_in(key, i), ii))(
                  jnp.arange(n, dtype=jnp.uint32)))[0, 0].astype(jnp.float32),
          jnp.zeros(()))

    timed("sense_4way", lambda c, i: c + jnp.sum(jax.vmap(
        lambda kk, pp, ww: sense_4way(kk, pp, ww, cfg.sensors))(
        ks, perturb(c), walls_agent)) * 1e-9, jnp.zeros(()))

    timed("sense_scan 181", lambda c, i: c + jnp.sum(jax.vmap(
        lambda kk, pp, ww: sense_scan(kk, pp, ww, 181, cfg.sensors))(
        ks, perturb(c), walls_agent)) * 1e-9, jnp.zeros(()))

    def proj_body(c, i):
        p = perturb(c)
        sd = jnp.broadcast_to(p[:, 0:1] * 0 + 1.0, (n, 181))
        sa = p[:, 2:3] + scan_angles(181, p.dtype)[None, :]
        hx = p[:, 0:1] + sd * jnp.cos(sa)
        hy = p[:, 1:2] + sd * jnp.sin(sa)
        return c + (jnp.sum(hx) + jnp.sum(hy)) * 1e-9
    timed("scan projection trig", proj_body, jnp.zeros(()))

    lm = jnp.zeros((n,), jnp.int32).at[::7].set(2)
    def closure_body(cl, i):
        p = pose[:, 0] + cl.drift_dx[0] * 1e-9
        cl2, _, _, _ = closure_add_poses_batch(
            cl, p, pose[:, 1], agents_ix, lm, cfg.slam, valid=alive)
        return cl2
    timed("closure batch (L=%d)" % cfg.slam.landmark_capacity,
          closure_body, state.srv.closure)

    navp = navm.NavParams(wall_side=params.wall_side,
                          motor_pwm=params.motor_pwm,
                          return_style=params.return_style,
                          home_x=params.home_x, home_y=params.home_y)
    zb = jnp.zeros((n, 4))
    hz = jnp.zeros((n,), bool)
    dist4 = jnp.full((n, 4), 1.0)
    def nav_body(nv, i):
        d = dist4 + nv.target_age_s[:, None] * 1e-9
        nv2, _ = navm.nav_step(nv, navp, d, pose, jnp.zeros((n,)),
                               zb, hz, 0.4, cfg.nav)
        return nv2
    timed("nav_step", nav_body, state.nav)

    def ekf_body(e, i):
        w = e.x[:, 3] * 1e-9
        return jax.vmap(lambda s, ww: ekf_update(
            ekf_predict(s, ww, 1.0, cfg.ekf), 0.1, ww, cfg.ekf))(e, w)
    timed("ekf vmapped (retired)", ekf_body, state.ekf)

    def ekf_batch_body(e, i):
        w = e.x[:, 3] * 1e-9
        return ekf_step_batch(e, w, jnp.full((n,), 0.1),
                              e.last_t + 1.0, cfg.ekf)
    timed("ekf SoA batch (engine)", ekf_batch_body, state.ekf)

    def drift_body(o, i):
        d = jnp.full((n,), 0.07) + o.x_est * 1e-12
        return jax.vmap(lambda kk, oo, dd, ts, yb: drift_integrate(
            kk, oo, dd, jnp.zeros(()), ts, yb, cfg.noise))(
            ks, o, d, params.trans_scale, params.yaw_bias_per_m)
    timed("drift+encoder", drift_body, state.odom)

    def v2v_body(c, i):
        txy = perturb(c)[:, :2]
        d2 = jnp.sum((txy[:, None, :] - txy[None, :, :]) ** 2, -1)
        d2 = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, d2)
        return c + jnp.sum(jnp.sqrt(jnp.min(d2, 1))) * 1e-9
    timed("v2v O(N^2)", v2v_body, jnp.zeros(()))

    def zone_body(z, i):
        x = pose[:, 0] + z.min_x[0] * 1e-9
        return zone_observe_batch(
            z, jnp.concatenate([agents_ix, jnp.repeat(agents_ix, 4)]),
            jnp.concatenate([x, jnp.repeat(x, 4)]),
            jnp.concatenate([pose[:, 1], jnp.repeat(pose[:, 1], 4)]),
            jnp.ones((5 * n,), bool))
    timed("zone fold scatter (retired)", zone_body, state.srv.zone)

    def zone_rows_body(z, i):
        x = pose[:, 0] + z.min_x[0] * 1e-9
        xs = jnp.concatenate([x[:, None]] * 5, axis=1)
        ys = jnp.concatenate([pose[:, 1:2]] * 5, axis=1)
        return zone_observe_rows(z, xs, ys, jnp.ones((n, 5), bool))
    timed("zone fold rows (engine)", zone_rows_body, state.srv.zone)

    timed("collision cast", lambda c, i: c + jnp.sum(jax.vmap(
        lambda pp, ww: cast_rays(pp[:2], pp[2], ww))(
        perturb(c), walls_agent)) * 1e-9, jnp.zeros(()))

    from swarm_tpu.ops.beam_raster import (BeamSpec, beams_from_scan,
                                           reach_cells)
    from swarm_tpu.ops.fast_raster import free_raster_fast
    spec = BeamSpec.scan(181)
    sd0 = jnp.full((n, 181), 1.0)
    db, tb = beams_from_scan(sd0, cfg.sensors.max_range, cfg.sensors.min_range)
    reach = reach_cells(cfg)

    def raster_body(lo, i):
        return free_raster_fast(
            lo * 0.999, pose[:, :2], pose[:, 2], db, alive, spec, cfg.grid,
            n_groups=8, trusted=tb, reach=reach,
            tail_weight=cfg.engine.beam_tail_weight)[0]
    timed("fast raster groups=8", raster_body, state.srv.logodds)

    def raster_pb_body(lo, i):
        return free_raster_fast(
            lo * 0.999, pose[:, :2], pose[:, 2], db, alive, spec, cfg.grid,
            n_groups=spec.n_beams, trusted=tb, reach=reach, pack8=True)[0]
    timed("fast raster per-beam", raster_pb_body, state.srv.logodds)

    from swarm_tpu.ops.beam_raster import endpoint_rays
    from swarm_tpu.ops.raster import logodds_delta

    def ep_body(c, i):
        d, w = logodds_delta(
            endpoint_rays(pose[:, :2] + c * 1e-9, pose[:, 2], db, tb,
                          alive, spec), cfg.grid, k_max=1)
        return c + jnp.sum(d) * 1e-12 + w.astype(jnp.float32) * 1e-9
    timed("endpoint scatter 181/agent", ep_body, jnp.zeros(()))

    # whole fused step for the total
    from swarm_tpu.engine.sim import sim_step

    def step_body(s, i):
        new, _ = sim_step(s, cfg, walls_grouped=walls_grouped,
                          room_of_agent=room_of_agent,
                          walls=jnp.asarray(walls), params=params)
        return new
    timed("FULL sim_step", step_body, state)


if __name__ == "__main__":
    main()

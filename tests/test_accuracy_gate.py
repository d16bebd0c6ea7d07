"""CI accuracy gate: the deployable correction
mechanism (anchored scan-merge, SlamConfig.merge_anchor) must cut
late-trajectory ATE versus raw drifted odometry on a short closed-loop
run — the recorded factor is printed so the number stays
reproducible."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _run(cfg, walls, params, rooms, steps=400, chunk=100):
    from swarm_tpu.engine.sim import sim_init, sim_step

    walls_j = jnp.asarray(walls)
    wg, roa = rooms

    def body(s, _):
        s2, m = sim_step(s, cfg, walls_j, params,
                         walls_grouped=wg, room_of_agent=roa)
        return s2, (m.pose_err, m.merges)

    chunk_fn = jax.jit(lambda s: jax.lax.scan(body, s, None, length=chunk))
    st = sim_init(cfg, params)
    errs, merges = [], 0
    for _ in range(steps // chunk):
        st, (e, mg) = chunk_fn(st)
        errs.append(np.asarray(e))
        merges += int(np.asarray(mg).sum())
    return np.concatenate(errs), merges


def test_anchored_merge_cuts_late_ate():
    from __graft_entry__ import _cfg_and_world

    base, walls, params, rooms = _cfg_and_world(
        4, frontiers=False, parity=False, raster_mode="beam",
        fast_raster=False, scan_rays=61, tiled=True)
    raw_cfg = base.replace(
        slam=dataclasses.replace(base.slam, closure_radius_m=0.0),
        engine=dataclasses.replace(base.engine, merge_every=0))
    mrg_cfg = base.replace(
        slam=dataclasses.replace(base.slam, closure_radius_m=0.0),
        engine=dataclasses.replace(base.engine, merge_every=16))
    err_raw, _ = _run(raw_cfg, walls, params, rooms)
    err_mrg, merges = _run(mrg_cfg, walls, params, rooms)
    k = max(1, len(err_raw) // 10)
    late_raw = float(err_raw[-k:].mean())
    late_mrg = float(err_mrg[-k:].mean())
    factor = late_mrg / max(late_raw, 1e-9)
    print(f"[ACC GATE] late ATE raw={late_raw:.3f} m "
          f"anchored-merge={late_mrg:.3f} m factor={factor:.2f} "
          f"({merges} merges)")
    assert merges > 0
    # anchored merge must not be worse than raw, and should cut late ATE
    assert factor < 0.95, (late_raw, late_mrg)

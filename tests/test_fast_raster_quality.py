"""Map-quality guards for the fast raster tiers.

Two tiers, two bars:

  * PER-BEAM EXACT (beam_groups=0, the default): the fast path's
    per-beam carve implements the exact inverse sensor model — its map
    must match the XLA exact tier (`beam_raster_reference`) at
    free-space IoU >= 0.9 and wall placement p90 <= 1 cell, on
    engine-level closed-loop runs AND raster-level 300-step rollouts
    across worlds/seeds (measured ~0.97-0.99).
  * GROUP-MIN TURBO (beam_groups > 0): the group-min carve + weak tail
    under-fills sector interiors by design; its structural bar is the
    honest measured plateau (IoU > 0.7, walls within 2 cells). Phase-
    rotated grouping was prototyped (tools/proto_phase_quality.py) and
    REJECTED: sensor noise biases window minima ~1.3 sigma low, so the
    max-over-phases carve never converges to the exact model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _cfg_and_world
from swarm_tpu.config import GridConfig, SensorConfig
from swarm_tpu.engine.sim import sim_init, sim_rollout
from swarm_tpu.geom.world import BEDROOM_WALLS, make_rect_room
from swarm_tpu.models.scan import sense_scan
from swarm_tpu.ops.beam_raster import (BeamSpec, beam_raster_reference,
                                       beams_from_scan, endpoint_rays,
                                       free_raster_reference)
from swarm_tpu.ops.raster import logodds_delta, tri_state_view


def _run(patch, steps=60, fast_raster=True):
    cfg, walls, params, rooms = _cfg_and_world(
        4, frontiers=False, parity=False, raster_mode="beam",
        fast_raster=fast_raster, scan_rays=61, tiled=True)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, **patch))
    st = sim_init(cfg, params)
    final, _ = sim_rollout(st, steps, cfg, jnp.asarray(walls), params,
                           walls_grouped=rooms[0], room_of_agent=rooms[1])
    return np.asarray(tri_state_view(final.srv.logodds, cfg.grid)), cfg


def _compare(exact, fast, cfg):
    free_e = exact == cfg.grid.free
    free_f = fast == cfg.grid.free
    iou = (free_e & free_f).sum() / max((free_e | free_f).sum(), 1)
    occ_e = np.argwhere(exact == cfg.grid.occupied)
    occ_f = np.argwhere(fast == cfg.grid.occupied)
    assert len(occ_f) > 10 and len(occ_e) > 10
    d = np.abs(occ_f[:, None, :] - occ_e[None, :, :]).max(-1).min(-1)
    return iou, np.quantile(d, 0.9)


def test_per_beam_kernel_matches_exact_engine():
    """Engine-level: per-beam fast path vs the exact tier, same
    closed-loop run — with the exact endpoint scatter AND with endpoint-
    ring painting (the bench default: per-beam trust is exact, hits
    land on the |r - r_b| <= 0.71 ring)."""
    exact, cfg = _run({"raster_4way": False}, fast_raster=False)
    fast, _ = _run({"raster_4way": False, "beam_groups": 0})
    iou, p90 = _compare(exact, fast, cfg)
    assert iou >= 0.9, iou
    assert p90 <= 1.0, p90

    fast_ke, _ = _run({"raster_4way": False, "beam_groups": 0,
                       "kernel_endpoints": True})
    iou, p90 = _compare(exact, fast_ke, cfg)
    assert iou >= 0.9, ("kernel_endpoints", iou)
    assert p90 <= 1.0, ("kernel_endpoints", p90)


def test_group_turbo_structurally_matches_exact():
    """Grouped tier (groups=8, ring endpoints): honest structural bar."""
    exact, cfg = _run({"raster_4way": False}, fast_raster=False)
    fast, _ = _run({"raster_4way": False, "kernel_endpoints": True,
                    "beam_groups": 8})
    iou, p90 = _compare(exact, fast, cfg)
    assert iou > 0.7, iou
    assert p90 <= 2.0, p90


def _raster_rollout(walls, grid, seed, steps, rays=61, agents=4,
                    n_groups=0):
    """Raster-level rollout: random-walk agents, identical noisy scans
    accumulated by the exact tier and the fast tier's reference
    (fast path == reference bit-for-bit, tests/test_beam_raster.py)."""
    sens = SensorConfig()
    spec = BeamSpec.scan(rays)
    reach = int(np.ceil(sens.max_range / grid.resolution)) + 2
    ng = spec.n_beams if n_groups <= 0 else n_groups
    key = jax.random.PRNGKey(seed)
    k0, key = jax.random.split(key)
    pos = jax.random.uniform(k0, (agents, 2), minval=-1.2, maxval=0.8)
    yaw = jnp.zeros((agents,))
    active = jnp.ones((agents,), bool)
    lo_e = jnp.zeros((grid.size, grid.size))
    lo_f = jnp.zeros_like(lo_e)

    @jax.jit
    def step(key, pos, yaw, lo_e, lo_f):
        k1, k2, k3, key = jax.random.split(key, 4)
        scan = sense_scan(k1, jnp.concatenate([pos, yaw[:, None]], -1),
                          walls, rays, sens)
        db, tb = beams_from_scan(scan, sens.max_range, sens.min_range)
        lo_e, _ = beam_raster_reference(lo_e, pos, yaw, db, tb, spec,
                                        grid, reach=reach)
        ep, _ = logodds_delta(
            endpoint_rays(pos, yaw, db, tb, active, spec), grid, k_max=1)
        lo_fn, _ = free_raster_reference(lo_f, pos, yaw, db, active, spec,
                                         grid, n_groups=ng, reach=reach,
                                         tail_weight=0.0)
        lo_f = jnp.clip(lo_fn + ep, -grid.logodds_clamp,
                        grid.logodds_clamp)
        yaw = yaw + jax.random.uniform(k2, yaw.shape, minval=-0.4,
                                       maxval=0.4)
        d = jnp.minimum(
            jax.random.uniform(k3, yaw.shape, minval=0.0, maxval=0.12),
            jnp.maximum(scan[:, rays // 2] - 0.3, 0.0))
        pos = pos + d[:, None] * jnp.stack([jnp.cos(yaw),
                                            jnp.sin(yaw)], -1)
        pos = jnp.clip(pos, -2.2, 1.7)
        return key, pos, yaw, lo_e, lo_f

    for _ in range(steps):
        key, pos, yaw, lo_e, lo_f = step(key, pos, yaw, lo_e, lo_f)
    te = np.asarray(tri_state_view(lo_e, grid))
    tf = np.asarray(tri_state_view(lo_f, grid))
    return te, tf


def test_per_beam_raster_quality_300_steps_multiworld():
    """Raster-level, 300 steps, two worlds x two seeds: per-beam fast
    tier vs exact — IoU >= 0.9, walls within 1 cell."""
    grid = GridConfig(size=256, origin_x=-3.0, origin_y=-4.0)
    worlds = [
        (jnp.asarray(BEDROOM_WALLS), 42),
        (jnp.asarray(make_rect_room(-2.5, -3.5, 2.0, 1.5)), 7),
    ]
    for walls, seed in worlds:
        te, tf = _raster_rollout(walls, grid, seed, steps=300)
        fe, ff = te == grid.free, tf == grid.free
        iou = (fe & ff).sum() / max((fe | ff).sum(), 1)
        assert iou >= 0.9, (seed, iou)
        occ_e = np.argwhere(te == grid.occupied)
        occ_f = np.argwhere(tf == grid.occupied)
        assert len(occ_e) > 10 and len(occ_f) > 10
        d = np.abs(occ_f[:, None, :] - occ_e[None, :, :]).max(-1).min(-1)
        assert np.quantile(d, 0.9) <= 1.0, (seed, np.quantile(d, 0.9))

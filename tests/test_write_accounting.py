"""Write-metric reconciliation.

The fast raster reports the applied counter (sum of per-cell crossing
counts actually painted — free/tail/ring cells, the same quantity
free_raster_reference counts), not an analytic floor(db/res)-1 claim. These tests reconcile that counter against the
evidence observable in the map (sum |delta| in unit updates on a fresh,
unclamped map): the counter must track |delta| tightly on BOTH tiers, so
the headline throughput number's semantics stay pinned down.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _cfg_and_world
from swarm_tpu.engine.sim import make_sim_step, sim_init


def _measure_ratio(fast_raster: bool, steps_warm=2, steps_meas=4,
                   agents=8):
    cfg, walls, params, rooms = _cfg_and_world(
        agents, frontiers=False, parity=False, raster_mode="beam",
        fast_raster=fast_raster, scan_rays=61, tiled=fast_raster)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, kernel_endpoints=False, raster_4way=False,
        beam_groups=8))
    walls = jnp.asarray(walls)
    step = make_sim_step(cfg, walls, params, donate=False,
                         walls_grouped=rooms[0], room_of_agent=rooms[1])
    state = sim_init(cfg, params)
    hit = cfg.grid.logodds_hit
    miss = abs(cfg.grid.logodds_miss)
    ratios = []
    for k in range(steps_warm + steps_meas):
        lo0 = state.srv.logodds
        state, m = step(state)
        if k < steps_warm:
            continue
        d = np.asarray(state.srv.logodds) - np.asarray(lo0)
        applied = (np.sum(np.maximum(-d, 0.0)) / miss +
                   np.sum(np.maximum(d, 0.0)) / hit)
        ratios.append(applied / max(int(m.writes), 1))
    return np.asarray(ratios)


def test_kernel_tier_counter_is_applied():
    """Fast tier: the painted counter must track the
    map-observable applied evidence. The only slack is physical: cells a
    slow-moving agent repaints every step saturate at the log-odds clamp
    within a few observations, after which their |delta| is 0 while the
    raster still performs (and counts) the fused update — the same way
    the reference's Bresenham re-writes already-FREE cells
    (dual_bot_mapper.py:136-156). Measured on steps 2-5 the ratio decays
    ~0.97 -> ~0.85 as the start-area cells converge."""
    r = _measure_ratio(fast_raster=True)
    assert (r > 0.75).all(), r
    assert (r < 1.02).all(), r


def test_reference_tier_counts_painted_cells():
    """The exact beam tier counts actually-painted cells, so applied must
    track the claim within same-cell cancellation slack."""
    r = _measure_ratio(fast_raster=False)
    assert (r > 0.9).all(), r
    assert (r < 1.02).all(), r


def test_kernel_tier_counter_floor_at_swarm_density():
    """The headline bench's delta_ratio_fresh at 1024 agents
    sits below the 8-agent test floor — explained as
    start-area clamp saturation when many agents' fans overlap. Pin that
    explanation at a swarm-denser config: 64 agents on the same tiled
    world (8x the 8-agent test's overlap density). The ratio may sit
    lower than the sparse config's but must hold the 0.6 bench floor,
    and the FIRST (freshest) window must stay the highest — saturation
    decays the ratio with map age; counter inflation would not."""
    r = _measure_ratio(fast_raster=True, steps_meas=3, agents=64)
    assert (r > 0.6).all(), r
    assert (r < 1.02).all(), r
    assert r[0] >= r[-1] - 0.02, r   # decay (noise slack), not inflation

"""Long-horizon sharded soak: does the spatial
sharding's static drift budget (drift_margin_m = 1.0,
parallel.sharded.agent_evidence_box) actually hold over thousands of
steps with closures + merge actively correcting drift?

Opt-in (SWARM_SOAK=1, optionally SWARM_SOAK_STEPS=5000): ~10-20 min on
the virtual-CPU mesh. The short default (SWARM_SOAK unset) runs a
300-step version of the same assertions so the wiring stays covered in
CI.

Asserts, for the rows and tiles decompositions with closures + merge ON:
  * band_escapes == 0 on EVERY step (the runtime guard never fires, so
    the static containment proof held end to end);
  * the end-state map equals the replicated-psum decomposition's
    bit-for-bit (same per-device evidence grouping);
  * the max observed drift-corrected estimate error stays under the
    1.0 m budget (recorded, so the margin is a measured bound).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swarm_tpu.config import EngineConfig, GridConfig, SwarmConfig
from swarm_tpu.engine.sim import make_agent_params, sim_init
from swarm_tpu.geom.world import walls_by_group
from swarm_tpu.parallel import make_mesh, make_sharded_sim_step, shard_state

SOAK = os.environ.get("SWARM_SOAK", "") == "1"
STEPS = int(os.environ.get("SWARM_SOAK_STEPS", "5000")) if SOAK else 300


def _worlds(kind: str, n_dev: int, scan_rays: int = 37,
            turn_gate: float = 0.0):
    """(cfg, walls, params, wg, roa, mesh, shard_kw) for a decomposition
    family. rows/replicated share the vertical-rooms world; tiles uses
    the device-major tiled-blocks world (__graft_entry__ dryrun setup).

    scan_rays/turn_gate: the soak preset (37-ray fans, turn gate OFF —
    see the SlamConfig note below) vs the DEPLOYABLE preset (181-ray
    fans, the config.py default gate) for the density leg."""
    if kind == "tiles":
        from jax.sharding import Mesh

        from swarm_tpu.geom.world import make_tiled_rooms_blocks

        R, C = n_dev // 2, 2
        size = -(-max(C * 256, R * 128) // 256) * 256
        walls, origins = make_tiled_rooms_blocks(R, C, size)
        n_rooms = origins.shape[0]
        n_agents = 2 * n_rooms
        i = np.arange(n_agents)
        room = i // 2
        from swarm_tpu.config import SlamConfig
        cfg = SwarmConfig(
            n_agents=n_agents,
            grid=GridConfig(size=size, origin_x=0.0, origin_y=0.0),
            engine=EngineConfig(parity_mode=False, compute_frontiers=False,
                                raster_mode="beam", scan_rays=scan_rays,
                                raster_4way=False, fast_raster=False,
                                kernel_endpoints=False, endpoint_hits=True,
                                merge_every=16),
            # the deployable correction preset (see __graft_entry__):
            # anchored merge keeps drift bounded; the unanchored live-map
            # feedback loop diverges past the band budget within ~300
            # steps (bench_accuracy finding). merge_frame_gain: the r4
            # online frame tracker — without it the 5k soak loses ~2
            # agents past the band budget (escapes 319, max drift
            # 1.61 m); with it the budget HOLDS (escapes 0, 0.72 m).
            # turn_gate=0 for the sparse 37-ray fan: the accumulated
            # innovations absorb the turn-projection noise, and gating
            # starved fast movers of their own corrections (measured
            # sweep).
            slam=SlamConfig(closure_same_agent_only=True,
                            closure_correction=0.0, merge_anchor=True,
                            merge_frame_gain=0.35,
                            merge_frame_turn_gate=turn_gate))
        params = make_agent_params(n_agents, separation=2.0, cfg=cfg)
        params = params._replace(
            home_x=jnp.asarray(origins[room, 0] + np.where(i % 2, 5.5, 0.5),
                               jnp.float32),
            home_y=jnp.asarray(origins[room, 1] + np.where(i % 2, 3.5, 0.5),
                               jnp.float32),
            x_offset=jnp.zeros((n_agents,), jnp.float32))
        mesh = Mesh(np.asarray(jax.devices()[:n_dev]).reshape(R, C),
                    ("gr", "gc"))
        return (cfg, walls, params, walls_by_group(walls),
                jnp.asarray(room, jnp.int32), mesh,
                dict(grid_tiles_sharded=True))
    from tests.test_sharded_spatial import _vertical_world

    from swarm_tpu.config import SlamConfig

    cfg, walls, params, wg, roa = _vertical_world(n_dev)
    cfg = cfg.replace(
        engine=dataclasses.replace(cfg.engine, merge_every=16),
        slam=SlamConfig(closure_same_agent_only=True,
                        closure_correction=0.0, merge_anchor=True,
                        merge_frame_gain=0.35,
                        merge_frame_turn_gate=0.0))
    mesh = make_mesh(n_dev)
    kw = dict(grid_rows_sharded=True) if kind == "rows" else {}
    return cfg, walls, params, wg, roa, mesh, kw


def _soak(kind: str, grid_sharding: str, n_dev: int, steps: int,
          scan_rays: int = 37, turn_gate: float = 0.0):
    cfg, walls, params, wg, roa, mesh, shard_kw = _worlds(
        kind, n_dev, scan_rays=scan_rays, turn_gate=turn_gate)
    step = make_sharded_sim_step(cfg, walls, params, mesh, donate=False,
                                 grid_sharding=grid_sharding,
                                 walls_grouped=wg, room_of_agent=roa)
    st = shard_state(sim_init(cfg, params), mesh, **shard_kw)
    escapes = 0
    max_err = 0.0
    merges = 0
    for _ in range(steps):
        st, m = step(st)
        escapes += int(m.band_escapes)
        merges += int(m.merges)
        e = float(m.pose_err)
        if e > max_err:
            max_err = e
    return st, escapes, max_err, merges


@pytest.mark.parametrize("kind,sharding", [("rows", "rows"),
                                           ("tiles", "tiles")])
def test_sharded_soak_band_containment(kind, sharding):
    n_dev = 4
    if len(jax.devices()) < n_dev:
        pytest.skip("needs 4 devices")
    st, escapes, max_err, merges = _soak(kind, sharding, n_dev, STEPS)
    st_ref, escapes_ref, _, _ = _soak(kind, "replicated", n_dev, STEPS)
    maps_equal = bool(
        (np.asarray(st.srv.logodds) == np.asarray(st_ref.srv.logodds))
        .all())
    # closures+merge were genuinely active during the soak
    assert merges > 0
    print(f"[SOAK {sharding}] steps={STEPS} escapes={escapes} "
          f"merges={merges} max_mean_drift={max_err:.3f} m "
          f"maps_equal={maps_equal}")

    # The budget genuinely holds end to end — zero guard fires,
    # bit-equal maps, drift under the 1.0 m budget. r3 had to weaken
    # the 5k-step contract to "no silent violation" (a minority of
    # agents outran the matcher's capture range); the r4 online frame
    # tracker (SlamConfig.merge_frame_gain — drift corrected at the
    # source rate) restores the STRICT contract at every horizon
    # (measured at 5000 steps: escapes 0, max mean drift 0.72 m, vs
    # 319 escapes / 1.61 m without the tracker).
    assert escapes == 0, f"{sharding}: {escapes} band escapes"
    np.testing.assert_array_equal(np.asarray(st.srv.logodds),
                                  np.asarray(st_ref.srv.logodds))
    assert max_err < 1.0, f"max drift {max_err:.3f} m >= 1.0 m budget"


# deployable-density leg steps: the 181-ray fan is ~5x the 37-ray soak
# preset's raster work, so the opt-in horizon defaults to 2000 (strict
# contract bar) and CI runs a 150-step wiring pass
DEPLOY_STEPS = (int(os.environ.get("SWARM_SOAK_DEPLOY_STEPS", "2000"))
                if SOAK else 150)


def test_sharded_soak_deployable_density():
    """The soak contract at DEPLOYABLE scan density —
    181-ray servo fans with the frame tracker's turn gate at its
    config.py default (the r4 soak record used 37-ray fans with the
    gate disabled, so the long-horizon evidence did not cover the
    preset actually shipped). Tiles decomposition + merge + closures ON.

    MEASURED ENVELOPE (r5, 2000 steps, this world's 6x4 m rooms): the
    strict zero-escape triple does NOT extend to dense fans here — a
    minority of agents' corrections fail (per-agent drift p95 1.76 m /
    max 2.55 m while the MEAN holds 0.45 m; 3 of 16 agents past the
    1.0 m static margin). The turn gate accounts for about half the
    escape events (149 gate-on -> 126 with the starvation override ->
    72 gate-off); the rest is dense-fan match failure in wall-dominated
    small rooms. A wider margin cannot be declared: the tile/halo
    static proof (make_sharded_sim_step's containment check) bounds the
    evidence box a tile can exchange, so the 1.0 m margin IS the
    envelope this decomposition supports — beyond it the runtime guard
    drops out-of-band evidence LOUDLY (band_escapes metric), never
    silently. This leg therefore asserts the disclosed contract: the
    mean-drift budget holds, escapes stay under 1 % of agent-steps
    (measured 0.4 %), and the guard accounting is exact. The strict
    triple remains proven at the 37-ray soak preset
    (test_sharded_soak_band_containment, 5k steps).

    Opt-in full horizon: SWARM_SOAK=1 (2000 steps, override via
    SWARM_SOAK_DEPLOY_STEPS); CI default is a 150-step wiring pass."""
    from swarm_tpu.config import SlamConfig
    n_dev = 4
    if len(jax.devices()) < n_dev:
        pytest.skip("needs 4 devices")
    gate = SlamConfig().merge_frame_turn_gate   # deployable default
    st, escapes, max_err, merges = _soak(
        "tiles", "tiles", n_dev, DEPLOY_STEPS, scan_rays=181,
        turn_gate=gate)
    assert merges > 0
    n_agents = st.pose_true.shape[0]
    esc_frac = escapes / (DEPLOY_STEPS * n_agents)
    print(f"[SOAK deploy-density] steps={DEPLOY_STEPS} escapes={escapes} "
          f"({esc_frac:.4f}/agent-step) merges={merges} "
          f"max_mean_drift={max_err:.3f} m")
    assert max_err < 1.0, f"mean drift {max_err:.3f} m >= 1.0 m budget"
    assert esc_frac < 0.01, \
        f"escape rate {esc_frac:.4f} above the measured 1% envelope"

"""Polar beam-model raster: semantics, fast-path equivalence with the
reference on full-grid, band and tile windows, and agreement with the line
raster on a real scenario."""

import jax
import jax.numpy as jnp
import numpy as np

from swarm_tpu.config import EngineConfig, GridConfig, SwarmConfig
from swarm_tpu.ops.beam_raster import (BeamSpec, beam_raster_reference,
                                       beams_from_4way, beams_from_scan)
from swarm_tpu.ops.raster import RayBatch, logodds_raster


def test_beam_semantics_4way():
    cfg = GridConfig(size=384)
    lo = jnp.zeros((cfg.size, cfg.size), jnp.float32)
    xy = jnp.asarray([[0.0, 0.0]])   # cell (100, 100)
    yaw = jnp.asarray([0.0])
    d, tr = beams_from_4way(jnp.asarray([[1.0, 4.0, 4.0, 4.0]]), 1.2, 0.05)
    out, w = beam_raster_reference(lo, xy, yaw, d, tr,
                                   BeamSpec.four_way(), cfg)
    out = np.asarray(out)
    occ = np.argwhere(out > 0)
    # the 1.0 m front hit lands at ~(100, 120)
    assert len(occ) > 0
    assert (np.abs(occ - [100, 120]) <= 2).all(axis=1).any()
    # free space carved along all four beams; diagonal untouched
    assert (out[99:101, 102:118] < 0).any(axis=0).all()
    assert (out[102:122, 99:101] < 0).any(axis=1).all()
    assert abs(out[110, 110]) == 0
    assert int(w) > 50


def test_beam_scan_fov_limited():
    cfg = GridConfig(size=384)
    lo = jnp.zeros((cfg.size, cfg.size), jnp.float32)
    xy = jnp.asarray([[0.0, 0.0]])
    yaw = jnp.asarray([0.0])
    scan = np.full((1, 181), 4.0, np.float32)
    scan[0, 85:96] = 0.9
    d, tr = beams_from_scan(jnp.asarray(scan), 1.2, 0.05)
    out, _ = beam_raster_reference(lo, xy, yaw, d, tr, BeamSpec.scan(), cfg)
    out = np.asarray(out)
    assert np.abs(out[:, :99]).max() == 0     # nothing behind the fan
    occ = np.argwhere(out > 0)
    assert len(occ) >= 4                      # a wall arc ahead
    assert np.abs(occ[:, 1] - 118).max() <= 2


def test_beam_vs_line_raster_agreement():
    """Both evidence models must produce the same map structure on the
    closed-loop dual-bot run (free interior, occupied walls)."""
    from swarm_tpu.engine.sim import make_agent_params, sim_init, sim_rollout
    from swarm_tpu.geom.world import BEDROOM_WALLS
    from swarm_tpu.ops.raster import tri_state_view

    walls = jnp.asarray(BEDROOM_WALLS)
    params = make_agent_params(2)
    grids = {}
    for mode in ("line", "beam"):
        cfg = SwarmConfig(n_agents=2, grid=GridConfig(size=384),
                          engine=EngineConfig(
                              parity_mode=False, compute_frontiers=False,
                              raster_mode=mode))
        final, _ = jax.jit(lambda s, c=cfg: sim_rollout(
            s, 100, c, walls, params))(sim_init(cfg, params))
        grids[mode] = np.asarray(tri_state_view(final.srv.logodds,
                                                cfg.grid))
    free_line = grids["line"] == 0
    free_beam = grids["beam"] == 0
    inter = (free_line & free_beam).sum()
    union = (free_line | free_beam).sum()
    assert inter / union > 0.5, (inter, union)   # same explored structure
    assert (grids["beam"] == 100).sum() > 10


def test_engine_pallas_mode_runs_interpret():
    """fast_raster engine mode end-to-end (the path the GPU runs)."""
    from swarm_tpu.engine.sim import make_agent_params, sim_init, sim_step
    from swarm_tpu.geom.world import BEDROOM_WALLS

    cfg = SwarmConfig(n_agents=2, grid=GridConfig(size=384),
                      engine=EngineConfig(
                          parity_mode=False, compute_frontiers=False,
                          raster_mode="beam", fast_raster=True))
    params = make_agent_params(2)
    st = sim_init(cfg, params)
    for _ in range(3):
        st, m = sim_step(st, cfg, jnp.asarray(BEDROOM_WALLS), params)
    assert int(m.writes) > 0
    assert np.isfinite(np.asarray(st.srv.logodds)).all()


def test_banded_window_kernel_bit_exact():
    """free_raster_fast on row-band and 2-D tile windows (traced offsets,
    grid-edge ghost guard) is BIT-EXACT vs the reference on the same
    windows — the surface the sharded engine's decompositions use
    (parallel/sharded.py). The agents' fans do not overlap, so both
    apply one float product per cell."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from swarm_tpu.config import GridConfig
    from swarm_tpu.ops.beam_raster import (BeamSpec,
                                           free_raster_reference)
    from swarm_tpu.ops.fast_raster import free_raster_fast

    grid = GridConfig(size=512, origin_x=0.0, origin_y=0.0)
    spec = BeamSpec.scan(61)
    key = jax.random.PRNGKey(1)
    pos_cells = jnp.asarray([[250.0, 120.0], [253.0, 253.0],
                             [40.0, 300.0]])
    xy = pos_cells[:, ::-1] * grid.resolution
    yaw = jnp.asarray([0.3, -1.2, 2.0])
    dist = jax.random.uniform(key, (3, 61), minval=0.15, maxval=1.19)
    act = jnp.ones((3,), bool)

    cases = [
        ((jnp.int32(96), 256), None),                       # row band
        ((jnp.int32(192), 320), (jnp.int32(0), 512)),       # tile + halo
        ((jnp.int32(-32), 320), (jnp.int32(-128), 512)),    # grid-edge
    ]
    for band, band_cols in cases:
        tgt = (band[1], band_cols[1] if band_cols else grid.size)
        ref, w = free_raster_reference(
            jnp.zeros(tgt), xy, yaw, dist, act, spec, grid,
            n_groups=spec.n_beams, reach=26, band=band,
            band_cols=band_cols, tail_weight=0.0)
        ker, kw = free_raster_fast(
            jnp.zeros(tgt), xy, yaw, dist, act, spec, grid,
            n_groups=spec.n_beams, reach=26, band=band,
            band_cols=band_cols)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(ker))
        assert float(w) > 0
        # the painted counter equals the reference's painted count
        # (identical free masks + crossing counts, bit-exact)
        np.testing.assert_allclose(float(jnp.sum(kw)), float(w), rtol=1e-6)


def test_bfloat16_grid_tristate_equivalent():
    """The bf16 grid knob (half the device memory of the 1 GB 16,384^2
    float32 grid) — evidence is applied in f32 and rounds on store, so
    the tri-state view must match the f32 run on all but a sliver of
    threshold-straddling cells."""
    from swarm_tpu.engine.sim import make_agent_params, sim_init, sim_step
    from swarm_tpu.geom.world import BEDROOM_WALLS
    from swarm_tpu.ops.raster import tri_state_view

    grids = {}
    for dt in ("float32", "bfloat16"):
        cfg = SwarmConfig(
            n_agents=2,
            grid=GridConfig(size=384, logodds_dtype=dt),
            engine=EngineConfig(parity_mode=False, compute_frontiers=False,
                                raster_mode="beam", fast_raster=True,
                                scan_rays=37, raster_4way=False))
        params = make_agent_params(2, cfg=cfg)
        st = sim_init(cfg, params)
        assert st.srv.logodds.dtype == cfg.grid.lo_dtype
        walls = jnp.asarray(BEDROOM_WALLS)
        for _ in range(30):
            st, m = sim_step(st, cfg, walls, params)
        grids[dt] = np.asarray(tri_state_view(st.srv.logodds, cfg.grid))
        assert int(m.writes) > 0
    a, b = grids["float32"], grids["bfloat16"]
    explored = (a != -1) | (b != -1)
    agree = (a == b) & explored
    assert agree.sum() / max(explored.sum(), 1) > 0.98, \
        (explored.sum(), (a != b).sum())


def test_pack8_window_kernel_bit_exact():
    """The 1/4-cell range quantization (EngineConfig.beam_pack8) of the
    fast path is BIT-EXACT vs the reference fed 1/4-cell-quantized ranges
    (quantize_ranges_cells8): 1/4 cell is an exact multiple of the shared
    1/256-cell quant, so the reference's own re-quantization is identity.
    Covers full-grid, row-band, and grid-edge tile windows."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from swarm_tpu.config import GridConfig
    from swarm_tpu.ops.beam_raster import (BeamSpec, free_raster_reference,
                                           quantize_ranges_cells8)
    from swarm_tpu.ops.fast_raster import free_raster_fast

    grid = GridConfig(size=512, origin_x=0.0, origin_y=0.0)
    spec = BeamSpec.scan(61)
    key = jax.random.PRNGKey(7)
    pos_cells = jnp.asarray([[250.0, 120.0], [253.0, 253.0],
                             [40.0, 300.0]])
    xy = pos_cells[:, ::-1] * grid.resolution
    yaw = jnp.asarray([0.3, -1.2, 2.0])
    dist = jax.random.uniform(key, (3, 61), minval=0.15, maxval=1.19)
    act = jnp.ones((3,), bool)
    # the reference sees the coarser fixed point explicitly
    dist_q = quantize_ranges_cells8(dist / grid.resolution) \
        * grid.resolution

    cases = [
        (None, None),                                       # full grid
        ((jnp.int32(96), 256), None),                       # row band
        ((jnp.int32(-32), 320), (jnp.int32(-128), 512)),    # grid-edge
    ]
    for band, band_cols in cases:
        tgt = (band[1] if band else grid.size,
               band_cols[1] if band_cols else grid.size)
        ref, w = free_raster_reference(
            jnp.zeros(tgt), xy, yaw, dist_q, act, spec, grid,
            n_groups=spec.n_beams, reach=26, band=band,
            band_cols=band_cols, tail_weight=0.0)
        ker, kw = free_raster_fast(
            jnp.zeros(tgt), xy, yaw, dist, act, spec, grid,
            n_groups=spec.n_beams, reach=26, band=band,
            band_cols=band_cols, pack8=True)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(ker))
        assert float(w) > 0
        np.testing.assert_allclose(float(jnp.sum(kw)), float(w), rtol=1e-6)


def test_pack8_trusted_flag_matches_pack16():
    """With endpoint-ring painting ON, the 1/4-cell quantization paints
    the same ring as the 1/256-cell one: feed both ranges already at
    1/4-cell fixed point (exact in both) and require bit-equal maps and
    counters."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from swarm_tpu.config import GridConfig
    from swarm_tpu.ops.beam_raster import (BeamSpec,
                                           quantize_ranges_cells8)
    from swarm_tpu.ops.fast_raster import free_raster_fast

    grid = GridConfig(size=512, origin_x=0.0, origin_y=0.0)
    spec = BeamSpec.scan(61)
    key = jax.random.PRNGKey(11)
    xy = jnp.asarray([[6.0, 12.5], [12.6, 12.6]])
    yaw = jnp.asarray([0.9, -2.1])
    dist = jax.random.uniform(key, (2, 61), minval=0.15, maxval=1.19)
    dist = quantize_ranges_cells8(dist / grid.resolution) * grid.resolution
    trusted = jax.random.bernoulli(jax.random.PRNGKey(3), 0.7, (2, 61))
    act = jnp.ones((2,), bool)

    outs = {}
    for pack8 in (False, True):
        outs[pack8] = free_raster_fast(
            jnp.zeros((grid.size, grid.size)), xy, yaw, dist, act, spec,
            grid, n_groups=spec.n_beams, reach=26, trusted=trusted,
            pack8=pack8)
    np.testing.assert_array_equal(np.asarray(outs[False][0]),
                                  np.asarray(outs[True][0]))
    np.testing.assert_allclose(np.asarray(outs[False][1]),
                               np.asarray(outs[True][1]), rtol=1e-6)
    assert float(jnp.sum(outs[True][1])) > 0

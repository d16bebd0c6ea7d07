"""Cross-agent map merging: warp correctness and misaligned-map recovery."""

import jax
import jax.numpy as jnp
import numpy as np

from swarm_tpu.config import EngineConfig, GridConfig, SwarmConfig
from swarm_tpu.slam.merge import merge_local_maps, warp_grid


def test_warp_identity_and_shift():
    g = jnp.zeros((256, 256), jnp.float32).at[100:120, 80:90].set(1.0)
    same = warp_grid(g, 0.0, 0.0, 0.0)
    np.testing.assert_allclose(np.asarray(same), np.asarray(g), atol=1e-5)
    shifted = np.asarray(warp_grid(g, 7.0, -5.0, 0.0))
    np.testing.assert_allclose(shifted[95:115, 87:97],
                               np.asarray(g)[100:120, 80:90], atol=1e-5)


def test_warp_rotation_roundtrip():
    g = jnp.zeros((256, 256), jnp.float32).at[100:140, 120:126].set(1.0)
    rot = warp_grid(g, 0.0, 0.0, 0.3)
    back = np.asarray(warp_grid(rot, 0.0, 0.0, -0.3))
    inside = np.asarray(g)[60:200, 60:200]
    # bilinear blurs edges; mass and bulk position must survive
    assert abs(back.sum() - np.asarray(g).sum()) / np.asarray(g).sum() < 0.05
    assert np.abs(back[60:200, 60:200] - inside).mean() < 0.02


def _session_grids(offset_m):
    """Run the dual-bot sim twice, agent-separated grids; artificially
    translate agent 1's map by offset_m to emulate inter-map drift."""
    from swarm_tpu.engine.sim import make_agent_params, sim_init, sim_rollout
    from swarm_tpu.geom.world import BEDROOM_WALLS

    cfg = SwarmConfig(n_agents=2, grid=GridConfig(size=256),
                      engine=EngineConfig(parity_mode=False,
                                          compute_frontiers=False))
    params = make_agent_params(2, separation=0.0, cfg=cfg)
    walls = jnp.asarray(BEDROOM_WALLS)

    # two single-agent runs over the SAME route (different noise seeds) ->
    # overlapping local maps, the case the merger must align
    from swarm_tpu.engine.sim import sim_init

    grids = []
    cfg1 = SwarmConfig(n_agents=1, grid=cfg.grid, engine=cfg.engine)
    p1 = jax.tree.map(lambda a: a[0:1], params)
    for seed in (0, 1):
        final, _ = jax.jit(lambda s: sim_rollout(
            s, 120, cfg1, walls, p1))(
            sim_init(cfg1, p1, jax.random.PRNGKey(seed)))
        grids.append(final.srv.logodds)
    g0, g1 = grids
    cells = int(round(offset_m / cfg.grid.resolution))
    g1 = jnp.roll(g1, (cells, -cells), axis=(0, 1))   # fake drift
    return cfg, g0, g1


def test_merge_recovers_offset():
    cfg, g0, g1 = _session_grids(offset_m=0.3)
    out = merge_local_maps(jnp.stack([g0, g1]), cfg.grid, cfg.slam)
    assert bool(out.merged[1]), float(out.transforms.fitness[1])
    # recovered translation ~ -0.3 m in y(dy relates to rows) etc.
    dx = float(out.transforms.dx[1])
    dy = float(out.transforms.dy[1])
    assert abs(dx - 0.3) < 0.1 or abs(dx + 0.3) < 0.1 or \
           abs(dy - 0.3) < 0.1 or abs(dy + 0.3) < 0.1, (dx, dy)
    # merged map has stronger wall evidence than either input
    merged_occ = (np.asarray(out.global_logodds) > 0.5).sum()
    assert merged_occ >= (np.asarray(g0) > 0.5).sum()


def _wall_submap(origin, width, height, drift_x=0.0, res=0.05):
    """Synthetic submap of a 4x2 m room perimeter (walls y=1, y=3, x=0,
    x=4) cropped to this map's own extent. drift_x shifts the REPORTED
    origin while the evidence stays true — emulating inter-map drift."""
    grid = np.zeros((height, width), np.int8)
    ox, oy = origin

    def mark(x, y):
        cx = int(np.floor((x - ox) / res))
        cy = int(np.floor((y - oy) / res))
        if 0 <= cx < width and 0 <= cy < height:
            grid[cy, cx] = 100

    ts = np.arange(0.0, 4.0, res / 2)
    for t in ts:
        mark(t, 1.0)
        mark(t, 3.0)
    for t in np.arange(1.0, 3.0, res / 2):
        mark(0.0, t)
        mark(4.0, t)
    # interior doorway wall at x=2 — a vertical feature inside the
    # overlap region, pinning x-translation (horizontal walls alone are
    # aperture-degenerate along x)
    for t in np.arange(1.0, 2.0, res / 2):
        mark(2.0, t)
    return grid, (ox + drift_x, oy)


def test_dynamic_merge_offset_submaps():
    """merge_submaps_dynamic accepts differently-sized, offset submaps and
    produces a bounds-fitted global map (map_merger.py:87-127 semantics)."""
    from swarm_tpu.slam.merge import merge_submaps_dynamic

    res = 0.05
    # submap A: the full room, true origin
    a = _wall_submap((-0.25, 0.75), 92, 50, res=res)
    # submap B: right crop, DIFFERENT size, origin offset +0.15 m in x
    b = _wall_submap((1.25, 0.75), 62, 52, drift_x=0.15, res=res)
    grid, origin, reports = merge_submaps_dynamic(
        [a, b], res, fitness_min=0.6)

    assert reports[0]["ok"] and reports[1]["ok"], reports
    # the matcher must recover (and undo) the injected +0.15 m drift
    assert abs(reports[1]["dx"] + 0.15) < 0.06, reports[1]
    assert abs(reports[1]["dy"]) < 0.06, reports[1]
    # bounds-fitted extent: merged walls span [0, 4] x [1, 3] ->
    # origin near (0, 1), ~81 x 41 cells (+ alignment slack)
    assert abs(origin[0] - 0.0) < 0.15 and abs(origin[1] - 1.0) < 0.15
    h, w = grid.shape
    assert 70 <= w <= 92 and 34 <= h <= 50, grid.shape
    assert (grid == 100).sum() > 200
    # unknown filler is the reference's -1
    assert (grid == -1).sum() > 0


def test_dynamic_merge_rejects_unrelated_submap():
    from swarm_tpu.slam.merge import merge_submaps_dynamic

    res = 0.05
    a = _wall_submap((-0.25, 0.75), 60, 50, res=res)
    rng = np.random.default_rng(0)
    noise = (rng.random((48, 48)) < 0.01).astype(np.int8) * 100
    grid, origin, reports = merge_submaps_dynamic(
        [a, (noise, (10.0, 10.0))], res, fitness_min=0.6)
    assert reports[0]["ok"] and not reports[1]["ok"]
    # global map stays A-only: extent must not include the far noise blob
    assert origin[0] < 5.0 and grid.shape[1] < 120


def test_merge_rejects_unrelated_map():
    cfg, g0, _ = _session_grids(offset_m=0.0)
    noise = jnp.asarray(
        (np.random.default_rng(0).random(g0.shape) < 0.001) * 0.9,
        jnp.float32)
    out = merge_local_maps(jnp.stack([g0, noise]), cfg.grid, cfg.slam)
    assert not bool(out.merged[1])
    # global stays the anchor
    np.testing.assert_allclose(np.asarray(out.global_logodds),
                               np.clip(np.asarray(g0), -10, 10), atol=1e-5)

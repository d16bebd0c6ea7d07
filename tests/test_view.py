"""Interactive operator view (server/view.py) — the reference's PyGame
dashboard (dual_bot_mapper.py:380-668) and replay controls
(playback_dual_session.py:163-219) as an HTTP view."""

import json
import os
import urllib.request

import numpy as np

from swarm_tpu.server.view import MapView, PlaybackSource, render_view


def _snap(n=2, s=64):
    grid = np.full((s, s), -1, np.int8)
    grid[10:50, 10:50] = 0
    grid[10, 10:50] = 100
    return {
        "grid": grid,
        "resolution": 0.05,
        "origin": (0.0, 0.0),
        "poses": np.array([[1.0, 1.0, 0.3], [2.0, 1.5, -1.0]][:n]),
        "online": np.array([True, False][:n]),
        "pkt_counts": np.array([17, 5][:n]),
        "zones": np.array([[0.5, 0.5, 1.5, 1.2], [0, 0, 0, 0]][:n]),
        "zone_active": np.array([True, False][:n]),
        "frontiers": np.array([[1.2, 1.2]]),
        "n_frontiers": 1,
        "closures": 3,
        "pkt_total": 22,
        "t": 12.5,
    }


def test_render_view_draws_window():
    img = render_view(_snap(), cx=1.5, cy=1.5, zoom=100, w=320, h=240)
    assert img.shape == (240, 320, 3)
    # free/occupied/background all present, robots stamped
    colors = {tuple(c) for c in img.reshape(-1, 3)}
    assert (34, 40, 49) in colors          # free
    assert (120, 200, 255) in colors       # occupied wall row
    assert (255, 120, 90) in colors        # bot 1 marker
    assert (128, 128, 128) in colors       # offline bot 2
    assert (255, 80, 80) in colors         # zone outline


def test_render_view_zoom_clamped_and_offcenter():
    # extreme zoom + center far outside the grid must not crash
    img = render_view(_snap(), cx=900.0, cy=-900.0, zoom=1e9, w=64, h=64)
    assert img.shape == (64, 64, 3)
    img = render_view(_snap(), cx=0, cy=0, zoom=1.0, w=64, h=64)
    assert img.shape == (64, 64, 3)


def test_http_view_endpoints():
    view = MapView(_snap, port=0)          # ephemeral port
    view.start()
    try:
        base = f"http://127.0.0.1:{view.port}"
        html = urllib.request.urlopen(base + "/").read()
        assert b"swarm_tpu live view" in html
        hud = json.load(urllib.request.urlopen(base + "/hud.json"))
        assert hud["pkt_total"] == 22 and hud["closures"] == 3
        assert hud["bots"][0]["online"] and not hud["bots"][1]["online"]
        png = urllib.request.urlopen(
            base + "/map.png?cx=1.5&cy=1.5&zoom=150&w=400&h=300").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        view.stop()


def _write_session(tmp_path):
    os.makedirs(tmp_path, exist_ok=True)
    with open(os.path.join(tmp_path, "telemetry.csv"), "w") as f:
        f.write("time,agent,x,y,yaw_deg,encoder,v2v,front_cm,"
                "left_cm,back_cm,right_cm,landmark\n")
        for k in range(20):
            for a in (1, 2):
                f.write(f"{k * 0.5},{a},{0.1 * k},{0.2 * a},0.0,{k},0,"
                        f"50,80,100,60,0\n")
    with open(os.path.join(tmp_path, "pointcloud.csv"), "w") as f:
        f.write("time,agent,sensor,x,y\n")
        for k in range(20):
            f.write(f"{k * 0.5},1,front,{0.1 * k + 0.5},0.4\n")


def test_playback_source_controls(tmp_path):
    d = str(tmp_path / "sess")
    _write_session(d)
    src = PlaybackSource(d, speed=2.0)
    s1 = src.snapshot()
    assert s1["playback"]["speed"] == 2.0
    assert s1["poses"].shape == (2, 3)
    src.ctl("pause")
    t1 = src.snapshot()["t"]
    t2 = src.snapshot()["t"]
    assert t1 == t2                         # frozen
    src.ctl("speed", 50.0)
    assert src.speed == 20.0                # ref clamp 0.1-20x
    src.ctl("pause")                        # resume
    src._last_wall -= 1.0                   # simulate 1 s of wall time
    t3 = src.snapshot()["t"]
    assert t3 > t2 + 5                      # 20x speed advanced the clock
    src.ctl("reset")
    assert src.snapshot()["t"] < 1.0
    img = render_view(src.snapshot(), cx=1.0, cy=0.4, zoom=100,
                      w=200, h=150)
    assert img.shape == (150, 200, 3)


def test_live_view_cloud_and_path_layers():
    """the LIVE view draws per-sensor point clouds and
    downsampled paths, not just the grid — ViewTrails feeds the snapshot
    layers and render_view colors them per agent / shades per sensor."""
    from swarm_tpu.server.live import ViewTrails

    tr = ViewTrails(cloud_cap=64, path_cap=32)
    agents = np.array([0, 1], np.int32)
    rx = np.array([1.0, 2.0], np.float32)
    ry = np.array([1.0, 1.5], np.float32)
    hits = np.zeros((2, 4, 2), np.float32)
    hits[0, :, 0] = [1.5, 1.0, 0.5, 1.0]
    hits[0, :, 1] = [1.0, 1.5, 1.0, 0.5]
    hits[1, :, 0] = [2.5, 2.0, 1.5, 2.0]
    hits[1, :, 1] = [1.5, 2.0, 1.5, 1.0]
    hv = np.ones((2, 4), bool)
    for _ in range(3):
        tr.observe(agents, rx, ry, hits, hv)
    layers = tr.snapshot_layers()
    assert len(layers["points"][0]) == 24          # 2 agents x 4 x 3 frames
    assert len(layers["paths"][0]) == 6
    assert set(np.unique(layers["points_sensor"])) == {0, 1, 2, 3}

    snap = _snap()
    snap.update(layers)
    img = render_view(snap, cx=1.5, cy=1.25, zoom=150, w=320, h=240)
    base = render_view(_snap(), cx=1.5, cy=1.25, zoom=150, w=320, h=240)
    # cloud/path pixels change the frame vs the grid-only render
    assert (img != base).any()
    # agent-1 cloud color family present (front sensor = full brightness)
    colors = {tuple(c) for c in img.reshape(-1, 3)}
    assert (255, 120, 90) in colors


def test_ring_buffers_wrap():
    from swarm_tpu.server.live import ViewTrails

    tr = ViewTrails(cloud_cap=10, path_cap=4)
    a = np.zeros(3, np.int32)
    xy = np.zeros(3, np.float32)
    hits = np.random.default_rng(0).normal(size=(3, 4, 2)).astype(np.float32)
    hv = np.ones((3, 4), bool)
    for _ in range(5):
        tr.observe(a, xy, xy, hits, hv)
    layers = tr.snapshot_layers()
    assert len(layers["points"][0]) == 10          # capped at ring size
    assert len(layers["paths"][0]) == 4


def test_polar_frame_and_replay(tmp_path):
    """SURVEY §2 #36: polar radar frame (room_mapper.py:47-110 semantics)
    + frame-by-frame scan replay (playback_viewer.py:54-68)."""
    from swarm_tpu.render.polar import playback_scan_frames, render_polar_frame

    rng = np.random.default_rng(3)
    ranges = rng.uniform(0.1, 1.1, 181)
    ranges[50:60] = 3.0                      # out of trust -> blanked
    img = render_polar_frame(ranges, yaw=0.5, v2v=123,
                             out_path=str(tmp_path / "radar.png"))
    assert img.ndim == 3 and img.shape[2] == 3
    assert (tmp_path / "radar.png").exists()

    log = {
        "t": np.arange(3, dtype=np.float64),
        "x": np.array([0.0, 0.1, 0.2], np.float32),
        "y": np.zeros(3, np.float32),
        "yaw": np.zeros(3, np.float32),
        "encoder": np.array([10, 20, 30]),
        "v2v": np.array([1, 2, 3]),
        "ranges": rng.uniform(0.1, 1.1, (3, 181)).astype(np.float32),
    }
    frames = playback_scan_frames(log, str(tmp_path / "frames"),
                                  gif=str(tmp_path / "scan.gif"))
    assert len(frames) == 3
    assert (tmp_path / "scan.gif").exists()

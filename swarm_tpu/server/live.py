"""Live UDP mapping server — the reference's `dual_bot_mapper.py` main loop
(:713-1048) with the per-packet Python math replaced by the jitted batched
engine.

Architecture: the socket drains up to `max_packets_per_frame` datagrams per
frame (ref :816), parses them with the proto codecs, pads them into a
fixed-shape [B] packet batch, and ONE jitted `lax.scan` (engine.replay
.ingest_packet) applies the whole frame — raster, closures, zones,
heartbeat — on device. Frame-rate work on the host is parsing + two small
device transfers. ZONE/TARG packets go back over UDP on the reference's
cadences; session CSVs stream via proto.csvio.SessionWriter.

Generalises the reference's hardcoded 2 bots (ports 8888/8889,
MULTI_AGENT_SETUP_GUIDE.md:25-31) to N agents with a bot-address registry
learned from incoming packet source addresses.
"""

from __future__ import annotations

import socket
import time
from typing import Dict, Optional, Tuple

import numpy as np

from swarm_tpu.config import SwarmConfig
from swarm_tpu.proto.csvio import SessionWriter
from swarm_tpu.proto.packets import (QuasarPacketV1, QuasarPacketV2,
                                     TargetPacket, ZonePacket, parse_packet)


class ViewTrails:
    """Bounded live point-cloud + path rings for the operator view — the
    reference dashboard's per-sensor colored clouds (last 2000 points per
    sensor, dual_bot_mapper.py:560-572) and downsampled paths (:583),
    kept as fixed-size numpy rings so a long run can't grow host memory.
    Maintained only while a view is attached (zero cost otherwise)."""

    def __init__(self, cloud_cap: int = 20000, path_cap: int = 10000):
        self.cloud_xy = np.zeros((cloud_cap, 2), np.float32)
        self.cloud_agent = np.zeros(cloud_cap, np.int32)
        self.cloud_sensor = np.zeros(cloud_cap, np.int8)
        self.cloud_n = 0
        self.cloud_cur = 0
        self.path_xy = np.zeros((path_cap, 2), np.float32)
        self.path_agent = np.zeros(path_cap, np.int32)
        self.path_n = 0
        self.path_cur = 0

    def _push(self, buf_xy, buf_a, cur, n, xy, agent, buf_s=None, sens=None):
        cap = len(buf_xy)
        k = min(len(xy), cap)
        idx = (cur + np.arange(k)) % cap
        buf_xy[idx] = xy[-k:]
        buf_a[idx] = agent[-k:]
        if buf_s is not None:
            buf_s[idx] = sens[-k:]
        return (cur + k) % cap, min(n + k, cap)

    def observe(self, agents0, rx, ry, hits, hv):
        """One ingested frame's world-projected hits + poses."""
        n_real = len(agents0)
        if n_real == 0:
            return
        a4 = np.repeat(np.asarray(agents0, np.int32), 4)
        s4 = np.tile(np.arange(4, dtype=np.int8), n_real)
        ok = np.asarray(hv[:n_real]).reshape(-1)
        pts = np.asarray(hits[:n_real], np.float32).reshape(-1, 2)
        if ok.any():
            self.cloud_cur, self.cloud_n = self._push(
                self.cloud_xy, self.cloud_agent, self.cloud_cur,
                self.cloud_n, pts[ok], a4[ok],
                self.cloud_sensor, s4[ok])
        pxy = np.stack([np.asarray(rx[:n_real], np.float32),
                        np.asarray(ry[:n_real], np.float32)], -1)
        self.path_cur, self.path_n = self._push(
            self.path_xy, self.path_agent, self.path_cur, self.path_n,
            pxy, np.asarray(agents0, np.int32))

    def snapshot_layers(self):
        c, p = self.cloud_n, self.path_n
        return {
            "points": (self.cloud_xy[:c], self.cloud_agent[:c]),
            "points_sensor": self.cloud_sensor[:c],
            "paths": (self.path_xy[:p], self.path_agent[:p]),
        }


class LiveServer:
    """Bind, ingest, coordinate. Drop-in for dual_bot_mapper.py's loop."""

    def __init__(self, cfg: SwarmConfig = SwarmConfig(), port: int = 8888,
                 separation: float = 5.0, log_dir: Optional[str] = None,
                 enable_targets: bool = False,
                 bot_tx_port_base: int = 8888,
                 native_codec: bool = True,
                 ingest_mode: str = "parity"):
        import jax
        import jax.numpy as jnp
        from swarm_tpu.engine.replay import (ingest_frame, ingest_packet,
                                             server_init)

        if ingest_mode not in ("parity", "throughput"):
            raise ValueError(f"unknown ingest_mode {ingest_mode!r}")
        self.ingest_mode = ingest_mode

        # Native batch codec (swarm_tpu.native/src/codec.cpp): one C pass
        # turns a frame's raw datagrams into column arrays, keeping the
        # per-packet Python struct codec off the serve hot path. Falls
        # back silently-but-loudly if the toolchain can't build it.
        self._native = None
        if native_codec:
            try:
                from swarm_tpu.native import parse_telemetry_columns
                parse_telemetry_columns([b"QSRL"])     # build + load now
                self._native = parse_telemetry_columns
            except Exception as e:                     # pragma: no cover
                print(f"[SERVER] native codec unavailable ({e}); using "
                      "the Python struct codec")

        self.cfg = cfg
        self.enable_targets = enable_targets
        self.n = cfg.n_agents
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # Burst headroom: the reference drains only 20 pkts/frame (:816);
        # a deep kernel buffer absorbs bot bursts between frames.
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 4 * 1024 * 1024)
        except OSError:
            pass
        self.sock.bind(("0.0.0.0", port))
        self.sock.setblocking(False)
        self.port = port
        # agent -> (ip, port); learned from RX, overridable. The reference
        # sends to fixed per-bot ports 8888/8889 (:758-759).
        self.bot_addrs: Dict[int, Tuple[str, int]] = {}
        self.bot_tx_port_base = bot_tx_port_base
        self.t0 = time.time()
        self.state = server_init(cfg, t0=0.0)
        self.offsets = jnp.asarray(
            [0.0 if a % 2 == 0 else separation for a in range(self.n)],
            jnp.float32)
        self.writer = SessionWriter(log_dir) if log_dir else None
        self.online_prev = np.zeros(self.n, bool)
        self.pkt_total = 0
        self._trails: Optional[ViewTrails] = None

        b = cfg.engine.max_packets_per_frame

        # scan-matched closures in SERVING mode (SlamConfig
        # .closure_scanmatch, throughput ingest only): scan payloads
        # update a host-side latest-sweep table that rides into the
        # jitted frame application, so the closure log carries measured
        # SE(2) edges (+ fitness) for the offline refiners
        self.latest_scans = None
        scanmatch = (cfg.slam.closure_scanmatch
                     and cfg.engine.scan_rays > 0
                     and ingest_mode == "throughput")
        if scanmatch:
            self.latest_scans = np.zeros(
                (self.n, cfg.engine.scan_rays), np.float32)

        if ingest_mode == "throughput":
            # one fused application per frame (order-exact parity grid,
            # frame-coarse closure/cadence semantics — engine.replay
            # .ingest_frame): the per-packet scan serializes ~100 us/pkt
            if scanmatch:
                def frame_fn(state, batch, scans):
                    return ingest_frame(state, batch, cfg, self.offsets,
                                        enable_targets=enable_targets,
                                        compute_frontiers=True,
                                        scans=scans)
            else:
                def frame_fn(state, batch):
                    return ingest_frame(state, batch, cfg, self.offsets,
                                        enable_targets=enable_targets,
                                        compute_frontiers=True)
        else:
            def frame_fn(state, batch):
                def step(st, pkt):
                    return ingest_packet(st, pkt, cfg, self.offsets,
                                         enable_targets=enable_targets,
                                         compute_frontiers=True)
                return jax.lax.scan(step, state, batch)

        # No donation: freshly-initialised states can alias identical
        # zero-constant buffers across leaves, which donation rejects.
        self._frame = jax.jit(frame_fn)
        self._batch_size = b
        self._jnp = jnp
        # Warm the compile NOW (an all-padding frame) so the first real
        # traffic burst doesn't sit behind a multi-second XLA compile.
        self.ingest([])

    def now(self) -> float:
        return time.time() - self.t0

    # -- RX ------------------------------------------------------------------

    def drain_socket(self):
        """<= max_packets_per_frame datagrams -> parsed telemetry list."""
        out = []
        for _ in range(self._batch_size):
            try:
                data, addr = self.sock.recvfrom(2048)
            except BlockingIOError:
                break
            pkt = parse_packet(data)
            if isinstance(pkt, (QuasarPacketV2, QuasarPacketV1)):
                agent0 = pkt.agent - 1
                if 0 <= agent0 < self.n:
                    self.bot_addrs.setdefault(
                        agent0, (addr[0], self.bot_tx_port_base + agent0))
                    out.append((agent0, pkt))
            elif self.latest_scans is not None and \
                    hasattr(pkt, "ranges"):
                # 751/743 B scan payloads feed the measured-closure
                # sweep table (bridge mode routes them to ScanBridge
                # instead; the plain live server used to drop them)
                agent0 = pkt.agent - 1
                if 0 <= agent0 < self.n:
                    r = np.asarray(pkt.ranges, np.float32)
                    k = min(len(r), self.latest_scans.shape[1])
                    self.latest_scans[agent0, :k] = r[:k]
        return out

    def ingest(self, pkts) -> None:
        """Apply one frame's packets through the jitted scan."""
        agents, cols = self._columns_from_pkts(pkts)
        self.ingest_columns(agents, cols)

    def _columns_from_pkts(self, pkts):
        """Typed packets -> the column arrays ingest_columns consumes."""
        n_real = min(len(pkts), self._batch_size)
        agents = np.asarray([a for a, _ in pkts[:n_real]], np.int32)
        cols = {
            "x": np.asarray([p.x for _, p in pkts[:n_real]], np.float32),
            "y": np.asarray([p.y for _, p in pkts[:n_real]], np.float32),
            "yaw": np.asarray([p.yaw for _, p in pkts[:n_real]],
                              np.float32),
            "encoder": np.asarray([p.encoder for _, p in pkts[:n_real]],
                                  np.int32),
            "v2v": np.asarray([p.v2v for _, p in pkts[:n_real]],
                              np.int32),
            "dist4": np.asarray(
                [[p.front, p.left, p.back, p.right]
                 for _, p in pkts[:n_real]],
                np.float32).reshape(n_real, 4),
            "landmark": np.asarray(
                [getattr(p, "landmark", 0) for _, p in pkts[:n_real]],
                np.int32),
        }
        return agents, cols

    def ingest_columns(self, agents0, cols) -> None:
        """Apply one frame's telemetry given as column arrays (what the
        native codec produces; `ingest` adapts typed packets to this)."""
        from swarm_tpu.engine.replay import PacketStream

        jnp = self._jnp
        b = self._batch_size
        now = self.now()
        n_real = min(len(agents0), b)

        def pad(a, dtype, tail=()):
            out = np.zeros((b,) + tail, dtype)
            out[:n_real] = a[:n_real]
            return jnp.asarray(out)

        batch = PacketStream(
            t=jnp.full((b,), np.float32(now)),
            agent=pad(agents0, np.int32),
            x=pad(cols["x"], np.float32),
            y=pad(cols["y"], np.float32),
            yaw=pad(cols["yaw"], np.float32),
            encoder=pad(cols["encoder"], np.int32),
            v2v=pad(cols["v2v"], np.int32),
            dist=pad(cols["dist4"], np.float32, (4,)),
            landmark=pad(cols["landmark"], np.int32),
            valid=jnp.asarray(np.arange(b) < n_real))
        if self.latest_scans is not None:
            self.state, outs = self._frame(self.state, batch,
                                           jnp.asarray(self.latest_scans))
        else:
            self.state, outs = self._frame(self.state, batch)
        self.pkt_total += n_real

        if self._trails is not None and n_real:
            self._trails.observe(agents0[:n_real],
                                 np.asarray(outs.rx)[:n_real],
                                 np.asarray(outs.ry)[:n_real],
                                 np.asarray(outs.hits)[:n_real],
                                 np.asarray(outs.hit_valid)[:n_real])
        if self.writer and n_real:
            rx = np.asarray(outs.rx)[:n_real]
            ry = np.asarray(outs.ry)[:n_real]
            yaw = np.asarray(outs.yaw)[:n_real]
            hits = np.asarray(outs.hits)[:n_real]
            hv = np.asarray(outs.hit_valid)[:n_real]
            for i in range(n_real):
                self.writer.telemetry(
                    now, int(agents0[i]) + 1, rx[i], ry[i], yaw[i],
                    int(cols["encoder"][i]), int(cols["v2v"][i]),
                    list(cols["dist4"][i]), int(cols["landmark"][i]))
                self.writer.points(now, int(agents0[i]) + 1, hits[i],
                                   hv[i])

    def drain_ingest(self) -> int:
        """One frame: drain the socket and ingest. Returns the number of
        telemetry packets applied."""
        agents0, cols = self.drain_columns()
        if len(agents0):
            self.ingest_columns(agents0, cols)
        return int(len(agents0))

    def drain_columns(self):
        """Drain the socket into ONE frame's column arrays WITHOUT
        applying them (host-side bookkeeping — bot-address learning, the
        measured-closure sweep table — still happens here). Split from
        the device application so `run(pipeline=...)` can overlap the
        next frame's socket drain with the in-flight device dispatch.
        With the native codec the datagrams
        go straight to column arrays (no per-packet Python objects);
        otherwise falls back to the Python struct codec."""
        if self._native is None:
            return self._columns_from_pkts(self.drain_socket())
        from swarm_tpu.native import drain_udp_socket, \
            parse_telemetry_buffer

        # recvmmsg batch drain: one syscall per <= 256 datagrams (the
        # per-datagram recvfrom loop capped the throughput mode)
        buf, lens, ip4, _ports, n = drain_udp_socket(
            self.sock.fileno(), max_msgs=self._batch_size)
        empty = (np.zeros((0,), np.int32), {})
        if n == 0:
            return empty
        cols = parse_telemetry_buffer(buf, lens, n)
        agent0 = cols["agent"] - 1
        if self.latest_scans is not None:
            # scan payloads (kinds 3/4) feed the measured-closure sweep
            # table; the codec parses their 181 ranges zero-copy
            sk = ((cols["kind"] == 3) | (cols["kind"] == 4)) & \
                (agent0 >= 0) & (agent0 < self.n)
            for i in np.nonzero(sk)[0]:
                r = cols["scans"][i]
                k = min(len(r), self.latest_scans.shape[1])
                self.latest_scans[int(agent0[i]), :k] = r[:k]
        # 4-way telemetry only (kinds 1/2), mirroring drain_socket's
        # isinstance filter — scan payloads otherwise belong to the
        # ScanBridge.
        keep = ((cols["kind"] == 1) | (cols["kind"] == 2)) & \
            (agent0 >= 0) & (agent0 < self.n)
        idx = np.nonzero(keep)[0]
        for i in idx:
            a = int(agent0[i])
            if a not in self.bot_addrs:
                ip = socket.inet_ntoa(
                    int(ip4[i]).to_bytes(4, "big"))
                self.bot_addrs[a] = (ip, self.bot_tx_port_base + a)
        if not len(idx):
            return empty
        return agent0[idx], {k: v[idx] for k, v in cols.items()
                             if k not in ("kind", "agent", "n_good",
                                          "scans")}

    # -- TX ------------------------------------------------------------------

    def send_zones(self) -> int:
        """Latest zone snapshot -> ZONE packets (lift sentinel for inactive),
        ref :921-945."""
        boxes = np.asarray(self.state.zone_boxes)
        active = np.asarray(self.state.zone_active)
        sent = 0
        for a, addr in self.bot_addrs.items():
            z = (ZonePacket(*boxes[a]) if active[a]
                 else ZonePacket(*ZonePacket.LIFT))
            try:
                self.sock.sendto(z.pack(), addr)
                sent += 1
            except OSError as e:        # ref logs and continues (:687)
                print(f"[ZONE] send to bot {a + 1} failed: {e}")
        return sent

    def send_targets(self) -> int:
        """TARG packets for agents with assignments (the reference's
        commented-out path, :959-996, behind enable_targets)."""
        if not self.enable_targets:
            return 0
        tg = np.asarray(self.state.targets)
        has = np.asarray(self.state.has_target)
        sent = 0
        for a, addr in self.bot_addrs.items():
            if has[a]:
                try:
                    self.sock.sendto(TargetPacket(*tg[a]).pack(), addr)
                    sent += 1
                except OSError as e:
                    print(f"[TARGET] send to bot {a + 1} failed: {e}")
        return sent

    # -- loop ----------------------------------------------------------------

    def heartbeat_transitions(self):
        """Print OFFLINE/ONLINE transitions (ref :804-812)."""
        from swarm_tpu.coord.heartbeat import heartbeat_update

        online = np.asarray(heartbeat_update(
            self.state.last_packet_t, self.now(),
            self.cfg.coord.heartbeat_timeout_s))
        for a in range(self.n):
            if self.online_prev[a] and not online[a]:
                print(f"[HEARTBEAT] Bot {a + 1} OFFLINE "
                      f"(no packets for "
                      f"{self.cfg.coord.heartbeat_timeout_s:.0f}s)")
            elif not self.online_prev[a] and online[a]:
                print(f"[HEARTBEAT] Bot {a + 1} ONLINE")
        self.online_prev = online
        return online

    def run(self, duration_s: Optional[float] = None, fps: float = 30.0,
            render_png: Optional[str] = None, render_every_s: float = 5.0,
            pipeline: int = 0):
        """The main loop. Ctrl-C or duration ends it; closes logs.

        pipeline > 0: frames are applied on a worker
        thread fed by a bounded queue of that depth, so the socket drain
        for frame k+1 overlaps the device dispatch of frame k.
        Backpressure: when the device falls
        behind, `put` blocks and the 4 MB kernel RCVBUF absorbs the
        burst. TX (zones/targets/heartbeat) stays on this thread —
        reading `self.state` mid-flight is safe (JAX arrays are
        immutable snapshots; the worker only rebinds the name)."""
        frame_dt = 1.0 / fps if fps > 0 else 0.0   # fps <= 0 = uncapped
        last_render = 0.0
        apply_q = apply_thread = None
        if pipeline > 0:
            import queue
            import threading
            apply_q = queue.Queue(maxsize=pipeline)

            def apply_loop():
                while True:
                    item = apply_q.get()
                    if item is None:
                        return
                    self.ingest_columns(*item)

            apply_thread = threading.Thread(target=apply_loop, daemon=True)
            apply_thread.start()
        # Coordination TX cadences (ref broadcasts ZONE every 2 s,
        # dual_bot_mapper.py:921-945, and would send TARG every 3 s via the
        # commented-out block :959-996).
        last_zone_send = -1e30
        last_target_send = -1e30
        run_t0 = time.time()
        pkt_at_start = self.pkt_total
        try:
            # duration is measured from run() start, not server __init__ —
            # the warm-up compile can exceed a short duration budget
            while duration_s is None or time.time() - run_t0 < duration_s:
                start = time.time()
                if apply_q is not None:
                    agents0, cols = self.drain_columns()
                    if len(agents0):
                        apply_q.put((agents0, cols))
                else:
                    self.drain_ingest()
                self.heartbeat_transitions()
                now = self.now()
                if now - last_zone_send >= self.cfg.coord.zone_interval_s:
                    self.send_zones()
                    last_zone_send = now
                if (self.enable_targets and now - last_target_send
                        >= self.cfg.coord.target_interval_s):
                    self.send_targets()
                    last_target_send = now
                if render_png and self.now() - last_render > render_every_s:
                    self.render(render_png)
                    last_render = self.now()
                lag = frame_dt - (time.time() - start)
                if lag > 0:
                    time.sleep(lag)
        except KeyboardInterrupt:
            pass
        finally:
            if apply_q is not None:
                apply_q.put(None)             # drain queued frames, then stop
                apply_thread.join(timeout=30.0)
            # throughput over the run window only (excludes the warm-up
            # compile in __init__ and any idle time before run())
            el = max(time.time() - run_t0, 1e-9)
            got = self.pkt_total - pkt_at_start
            print(f"[SERVER] {got} packets in {el:.1f}s "
                  f"({got / el:.0f} pkt/s)")
            self.close()

    # -- interactive view ----------------------------------------------------

    def view_snapshot(self):
        """Numpy state snapshot for server.view.MapView (the reference's
        live dashboard state, dual_bot_mapper.py:380-668)."""
        from swarm_tpu.coord.heartbeat import heartbeat_update

        st = self.state
        online = np.asarray(heartbeat_update(
            st.last_packet_t, self.now(),
            self.cfg.coord.heartbeat_timeout_s))
        poses = np.concatenate(
            [np.asarray(st.agent_xy),
             np.asarray(st.agent_yaw)[:, None]], axis=1)
        snap = {
            "grid": np.asarray(st.grid),
            "resolution": self.cfg.grid.resolution,
            "origin": (self.cfg.grid.origin_x, self.cfg.grid.origin_y),
            "poses": poses,
            "online": online,
            "pkt_counts": np.asarray(st.pkt_counts),
            "zones": np.asarray(st.zone_boxes),
            "zone_active": np.asarray(st.zone_active),
            "frontiers": np.asarray(st.frontier_centroids),
            "n_frontiers": int(st.n_frontiers),
            "closures": int(st.closure.cl_count),
            "pkt_total": self.pkt_total,
            "t": self.now(),
        }
        if self._trails is not None:
            # live per-sensor clouds + paths (dual_bot_mapper.py:560-583)
            snap.update(self._trails.snapshot_layers())
        return snap

    def start_view(self, port: int = 8800, bind: str = "127.0.0.1"):
        """Launch the HTTP operator view (zoom/pan/HUD + per-sensor
        clouds and paths) on a daemon thread; the ingest loop is
        untouched."""
        from swarm_tpu.server.view import MapView

        self._trails = ViewTrails()
        self._view = MapView(self.view_snapshot, port=port,
                             bind=bind).start()
        return self._view

    def render(self, path: str) -> str:
        from swarm_tpu.render import render_map, save_png

        img = render_map(self.state.grid, self.cfg.grid, scale=4,
                         zones=self.state.zone_boxes,
                         zones_active=self.state.zone_active,
                         frontiers=self.state.frontier_centroids,
                         n_frontiers=self.state.n_frontiers)
        return save_png(img, path)

    def close(self):
        if self.writer:
            cl = self.state.closure
            n_cl = int(cl.cl_count)
            self.writer.close(closures=(
                np.asarray(cl.cl_lm_node)[:n_cl],
                np.asarray(cl.cl_node)[:n_cl],
                np.asarray(cl.cl_dx)[:n_cl],
                np.asarray(cl.cl_dy)[:n_cl]))
            self.writer = None
        self.sock.close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Live UDP swarm mapping server "
                    "(dual_bot_mapper.py equivalent)")
    ap.add_argument("--port", type=int, default=8888)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--separation", type=float, default=5.0)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--enable-targets", action="store_true")
    ap.add_argument("--render-png", default=None)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--max-packets", type=int, default=None,
                    help="datagrams drained per frame (reference budget: 20, "
                         "dual_bot_mapper.py:816; raise for >600 pkt/s "
                         "ingest — the batched ingest absorbs it)")
    ap.add_argument("--fps", type=float, default=30.0,
                    help="frame-rate cap (reference renders at 30 FPS, "
                         ":474); ingest ceiling = fps x max-packets")
    ap.add_argument("--ingest-mode", default="parity",
                    choices=["parity", "throughput"],
                    help="parity = per-packet ordered scan (reference "
                         "drop-in); throughput = one fused application "
                         "per frame (order-exact grid, frame-coarse "
                         "closure timing) for swarm packet rates")
    ap.add_argument("--no-native-codec", action="store_true",
                    help="parse datagrams with the per-packet Python "
                         "struct codec instead of the native C++ batch "
                         "codec (native/src/codec.cpp, ~8x faster)")
    ap.add_argument("--view", type=int, nargs="?", const=8800, default=None,
                    metavar="PORT",
                    help="serve the interactive operator view (zoom/pan/"
                         "HUD — the reference's PyGame dashboard, "
                         "dual_bot_mapper.py:380-668) at this HTTP port")
    ap.add_argument("--view-bind", default="127.0.0.1",
                    help="view bind address (loopback by default; set "
                         "0.0.0.0 to expose deliberately)")
    ap.add_argument("--pipeline", type=int, default=0, metavar="DEPTH",
                    help="apply frames on a worker thread behind a "
                         "bounded queue of this depth, overlapping the "
                         "next frame's socket drain with the in-flight "
                         "device dispatch; 0 = sequential")
    ap.add_argument("--closure-scanmatch", action="store_true",
                    help="scan-match fired closures against the stored "
                         "landmark sweeps (throughput mode; 751/743 B "
                         "scan payloads feed the sweep table) — the "
                         "closure log then carries measured SE(2) edges "
                         "for the offline refiners (slam/joint.py)")
    args = ap.parse_args(argv)
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    cfg = SwarmConfig(n_agents=args.agents)
    import dataclasses
    if args.max_packets:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, max_packets_per_frame=args.max_packets))
    if args.closure_scanmatch:
        cfg = cfg.replace(
            engine=dataclasses.replace(cfg.engine, scan_rays=181),
            slam=dataclasses.replace(cfg.slam, closure_scanmatch=True))
    srv = LiveServer(cfg, port=args.port, separation=args.separation,
                     log_dir=args.log_dir, enable_targets=args.enable_targets,
                     native_codec=not args.no_native_codec,
                     ingest_mode=args.ingest_mode)
    print(f"[SERVER] listening on 0.0.0.0:{args.port} "
          f"({args.agents} agents, separation {args.separation})")
    if args.view is not None:
        srv.start_view(args.view, bind=args.view_bind)
    srv.run(duration_s=args.duration, fps=args.fps,
            render_png=args.render_png, pipeline=args.pipeline)


if __name__ == "__main__":
    main()

"""Live-serving throughput benchmark: packets/second
through the REAL server loop — UDP socket -> recvmmsg drain -> native C++
batch codec -> one fused jitted frame application per frame — with the
frame work running on whatever device JAX resolves (one device dispatch
per frame, amortized over the whole batch, like bench.py's chunked
rollouts).

A blaster thread saturates the loopback socket with QuasarPacket v2
telemetry (42 B, dual_bot_mapper.py:41-42) from synthetic agents walking
noisy circles; the server runs its normal `run()` loop uncapped
(fps=0). Reference design budget: <= 20 pkts/frame x 30 FPS = 600 pkt/s
(dual_bot_mapper.py:816, :474).

Usage: python tools/bench_serve.py [--duration 10] [--agents 64]
       [--platform cpu] [--ingest-mode throughput]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _packet_ring(n_agents: int):
    """4096 pre-packed v2 telemetry packets from synthetic agents
    walking noisy circles."""
    rng = np.random.default_rng(0)
    fmt = struct.Struct("<4sBfffiIffffB")
    ring = []
    for k in range(4096):
        a = int(k % n_agents)
        t = k * 0.05
        x = 2.0 + np.cos(t + a) * 1.5
        y = 1.5 + np.sin(t + a) * 1.0
        ring.append(fmt.pack(
            b"QSRL", a + 1, np.float32(x), np.float32(y),
            np.float32((t + a) % 6.28 - 3.14), k, 0,
            np.float32(rng.uniform(0.1, 1.1)),
            np.float32(rng.uniform(0.1, 1.1)),
            np.float32(rng.uniform(0.1, 1.1)),
            np.float32(rng.uniform(0.1, 1.1)), 0))
    return ring


def blaster(port: int, n_agents: int, stop: threading.Event,
            sent_box: list):
    """Python-sendto fallback blaster (~5-10 us interpreter time per
    packet — on a single-core host this steals roughly half the CPU from
    the server under test; prefer the native sendmmsg blaster)."""
    ring = _packet_ring(n_agents)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    addr = ("127.0.0.1", port)
    sent = 0
    i = 0
    while not stop.is_set():
        try:
            s.sendto(ring[i & 4095], addr)
            sent += 1
        except OSError:
            time.sleep(0.001)
        i += 1
    sent_box.append(sent)
    s.close()


def native_blaster(port: int, n_agents: int, stop_flag, stop_event,
                   sent_box: list, fellback: list,
                   burst: int, sleep_us: int):
    """sendmmsg blaster (native.blast_udp_ring): ~1 us/packet and the
    inter-burst usleep yields the core to the server, so the measured
    pkt/s reflects the server, not the load generator.

    blast_udp returns -1 on socket()/connect() failure; without the
    check the benchmark would report packets_sent: -1 and proceed
    measuring ZERO offered load (advisor r3 finding) — fall back to the
    Python sendto blaster instead and record that it happened."""
    from swarm_tpu import native
    sent = native.blast_udp_ring(
        port, _packet_ring(n_agents), stop_flag,
        burst=burst, sleep_us=sleep_us)
    if sent < 0:
        print("[BENCH] native blaster socket/connect failed; falling "
              "back to the Python sendto blaster", flush=True)
        fellback.append(True)
        blaster(port, n_agents, stop_event, sent_box)
        return
    sent_box.append(sent)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--ingest-mode", default="throughput",
                    choices=["parity", "throughput"])
    ap.add_argument("--max-packets", type=int, default=2048)
    ap.add_argument("--no-native-codec", action="store_true")
    ap.add_argument("--python-blaster", action="store_true",
                    help="use the legacy Python sendto loop as the load "
                         "generator instead of the native sendmmsg one")
    ap.add_argument("--blast-burst", type=int, default=64)
    ap.add_argument("--blast-sleep-us", type=int, default=500,
                    help="native blaster inter-burst usleep; paces the "
                         "offered load (burst/sleep ~ 128k pkt/s at the "
                         "defaults) and yields the core to the server")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="frame-application pipeline depth (see "
                         "server.live.LiveServer.run); overlaps the "
                         "device dispatch with the next frame's drain")
    args = ap.parse_args()
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from swarm_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import dataclasses

    from swarm_tpu.config import SwarmConfig
    from swarm_tpu.server.live import LiveServer

    cfg = SwarmConfig(n_agents=args.agents)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, max_packets_per_frame=args.max_packets))

    # ephemeral port: bind 0, read it back
    srv = LiveServer(cfg, port=0, separation=2.0,
                     ingest_mode=args.ingest_mode,
                     native_codec=not args.no_native_codec)
    port = srv.sock.getsockname()[1]
    platform = jax.devices()[0].platform
    print(f"[BENCH] serving on 127.0.0.1:{port} platform={platform} "
          f"mode={args.ingest_mode} codec="
          f"{'native' if srv._native else 'python'}", flush=True)

    import ctypes

    sent_box: list = []
    use_native_blast = not args.python_blaster
    if use_native_blast:
        try:
            from swarm_tpu import native
            native.get_lib()  # build before the timed window
        except Exception as e:  # pragma: no cover - non-linux fallback
            print(f"[BENCH] native blaster unavailable ({e}); "
                  f"falling back to Python sendto", flush=True)
            use_native_blast = False
    stop = threading.Event()
    stop_flag = ctypes.c_int32(0)
    fellback: list = []
    if use_native_blast:
        tx = threading.Thread(
            target=native_blaster,
            args=(port, args.agents, stop_flag, stop, sent_box, fellback,
                  args.blast_burst, args.blast_sleep_us),
            daemon=True)
    else:
        tx = threading.Thread(target=blaster,
                              args=(port, args.agents, stop, sent_box),
                              daemon=True)
    tx.start()
    t0 = time.time()
    srv.run(duration_s=args.duration, fps=0.0, pipeline=args.pipeline)
    dt = time.time() - t0
    stop.set()
    stop_flag.value = 1
    tx.join(timeout=2.0)
    got = srv.pkt_total
    print(json.dumps({
        "metric": "serve_pkt_per_s",
        "value": round(got / dt, 1),
        "unit": "pkt/s",
        "vs_reference_budget": round(got / dt / 600.0, 1),
        "detail": {
            "platform": platform,
            "ingest_mode": args.ingest_mode,
            "native_codec": srv._native is not None,
            "agents": args.agents,
            "duration_s": round(dt, 2),
            "packets_applied": got,
            "packets_sent": sent_box[0] if sent_box else None,
            "blaster": ("python_sendto_fallback" if fellback
                        else "native_sendmmsg" if use_native_blast
                        else "python_sendto"),
            "max_packets_per_frame": args.max_packets,
            "pipeline": args.pipeline,
        },
    }))


if __name__ == "__main__":
    main()

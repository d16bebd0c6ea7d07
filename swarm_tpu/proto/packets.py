"""Quasar-Lite v2 wire protocol: binary packet layouts + batch codecs.

The reference defines these structs twice — C structs in the firmware
(AgentFirmware_Bot1/AgentFirmware_Bot1.ino:65-69, 84-88, 172-185) and
Python `struct` format strings on the server (server_nodes/
dual_bot_mapper.py:40-54, udp_bridge.py:34-38, udp_receiver_standalone.py:15).
Here each layout exists once, as a packed numpy structured dtype, giving
both a scalar codec (drop-in for `struct.pack/unpack`) and a ZERO-COPY
batch codec: a [B]-packet byte buffer views as a structured array whose
columns feed the engine's batched ingest directly — the batched
replacement for the reference's per-packet `struct.unpack` loop
(dual_bot_mapper.py:827-838).

Layouts (little-endian, packed):
  QuasarPacket v2  'QSRL' <4sBfffiIffffB  42 B  bot -> server telemetry
  QuasarPacket v1  'QSRL' <4sBfffiIffff   41 B  (no landmark byte)
  Scan packet      'QSRL' <4sBfffiIH181f 751 B  181-ray servo sweep
  Scan (bridge)    'QSRL' <4sBfffH181f   743 B  udp_bridge.py variant
  ZonePacket       'ZONE' <4sffff         20 B  server -> bot forbidden AABB
  TargetPacket     'TARG' <4sff           12 B  server -> bot frontier goal
  CommandPacket    'CMD1' <4sff           12 B  server -> bot cmd_vel
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Union

import numpy as np

MAGIC_TELEMETRY = b"QSRL"
MAGIC_ZONE = b"ZONE"
MAGIC_TARGET = b"TARG"
MAGIC_COMMAND = b"CMD1"

PACKET_FMT_V2 = "<4sBfffiIffffB"      # dual_bot_mapper.py:41
PACKET_FMT_V1 = "<4sBfffiIffff"       # dual_bot_mapper.py:45
SCAN_FMT = "<4sBfffiIH181f"           # udp_receiver_standalone.py:15
SCAN_FMT_BRIDGE = "<4sBfffH181f"      # udp_bridge.py:34
ZONE_FMT = "<4sffff"                  # dual_bot_mapper.py:49
TARGET_FMT = "<4sff"                  # dual_bot_mapper.py:53
CMD_FMT = "<4sff"                     # udp_bridge.py:37

PACKET_SIZE_V2 = struct.calcsize(PACKET_FMT_V2)        # 42
PACKET_SIZE_V1 = struct.calcsize(PACKET_FMT_V1)        # 41
SCAN_SIZE = struct.calcsize(SCAN_FMT)                  # 751
SCAN_SIZE_BRIDGE = struct.calcsize(SCAN_FMT_BRIDGE)    # 743
ZONE_SIZE = struct.calcsize(ZONE_FMT)                  # 20
TARGET_SIZE = struct.calcsize(TARGET_FMT)              # 12
CMD_SIZE = struct.calcsize(CMD_FMT)                    # 12

# Packed structured dtypes (align=False == struct '<' semantics).
DTYPE_V2 = np.dtype([
    ("magic", "S4"), ("agent", "u1"),
    ("x", "<f4"), ("y", "<f4"), ("yaw", "<f4"),
    ("encoder", "<i4"), ("v2v", "<u4"),
    ("front", "<f4"), ("left", "<f4"), ("back", "<f4"), ("right", "<f4"),
    ("landmark", "u1")])
DTYPE_V1 = np.dtype([
    ("magic", "S4"), ("agent", "u1"),
    ("x", "<f4"), ("y", "<f4"), ("yaw", "<f4"),
    ("encoder", "<i4"), ("v2v", "<u4"),
    ("front", "<f4"), ("left", "<f4"), ("back", "<f4"), ("right", "<f4")])
DTYPE_SCAN = np.dtype([
    ("magic", "S4"), ("agent", "u1"),
    ("x", "<f4"), ("y", "<f4"), ("yaw", "<f4"),
    ("encoder", "<i4"), ("v2v", "<u4"),
    ("n_rays", "<u2"), ("ranges", "<f4", (181,))])
DTYPE_SCAN_BRIDGE = np.dtype([
    ("magic", "S4"), ("agent", "u1"),
    ("x", "<f4"), ("y", "<f4"), ("yaw", "<f4"),
    ("n_rays", "<u2"), ("ranges", "<f4", (181,))])
DTYPE_ZONE = np.dtype([
    ("magic", "S4"), ("min_x", "<f4"), ("min_y", "<f4"),
    ("max_x", "<f4"), ("max_y", "<f4")])
DTYPE_TARGET = np.dtype([("magic", "S4"), ("x", "<f4"), ("y", "<f4")])
DTYPE_CMD = np.dtype([("magic", "S4"), ("linear_x", "<f4"),
                      ("angular_z", "<f4")])

assert DTYPE_V2.itemsize == PACKET_SIZE_V2
assert DTYPE_V1.itemsize == PACKET_SIZE_V1
assert DTYPE_SCAN.itemsize == SCAN_SIZE
assert DTYPE_SCAN_BRIDGE.itemsize == SCAN_SIZE_BRIDGE
assert DTYPE_ZONE.itemsize == ZONE_SIZE


class QuasarPacketV2(NamedTuple):
    """Telemetry v2 (AgentFirmware_Bot1.ino:172-185). Distances in metres,
    yaw radians, agent 1-based on the wire."""
    agent: int
    x: float
    y: float
    yaw: float
    encoder: int
    v2v: int
    front: float
    left: float
    back: float
    right: float
    landmark: int

    def pack(self) -> bytes:
        return struct.pack(PACKET_FMT_V2, MAGIC_TELEMETRY, self.agent,
                           self.x, self.y, self.yaw, self.encoder, self.v2v,
                           self.front, self.left, self.back, self.right,
                           self.landmark)

    @classmethod
    def unpack(cls, data: bytes) -> "QuasarPacketV2":
        u = struct.unpack(PACKET_FMT_V2, data)
        if u[0] != MAGIC_TELEMETRY:
            raise ValueError(f"bad magic {u[0]!r}")
        return cls(*u[1:])


class QuasarPacketV1(NamedTuple):
    """Telemetry v1 (AgentFirmware.ino.ino:69-82) — no landmark byte."""
    agent: int
    x: float
    y: float
    yaw: float
    encoder: int
    v2v: int
    front: float
    left: float
    back: float
    right: float

    def pack(self) -> bytes:
        return struct.pack(PACKET_FMT_V1, MAGIC_TELEMETRY, self.agent,
                           self.x, self.y, self.yaw, self.encoder, self.v2v,
                           self.front, self.left, self.back, self.right)

    @classmethod
    def unpack(cls, data: bytes) -> "QuasarPacketV1":
        u = struct.unpack(PACKET_FMT_V1, data)
        if u[0] != MAGIC_TELEMETRY:
            raise ValueError(f"bad magic {u[0]!r}")
        return cls(*u[1:])


class ScanPacket(NamedTuple):
    """181-ray servo sweep (esp32_firmware/src/main.cpp:30-41)."""
    agent: int
    x: float
    y: float
    yaw: float
    encoder: int
    v2v: int
    ranges: np.ndarray    # [181] metres, -90..+90 deg

    def pack(self) -> bytes:
        return struct.pack(SCAN_FMT, MAGIC_TELEMETRY, self.agent,
                           self.x, self.y, self.yaw, self.encoder, self.v2v,
                           len(self.ranges), *np.asarray(self.ranges, np.float32))

    @classmethod
    def unpack(cls, data: bytes) -> "ScanPacket":
        u = struct.unpack(SCAN_FMT, data)
        if u[0] != MAGIC_TELEMETRY:
            raise ValueError(f"bad magic {u[0]!r}")
        return cls(agent=u[1], x=u[2], y=u[3], yaw=u[4], encoder=u[5],
                   v2v=u[6], ranges=np.asarray(u[8:], np.float32))


class ScanPacketBridge(NamedTuple):
    """181-ray scan, bridge layout '<4sBfffH181f' (udp_bridge.py:34) —
    the QuasarPacket the esp32 PlatformIO firmware actually transmits
    (esp32_firmware/src/main.cpp:30-41): no encoder/v2v fields."""
    agent: int
    x: float
    y: float
    yaw: float
    ranges: np.ndarray    # [181] metres, -90..+90 deg

    # Field-compatibility with ScanPacket consumers (CSV logger columns
    # default to 0, per the standalone receiver's schema).
    @property
    def encoder(self) -> int:
        return 0

    @property
    def v2v(self) -> int:
        return 0

    def pack(self) -> bytes:
        return struct.pack(SCAN_FMT_BRIDGE, MAGIC_TELEMETRY, self.agent,
                           self.x, self.y, self.yaw, len(self.ranges),
                           *np.asarray(self.ranges, np.float32))

    @classmethod
    def unpack(cls, data: bytes) -> "ScanPacketBridge":
        u = struct.unpack(SCAN_FMT_BRIDGE, data)
        if u[0] != MAGIC_TELEMETRY:
            raise ValueError(f"bad magic {u[0]!r}")
        return cls(agent=u[1], x=u[2], y=u[3], yaw=u[4],
                   ranges=np.asarray(u[6:], np.float32))


class ZonePacket(NamedTuple):
    """Forbidden-territory AABB; (999, 999, -999, -999) lifts the zone
    (dual_bot_mapper.py:675-688; AgentFirmware_Bot1.ino:110-125)."""
    min_x: float
    min_y: float
    max_x: float
    max_y: float

    LIFT = (999.0, 999.0, -999.0, -999.0)

    def pack(self) -> bytes:
        return struct.pack(ZONE_FMT, MAGIC_ZONE, self.min_x, self.min_y,
                           self.max_x, self.max_y)

    @classmethod
    def unpack(cls, data: bytes) -> "ZonePacket":
        u = struct.unpack(ZONE_FMT, data)
        if u[0] != MAGIC_ZONE:
            raise ValueError(f"bad magic {u[0]!r}")
        return cls(*u[1:])

    @property
    def lifted(self) -> bool:
        # firmware treats min_x > 900 as the lift sentinel (ino:117)
        return self.min_x > 900.0


class TargetPacket(NamedTuple):
    """Frontier waypoint (dual_bot_mapper.py:691-699)."""
    x: float
    y: float

    def pack(self) -> bytes:
        return struct.pack(TARGET_FMT, MAGIC_TARGET, self.x, self.y)

    @classmethod
    def unpack(cls, data: bytes) -> "TargetPacket":
        u = struct.unpack(TARGET_FMT, data)
        if u[0] != MAGIC_TARGET:
            raise ValueError(f"bad magic {u[0]!r}")
        return cls(*u[1:])


class CommandPacket(NamedTuple):
    """cmd_vel relay (udp_bridge.py:140-148; esp32_firmware/src/main.cpp:43-47)."""
    linear_x: float
    angular_z: float

    def pack(self) -> bytes:
        return struct.pack(CMD_FMT, MAGIC_COMMAND, self.linear_x,
                           self.angular_z)

    @classmethod
    def unpack(cls, data: bytes) -> "CommandPacket":
        u = struct.unpack(CMD_FMT, data)
        if u[0] != MAGIC_COMMAND:
            raise ValueError(f"bad magic {u[0]!r}")
        return cls(*u[1:])


AnyPacket = Union[QuasarPacketV2, QuasarPacketV1, ScanPacket,
                  ScanPacketBridge, ZonePacket, TargetPacket, CommandPacket]


def parse_packet(data: bytes) -> Optional[AnyPacket]:
    """Size+magic dispatch, the way the server does it
    (dual_bot_mapper.py:827-838: v2 by size 42, v1 by size 41).
    Returns None for unrecognised datagrams (the server's silent skip)."""
    n = len(data)
    try:
        if n == PACKET_SIZE_V2:
            return QuasarPacketV2.unpack(data)
        if n == PACKET_SIZE_V1:
            return QuasarPacketV1.unpack(data)
        if n == SCAN_SIZE:
            return ScanPacket.unpack(data)
        if n == SCAN_SIZE_BRIDGE:
            return ScanPacketBridge.unpack(data)
        if n == ZONE_SIZE:
            return ZonePacket.unpack(data)
        if n == TARGET_SIZE == CMD_SIZE:
            magic = data[:4]
            if magic == MAGIC_TARGET:
                return TargetPacket.unpack(data)
            if magic == MAGIC_COMMAND:
                return CommandPacket.unpack(data)
    except (struct.error, ValueError):
        return None
    return None


# ---------------------------------------------------------------------------
# Batch codecs — zero-copy structured-array views for the batched engine.
# ---------------------------------------------------------------------------

def unpack_quasar_batch(buf: bytes, version: int = 2) -> np.ndarray:
    """View a concatenated byte buffer of B same-version telemetry packets
    as a structured array [B]. Zero copy; columns feed PacketStream /
    the batched ingest directly."""
    dt = DTYPE_V2 if version == 2 else DTYPE_V1
    if len(buf) % dt.itemsize:
        raise ValueError(f"buffer {len(buf)} B not a multiple of "
                         f"{dt.itemsize} B")
    arr = np.frombuffer(buf, dtype=dt)
    if not (arr["magic"] == MAGIC_TELEMETRY).all():
        raise ValueError("bad magic in batch")
    return arr


def pack_quasar_v2_batch(agent, x, y, yaw, encoder, v2v, dist4,
                         landmark) -> bytes:
    """Pack [B] telemetry arrays into B wire packets (one buffer).

    agent: [B] 1-based ids; dist4: [B, 4] metres (front, left, back, right).
    """
    b = len(np.atleast_1d(agent))
    out = np.empty(b, DTYPE_V2)
    out["magic"] = MAGIC_TELEMETRY
    out["agent"] = np.asarray(agent, np.uint8)
    out["x"] = np.asarray(x, np.float32)
    out["y"] = np.asarray(y, np.float32)
    out["yaw"] = np.asarray(yaw, np.float32)
    out["encoder"] = np.asarray(encoder, np.int32)
    out["v2v"] = np.asarray(v2v, np.uint32)
    d = np.asarray(dist4, np.float32).reshape(b, 4)
    out["front"], out["left"] = d[:, 0], d[:, 1]
    out["back"], out["right"] = d[:, 2], d[:, 3]
    out["landmark"] = np.asarray(landmark, np.uint8)
    return out.tobytes()

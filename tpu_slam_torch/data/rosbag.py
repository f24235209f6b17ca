"""Pure-Python rosbag (v2.0) reader for the lesson bags — the port's copy
of ``tpu_slam/data/rosbag.py`` (struct, bz2 and numpy only).

Replaces the reference's L0 transport (rosbag replay + rostopic pub/sub,
SURVEY §1): the lesson workloads are driven by `rosbag play` of
`lesson1.bag` / `lesson3.bag` / `lesson5.bag` (`lesson1/launch/demo.launch`,
README.md:38-40; the bags themselves are not shipped in the reference
checkout — see `.MISSING_LARGE_BLOBS`). This reader parses the bag format
directly (no ROS dependency) and deserializes the three message types the
pipelines consume: sensor_msgs/LaserScan, sensor_msgs/Imu, nav_msgs/Odometry.

Supports uncompressed and bz2 chunks (lesson bags use the default bz2).
Format: http://wiki.ros.org/Bags/Format/2.0
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Callable, Iterator

import numpy as np

_OP_BAG_HEADER = 0x03
_OP_CHUNK = 0x05
_OP_CONNECTION = 0x07
_OP_MSG_DATA = 0x02
_OP_INDEX_DATA = 0x04
_OP_CHUNK_INFO = 0x06


def _read_header(data: bytes) -> dict[str, bytes]:
    out = {}
    o = 0
    while o < len(data):
        (flen,) = struct.unpack_from("<I", data, o)
        o += 4
        field = data[o : o + flen]
        o += flen
        k, _, v = field.partition(b"=")
        out[k.decode()] = v
    return out


def _records(data: bytes) -> Iterator[tuple[dict, bytes]]:
    o = 0
    n = len(data)
    while o + 8 <= n:
        (hlen,) = struct.unpack_from("<I", data, o)
        o += 4
        header = _read_header(data[o : o + hlen])
        o += hlen
        (dlen,) = struct.unpack_from("<I", data, o)
        o += 4
        yield header, data[o : o + dlen]
        o += dlen


@dataclasses.dataclass
class Connection:
    topic: str
    msg_type: str
    md5: str


@dataclasses.dataclass
class BagMessage:
    topic: str
    msg_type: str
    stamp: float  # receive time (sec)
    raw: bytes


class _Reader:
    """Sequential deserializer over a serialized ROS message body."""

    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u32(self):
        (v,) = struct.unpack_from("<I", self.d, self.o)
        self.o += 4
        return v

    def i32(self):
        (v,) = struct.unpack_from("<i", self.d, self.o)
        self.o += 4
        return v

    def f32(self):
        (v,) = struct.unpack_from("<f", self.d, self.o)
        self.o += 4
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.d, self.o)
        self.o += 8
        return v

    def time(self):
        sec, nsec = struct.unpack_from("<II", self.d, self.o)
        self.o += 8
        return sec + nsec * 1e-9

    def string(self):
        n = self.u32()
        s = self.d[self.o : self.o + n].decode(errors="replace")
        self.o += n
        return s

    def f32_array(self):
        n = self.u32()
        a = np.frombuffer(self.d, "<f4", count=n, offset=self.o)
        self.o += 4 * n
        return a

    def f64_fixed(self, n):
        a = np.frombuffer(self.d, "<f8", count=n, offset=self.o)
        self.o += 8 * n
        return a

    def header(self):
        self.u32()  # seq
        t = self.time()
        frame = self.string()
        return t, frame


def parse_laser_scan(raw: bytes) -> dict:
    """sensor_msgs/LaserScan → dict (the fields LaserScanToLDP and the
    converter nodes read, scan_to_pointclod2_converter.cc:44-92)."""
    r = _Reader(raw)
    stamp, frame = r.header()
    out = {
        "stamp": stamp,
        "frame_id": frame,
        "angle_min": r.f32(),
        "angle_max": r.f32(),
        "angle_increment": r.f32(),
        "time_increment": r.f32(),
        "scan_time": r.f32(),
        "range_min": r.f32(),
        "range_max": r.f32(),
        "ranges": r.f32_array(),
        "intensities": r.f32_array(),
    }
    return out


def parse_imu(raw: bytes) -> dict:
    """sensor_msgs/Imu → dict (lesson5 uses orientation + angular velocity,
    lidar_undistortion.cc:177-243)."""
    r = _Reader(raw)
    stamp, frame = r.header()
    quat = r.f64_fixed(4)  # x y z w
    r.f64_fixed(9)
    gyro = r.f64_fixed(3)
    r.f64_fixed(9)
    accel = r.f64_fixed(3)
    r.f64_fixed(9)
    yaw = np.arctan2(
        2.0 * (quat[3] * quat[2] + quat[0] * quat[1]),
        1.0 - 2.0 * (quat[1] ** 2 + quat[2] ** 2),
    )
    return {
        "stamp": stamp,
        "frame_id": frame,
        "orientation": quat,
        "yaw": float(yaw),
        "angular_velocity": gyro,
        "linear_acceleration": accel,
    }


def parse_odometry(raw: bytes) -> dict:
    """nav_msgs/Odometry → dict (lesson5 wheel odometry,
    lidar_undistortion.cc:252-335)."""
    r = _Reader(raw)
    stamp, frame = r.header()
    child = r.string()
    pos = r.f64_fixed(3)
    quat = r.f64_fixed(4)
    r.f64_fixed(36)  # pose covariance
    lin = r.f64_fixed(3)
    ang = r.f64_fixed(3)
    r.f64_fixed(36)  # twist covariance
    yaw = np.arctan2(
        2.0 * (quat[3] * quat[2] + quat[0] * quat[1]),
        1.0 - 2.0 * (quat[1] ** 2 + quat[2] ** 2),
    )
    return {
        "stamp": stamp,
        "frame_id": frame,
        "child_frame_id": child,
        "pose": np.array([pos[0], pos[1], float(yaw)]),
        "linear_velocity": lin,
        "angular_velocity": ang,
    }


PARSERS: dict[str, Callable[[bytes], dict]] = {
    "sensor_msgs/LaserScan": parse_laser_scan,
    "sensor_msgs/Imu": parse_imu,
    "nav_msgs/Odometry": parse_odometry,
}


def read_bag(path: str, topics: set[str] | None = None) -> Iterator[BagMessage]:
    """Stream messages from a rosbag 2.0 file in chunk order."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a rosbag 2.0 file: {magic!r}")
        data = f.read()

    connections: dict[int, Connection] = {}

    def handle_block(block: bytes) -> Iterator[BagMessage]:
        for h, body in _records(block):
            op = h.get("op", b"\x00")[0]
            if op == _OP_CONNECTION:
                conn_id = struct.unpack("<I", h["conn"])[0]
                fields = _read_header(body)
                connections[conn_id] = Connection(
                    topic=h["topic"].decode(),
                    msg_type=fields.get("type", b"").decode(),
                    md5=fields.get("md5sum", b"").decode(),
                )
            elif op == _OP_MSG_DATA:
                conn_id = struct.unpack("<I", h["conn"])[0]
                sec, nsec = struct.unpack("<II", h["time"])
                conn = connections.get(conn_id)
                if conn is None:
                    continue
                if topics is not None and conn.topic not in topics:
                    continue
                yield BagMessage(
                    topic=conn.topic,
                    msg_type=conn.msg_type,
                    stamp=sec + nsec * 1e-9,
                    raw=body,
                )

    for h, body in _records(data):
        op = h.get("op", b"\x00")[0]
        if op == _OP_CHUNK:
            compression = h.get("compression", b"none")
            if compression == b"bz2":
                body = bz2.decompress(body)
            elif compression not in (b"none", b""):
                raise ValueError(f"unsupported compression {compression!r}")
            yield from handle_block(body)
        elif op in (_OP_CONNECTION, _OP_MSG_DATA):
            # connection/message records outside chunks (unchunked bags)
            for m in handle_block(
                struct.pack("<I", len(_pack_header(h)))
                + _pack_header(h)
                + struct.pack("<I", len(body))
                + body
            ):
                yield m


def _pack_header(h: dict) -> bytes:
    out = b""
    for k, v in h.items():
        field = k.encode() + b"=" + v
        out += struct.pack("<I", len(field)) + field
    return out


def parse_messages(
    path: str, topics: set[str] | None = None
) -> Iterator[tuple[BagMessage, dict]]:
    """read_bag + per-type deserialization for supported types."""
    for msg in read_bag(path, topics):
        parser = PARSERS.get(msg.msg_type)
        if parser is not None:
            yield msg, parser(msg.raw)


def load_scan_array(path: str, topic: str):
    """Bulk-load a LaserScan stream as arrays: (ranges (M, N) f32, stamps
    (M,) f64, meta dict). Prefers the native C++ decoder
    (tpu_slam_torch/native, ts_bag_read_scans — one pass, zero-copy into
    numpy); uses this module's pure-python parser when the native library
    is unavailable, as the reference does (host decoding; the device is
    not involved). This is the L0 data-loader feeding device tensors
    (rosbag play → host pipeline, SURVEY §1)."""
    from tpu_slam_torch import native

    out = native.bag_read_scans(path, topic)
    if out is not None:
        return out
    ranges, stamps, meta = [], [], None
    for msg, parsed in parse_messages(path, {topic}):
        if msg.msg_type != "sensor_msgs/LaserScan":
            continue
        ranges.append(parsed["ranges"])
        stamps.append(parsed["stamp"])
        if meta is None:
            meta = {
                k: float(parsed[k])
                for k in (
                    "angle_min", "angle_max", "angle_increment",
                    "time_increment", "scan_time", "range_min", "range_max",
                )
            }
    if not ranges:
        return np.zeros((0, 0), np.float32), np.zeros(0), {}
    n = max(len(r) for r in ranges)
    arr = np.full((len(ranges), n), np.inf, np.float32)
    for i, r in enumerate(ranges):
        arr[i, : len(r)] = r
    return arr, np.asarray(stamps, np.float64), meta


def write_bag(
    path: str,
    messages: list[tuple[str, str, float, bytes]],
    compression: str = "none",
) -> None:
    """Minimal rosbag 2.0 writer (topic, type, stamp, raw body) with one
    chunk, optionally bz2-compressed like the lesson bags.

    Exists so the reader is testable without the missing lesson bags and so
    simulated sequences can be exported in bag form.
    """
    conns: dict[tuple[str, str], int] = {}
    out = bytearray(b"#ROSBAG V2.0\n")

    def rec(h: dict, body: bytes):
        hp = _pack_header(h)
        out.extend(struct.pack("<I", len(hp)))
        out.extend(hp)
        out.extend(struct.pack("<I", len(body)))
        out.extend(body)

    rec(
        {
            "op": bytes([_OP_BAG_HEADER]),
            "index_pos": struct.pack("<Q", 0),
            "conn_count": struct.pack("<I", 0),
            "chunk_count": struct.pack("<I", 0),
        },
        b"\x20" * 4096,  # header padding per format spec
    )
    # chunk containing everything, uncompressed
    chunk = bytearray()

    def crec(h: dict, body: bytes):
        hp = _pack_header(h)
        chunk.extend(struct.pack("<I", len(hp)))
        chunk.extend(hp)
        chunk.extend(struct.pack("<I", len(body)))
        chunk.extend(body)

    for topic, msg_type, stamp, raw in messages:
        key = (topic, msg_type)
        if key not in conns:
            cid = len(conns)
            conns[key] = cid
            crec(
                {
                    "op": bytes([_OP_CONNECTION]),
                    "conn": struct.pack("<I", cid),
                    "topic": topic.encode(),
                },
                _pack_header(
                    {"topic": topic.encode(), "type": msg_type.encode(),
                     "md5sum": b"*"}
                ),
            )
        sec = int(stamp)
        nsec = int((stamp - sec) * 1e9)
        crec(
            {
                "op": bytes([_OP_MSG_DATA]),
                "conn": struct.pack("<I", conns[key]),
                "time": struct.pack("<II", sec, nsec),
            },
            raw,
        )
    payload = bytes(chunk)
    if compression == "bz2":
        payload = bz2.compress(payload)
    elif compression != "none":
        raise ValueError(f"unsupported compression {compression!r}")
    rec(
        {
            "op": bytes([_OP_CHUNK]),
            "compression": compression.encode(),
            "size": struct.pack("<I", len(chunk)),
        },
        payload,
    )
    with open(path, "wb") as f:
        f.write(out)


def _ser_header(stamp: float, frame: str) -> bytes:
    out = bytearray(struct.pack("<I", 0))  # seq
    sec = int(stamp)
    out.extend(struct.pack("<II", sec, int((stamp - sec) * 1e9)))
    f = frame.encode()
    out.extend(struct.pack("<I", len(f)) + f)
    return bytes(out)


def _yaw_quat(yaw: float) -> np.ndarray:
    return np.array([0.0, 0.0, np.sin(yaw / 2.0), np.cos(yaw / 2.0)])


def serialize_imu(stamp: float, yaw: float, gyro, frame="imu") -> bytes:
    """Inverse of parse_imu (orientation from yaw, zero covariances)."""
    out = bytearray(_ser_header(stamp, frame))
    out.extend(_yaw_quat(yaw).astype("<f8").tobytes())
    out.extend(np.zeros(9, "<f8").tobytes())
    out.extend(np.asarray(gyro, "<f8").tobytes())
    out.extend(np.zeros(9, "<f8").tobytes())
    out.extend(np.zeros(3, "<f8").tobytes())  # accel
    out.extend(np.zeros(9, "<f8").tobytes())
    return bytes(out)


def serialize_odometry(
    stamp: float, pose, twist=(0.0, 0.0, 0.0), frame="odom", child="base_link"
) -> bytes:
    """Inverse of parse_odometry (pose = (x, y, yaw), twist = (vx, vy, wz))."""
    out = bytearray(_ser_header(stamp, frame))
    c = child.encode()
    out.extend(struct.pack("<I", len(c)) + c)
    out.extend(np.array([pose[0], pose[1], 0.0], "<f8").tobytes())
    out.extend(_yaw_quat(float(pose[2])).astype("<f8").tobytes())
    out.extend(np.zeros(36, "<f8").tobytes())
    out.extend(np.array([twist[0], twist[1], 0.0], "<f8").tobytes())
    out.extend(np.array([0.0, 0.0, twist[2]], "<f8").tobytes())
    out.extend(np.zeros(36, "<f8").tobytes())
    return bytes(out)


def serialize_laser_scan(scan: dict) -> bytes:
    """Inverse of parse_laser_scan (for bag export of simulated data)."""
    out = bytearray()
    out.extend(struct.pack("<I", 0))  # seq
    sec = int(scan["stamp"])
    out.extend(struct.pack("<II", sec, int((scan["stamp"] - sec) * 1e9)))
    frame = scan.get("frame_id", "laser").encode()
    out.extend(struct.pack("<I", len(frame)) + frame)
    for k in (
        "angle_min", "angle_max", "angle_increment", "time_increment",
        "scan_time", "range_min", "range_max",
    ):
        out.extend(struct.pack("<f", float(scan[k])))
    r = np.asarray(scan["ranges"], "<f4")
    out.extend(struct.pack("<I", len(r)) + r.tobytes())
    inten = np.asarray(scan.get("intensities", []), "<f4")
    out.extend(struct.pack("<I", len(inten)) + inten.tobytes())
    return bytes(out)

"""ctypes bindings for the native host-side components — the port's copy
of ``tpu_slam/native/__init__.py``.

``tpu_slam_native.cpp`` (the reference's code, copied) is built with g++
at first use into ``build/tpu_slam_torch_native/`` at the root of the
checkout (git-ignored), under a name that carries a hash of the source,
the flags and the host CPU's features. The flags are the reference's (``-O3 -march=native``): with
others the compiler may contract float32 steps into other fmas, and a
rasterized cell would move against the reference's. ``available()`` says
whether the library built and loaded; when it did not, ``build_error()``
holds the compiler's (or the loader's) message. The host functions that
have a numpy version (``raycast``, ``decimate``) use it when the library
is unavailable, as the reference does; the others raise, or return None
(the bag readers, whose callers then parse the bag in Python).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "tpu_slam_native.cpp"
BUILD_DIR = _DIR.parent.parent / "build" / "tpu_slam_torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False
_error: str | None = None


def _cpu_flags() -> bytes:
    """The host CPU's feature flags, which ``-march=native`` compiles for:
    a library built on another machine is not taken."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    """The library, named by a hash of the source, the flags and the host
    CPU's features."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libtpu_slam_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """g++ into a temporary file, then renamed into place (several
    processes may build at once); the compiler's output is kept in
    ``build_error()`` when it fails."""
    global _error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
            capture_output=True, text=True, timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        _error = f"g++ could not run: {e}"
        return False
    if proc.returncode != 0:
        _error = f"g++ failed ({proc.returncode}):\n{proc.stderr}"
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        _error = f"loading {so} failed: {e}"
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    fp = ctypes.POINTER(ctypes.c_float)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    cs = ctypes.c_char_p
    lib.ts_raycast.argtypes = [dp, i64, dp, dp, i64, ctypes.c_double, dp]
    lib.ts_bresenham_masks.argtypes = [dp, dp, u8, i64, i64, i64, u8, u8]
    lib.ts_decimate.argtypes = [fp, i64, i64, fp]
    lib.ts_bag_count.argtypes = [cs, cs, ctypes.POINTER(i64)]
    lib.ts_bag_count.restype = i64
    lib.ts_bag_read_scans.argtypes = [cs, cs, i64, i64, fp, dp, dp]
    lib.ts_bag_read_scans.restype = i64
    lib.ts_bag_read_imu.argtypes = [cs, cs, i64, dp, dp, dp]
    lib.ts_bag_read_imu.restype = i64
    lib.ts_bag_read_odom.argtypes = [cs, cs, i64, dp, dp, dp]
    lib.ts_bag_read_odom.restype = i64
    i32 = ctypes.POINTER(ctypes.c_int32)
    f32 = ctypes.c_float
    lib.ts_karto_counts.argtypes = [
        fp, fp, fp, i64, i64, f32, f32, f32, i64, i64, f32, f32, f32,
        i32, i32,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the library is unavailable (None when it loaded or was not
    tried yet)."""
    return _error


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def raycast(segments: np.ndarray, origins: np.ndarray, angles: np.ndarray,
            range_max: float) -> np.ndarray:
    """Native batched ray/segment intersection (data/simulator.py's numpy
    version when the library is unavailable)."""
    lib = _load()
    seg = np.ascontiguousarray(segments, np.float64)
    org = np.ascontiguousarray(origins, np.float64)
    ang = np.ascontiguousarray(angles, np.float64)
    if lib is None:
        from tpu_slam_torch.data.simulator import World
        from tpu_slam_torch.data.simulator import raycast as np_raycast

        return np_raycast(World(seg), org, ang, range_max)
    out = np.empty(len(ang), np.float64)
    lib.ts_raycast(_dp(seg), len(seg), _dp(org), _dp(ang), len(ang),
                   float(range_max), _dp(out))
    return out


def bresenham_masks(origin_cell: np.ndarray, end_cells: np.ndarray,
                    valid: np.ndarray, w: int, h: int):
    """Reference-exact Bresenham (free, occ) masks — the golden CPU check
    for ops/gridmap.scan_masks. Requires the native library."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    oc = np.ascontiguousarray(origin_cell, np.float64)
    ec = np.ascontiguousarray(end_cells, np.float64)
    v = np.ascontiguousarray(valid, np.uint8)
    free = np.zeros(w * h, np.uint8)
    occ = np.zeros(w * h, np.uint8)
    lib.ts_bresenham_masks(_dp(oc), _dp(ec), _u8p(v), len(ec), w, h,
                           _u8p(free), _u8p(occ))
    return free.reshape(h, w).astype(bool), occ.reshape(h, w).astype(bool)


def karto_counts(origins: np.ndarray, endpoints: np.ndarray,
                 ranges: np.ndarray, grid_cfg, range_threshold: float,
                 min_range: float = 0.0,
                 max_range: float = np.inf) -> tuple[np.ndarray, np.ndarray]:
    """Whole-mission Karto pass/hit counters (CreateFromScans) on the host.

    EXACT reference semantics (Karto.h:5886-5950), those of
    ops/gridmap.karto_counts_update_scan: Bresenham TraceLine inclusive of
    the endpoint, valid endpoints (r < threshold - 1e-6) double-count pass
    + hit, rays clamped at the threshold, r<=min / r>=max / NaN skipped.
    Returns (pass_cnt, hit_cnt) int32 (H, W)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    org = np.ascontiguousarray(origins, np.float32)
    ends = np.ascontiguousarray(endpoints, np.float32)
    r = np.ascontiguousarray(ranges, np.float32)
    T, N = r.shape
    H, W = grid_cfg.size_y, grid_cfg.size_x
    pc = np.zeros(H * W, np.int32)
    hc = np.zeros(H * W, np.int32)
    lib.ts_karto_counts(
        _fp(org), _fp(ends), _fp(r), T, N,
        float(grid_cfg.resolution), float(grid_cfg.origin_x),
        float(grid_cfg.origin_y), W, H,
        float(range_threshold), float(min_range), float(max_range),
        _i32p(pc), _i32p(hc),
    )
    return pc.reshape(H, W), hc.reshape(H, W)


def decimate(ranges: np.ndarray, factor: int) -> np.ndarray:
    """Min-filter beam decimation."""
    lib = _load()
    r = np.ascontiguousarray(ranges, np.float32)
    if lib is None:
        m = len(r) // factor
        return r[: m * factor].reshape(m, factor).min(axis=1)
    out = np.empty(len(r) // factor, np.float32)
    lib.ts_decimate(_fp(r), len(r), factor, _fp(out))
    return out


def _count(lib, path: str, topic: str) -> tuple[int, int]:
    beams = ctypes.c_int64(0)
    n = lib.ts_bag_count(path.encode(), topic.encode(), ctypes.byref(beams))
    return n, beams.value


def bag_read_scans(path: str, topic: str):
    """Native bulk LaserScan decode: (ranges (M, N) f32, stamps (M,) f64,
    meta dict). Returns None when the native path can't handle the bag
    (library unavailable / bz2 chunks without libbz2) — the caller then
    parses the bag in Python."""
    lib = _load()
    if lib is None:
        return None
    n, beams = _count(lib, path, topic)
    if n < 0 or beams <= 0:
        return None
    ranges = np.empty((n, beams), np.float32)
    stamps = np.empty(n, np.float64)
    meta = np.zeros(7, np.float64)
    got = lib.ts_bag_read_scans(
        path.encode(), topic.encode(), n, beams, _fp(ranges), _dp(stamps),
        _dp(meta),
    )
    if got < 0:
        return None
    keys = (
        "angle_min", "angle_max", "angle_increment", "time_increment",
        "scan_time", "range_min", "range_max",
    )
    return (
        ranges[:got],
        stamps[:got],
        {k: float(v) for k, v in zip(keys, meta)},
    )


def bag_read_imu(path: str, topic: str):
    """Native bulk Imu decode: (stamps, yaw, gyro (M, 3)) or None."""
    lib = _load()
    if lib is None:
        return None
    n, _beams = _count(lib, path, topic)
    if n < 0:
        return None
    stamps = np.empty(n, np.float64)
    yaw = np.empty(n, np.float64)
    gyro = np.empty((n, 3), np.float64)
    got = lib.ts_bag_read_imu(
        path.encode(), topic.encode(), n, _dp(stamps), _dp(yaw), _dp(gyro)
    )
    if got < 0:
        return None
    return stamps[:got], yaw[:got], gyro[:got]


def bag_read_odom(path: str, topic: str):
    """Native bulk Odometry decode: (stamps, pose (M, 3), twist (M, 3))
    or None."""
    lib = _load()
    if lib is None:
        return None
    n, _beams = _count(lib, path, topic)
    if n < 0:
        return None
    stamps = np.empty(n, np.float64)
    pose = np.empty((n, 3), np.float64)
    twist = np.empty((n, 3), np.float64)
    got = lib.ts_bag_read_odom(
        path.encode(), topic.encode(), n, _dp(stamps), _dp(pose), _dp(twist)
    )
    if got < 0:
        return None
    return stamps[:got], pose[:got], twist[:got]

"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/tpu_slam_torch/`` at the
root of the checkout (git-ignored), under a name that carries a hash of the
source, the shared headers and the flags, and loaded with ``ctypes``. A
build or load failure raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_slam_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# the H100's limits that the kernels' launch geometry keeps to
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may hold
SMEM_STATIC_RESERVE = 1_024  # of them, left to a kernel's static arrays
MAX_CLUSTER = 8  # blocks in a portable thread-block cluster

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a bare Python int
# would be passed as a 32-bit int and cut the pointer)
SIGNATURES = {
    "plicp_fused": (
        "plicp_fused_launch",
        # src, src_valid, tgt, tgt_valid, init, pose, stats, H,
        # B, N, M, rounds, max_d2, eps_xy, eps_th, q_perc, q_adap,
        # adap_mult, threads, sources a thread, smem, targets a chunk,
        # lists_global, scratch, scratch floats a pair, stream
        [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
         _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _VP,
         _I, _VP],
    ),
    "cr_lm": (
        "cr_lm_launch",
        # pT8, slots, out, scratch, lam0, W, K, iters, sq_min_delta,
        # blocks, warps, smem, stream
        [_VP, _VP, _VP, _VP, _F, _I, _I, _I, _F, _I, _I, _I, _VP],
    ),
    "cr_stream": (
        "cr_stream_launch",
        # pT8, slots, out, scratch, lam0, W, K, iters, sq_min_delta, h0,
        # blocks, warps, smem, chunk, stream
        [_VP, _VP, _VP, _VP, _F, _I, _I, _I, _F, _I, _I, _I, _I, _I, _VP],
    ),
    "pcg_lm": (
        "pcg_lm_launch",
        # pT, ei, ej, meansT, W6, fm, row_ptr, inc, pos, out, L, scratch,
        # lam0, M, E, iters, cg_iters, cg_tol, sq_min_delta, blocks, logS,
        # qmax, smem, restarts, stream
        [_VP] * 10 + [_I, _VP, _F, _I, _I, _I, _I, _F, _F] + [_I] * 5
        + [_VP],
    ),
    "hector_fused": (
        "hector_fused_launch",
        # grids, sizes, geo (host arrays), L, pts, valid, pose_in, out, N,
        # iters_fine, iters_coarse, max_rot_step, threads, beams a thread,
        # stream
        [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _I, _I,
         _VP],
    ),
    "correlative_response": (
        "correlative_response_launch",
        # grid, ys, xs, valid, out, C, H, W, A, N, nx, ny, stride, valid's
        # lane stride, candidates a thread, threads, strips a tile, beam
        # slices, stream
        [_VP] * 5 + [_I] * 13 + [_VP],
    ),
    "nn": (
        "nn_launch",
        # src, tgt, tgt_valid, idx, d2, B, N, M, lanes, threads, tiles,
        # smem, targets a chunk, stream
        [_VP] * 5 + [_I] * 8 + [_VP],
    ),
    "loop_sweep": (
        "loop_sweep_launch",
        # poses, row stride, T, tried, tried pairs, cells, scratch, out, g,
        # gap, min_gap, r2, cap, stream
        [_VP, _I, _I, _VP, _I, _VP, _VP, _VP, _I, _I, _I, _F, _I, _VP],
    ),
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for kernel ``name`` unless its library exists; returns
    (process or None, temporary output, final output)."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp, out) -> None:
    if proc is None:
        return
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{stdout}\n{stderr}")
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _finish_build(name, *_start_build(name))
    lib = ctypes.CDLL(str(library_path(name)))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise on a CUDA error."""
    fn = getattr(load(name), SIGNATURES[name][0])
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def build_all() -> list[Path]:
    """Build every kernel of the package, one nvcc per source, all started
    together; returns the library paths."""
    started = {name: _start_build(name) for name in SIGNATURES}
    try:
        for name, job in started.items():
            _finish_build(name, *job)
    finally:
        for proc, _tmp, _out in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in SIGNATURES:
        load(name)
    return [library_path(name) for name in SIGNATURES]

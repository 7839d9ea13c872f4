"""Hand-written CUDA FAST-9 kernel (csrc/fast_corners.cu) and its wrappers.

Counterpart of orb_slam_cuda_tpu/ops/pallas_fast.py. The kernel is built
at first use with nvcc for sm_90a into `build/kernels/` at the repository
root, as a shared library with a plain C interface loaded through ctypes.

`fast_corners_pyramid(levels, th_hi, th_lo, cell, border)` returns one
final corner map per pyramid level (FAST-9 at both thresholds, 3x3 NMS of
each, the per-cell choice, the keypoint border zeroed) from one launch
over all levels; its plain version is frontend/fast.py::fast_corners_plain
level by level. `fast_score_pair(img, th_hi, th_lo)` returns the two
thresholded score maps of one level, the reference kernel's own function;
its plain version is frontend/fast.py::fast_score at each threshold. CPU
tensors take the plain version; CUDA tensors launch the kernel or raise.
`launches` counts kernel launches and nothing else: a launch recorded
into a CUDA graph under capture runs nothing, so it counts in `recorded`
instead, and engine/programs.py adds a graph's recorded launches to
`launches` at each replay.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import torch

from ..frontend import fast

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fast_corners.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
CELL = 32  # the kernel's tile is the cell of the two-threshold choice
MAX_LEVELS = 16  # capacity of the kernel's level table

launches = 0
recorded = 0
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfast_corners_{digest}.so")


def build() -> tuple:
    """Compile the kernel with NVCC_FLAGS if its library is missing.
    Returns (library path, seconds spent compiling)."""
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, dt


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        lib.fast_score_pair.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.fast_score_pair.restype = ctypes.c_int
        lib.fast_corners_pyramid.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.fast_corners_pyramid.restype = ctypes.c_int
        _lib = lib
    return _lib


def _count():
    global launches, recorded
    if torch.cuda.is_current_stream_capturing():
        recorded += 1
    else:
        launches += 1


def _check_level(name: str, img, device):
    if img.device != device:
        raise ValueError(f"{name}: levels on {device} and {img.device}; needs one device")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(
            f"{name}: needs a contiguous 2-D float32 tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}"
        )


def fast_score_pair(img, th_hi: float, th_lo: float):
    """(H,W) float32 image -> (score_hi, score_lo) FAST-9 maps."""
    if img.device.type == "cpu":
        return fast.fast_score(img, th_hi), fast.fast_score(img, th_lo)
    if img.device.type != "cuda":
        raise ValueError(f"fast_score_pair: unsupported device {img.device}")
    _check_level("fast_score_pair", img, img.device)
    lib = _load()
    h, w = img.shape
    hi = torch.empty_like(img)
    lo = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.fast_score_pair(
            img.data_ptr(), hi.data_ptr(), lo.data_ptr(), h, w,
            float(th_hi), float(th_lo), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fast_score_pair kernel launch failed: cudaError {rc}")
    _count()
    return hi, lo


def pyramid_buffers(shapes, device):
    """Per-level float32 views of one flat buffer, for `fast_corners_pyramid`'s
    `out`: a caller with a fixed image size allocates them once."""
    flat = torch.empty(sum(h * w for h, w in shapes), dtype=torch.float32, device=device)
    views, at = [], 0
    for h, w in shapes:
        views.append(flat[at:at + h * w].view(h, w))
        at += h * w
    return views


def fast_corners_pyramid(levels, th_hi: float, th_lo: float, cell: int = CELL,
                         border: int = 19, out=None):
    """List of (H_l,W_l) float32 pyramid levels -> list of final corner maps,
    one kernel launch for all levels. `out`, if given, is a list of
    tensors shaped like the levels that receive the maps (and are returned);
    otherwise the maps are allocated here."""
    levels = list(levels)
    if not levels:
        raise ValueError("fast_corners_pyramid: no levels")
    if th_hi < 0 or th_lo < 0 or border < 0 or cell <= 0:
        raise ValueError("fast_corners_pyramid: thresholds and border must be >= 0, cell > 0")
    device = levels[0].device
    for img in levels:
        _check_level("fast_corners_pyramid", img, device)
    if out is None:
        out = pyramid_buffers([tuple(img.shape) for img in levels], device)
    elif len(out) != len(levels):
        raise ValueError(f"fast_corners_pyramid: {len(out)} outputs for {len(levels)} levels")
    for img, o in zip(levels, out):
        _check_level("fast_corners_pyramid out", o, device)
        if o.shape != img.shape:
            raise ValueError(f"fast_corners_pyramid: output {tuple(o.shape)} for level {tuple(img.shape)}")
    if device.type == "cpu":
        for img, o in zip(levels, out):
            o.copy_(fast.fast_corners_plain(img, th_hi, th_lo, cell, border))
        return out
    if device.type != "cuda":
        raise ValueError(f"fast_corners_pyramid: unsupported device {device}")
    if cell != CELL or len(levels) > MAX_LEVELS:
        raise ValueError(
            f"fast_corners_pyramid: the kernel takes cell {CELL} and up to {MAX_LEVELS} levels, "
            f"got cell {cell}, {len(levels)} levels"
        )
    lib = _load()
    n = len(levels)
    imgs = (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels])
    outs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in out])
    hs = (ctypes.c_int * n)(*[img.shape[0] for img in levels])
    ws = (ctypes.c_int * n)(*[img.shape[1] for img in levels])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fast_corners_pyramid(
            imgs, outs, hs, ws, n, float(th_hi), float(th_lo), int(border), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fast_corners_pyramid kernel launch failed: cudaError {rc}")
    _count()
    return out

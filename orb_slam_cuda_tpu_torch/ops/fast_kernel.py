"""Hand-written CUDA FAST-9 kernel (csrc/fast_score.cu) and its wrapper.

Counterpart of orb_slam_cuda_tpu/ops/pallas_fast.py. The kernel is built
at first use with nvcc for sm_90a into `build/kernels/` at the repository
root, as a shared library with a plain C interface loaded through ctypes.

`fast_score_pair(img, th_hi, th_lo)` returns the two thresholded score
maps. A CPU tensor takes the plain version (frontend/fast.py::fast_score
at each threshold); a CUDA tensor launches the kernel or raises.
`launches` counts kernel launches and nothing else.
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
SOURCE = os.path.join(_PKG_DIR, "csrc", "fast_score.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = 0
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfast_score_{digest}.so")


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
        _lib = lib
    return _lib


def fast_score_pair(img, th_hi: float, th_lo: float):
    """(H,W) float32 image -> (score_hi, score_lo) FAST-9 maps."""
    global launches
    if img.device.type == "cpu":
        return fast.fast_score(img, th_hi), fast.fast_score(img, th_lo)
    if img.device.type != "cuda":
        raise ValueError(f"fast_score_pair: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(
            "fast_score_pair: needs a contiguous 2-D float32 tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}"
        )
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
    launches += 1
    return hi, lo

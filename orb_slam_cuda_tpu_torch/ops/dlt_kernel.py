"""Hand-written CUDA DLT triangulation (csrc/triangulate_dlt.cu) and its
wrapper.

Counterpart of orb_slam_cuda_tpu/geometry/triangulate.py::triangulate_dlt,
whose batched `eigh` the JAX package shaped for the TPU; on the card a
batched eigen-solver reads a status back to the host and cannot run inside
a captured CUDA graph, so the mapping programs triangulate here. The
kernel is built at first CUDA use with nvcc for sm_90a into
`build/kernels/` at the repository root, as a shared library with a plain
C interface loaded through ctypes (the FAST kernel's build).

`triangulate_dlt(P1, P2, xy1, xy2)`: CPU tensors take the plain version
(geometry/triangulate.py::triangulate_dlt_plain, `eigh`); CUDA tensors
launch the kernel or raise. `launches` and `recorded` count as
ops/fast_kernel.py's do (a launch under capture is recorded, and
engine/programs.py adds a graph's recorded launches at each replay).
"""

from __future__ import annotations

import ctypes
import os
import time

import torch

from ..utils import native_build
from .fast_kernel import BUILD_DIR, NVCC_FLAGS, _nvcc

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "triangulate_dlt.cu")

launches = 0
recorded = 0
_lib = None


def build() -> tuple:
    """Compile the kernel if its library is missing. Returns (library
    path, seconds spent here)."""
    t0 = time.perf_counter()
    path = native_build.build(SOURCE, "triangulate_dlt kernel", flags=tuple(NVCC_FLAGS),
                              build_dir=BUILD_DIR, compiler=_nvcc())
    return path, time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        lib.triangulate_dlt.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        lib.triangulate_dlt.restype = ctypes.c_int
        _lib = lib
    return _lib


def _count():
    global launches, recorded
    if torch.cuda.is_current_stream_capturing():
        recorded += 1
    else:
        launches += 1


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"triangulate_dlt: {name} must be a contiguous float32 {shape} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}")


def triangulate_dlt(P1, P2, xy1, xy2):
    """P1, P2 (3,4); xy1, xy2 (N,2) float32 -> (N,3) float32."""
    from ..geometry.triangulate import triangulate_dlt_plain

    device = xy1.device
    if device.type == "cpu":
        return triangulate_dlt_plain(P1, P2, xy1, xy2)
    if device.type != "cuda":
        raise ValueError(f"triangulate_dlt: unsupported device {device}")
    n = xy1.shape[0]
    _check("P1", P1, (3, 4), device)
    _check("P2", P2, (3, 4), device)
    _check("xy1", xy1, (n, 2), device)
    _check("xy2", xy2, (n, 2), device)
    if xy1.data_ptr() % 8 or xy2.data_ptr() % 8:
        raise ValueError("triangulate_dlt: image points must be 8-byte aligned (read as float2)")
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.triangulate_dlt(P1.data_ptr(), P2.data_ptr(), xy1.data_ptr(), xy2.data_ptr(),
                                 out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"triangulate_dlt kernel launch failed: cudaError {rc}")
    _count()
    return out

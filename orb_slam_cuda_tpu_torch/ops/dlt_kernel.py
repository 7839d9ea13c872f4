"""Hand-written CUDA DLT triangulation (csrc/triangulate_dlt.cu) and its
two wrappers.

Counterpart of orb_slam_cuda_tpu/geometry/triangulate.py::triangulate_dlt,
whose batched `eigh` the JAX package shaped for the TPU; on the card a
batched eigen-solver reads a status back to the host and cannot run inside
a captured CUDA graph, so the port triangulates here. The kernels are
built at first CUDA use with nvcc for sm_90a into `build/kernels/` at the
repository root, as a shared library with a plain C interface loaded
through ctypes (the FAST kernel's build).

`triangulate_dlt(P1, P2, xy1, xy2)`: the DLT points alone (the
initializer's call); plain version geometry/triangulate.py::
triangulate_dlt_plain (`eigh`).
`triangulate_gated(cam, T1, T2, xy1, uv2, idx, oct1, oct2, sig2, sf)`:
everything the mapper does to a triangulation neighbour after the
epipolar match, in one launch: the DLT points and their `ok` gate; plain
version geometry/triangulate.py::triangulate_gated_plain.
CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. Each entry counts as ops/fast_kernel.py does: `launches` and
`recorded` (module attributes) for `triangulate_dlt`, `gated.launches` and
`gated.recorded` for `triangulate_gated`; a launch under capture is
recorded, and engine/programs.py adds a graph's recorded launches at each
replay.
"""

from __future__ import annotations

import ctypes
import os
import sys
import time

import torch

from ..utils import native_build
from .fast_kernel import BUILD_DIR, NVCC_FLAGS, _nvcc

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "triangulate_dlt.cu")

launches = 0
recorded = 0
_lib = None


class Counts:
    """One entry's launch counts: `launches` run, `recorded` under capture."""

    def __init__(self):
        self.launches = 0
        self.recorded = 0


gated = Counts()


def build(defines=()) -> tuple:
    """Compile the kernels if their library is missing; `defines` are
    extra nvcc flags (the source's -D switches). Returns (library path,
    seconds spent here)."""
    t0 = time.perf_counter()
    path = native_build.build(SOURCE, "triangulate_dlt kernel", flags=(*NVCC_FLAGS, *defines),
                              build_dir=BUILD_DIR, compiler=_nvcc())
    return path, time.perf_counter() - t0


def bind(path: str):
    """The library at `path` with both entries' argument types set."""
    lib = ctypes.CDLL(path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.triangulate_dlt.argtypes = [ptr] * 5 + [i32, ptr]
    lib.triangulate_dlt.restype = i32
    lib.triangulate_gated.argtypes = [ptr] * 9 + [i32] * 3 + [f32] * 4 + [ptr] * 3
    lib.triangulate_gated.restype = i32
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


def _count(counts):
    """One launch of the entry counted by `counts` (this module for
    `triangulate_dlt`, `gated` for `triangulate_gated`)."""
    if torch.cuda.is_current_stream_capturing():
        counts.recorded += 1
    else:
        counts.launches += 1


def _check(entry, name, t, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{entry}: {name} must be a contiguous {dtype} {shape} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def triangulate_dlt(P1, P2, xy1, xy2):
    """P1, P2 (3,4); xy1, xy2 (N,2) float32 -> (N,3) float32."""
    from ..geometry.triangulate import triangulate_dlt_plain

    device = xy1.device
    if device.type == "cpu":
        return triangulate_dlt_plain(P1, P2, xy1, xy2)
    if device.type != "cuda":
        raise ValueError(f"triangulate_dlt: unsupported device {device}")
    n = xy1.shape[0]
    for name, t, shape in (("P1", P1, (3, 4)), ("P2", P2, (3, 4)), ("xy1", xy1, (n, 2)), ("xy2", xy2, (n, 2))):
        _check("triangulate_dlt", name, t, shape, device)
    if xy1.data_ptr() % 8 or xy2.data_ptr() % 8:
        raise ValueError("triangulate_dlt: image points must be 8-byte aligned (read as float2)")
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.triangulate_dlt(P1.data_ptr(), P2.data_ptr(), xy1.data_ptr(), xy2.data_ptr(),
                                 out.data_ptr(), n, _stream(device))
    if rc != 0:
        raise RuntimeError(f"triangulate_dlt kernel launch failed: cudaError {rc}")
    _count(sys.modules[__name__])
    return out


def triangulate_gated(cam, T1, T2, xy1, uv2, idx, oct1, oct2, sig2, sf):
    """The mapper's triangulation of one neighbour after the match: world-
    to-camera poses T1, T2 (4,4) float32; the new keyframe's points xy1
    (N,2) float32 and octaves oct1 (N,) int32; the neighbour's points uv2
    (N2,2) float32 and octaves oct2 (N2,) int32; the match idx (N,) int64
    into them (-1 unmatched); sig2, sf (L,) float32 level tables; the
    pinhole intrinsics of `cam`. Returns (xyz (N,3) float32, ok (N,) bool)."""
    from ..geometry.triangulate import triangulate_gated_plain

    device = xy1.device
    if device.type == "cpu":
        return triangulate_gated_plain(cam, T1, T2, xy1, uv2, idx, oct1, oct2, sig2, sf)
    if device.type != "cuda":
        raise ValueError(f"triangulate_gated: unsupported device {device}")
    n, n2, levels = xy1.shape[0], uv2.shape[0], sig2.shape[0]
    for name, t, shape, dtype in (("T1", T1, (4, 4), torch.float32), ("T2", T2, (4, 4), torch.float32),
                                  ("xy1", xy1, (n, 2), torch.float32), ("uv2", uv2, (n2, 2), torch.float32),
                                  ("idx", idx, (n,), torch.int64), ("oct1", oct1, (n,), torch.int32),
                                  ("oct2", oct2, (n2,), torch.int32), ("sig2", sig2, (levels,), torch.float32),
                                  ("sf", sf, (levels,), torch.float32)):
        _check("triangulate_gated", name, t, shape, device, dtype)
    if levels < 2 or (n > 0 and n2 == 0):
        raise ValueError(f"triangulate_gated: needs at least 2 levels and a neighbour with features, "
                         f"got {levels} levels and {n2} features")
    if xy1.data_ptr() % 8 or uv2.data_ptr() % 8:
        raise ValueError("triangulate_gated: image points must be 8-byte aligned (read as float2)")
    xyz = torch.empty((n, 3), dtype=torch.float32, device=device)
    ok = torch.empty((n,), dtype=torch.bool, device=device)
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.triangulate_gated(T1.data_ptr(), T2.data_ptr(), xy1.data_ptr(), uv2.data_ptr(), idx.data_ptr(),
                                   oct1.data_ptr(), oct2.data_ptr(), sig2.data_ptr(), sf.data_ptr(), levels, n,
                                   n2, cam.fx, cam.fy, cam.cx, cam.cy, xyz.data_ptr(), ok.data_ptr(),
                                   _stream(device))
    if rc != 0:
        raise RuntimeError(f"triangulate_gated kernel launch failed: cudaError {rc}")
    _count(gated)
    return xyz, ok

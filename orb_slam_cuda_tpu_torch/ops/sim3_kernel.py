"""Hand-written CUDA Sim3 RANSAC (csrc/sim3_ransac.cu) and its wrapper.

Counterpart of orb_slam_cuda_tpu/solvers/sim3_solver.py::solve_sim3_ransac,
whose batched `eigh` over the hypotheses the JAX package shaped for the
TPU; on the card a batched eigen-solver reads a status back to the host
and cannot run inside a captured CUDA graph, so the port solves Horn's
N-matrix by Jacobi here (the DLT kernel's, csrc/jacobi4.cuh). Built at
first CUDA use with nvcc for sm_90a into `build/kernels/` at the
repository root, a shared library with a plain C interface loaded through
ctypes, as ops/dlt_kernel.py builds.

`solve(x1, x2, uv1, uv2, valid, sets, th1, th2, cam, fix_scale,
min_inliers)`: CPU tensors take the plain version, solvers/sim3_solver.py::
solve_sim3_ransac_plain; CUDA tensors launch the kernel or raise. A call
is two kernel launches (the hypotheses, then the choice and refit) and
counts one in `launches` (module attribute), or in `recorded` under
capture; engine/programs.py adds a graph's recorded launches at each
replay. `launch` returns the kernel's choice too: the best hypothesis,
whether the refit was kept, and every hypothesis's count and Sim3.
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
SOURCE = os.path.join(_PKG_DIR, "csrc", "sim3_ransac.cu")

launches = 0
recorded = 0
_lib = None


def build() -> tuple:
    """Compile the kernel if its library is missing. Returns (library
    path, seconds spent here)."""
    t0 = time.perf_counter()
    path = native_build.build(SOURCE, "sim3_ransac kernel", flags=tuple(NVCC_FLAGS), build_dir=BUILD_DIR,
                              compiler=_nvcc())
    return path, time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sim3_ransac.argtypes = [ptr] * 8 + [i32] * 2 + [f32] * 4 + [i32] * 2 + [ptr] * 10
        lib.sim3_ransac.restype = i32
        _lib = lib
    return _lib


def _check(name, t, shape, device, dtype):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"sim3_ransac: {name} must be a contiguous {dtype} {shape} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}")


def launch(x1, x2, uv1, uv2, valid, sets, th1, th2, cam, fix_scale: bool, min_inliers: int):
    """The kernel on CUDA tensors: x1, x2 (M,3), uv1, uv2 (M,2), th1, th2
    (M,) float32, valid (M,) bool, sets (NH,3) int64. Returns (R (3,3),
    t (3,), s (), inliers (M,) bool, n_inliers () int64, ok () bool, info
    (2,) int32: the best hypothesis and 1 if the refit was kept, counts
    (NH,) int32, params (NH,13) float32: each hypothesis's R, t, s)."""
    device = x1.device
    if device.type != "cuda":
        raise ValueError(f"sim3_ransac: the kernel runs on CUDA tensors, got {device}")
    m, nh = x1.shape[0], sets.shape[0]
    for name, t, shape, dtype in (("x1", x1, (m, 3), torch.float32), ("x2", x2, (m, 3), torch.float32),
                                  ("uv1", uv1, (m, 2), torch.float32), ("uv2", uv2, (m, 2), torch.float32),
                                  ("th1", th1, (m,), torch.float32), ("th2", th2, (m,), torch.float32),
                                  ("valid", valid, (m,), torch.bool), ("sets", sets, (nh, 3), torch.int64)):
        _check(name, t, shape, device, dtype)
    if m < 1 or nh < 1:
        raise ValueError(f"sim3_ransac: needs matches and hypotheses, got M={m}, {nh} hypotheses")
    if uv1.data_ptr() % 8 or uv2.data_ptr() % 8:
        raise ValueError("sim3_ransac: image points must be 8-byte aligned (read as float2)")
    f32 = dict(dtype=torch.float32, device=device)
    counts = torch.empty((nh,), dtype=torch.int32, device=device)
    params = torch.empty((nh, 13), **f32)
    R, t, s = torch.empty((3, 3), **f32), torch.empty((3,), **f32), torch.empty((), **f32)
    inliers = torch.empty((m,), dtype=torch.bool, device=device)
    n_in = torch.empty((), dtype=torch.int64, device=device)
    ok = torch.empty((), dtype=torch.bool, device=device)
    info = torch.empty((2,), dtype=torch.int32, device=device)
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.sim3_ransac(x1.data_ptr(), x2.data_ptr(), uv1.data_ptr(), uv2.data_ptr(), th1.data_ptr(),
                             th2.data_ptr(), valid.data_ptr(), sets.data_ptr(), nh, m, cam.fx, cam.fy, cam.cx,
                             cam.cy, int(bool(fix_scale)), int(min_inliers), counts.data_ptr(),
                             params.data_ptr(), R.data_ptr(), t.data_ptr(), s.data_ptr(), inliers.data_ptr(),
                             n_in.data_ptr(), ok.data_ptr(), info.data_ptr(),
                             torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sim3_ransac kernel launch failed: cudaError {rc}")
    mod = sys.modules[__name__]
    if torch.cuda.is_current_stream_capturing():
        mod.recorded += 1
    else:
        mod.launches += 1
    return R, t, s, inliers, n_in, ok, info, counts, params


def solve(x1, x2, uv1, uv2, valid, sets, th1, th2, cam, fix_scale: bool = False, min_inliers: int = 20):
    """Sim3 RANSAC over the minimal sets `sets` (NH,3): a Sim3Result. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    from ..solvers.sim3_solver import Sim3Result, solve_sim3_ransac_plain

    device = x1.device
    if device.type == "cpu":
        return solve_sim3_ransac_plain(x1, x2, uv1, uv2, valid, cam, th1, th2, fix_scale=fix_scale,
                                       min_inliers=min_inliers, sample_sets=sets)
    if device.type != "cuda":
        raise ValueError(f"sim3_ransac: unsupported device {device}")
    return Sim3Result(*launch(x1, x2, uv1, uv2, valid, sets, th1, th2, cam, fix_scale, min_inliers)[:6])


def reference64(x1, x2, uv1, uv2, valid, sets, th1, th2, cam, fix_scale: bool, info, params):
    """The Sim3 (R, t, s) that the kernel's choice `info` should give,
    computed in float64 by the plain code: where the refit was kept, Horn
    weighted over the inliers of the best hypothesis (params[info[0]],
    counted by the plain version); else Horn on its minimal set. The
    kernel's checks hold its R, t, s against this."""
    from ..solvers.sim3_solver import _horn_centered, count_inliers, horn_sim3

    best, kept = (int(v) for v in info.tolist())
    x1d, x2d = x1.double(), x2.double()
    if not kept:
        return horn_sim3(x1d[sets[best]], x2d[sets[best]], fix_scale)
    p = params[best]
    w = count_inliers(p[:9].reshape(3, 3), p[9:12], p[12], x1, x2, uv1, uv2, valid, cam, th1, th2).double()[:, None]
    n = torch.clamp(torch.sum(w), min=3.0)
    c1, c2 = torch.sum(x1d * w, dim=0) / n, torch.sum(x2d * w, dim=0) / n
    return _horn_centered((x1d - c1) * w, (x2d - c2) * w, c1, c2, fix_scale)

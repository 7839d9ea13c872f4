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
is one kernel launch (a block a hypothesis; the last block to finish
chooses and refits, told so by a ticket: an integer on the card, one a
device, made at the device's first call, which must not be under graph
capture, and left 0 by every call) and counts one in `launches` (module
attribute), or in `recorded` under capture; engine/programs.py adds a
graph's recorded launches at each replay. `launch` returns the kernel's
choice too: the best hypothesis, whether the refit was kept, and every
hypothesis's count and Sim3.
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
_tickets = {}  # device index -> the kernel's ticket, int32 (1,)


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
        lib.sim3_ransac.argtypes = [ptr] * 8 + [i32] * 2 + [f32] * 4 + [i32] * 2 + [ptr] * 11
        lib.sim3_ransac.restype = i32
        _lib = lib
    return _lib


def _check(name, t, shape, device, dtype):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"sim3_ransac: {name} must be a contiguous {dtype} {shape} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}")


def _ticket(device):
    t = _tickets.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"sim3_ransac: the first call on {device} runs under graph capture; its ticket is "
                               "made at that call, so call the kernel once outside capture first")
        t = _tickets[device.index] = torch.zeros((1,), dtype=torch.int32, device=device)
    return t


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
    ticket = _ticket(device)
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.sim3_ransac(x1.data_ptr(), x2.data_ptr(), uv1.data_ptr(), uv2.data_ptr(), th1.data_ptr(),
                             th2.data_ptr(), valid.data_ptr(), sets.data_ptr(), nh, m, cam.fx, cam.fy, cam.cx,
                             cam.cy, int(bool(fix_scale)), int(min_inliers), counts.data_ptr(),
                             params.data_ptr(), R.data_ptr(), t.data_ptr(), s.data_ptr(), inliers.data_ptr(),
                             n_in.data_ptr(), ok.data_ptr(), info.data_ptr(), ticket.data_ptr(),
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


KITTI = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241, height=376)  # the loop path's camera


def synthetic_problem(device, m: int, seed: int, fix_scale: bool = False, outliers: float = 0.3, n_valid=None,
                      groups=None):
    """A RANSAC problem for the kernel's checks (the card tests and
    chip_smoke.py's full-width call): (cam, dict of x1, x2 (M,3), uv1, uv2
    (M,2), valid (M,), th1, th2 (M,) on `device`). Points 4-30 m in front
    of camera 2, x1 = S x2 under a Sim3 S (scale 1 with `fix_scale`), 0.5
    px of noise, a share `outliers` of x1 moved 0.5-3 m, the reference's
    per-octave thresholds 9.210 sigma^2 (scale 1.2). `n_valid` keeps
    that many matches valid. `groups` = (a, b): matches 0..a-1 follow S and
    a..a+b-1 a second Sim3, the rest are outliers."""
    import numpy as np

    from ..geometry import sim3
    from ..geometry.camera import Camera

    rng = np.random.default_rng(seed)
    cam = Camera.create(**KITTI)
    x2 = np.stack([rng.uniform(-8, 8, m), rng.uniform(-2, 2, m), rng.uniform(4, 30, m)], -1)
    xi = np.array([0.4, -0.1, 0.6, 0.03, -0.2, 0.01, 0.0 if fix_scale else 0.2], np.float32)
    S = [a.double().numpy() for a in sim3.exp(torch.as_tensor(xi))]
    x1 = S[2] * x2 @ S[0].T + S[1]
    out = rng.random(m) < outliers
    if groups is not None:
        xi2 = np.array([-0.5, 0.2, 0.3, 0.1, 0.25, -0.05, 0.0 if fix_scale else -0.1], np.float32)
        S2 = [a.double().numpy() for a in sim3.exp(torch.as_tensor(xi2))]
        a, b = groups
        x1[a:a + b] = S2[2] * x2[a:a + b] @ S2[0].T + S2[1]
        out = np.arange(m) >= a + b
    x1[out] += rng.uniform(0.5, 3.0, (int(out.sum()), 3)) * rng.choice([-1, 1], (int(out.sum()), 3))

    def project(X):
        return np.stack([cam.fx * X[:, 0] / X[:, 2] + cam.cx, cam.fy * X[:, 1] / X[:, 2] + cam.cy], -1)

    uv1 = project(x1) + rng.normal(0, 0.5, (m, 2))
    uv2 = project(x2) + rng.normal(0, 0.5, (m, 2))
    valid = np.ones(m, bool) if n_valid is None else np.arange(m) < n_valid
    valid &= (x1[:, 2] > 0.5)
    sig2 = 1.2 ** (2 * np.arange(8))
    oct1, oct2 = rng.integers(0, 4, m), rng.integers(0, 4, m)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    return cam, dict(x1=f32(x1), x2=f32(x2), uv1=f32(uv1), uv2=f32(uv2), valid=torch.as_tensor(valid, device=device),
                     th1=f32(9.210 * sig2[oct1]), th2=f32(9.210 * sig2[oct2]))


def synthetic_sets(p, seed: int):
    """128 minimal sets (128,3) int64 of `p`'s valid matches, drawn as the
    loop closer draws them (host keys seeded `seed`, masked on the card)."""
    from ..solvers import initializer

    keys = initializer.default_keys("sim3", seed, p["x1"].shape[0]).to(p["x1"].device)
    return initializer.sets_from_keys(keys, p["valid"], 3)


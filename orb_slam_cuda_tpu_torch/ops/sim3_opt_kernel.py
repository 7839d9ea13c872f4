"""OptimizeSim3's Jacobian: the hand-written CUDA kernel
(csrc/sim3_opt_jacobian.cu), its wrapper and its plain version.

Counterpart of orb_slam_cuda_tpu/solvers/sim3_opt.py's `flat_res` (with
`_pair_residuals`, :43) under `jax.jacfwd` (:95-101), which XLA fuses on
the TPU. For every correspondence of the loop closer's Sim3 refinement, at
the left-multiplied tangent xi = 0 of the estimate S (xi = (rho, phi,
sigma), g2o's order): J (2M,2,7) float32, J[m] the derivative of the
projection of S x2c[m] into keyframe 1 and J[M + m] that of S^-1 x1c[m]
into keyframe 2, each entry rounded once from the float64 chain.

`jacobian(S, x1c, x2c, cam)` -> J: CPU tensors take `jacobian_plain` (the
chain in float64 through `torch.func.jvp`, one pass a tangent coordinate:
`sim3.tangent_jacobian`); CUDA tensors launch the kernel or raise. A launch
counts one in `launches` (module attribute), or in `recorded` under graph
capture; engine/programs.py adds a graph's recorded launches at each
replay. M = 0 launches nothing and returns an empty J.

The kernel (the seven seeded poses once a block in shared memory; a
thread a pair, family and direction, a warp one family and direction; the
source's header) is built at first CUDA use with nvcc for sm_90a into
`build/kernels/` at the repository root, a shared library with a plain C
interface loaded through ctypes, as ops/pose_graph_kernel.py builds. Its
arithmetic is templated on the scalar, so g++ builds the same source for
the host (`build_host`): `host` runs the kernel's items one after the
other on CPU tensors and `pair_ops` counts the double operations the
function needs, for the CPU tests and the bound that chip_smoke.py
computes.
"""

from __future__ import annotations

import ctypes
import os
import sys
import time

import torch

from ..geometry import sim3
from ..utils import native_build
from .fast_kernel import BUILD_DIR, NVCC_FLAGS, _nvcc
from .pose_graph_kernel import HOST_FLAGS

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "sim3_opt_jacobian.cu")
DIRECTIONS = 7
DEPTH_MIN = 1e-6  # proj's depth clamp

launches = 0
recorded = 0
_lib = None
_host_lib = None


def pair_residuals(S, x1c, x2c, cam):
    """Projections of both edge families at Sim3 estimate S (S x2c into
    keyframe 1, S^-1 x1c into keyframe 2), and their depth flags."""
    y1 = sim3.transform(S, x2c)  # into the KF1 camera frame
    y2 = sim3.transform(sim3.inverse(S), x1c)  # into the KF2 camera frame

    def proj(y):
        z = torch.where(y[:, 2] > DEPTH_MIN, y[:, 2], torch.full_like(y[:, 2], DEPTH_MIN))
        return torch.stack([cam.fx * y[:, 0] / z + cam.cx, cam.fy * y[:, 1] / z + cam.cy], dim=-1)

    return proj(y1), proj(y2), y1[:, 2] > DEPTH_MIN, y2[:, 2] > DEPTH_MIN


def jacobian_plain(S, x1c, x2c, cam):
    """The kernel's plain version (any device): J (2M,2,7) from the chain in
    float64, rounded once to float32."""
    S64 = tuple(a.double() for a in S)
    x1, x2 = x1c.double(), x2c.double()

    def stacked(xi):
        p1, p2, _, _ = pair_residuals(sim3.retract(S64, xi), x1, x2, cam)
        return torch.cat([p1, p2], dim=0)

    return sim3.tangent_jacobian(stacked, torch.zeros((DIRECTIONS,), device=x1c.device)).float()


def build() -> tuple:
    """Compile the kernel if its library is missing. Returns (library
    path, seconds spent here)."""
    t0 = time.perf_counter()
    path = native_build.build(SOURCE, "sim3_opt_jacobian kernel", flags=tuple(NVCC_FLAGS), build_dir=BUILD_DIR,
                              compiler=_nvcc())
    return path, time.perf_counter() - t0


def _entry(lib, name, n_out):
    ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    fn = getattr(lib, name)
    fn.argtypes = [ptr] * 5 + [i64, f64, f64] + [ptr] * n_out
    fn.restype = ctypes.c_int
    return fn


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        _entry(lib, "sim3_opt_jacobian", 2)  # J, the stream
        _lib = lib
    return _lib


def build_host() -> str:
    """The same source built by g++ for the host (no CUDA): its
    `sim3_opt_jacobian_host` and `sim3_opt_jacobian_ops` entries."""
    global _host_lib
    path = native_build.build(SOURCE, "sim3_opt_jacobian host build", flags=HOST_FLAGS)
    if _host_lib is None:
        lib = ctypes.CDLL(path)
        _entry(lib, "sim3_opt_jacobian_host", 1)
        _entry(lib, "sim3_opt_jacobian_ops", 3)
        _host_lib = lib
    return path


def _checked(S, x1c, x2c, device) -> int:
    """The kernel's inputs checked: M."""
    R, t, s = S
    m = x1c.shape[0]
    for name, x, shape in (("R", R, (3, 3)), ("t", t, (3,)), ("s", s, ()), ("x1c", x1c, (m, 3)),
                           ("x2c", x2c, (m, 3))):
        if x.device != device or x.dtype != torch.float32 or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"sim3_opt_jacobian: {name} must be a contiguous float32 {shape} tensor on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device} contiguous={x.is_contiguous()}")
    return m


def _pointers(S, x1c, x2c):
    return tuple(x.data_ptr() for x in (*S, x1c, x2c))


def launch(S, x1c, x2c, cam):
    """The kernel on CUDA tensors: S = (R (3,3), t (3,), s ()), x1c, x2c
    (M,3), all float32 and contiguous. Returns J (2M,2,7) float32."""
    device = x1c.device
    m = _checked(S, x1c, x2c, device)
    if device.type != "cuda":
        raise ValueError(f"sim3_opt_jacobian: the kernel runs on CUDA tensors, got {device}")
    J = torch.empty((2 * m, 2, DIRECTIONS), dtype=torch.float32, device=device)
    if m == 0:
        return J
    lib = _load()
    # fx, fy are frozen into a captured graph: a loop closer's camera is fixed.
    with torch.cuda.device(device):
        rc = lib.sim3_opt_jacobian(*_pointers(S, x1c, x2c), m, float(cam.fx), float(cam.fy), J.data_ptr(),
                                   torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sim3_opt_jacobian kernel launch failed: cudaError {rc}")
    mod = sys.modules[__name__]
    if torch.cuda.is_current_stream_capturing():
        mod.recorded += 1
    else:
        mod.launches += 1
    return J


def jacobian(S, x1c, x2c, cam):
    """J (2M,2,7) float32 of both reprojection families at xi = 0. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    device = x1c.device
    if device.type == "cpu":
        return jacobian_plain(S, x1c, x2c, cam)
    if device.type != "cuda":
        raise ValueError(f"sim3_opt_jacobian: unsupported device {device}")
    return launch(S, x1c, x2c, cam)


def host(S, x1c, x2c, cam):
    """The kernel's arithmetic run on the host (the g++ build), item by
    item, on CPU tensors: J as `launch` returns it."""
    m = _checked(S, x1c, x2c, torch.device("cpu"))
    build_host()
    J = torch.empty((2 * m, 2, DIRECTIONS), dtype=torch.float32)
    rc = _host_lib.sim3_opt_jacobian_host(*_pointers(S, x1c, x2c), m, float(cam.fx), float(cam.fy), J.data_ptr())
    if rc != 0:
        raise RuntimeError(f"sim3_opt_jacobian_host failed: {rc}")
    return J


def pair_ops(S, x1c, x2c, cam):
    """The double operations the function needs on these inputs, counted
    by the host build (any device; the inputs are copied to the host):
    (pose (8,), primal (M,), tangent (M, 7)) int64: pose[0] the estimate's
    operations on primal values (its inverse, once) and pose[1 + c]
    direction c's on its seed's tangents there; each pair's operations on
    primal values (its two transforms and projections, once; every thread
    of the kernel repeats them) and each (pair, direction)'s on the
    tangents its seed makes (not those on tangents that are 0 whatever the
    seed). Each add, multiply and divide counts one, a comparison none."""
    S = tuple(x.cpu().contiguous() for x in S)
    x1c, x2c = x1c.cpu().contiguous(), x2c.cpu().contiguous()
    m = _checked(S, x1c, x2c, torch.device("cpu"))
    build_host()
    pose = torch.zeros((1 + DIRECTIONS,), dtype=torch.int64)
    primal = torch.zeros((m,), dtype=torch.int64)
    tangent = torch.zeros((m, DIRECTIONS), dtype=torch.int64)
    rc = _host_lib.sim3_opt_jacobian_ops(*_pointers(S, x1c, x2c), m, float(cam.fx), float(cam.fy), pose.data_ptr(),
                                         primal.data_ptr(), tangent.data_ptr())
    if rc != 0:
        raise RuntimeError(f"sim3_opt_jacobian_ops failed: {rc}")
    return pose, primal, tangent


# The rotation angles of `synthetic_pairs`' estimates, and its special rows.
CASE_ANGLES = (0.0, 1e-3, 0.3, 2.0)
# Rows 0-1: S x2c at depth 0 (to within float32 rounding, so y_z <= 1e-6:
# the clamp) and behind keyframe 1; rows 2-3 the same for S^-1 x1c in
# keyframe 2; rows 4-5 zeros, as an invalid pair's points may be.
SPECIAL_ROWS = 6


def synthetic_pairs(seed: int, m: int = 64, angle: float = 0.3, scale: float = 1.0, device="cpu"):
    """The kernel's arguments made from `seed` with numpy: (S, x1c, x2c,
    cam) on `device`, a KITTI camera. S rotates by `angle` about a random
    axis, scales by `scale` and translates by a random t; x2c lies 2-30 m
    in front of keyframe 2 and x1c = S x2c, a third of it moved 0.5-3 m (as
    outliers are). With m >= SPECIAL_ROWS the first rows are the special
    cases above."""
    import numpy as np

    from ..geometry.camera import Camera
    from .sim3_kernel import KITTI

    rng = np.random.default_rng(seed)
    axis = rng.normal(0.0, 1.0, 3)
    R = sim3.exp(torch.as_tensor(np.r_[0.0, 0.0, 0.0, angle * axis / np.linalg.norm(axis), 0.0]))[0].numpy()
    t, s = rng.normal(0.0, 1.0, 3), float(scale)
    z = rng.uniform(2.0, 30.0, m)
    x2 = np.stack([rng.uniform(-0.9, 0.9, m) * z, rng.uniform(-0.3, 0.3, m) * z, z], -1)
    x1 = s * x2 @ R.T + t
    out = rng.random(m) < 1 / 3
    x1[out] += rng.uniform(0.5, 3.0, (int(out.sum()), 3)) * rng.choice([-1, 1], (int(out.sum()), 3))
    if m >= SPECIAL_ROWS:
        into1 = lambda y: (np.asarray(y) - t) @ R / s  # noqa: E731  (x2c with S x2c = y)
        into2 = lambda y: s * np.asarray(y) @ R.T + t  # noqa: E731  (x1c with S^-1 x1c = y)
        x2[0], x2[1] = into1([0.5, -0.3, 0.0]), into1([0.3, 0.2, -2.0])
        x1[2], x1[3] = into2([0.4, 0.2, 0.0]), into2([-0.2, 0.1, -3.0])
        x1[4:6] = x2[4:6] = 0.0
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)  # noqa: E731
    S = (f32(R), f32(t), torch.tensor(s, dtype=torch.float32, device=device))
    return S, f32(x1), f32(x2), Camera.create(**KITTI)

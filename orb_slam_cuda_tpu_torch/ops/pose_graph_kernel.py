"""The essential graph's edge linearization: the hand-written CUDA kernel
(csrc/pose_graph_edges.cu), its wrapper and its plain version.

Counterpart of orb_slam_cuda_tpu/solvers/pose_graph.py's `_edge_residual`
under `jax.vmap(jax.jacfwd(...))` (:54, :88-89), which XLA fuses on the
TPU. For every edge, at the left-multiplied tangents xi_i = xi_j = 0:
r = log(M o S_i o S_j^-1) (E,7) and its forward-mode Jacobians Ji, Jj
(E,7,7), Ji[e, k, c] = dr_k / dxi_i[c], all float32, each rounded once
from the float64 chain; an edge that is not valid gets zeros.

`linearize(R, t, s, ei, ej, meas_R, meas_t, meas_s, valid)` -> (r, Ji, Jj):
CPU tensors take `linearize_plain` (the chain in float64 through
`torch.func.jvp`, one pass a tangent coordinate: `sim3.tangent_jacobian`);
CUDA tensors launch the kernel or raise. A launch counts one in `launches`
(module attribute), or in `recorded` under graph capture;
engine/programs.py adds a graph's recorded launches at each replay.
`launch` returns the edges' branch flags too (FLAG_*), which
`branch_flags_plain` computes from the plain chain. They show which branch
an edge took where r and J cannot: at a branch's threshold the two sides
agree to well within the r and J tolerances (so3_log's series at theta =
1e-4, W's |sigma| < 1e-5 side), so an edge on the wrong side would pass
those gates.

The kernel is built at first CUDA use with nvcc for sm_90a into
`build/kernels/` at the repository root, a shared library with a plain C
interface loaded through ctypes, as ops/sim3_kernel.py builds. Its
arithmetic is templated on the scalar, so g++ builds the same source for
the host (`build_host`): `host` runs the kernel's threads one after the
other on CPU tensors and `edge_ops` counts the double operations the
function needs (an edge's primal chain once, each direction's tangent
chain), for the CPU tests and the bound that chip_smoke.py computes.
"""

from __future__ import annotations

import ctypes
import os
import sys
import time

import torch

from ..geometry import se3, sim3
from ..utils import native_build
from .fast_kernel import BUILD_DIR, NVCC_FLAGS, _nvcc

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "pose_graph_edges.cu")
HOST_FLAGS = ("-x", "c++", "-O2", "-std=c++17", "-shared", "-fPIC")

DIRECTIONS = 14  # xi_i's 7 coordinates, then xi_j's
# Branch flags of an edge's chain (the source's FLAG_*).
FLAG_LOG_SMALL = 1  # so3_log: theta < 1e-4
FLAG_LOG_NEAR_PI = 2  # so3_log: theta > 3
FLAG_COS_CLAMPED = 4  # so3_log: (trace - 1) / 2 outside [-1, 1]
FLAG_SIGMA_ZERO = 8  # sim3.log's W: |sigma| < 1e-5
FLAG_THETA_ZERO = 16  # sim3.log's W: theta^2 < 1e-8

launches = 0
recorded = 0
_lib = None
_host_lib = None


def edge_residual(xi_i, xi_j, SiR, Sit, Sis, SjR, Sjt, Sjs, MR, Mt, Ms):
    """r = log(S_ji o (exp(xi_i) o S_i) o (exp(xi_j) o S_j)^-1) in R^7."""
    Si_u = sim3.compose(sim3.exp(xi_i), (SiR, Sit, Sis))
    Sj_u = sim3.compose(sim3.exp(xi_j), (SjR, Sjt, Sjs))
    return sim3.log(sim3.compose((MR, Mt, Ms), sim3.compose(Si_u, sim3.inverse(Sj_u))))


def _edge_args64(R, t, s, ei, ej, meas_R, meas_t, meas_s):
    return tuple(x.double() for x in (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], meas_R, meas_t, meas_s))


def linearize_plain(R, t, s, ei, ej, meas_R, meas_t, meas_s, valid):
    """The kernel's plain version (any device): r, Ji, Jj from the chain in
    float64, each rounded once to float32; edges not `valid` zeros."""
    a64 = _edge_args64(R, t, s, ei, ej, meas_R, meas_t, meas_s)
    zeros = torch.zeros((ei.shape[0], 7), dtype=torch.float64, device=R.device)
    r = edge_residual(zeros, zeros, *a64)
    Ji = sim3.tangent_jacobian(lambda x: edge_residual(x, zeros, *a64), zeros)
    Jj = sim3.tangent_jacobian(lambda x: edge_residual(zeros, x, *a64), zeros)
    v = valid.bool()
    return (torch.where(v[:, None], r, 0.0).float(), torch.where(v[:, None, None], Ji, 0.0).float(),
            torch.where(v[:, None, None], Jj, 0.0).float())


def branch_flags_plain(R, t, s, ei, ej, meas_R, meas_t, meas_s, valid):
    """(E,) int32: the branches each edge's float64 chain takes in
    sim3.log (FLAG_*), 0 for an edge not `valid`."""
    SiR, Sit, Sis, SjR, Sjt, Sjs, MR, Mt, Ms = _edge_args64(R, t, s, ei, ej, meas_R, meas_t, meas_s)
    B_R, _, B_s = sim3.compose((MR, Mt, Ms), sim3.compose((SiR, Sit, Sis), sim3.inverse((SjR, Sjt, Sjs))))
    c0 = (B_R[:, 0, 0] + B_R[:, 1, 1] + B_R[:, 2, 2] - 1.0) * 0.5
    w = torch.stack([B_R[:, 2, 1] - B_R[:, 1, 2], B_R[:, 0, 2] - B_R[:, 2, 0], B_R[:, 1, 0] - B_R[:, 0, 1]], -1)
    theta = torch.atan2(0.5 * torch.sqrt(torch.sum(w * w, -1) + 1e-24), torch.clamp(c0, -1.0, 1.0))
    phi, sigma = se3.so3_log(B_R), torch.log(B_s)
    near_pi = theta > 3.0
    flags = ((theta < 1e-4) & ~near_pi).int() * FLAG_LOG_SMALL + near_pi.int() * FLAG_LOG_NEAR_PI
    flags += (~((c0 >= -1.0) & (c0 <= 1.0))).int() * FLAG_COS_CLAMPED
    flags += (torch.abs(sigma) < 1e-5).int() * FLAG_SIGMA_ZERO
    flags += (torch.sum(phi * phi, -1) < 1e-8).int() * FLAG_THETA_ZERO
    return torch.where(valid.bool(), flags, 0).int()


def build() -> tuple:
    """Compile the kernel if its library is missing. Returns (library
    path, seconds spent here)."""
    t0 = time.perf_counter()
    path = native_build.build(SOURCE, "pose_graph_edges kernel", flags=tuple(NVCC_FLAGS), build_dir=BUILD_DIR,
                              compiler=_nvcc())
    return path, time.perf_counter() - t0


def _entry(lib, name, n_out):
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = getattr(lib, name)
    fn.argtypes = [ptr] * 3 + [i64] + [ptr] * 6 + [i64] + [ptr] * n_out
    fn.restype = ctypes.c_int
    return fn


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        _entry(lib, "pose_graph_edges", 5)
        _lib = lib
    return _lib


def build_host() -> str:
    """The same source built by g++ for the host (no CUDA): its
    `pose_graph_edges_host` and `pose_graph_edges_ops` entries."""
    global _host_lib
    path = native_build.build(SOURCE, "pose_graph_edges host build", flags=HOST_FLAGS)
    if _host_lib is None:
        lib = ctypes.CDLL(path)
        _entry(lib, "pose_graph_edges_host", 4)
        _entry(lib, "pose_graph_edges_ops", 2)
        _host_lib = lib
    return path


def _checked(args, device):
    """The kernel's inputs checked: (K, E)."""
    R, t, s, ei, ej, meas_R, meas_t, meas_s, valid = args
    k, e = R.shape[0], ei.shape[0]
    for name, x, shape, dtype in (("R", R, (k, 3, 3), torch.float32), ("t", t, (k, 3), torch.float32),
                                  ("s", s, (k,), torch.float32), ("ei", ei, (e,), torch.int64),
                                  ("ej", ej, (e,), torch.int64), ("meas_R", meas_R, (e, 3, 3), torch.float32),
                                  ("meas_t", meas_t, (e, 3), torch.float32), ("meas_s", meas_s, (e,), torch.float32),
                                  ("valid", valid, (e,), torch.bool)):
        if x.device != device or x.dtype != dtype or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"pose_graph_edges: {name} must be a contiguous {dtype} {shape} tensor on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device} contiguous={x.is_contiguous()}")
    if k < 1 or e < 1:
        raise ValueError(f"pose_graph_edges: needs vertices and edges, got K={k}, E={e}")
    return k, e


def _outputs(e, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((e, 7), **f32), torch.empty((e, 7, 7), **f32), torch.empty((e, 7, 7), **f32),
            torch.empty((e,), dtype=torch.int32, device=device))


def launch(R, t, s, ei, ej, meas_R, meas_t, meas_s, valid):
    """The kernel on CUDA tensors: R (K,3,3), t (K,3), s (K,), meas_R
    (E,3,3), meas_t (E,3), meas_s (E,) float32, ei, ej (E,) int64 in [0,
    K), valid (E,) bool, all contiguous. Returns (r (E,7), Ji, Jj (E,7,7),
    flags (E,) int32)."""
    args = (R, t, s, ei, ej, meas_R, meas_t, meas_s, valid)
    device = R.device
    k, e = _checked(args, device)
    if device.type != "cuda":
        raise ValueError(f"pose_graph_edges: the kernel runs on CUDA tensors, got {device}")
    out = _outputs(e, device)
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.pose_graph_edges(*(x.data_ptr() for x in args[:3]), k, *(x.data_ptr() for x in args[3:]), e,
                                  *(o.data_ptr() for o in out), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pose_graph_edges kernel launch failed: cudaError {rc}")
    mod = sys.modules[__name__]
    if torch.cuda.is_current_stream_capturing():
        mod.recorded += 1
    else:
        mod.launches += 1
    return out


def linearize(R, t, s, ei, ej, meas_R, meas_t, meas_s, valid):
    """(r (E,7), Ji (E,7,7), Jj (E,7,7)) float32 of every edge at xi = 0.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    device = R.device
    if device.type == "cpu":
        return linearize_plain(R, t, s, ei, ej, meas_R, meas_t, meas_s, valid)
    if device.type != "cuda":
        raise ValueError(f"pose_graph_edges: unsupported device {device}")
    return launch(R, t, s, ei, ej, meas_R, meas_t, meas_s, valid)[:3]


def host(R, t, s, ei, ej, meas_R, meas_t, meas_s, valid):
    """The kernel's arithmetic run on the host (the g++ build), thread by
    thread, on CPU tensors: (r, Ji, Jj, flags) as `launch` returns them."""
    args = (R, t, s, ei, ej, meas_R, meas_t, meas_s, valid)
    k, e = _checked(args, torch.device("cpu"))
    build_host()
    out = _outputs(e, "cpu")
    rc = _host_lib.pose_graph_edges_host(*(x.data_ptr() for x in args[:3]), k, *(x.data_ptr() for x in args[3:]),
                                         e, *(o.data_ptr() for o in out))
    if rc != 0:
        raise RuntimeError(f"pose_graph_edges_host failed: {rc}")
    return out


def edge_ops(R, t, s, ei, ej, meas_R, meas_t, meas_s, valid):
    """The double operations the function needs on these inputs, counted
    by the host build (any device; the inputs are copied to the host):
    (primal (E,), tangent (E, 14)) int64, each edge's operations on primal
    values (its chain once; every thread of the kernel repeats them) and
    each direction's operations on the tangents its seed makes (not those
    on tangents that are 0 whatever the seed). Each add, multiply, divide,
    sqrt, exp, log, sin, cos and atan2 counts one, a comparison none; 0 for
    an edge not valid."""
    args = tuple(x.cpu().contiguous() for x in (R, t, s, ei, ej, meas_R, meas_t, meas_s, valid))
    k, e = _checked(args, torch.device("cpu"))
    build_host()
    primal = torch.zeros((e,), dtype=torch.int64)
    tangent = torch.zeros((e, DIRECTIONS), dtype=torch.int64)
    rc = _host_lib.pose_graph_edges_ops(*(x.data_ptr() for x in args[:3]), k, *(x.data_ptr() for x in args[3:]),
                                        e, primal.data_ptr(), tangent.data_ptr())
    if rc != 0:
        raise RuntimeError(f"pose_graph_edges_ops failed: {rc}")
    return primal, tangent


# The rotation angles and log-scales of `branch_edges`' residuals: the
# identity, so3_log's small branch (with and without W's theta^2 < 1e-8),
# the generic one, its near-pi branch (every axis component away from 0),
# and W's |sigma| < 1e-5 branch and its other side.
BRANCH_ANGLES = (0.0, 1e-5, 5e-5, 3e-4, 0.3, 2.0, 3.05, 3.09)
BRANCH_SIGMAS = (0.0, 5e-6, -3e-6, 0.1, -0.08)


def _rodrigues(w):
    import numpy as np

    th = np.linalg.norm(w)
    if th == 0.0:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def branch_edges(seed: int, device="cpu", n_vertices: int = 16):
    """Edges whose residual chains take every branch of sim3.log, made
    from `seed` with numpy: the kernel's arguments (R, t, s, ei, ej,
    meas_R, meas_t, meas_s, valid) on `device`. Vertex 0 is the identity
    and edge 0 is (0, 0) with the identity measurement (r = 0 exactly);
    then for each angle of BRANCH_ANGLES and log-scale of BRANCH_SIGMAS an
    edge between random vertices whose measurement makes the residual's
    rotation that angle about a random axis with every component of size
    0.2 or more, its log-scale that sigma and its translation random (the
    measurement is rounded to float32, so the residual is the target to
    within that rounding; sigma = 0 edges join unit-scale vertices with a
    unit-scale measurement, so their sigma is 0 exactly); then 8 edges
    whose residual is the identity up to that rounding (where cos theta
    may round past 1); then 2 padded edges (valid False)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = n_vertices
    R = [np.eye(3)] + [_rodrigues(rng.normal(0, 1.0, 3)) for _ in range(n - 1)]
    t = [np.zeros(3)] + [rng.normal(0, 5.0, 3) for _ in range(n - 1)]
    s = [1.0] * (n // 2) + list(np.exp(rng.normal(0, 0.2, n - n // 2)))
    edges = [(0, 0, np.eye(3), np.zeros(3), 1.0)]

    def meas(i, j, B_R, B_t, B_s):
        # M = B o S_j o S_i^-1, so that M o S_i o S_j^-1 = B.
        Rij = R[j] @ R[i].T
        sij = s[j] / s[i]
        tij = t[j] - sij * Rij @ t[i]
        return B_R @ Rij, B_s * B_R @ tij + B_t, B_s * sij

    for angle in BRANCH_ANGLES:
        for sigma in BRANCH_SIGMAS:
            pool = np.arange(1, n) if sigma else np.arange(1, n // 2)  # sigma = 0: unit-scale vertices
            i, j = (int(x) for x in rng.choice(pool, 2, replace=False))
            axis = rng.uniform(0.2, 1.0, 3) * rng.choice([-1, 1], 3)
            B_R = _rodrigues(angle * axis / np.linalg.norm(axis))
            B_t = rng.normal(0, 0.05, 3) if angle else np.zeros(3)
            edges.append((i, j) + meas(i, j, B_R, B_t, float(np.exp(sigma))))
    for _ in range(8):
        i, j = (int(x) for x in rng.choice(np.arange(1, n), 2, replace=False))
        edges.append((i, j) + meas(i, j, np.eye(3), np.zeros(3), 1.0))
    edges += [(0, 0, np.eye(3), np.zeros(3), 1.0)] * 2

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    valid = np.ones(len(edges), bool)
    valid[-2:] = False
    return (f32(np.stack(R)), f32(np.stack(t)), f32(np.asarray(s)), i64([e[0] for e in edges]),
            i64([e[1] for e in edges]), f32(np.stack([e[2] for e in edges])), f32(np.stack([e[3] for e in edges])),
            f32(np.asarray([e[4] for e in edges])), torch.as_tensor(valid, device=device))

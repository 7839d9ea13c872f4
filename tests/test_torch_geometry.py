"""Parity of the port's geometry (se3, camera, triangulate) with the JAX
package, rtol 1e-5 on float32 outputs; plus the import boundary: the port
never imports jax, the reference package or OpenCV (absent on the card's
machine), and names no path into the reference package."""

import ast
import os
import re

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.geometry import se3 as jse3
from orb_slam_cuda_tpu.geometry import triangulate as jtri
from orb_slam_cuda_tpu_torch.geometry import camera as tcam
from orb_slam_cuda_tpu_torch.geometry import se3 as tse3
from orb_slam_cuda_tpu_torch.geometry import triangulate as ttri
from torch_parity import assert_same, jx, random_poses, run_both, tt

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
FORBIDDEN = ("jax", "jaxlib", "orb_slam_cuda_tpu", "cv2")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    xi = np.concatenate([rng.normal(0, 0.5, (64, 3)), rng.normal(0, 0.8, (64, 3))], 1).astype(np.float32)
    xi[:4, 3:] *= 1e-5  # small-angle Taylor branches
    return {
        "xi": xi,
        "phi": xi[:, 3:].copy(),
        "T": random_poses(rng, 64),
        "X": rng.normal(0, 2.0, (64, 50, 3)).astype(np.float32),
        "q": rng.normal(0, 1, (64, 4)).astype(np.float32),
    }


SE3_CASES = [
    ("hat", lambda m, d: (d["phi"],), lambda m: m.hat),
    ("so3_exp", lambda m, d: (d["phi"],), lambda m: m.so3_exp),
    ("so3_log", lambda m, d: (d["T"][:, :3, :3],), lambda m: m.so3_log),
    ("exp", lambda m, d: (d["xi"],), lambda m: m.exp),
    ("log", lambda m, d: (d["T"],), lambda m: m.log),
    ("inverse", lambda m, d: (d["T"],), lambda m: m.inverse),
    ("orthonormalize", lambda m, d: (d["T"],), lambda m: m.orthonormalize),
    ("transform", lambda m, d: (d["T"], d["X"]), lambda m: m.transform),
    ("transform_single", lambda m, d: (d["T"], d["X"][:, 0]), lambda m: m.transform),
    ("retract", lambda m, d: (d["T"], d["xi"] * 0.1), lambda m: m.retract),
    ("quat_to_rot", lambda m, d: (d["q"],), lambda m: m.quat_to_rot),
    ("rot_to_quat", lambda m, d: (d["T"][:, :3, :3],), lambda m: m.rot_to_quat),
    ("make_T", lambda m, d: (d["T"][:, :3, :3], d["xi"][:, :3]), lambda m: m.make_T),
]


@pytest.mark.parametrize("name,args,fn", SE3_CASES, ids=[c[0] for c in SE3_CASES])
def test_se3(data, name, args, fn):
    j, t = run_both(fn(jse3), fn(tse3), *args(None, data))
    assert_same(j, t, rtol=RTOL, atol=ATOL, what=name)


def test_so3_log_near_pi():
    R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None]
    j, t = run_both(jse3.so3_log, tse3.so3_log, R)
    assert_same(j, t, rtol=RTOL, atol=1e-5)


CAM = dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7, k1=0.26, k2=-0.95, p1=-0.005,
           p2=0.002, k3=1.16, width=640, height=480)


@pytest.fixture(scope="module")
def cams():
    return jcam.Camera.create(**CAM), tcam.Camera.create(**CAM)


def test_camera_project_backproject(cams, data):
    jc, tc = cams
    Xc = data["X"][0] + np.array([0, 0, 6.0], np.float32)
    for distort in (False, True):
        assert_same(jcam.project(jc, jx(Xc), distort), tcam.project(tc, tt(Xc), distort),
                    rtol=RTOL, atol=1e-3, what=f"project distort={distort}")
    uv = np.random.default_rng(2).uniform(0, 640, (100, 2)).astype(np.float32)
    z = np.linspace(0.5, 20, 100).astype(np.float32)
    assert_same(jcam.backproject(jc, jx(uv), jx(z)), tcam.backproject(tc, tt(uv), tt(z)),
                rtol=RTOL, atol=ATOL)


def test_camera_undistort(cams):
    jc, tc = cams
    uv = np.random.default_rng(3).uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    assert_same(jcam.undistort_points(jc, jx(uv)), tcam.undistort_points(tc, tt(uv)),
                rtol=RTOL, atol=1e-3)
    for a, b in zip(jcam.undistorted_bounds(jc), tcam.undistorted_bounds(tc)):
        assert_same(a, b, rtol=RTOL, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(jc.K), tc.K)


@pytest.fixture(scope="module")
def two_view():
    rng = np.random.default_rng(4)
    K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    T1 = np.eye(4, dtype=np.float32)
    # A wide baseline keeps the depth direction of each DLT well determined.
    T2 = random_poses(rng, 1, rot=0.05, trans=0.3)[0]
    T2[:3, 3] = [2.5, 0.4, 0.3]
    X = (rng.uniform(-2, 2, (80, 3)) + [0, 0, 6]).astype(np.float32)

    def proj(T):
        Xc = X @ T[:3, :3].T + T[:3, 3]
        return (Xc[:, :2] / Xc[:, 2:] * 500 + [320, 240]).astype(np.float32)

    return K, T1, T2, X, proj(T1), proj(T2)


def test_triangulate(two_view):
    K, T1, T2, X, xy1, xy2 = two_view
    # Normalized coordinates: a well-conditioned A^T A, so the two eigh
    # implementations agree to the geometry tolerance.
    n1 = (xy1 - K[:2, 2]) / K[0, 0]
    n2 = (xy2 - K[:2, 2]) / K[0, 0]
    j, t = run_both(jtri.triangulate_dlt, ttri.triangulate_dlt, T1[:3], T2[:3], n1, n2)
    assert_same(j, t, rtol=RTOL, atol=1e-5, what="triangulate_dlt normalized")
    # Pixel coordinates square the condition number of A^T A: in float32
    # both implementations are ~3e-4 off the true point, so the stated
    # tolerance there is 1e-3 relative.
    P1, P2 = K @ T1[:3], K @ T2[:3]
    j, t = run_both(jtri.triangulate_dlt, ttri.triangulate_dlt, P1, P2, xy1, xy2)
    assert_same(j, t, rtol=1e-3, atol=1e-3, what="triangulate_dlt pixels")
    np.testing.assert_allclose(np.asarray(t), X, atol=1e-2)
    assert_same(*run_both(jtri.projection_matrix, ttri.projection_matrix, K, T2), rtol=RTOL, atol=ATOL)
    for a, b in zip(*run_both(jtri.cheirality_and_parallax, ttri.cheirality_and_parallax, X, T1, T2)):
        assert_same(a, b, rtol=RTOL, atol=ATOL)
    F = run_both(jtri.fundamental_from_poses, ttri.fundamental_from_poses, K, T1, K, T2)
    assert_same(*F, rtol=1e-4, atol=1e-9, what="fundamental_from_poses")
    d = run_both(jtri.epipolar_distance_sq, ttri.epipolar_distance_sq, np.asarray(F[0]), xy1, xy2)
    assert_same(*d, rtol=1e-3, atol=1e-6)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


_REFERENCE_DIR = re.compile(r"(^|[/\\])orb_slam_cuda_tpu([/\\]|$)")
_CITATION = re.compile(r":\d+$")  # "file:line", as the kernel table cites the TPU kernel


def _reference_path_strings(path):
    """String constants, docstrings apart, that hold the reference package's
    directory as a path component: the stuff of a path built at run time."""
    tree = ast.parse(open(path).read(), path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs
                and _REFERENCE_DIR.search(node.value) and not _CITATION.search(node.value)):
            yield node.value


def test_reference_path_detector():
    import tempfile

    src = '"""doc: port of orb_slam_cuda_tpu/frontend/fast.py"""\nimport os\n' \
          'P = os.path.join(R, "orb_slam_cuda_tpu", "frontend", "x.npy")\n' \
          'Q = "../orb_slam_cuda_tpu/frontend/x.npy"\nC = "orb_slam_cuda_tpu/ops/pallas_fast.py:116"\n' \
          'T = "orb_slam_cuda_tpu_torch/csrc/k.cu"\n'
    with tempfile.NamedTemporaryFile("w", suffix=".py") as f:
        f.write(src)
        f.flush()
        assert sorted(_reference_path_strings(f.name)) == ["../orb_slam_cuda_tpu/frontend/x.npy", "orb_slam_cuda_tpu"]


def test_port_never_imports_jax():
    root = os.path.join(os.path.dirname(__file__), "..", "orb_slam_cuda_tpu_torch")
    offenders = []
    n_files = 0
    chip = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    paths = [chip]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        n_files += 1
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                offenders.append((path, mod))
        offenders += [(path, s) for s in _reference_path_strings(path)]
    assert n_files > 20
    assert not offenders, offenders

"""Parity of the port's solvers with the JAX package. Tolerances:
optimize_pose pose within 1e-4 and inlier mask exact (well-conditioned
fixture); initialize_two_view with the reference's minimal sets injected:
same success and model choice, R and t within 1e-3; bundle_adjust poses
and points within 1e-3 (float32 LM+PCG, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.solvers import bundle_adjust as jba
from orb_slam_cuda_tpu.solvers import initializer as jinit
from orb_slam_cuda_tpu.solvers import pose_opt as jpo
from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as tba
from orb_slam_cuda_tpu_torch.solvers import initializer as tinit
from orb_slam_cuda_tpu_torch.solvers import pose_opt as tpo
from orb_slam_cuda_tpu_torch.utils import convert
from torch_parity import assert_same, jx, random_poses, to_np, tt

torch.set_num_threads(2)
CAM_ARGS = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480)


@pytest.fixture(scope="module")
def cams():
    jc = jcam.Camera.create(**CAM_ARGS)
    return jc, convert.camera(jc)


def _project(T, X, K):
    Xc = X @ T[:3, :3].T + T[:3, 3]
    return (Xc[:, :2] / Xc[:, 2:] * K[0, 0] + K[:2, 2]).astype(np.float32)


def test_optimize_pose(cams):
    jc, tc = cams
    rng = np.random.default_rng(0)
    K = np.asarray(jc.K)
    T = random_poses(rng, 1, rot=0.1, trans=0.3)[0]
    X = (rng.uniform(-3, 3, (300, 3)) + [0, 0, 10]).astype(np.float32)
    uv = _project(T, X, K) + rng.normal(0, 0.5, (300, 2)).astype(np.float32)
    uv[:30] += rng.uniform(15, 40, (30, 2)).astype(np.float32)  # gross outliers
    ur = np.full(300, -1.0, np.float32)
    ur[200:220] = uv[200:220, 0] - 30.0  # a few stereo edges
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, 300))).astype(np.float32)
    valid = rng.random(300) < 0.95
    T0 = (random_poses(rng, 1, rot=0.01, trans=0.05)[0] @ T).astype(np.float32)
    j = jpo.optimize_pose(jx(T0), jx(X), jx(uv), jx(ur), jx(inv_s2), jx(valid), jc)
    t = tpo.optimize_pose(tt(T0), tt(X), tt(uv), tt(ur), tt(inv_s2), tt(valid), tc)
    assert_same(j.pose, t.pose, rtol=0, atol=1e-4, what="pose")
    assert_same(j.inliers, t.inliers, what="inliers")
    assert int(t.n_inliers) == int(j.n_inliers)


def _jax_sets(valid, key, n_hyp=200):
    """The reference's minimal-set draws (initializer.py draw())."""
    M = valid.shape[0]

    def draw(k):
        r = jax.random.uniform(k, (M,))
        r = jnp.where(jnp.asarray(valid), r, -1.0)
        return jnp.argsort(-r)[:8]

    return np.array(jax.vmap(draw)(jax.random.split(key, n_hyp)))


@pytest.mark.parametrize("scene", ["general", "planar"])
def test_initialize_two_view_injected_sets(cams, scene):
    jc, _ = cams
    rng = np.random.default_rng(1 if scene == "general" else 2)
    K = np.asarray(jc.K)
    M = 400
    if scene == "general":
        X = (rng.uniform([-4, -3, 6], [4, 3, 14], (M, 3))).astype(np.float32)
    else:
        X = np.concatenate([rng.uniform(-4, 4, (M, 2)), np.full((M, 1), 9.0)], 1).astype(np.float32)
    T2 = random_poses(rng, 1, rot=0.04, trans=0.1)[0]
    T2[:3, 3] = [0.8, 0.05, 0.1]
    xy1 = _project(np.eye(4, dtype=np.float32), X, K) + rng.normal(0, 0.3, (M, 2)).astype(np.float32)
    xy2 = _project(T2, X, K) + rng.normal(0, 0.3, (M, 2)).astype(np.float32)
    xy2[:25] += rng.uniform(20, 60, (25, 2)).astype(np.float32)
    valid = rng.random(M) < 0.9
    key = jax.random.PRNGKey(3)
    j = jinit.initialize_two_view(jx(xy1), jx(xy2), jx(valid), jx(K), key, min_triangulated=40)
    sets = _jax_sets(valid, key)
    t = tinit.initialize_two_view(tt(xy1), tt(xy2), tt(valid), tt(K), sets=sets, min_triangulated=40)
    assert bool(j.success) == bool(t.success)
    assert bool(j.used_homography) == bool(t.used_homography)
    assert bool(t.success), "fixture should initialize"
    assert bool(t.used_homography) == (scene == "planar")
    assert_same(j.R, t.R, rtol=0, atol=1e-3, what="R")
    assert_same(j.t, t.t, rtol=0, atol=1e-3, what="t")
    agree = (to_np(j.is_point) == to_np(t.is_point)).mean()
    assert agree > 0.98, agree


def test_draw_sets_pick_valid_rows():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[::3] = True
    g = torch.Generator().manual_seed(0)
    sets = tinit.draw_sets(valid, 20, g)
    assert sets.shape == (20, 8)
    assert bool(valid[sets].all())
    assert all(len(set(row.tolist())) == 8 for row in sets)


@pytest.fixture(scope="module")
def ba_problem():
    rng = np.random.default_rng(5)
    C, P = 6, 250
    K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] + list(random_poses(rng, C - 1, rot=0.05, trans=0.4)))
    X = (rng.uniform([-3, -2, 7], [3, 2, 12], (P, 3))).astype(np.float32)
    cam_i, pt_i, uv = [], [], []
    for c in range(C):
        for p in range(P):
            if rng.random() < 0.7:
                cam_i.append(c)
                pt_i.append(p)
                uv.append(_project(poses[c], X[p:p + 1], K)[0] + rng.normal(0, 0.5, 2))
    E = len(cam_i)
    uv = np.asarray(uv, np.float32)
    uv[:15] += 25.0
    E_pad = E + 37
    pad = lambda a, v: np.concatenate([a, np.full((E_pad - E,) + a.shape[1:], v, a.dtype)])  # noqa: E731
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    noisy_poses = np.stack([poses[0]] + [(random_poses(rng, 1, rot=0.005, trans=0.02)[0] @ T).astype(np.float32)
                                          for T in poses[1:]])
    return dict(
        cam_pose=noisy_poses, cam_fixed=cam_fixed,
        xyz=(X + rng.normal(0, 0.05, X.shape)).astype(np.float32), pt_valid=np.ones(P, bool),
        obs_cam=pad(np.asarray(cam_i, np.int32), -1), obs_pt=pad(np.asarray(pt_i, np.int32), -1),
        obs_uv=pad(uv, 0.0), obs_ur=pad(np.full(E, -1.0, np.float32), -1.0),
        obs_inv_sigma2=pad((1.0 / 1.2 ** (2 * rng.integers(0, 3, E))).astype(np.float32), 0.0),
        obs_valid=pad(np.ones(E, bool), False),
    )


def test_bundle_adjust(cams, ba_problem):
    jc, tc = cams
    jp = jba.BAProblem(**{k: jx(v) for k, v in ba_problem.items()})
    tp = tba.BAProblem(**{k: tt(v) for k, v in ba_problem.items()})
    j = jba.bundle_adjust(jp, jc, lm_iters=8, cg_iters=15)
    t = tba.bundle_adjust(tp, tc, lm_iters=8, cg_iters=15)
    assert_same(j.cam_pose, t.cam_pose, rtol=0, atol=1e-3, what="cam_pose")
    assert_same(j.xyz, t.xyz, rtol=0, atol=1e-3, what="xyz")
    assert_same(j.obs_inlier, t.obs_inlier, what="obs_inlier")
    np.testing.assert_allclose(float(j.final_error), float(t.final_error), rtol=1e-3)
    assert float(t.final_error) < float(tba.bundle_adjust(tp, tc, lm_iters=0).final_error)

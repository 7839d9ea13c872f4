"""A small map with real geometry for the mapping programs' tests: a
scene of points seen by keyframes along a sideways path, some points
already in the map (bound in every keyframe that sees them, so the
keyframes are covisible), the rest seen but unbound (what triangulation
and fusion work on). Descriptors and vocabulary nodes follow the point,
image points are exact projections, so both packages' eigen-solvers
agree to float rounding. Also the triangulation gate's degenerate cases
(`degenerate`), which the CPU tests hold against the JAX package and the
card tests hold the kernel to. `local_ba_problem` gathers the local BA
window of the fixture's new keyframe, as the mapper does."""

from __future__ import annotations

import numpy as np

from orb_slam_cuda_tpu_torch.geometry import se3

K, N, P = 12, 96, 2048
N_LIVE = 7  # keyframes 0..6 valid; 6 is the new one
N_SCENE, N_MAPPED = 160, 70
CAM_ARGS = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240)


def arrays(seed: int = 0) -> dict:
    import torch

    rng = np.random.default_rng(seed)
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0] = -0.25 * np.arange(K)
    xi[:, 3:] = rng.normal(0, 0.01, (K, 3))
    poses = se3.exp(torch.as_tensor(xi)).numpy()
    scene = rng.uniform([-3, -2, 6], [3, 2, 10], (N_SCENE, 3)).astype(np.float32)
    pdesc = rng.integers(0, 2**32, (N_SCENE, 8), dtype=np.uint32)
    pnode = rng.integers(0, 12, N_SCENE).astype(np.int32)
    kf_valid = np.arange(K) < N_LIVE
    kf_mp = np.full((K, N), -1, np.int32)
    uv = np.zeros((K, N, 2), np.float32)
    desc = rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32)
    node = rng.integers(0, 12, (K, N)).astype(np.int32)
    feat_valid = np.zeros((K, N), bool)
    for k in range(N_LIVE):
        seen = np.sort(rng.choice(N_SCENE, N - 6, replace=False))
        Xc = scene[seen] @ poses[k][:3, :3].T + poses[k][:3, 3]
        uv[k, : len(seen)] = Xc[:, :2] / Xc[:, 2:] * 200 + [160, 120]
        desc[k, : len(seen)] = pdesc[seen]
        node[k, : len(seen)] = pnode[seen]
        feat_valid[k] = True
        mapped = seen < N_MAPPED
        kf_mp[k, : len(seen)] = np.where(mapped, seen, -1)
    mp_valid = np.arange(P) < N_MAPPED
    xyz = np.zeros((P, 3), np.float32)
    xyz[:N_MAPPED] = scene[:N_MAPPED]
    mp_desc = np.zeros((P, 8), np.uint32)
    mp_desc[:N_MAPPED] = pdesc[:N_MAPPED]
    return dict(
        kf_pose=poses, kf_valid=kf_valid, kf_frame_id=np.arange(K, dtype=np.int32) * 3,
        kf_uv=uv, kf_right=np.full((K, N), -1.0, np.float32), kf_depth=np.full((K, N), -1.0, np.float32),
        kf_oct=np.zeros((K, N), np.int32), kf_ang=np.zeros((K, N), np.float32),
        kf_desc=desc, kf_feat_valid=feat_valid, kf_word=node.copy(), kf_node=node,
        kf_mp=kf_mp, covis=np.zeros((K, K), np.int32),
        mp_xyz=xyz, mp_valid=mp_valid, mp_desc=mp_desc,
        mp_normal=np.zeros((P, 3), np.float32), mp_min_dist=np.zeros(P, np.float32),
        mp_max_dist=np.full(P, 1e9, np.float32),
        mp_ref_kf=np.where(mp_valid, 0, -1).astype(np.int32),
        mp_first_kf=np.where(mp_valid, 0, -1).astype(np.int32),
        mp_visible=np.ones(P, np.float32), mp_found=np.ones(P, np.float32),
    )


DEGENERATE_CASES = ("unmatched", "behind", "zero_parallax", "w_clamped", "scale_edge")


def degenerate(case):
    """(T1, T2, xy1, uv2, idx, oct1, oct2, the ok expected) of one of the
    triangulation gate's degenerate cases, in the fixture's camera: two
    cameras 0.5 m apart and three points, each case in DEGENERATE_CASES."""
    fx, cx, cy = CAM_ARGS["fx"], CAM_ARGS["cx"], CAM_ARGS["cy"]
    T1, T2 = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    T2[0, 3] = -0.5  # the second camera 0.5 m to the right
    if case == "scale_edge":
        # Equal octaves, so the distance ratio must lie within (1/1.8, 1.8):
        # points with d1/d2 1% inside and 1% outside each edge.
        def point(ratio):
            lo, hi = 0.5, 60.0  # along z = 0.1, d1/d2 falls from 5.1 to 1 with x past the second camera
            for _ in range(200):
                mid = 0.5 * (lo + hi)
                r = np.hypot(mid, 0.1) / np.hypot(mid - 0.5, 0.1)
                lo, hi = (mid, hi) if r > ratio else (lo, mid)
            return [lo, 0.0, 0.1]

        # The third mirrors the first about x = 0.25: d1/d2 1% inside 1/1.8.
        X = np.array([point(1.8 * 0.99), point(1.8 * 1.01), [0.5 - point(1.8 * 0.99)[0], 0, 0.1]], np.float64)
        expect = [True, False, True]
    elif case == "behind":
        X = np.array([[1.0, 0.5, -10.0], [-2.0, 0.3, -4.0], [0.4, -0.2, -25.0]])
        expect = [False] * 3
    else:
        X = np.array([[1.0, 0.5, 10.0], [-2.0, 0.3, 4.0], [0.4, -0.2, 25.0]])
        expect = [False] * 3
    if case == "zero_parallax":
        T2 = T1.copy()
    if case == "w_clamped":  # A = 0: eigh gives e1, w = 0, X = (1e12, 0, 0)
        T1[:] = 0
        T2[:] = 0
    n = X.shape[0]
    Xh = np.concatenate([X, np.ones((n, 1))], 1)
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]])

    def proj(T):
        y = Xh @ (K @ (np.eye(4, dtype=np.float32) if case == "w_clamped" else T)[:3]).T
        return (y[:, :2] / y[:, 2:]).astype(np.float32)

    xy1, xy2 = proj(T1), proj(T2)
    uv2 = xy2[::-1].copy()  # the neighbour's features in another order
    idx = np.arange(n)[::-1].copy() if case != "unmatched" else np.full(n, -1)
    oct_ = np.array([0, 3, -1] if case != "scale_edge" else [2, 2, 99], np.int32)[:n]
    return T1, T2, xy1, uv2, idx.astype(np.int64), oct_, oct_[::-1].copy(), expect


def local_ba_problem(device="cpu"):
    """(BAProblem, Camera): the local BA window of the new keyframe (slot
    N_LIVE - 1) over the fixture's map on `device`, gathered as the mapper
    gathers it (8 local and 4 fixed cameras, 256 points): 12 x 96 dense
    observation slots, about a quarter of them valid."""
    import types

    import torch

    from orb_slam_cuda_tpu_torch.engine import local_mapping
    from orb_slam_cuda_tpu_torch.geometry.camera import Camera
    from orb_slam_cuda_tpu_torch.slam_map import MapConfig
    from orb_slam_cuda_tpu_torch.slam_map import ops as map_ops
    from orb_slam_cuda_tpu_torch.utils import convert

    cfg = MapConfig(max_keyframes=K, max_features=N, max_points=P)
    state = convert.map_state(types.SimpleNamespace(**arrays()), device)
    state = map_ops.update_point_stats(map_ops.refresh_covis_rows(state, torch.arange(K, device=device)), cfg)
    cam = Camera.create(**CAM_ARGS)
    inv_sig = 1.0 / torch.as_tensor(cfg.level_sigma2, dtype=torch.float32)
    problem, _, _ = local_mapping.gather_local_ba_problem(state, N_LIVE - 1, cam, inv_sig, n_local=8, n_fixed=4,
                                                          n_points=256)
    return problem, cam

"""A small map with real geometry for the mapping programs' tests: a
scene of points seen by keyframes along a sideways path, some points
already in the map (bound in every keyframe that sees them, so the
keyframes are covisible), the rest seen but unbound (what triangulation
and fusion work on). Descriptors and vocabulary nodes follow the point,
image points are exact projections, so both packages' eigen-solvers
agree to float rounding."""

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

"""Trajectory evaluation: ATE / RPE (numpy; a copy of
orb_slam_cuda_tpu/utils/evaluation.py)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Least-squares similarity (or rigid) alignment est -> gt:
    returns (s, R, t) with gt ~= s * R @ est + t."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    cov = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (E**2).sum() / len(est)
        s = np.trace(np.diag(D) @ S) / var_e
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_positions, gt_positions, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after (similarity) alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape and est.ndim == 2
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(((aligned - gt) ** 2).sum(axis=1).mean()))


def camera_centers(trajectory):
    """[(t, Tcw, ok)] -> (timestamps, centers (N,3)) for tracked frames."""
    ts, cs = [], []
    for stamp, T, ok in trajectory:
        if ok and T is not None:
            Twc = np.linalg.inv(T)
            ts.append(stamp)
            cs.append(Twc[:3, 3])
    return np.asarray(ts), np.asarray(cs)


def rpe_translation(est_poses, gt_poses, delta: int = 1):
    """Relative pose error (translation) over `delta`-frame intervals."""
    errs = []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        rel = np.linalg.inv(dg) @ de
        errs.append(np.linalg.norm(rel[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else 0.0

"""Trajectory export in TUM and KITTI formats (torch port of
orb_slam_cuda_tpu/io/trajectory.py): TUM rows are
`timestamp tx ty tz qx qy qz qw` of the camera-to-world transform, KITTI
rows the 3x4 camera-to-world matrix row-major. Untracked frames are
skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3


def _twc(Tcw: np.ndarray) -> np.ndarray:
    return np.linalg.inv(Tcw)


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit (w, x, y, z), w >= 0, by Shepperd's method
    in float32 on the host. Each step is one correctly rounded float32
    operation and the squared norm is accumulated with fused multiply-adds
    (emulated through float64), which is what the reference package's
    compiled float32 code computes on a CPU: the files the two packages
    write then agree to the last printed digit."""
    f = np.float32
    m = np.asarray(R, np.float64).astype(f)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    scores = [tr, m[0, 0] - m[1, 1] - m[2, 2], m[1, 1] - m[0, 0] - m[2, 2], m[2, 2] - m[0, 0] - m[1, 1]]
    best = int(np.argmax(scores))
    one = f(1.0)
    arg = [one + tr, one + m[0, 0] - m[1, 1] - m[2, 2], one - m[0, 0] + m[1, 1] - m[2, 2],
           one - m[0, 0] - m[1, 1] + m[2, 2]][best]
    d = np.sqrt(np.maximum(arg, f(1e-8))) / f(2.0)
    d4 = f(4.0) * d
    if best == 0:
        q = [d, (m[2, 1] - m[1, 2]) / d4, (m[0, 2] - m[2, 0]) / d4, (m[1, 0] - m[0, 1]) / d4]
    elif best == 1:
        q = [(m[2, 1] - m[1, 2]) / d4, d, (m[0, 1] + m[1, 0]) / d4, (m[0, 2] + m[2, 0]) / d4]
    elif best == 2:
        q = [(m[0, 2] - m[2, 0]) / d4, (m[0, 1] + m[1, 0]) / d4, d, (m[1, 2] + m[2, 1]) / d4]
    else:
        q = [(m[1, 0] - m[0, 1]) / d4, (m[0, 2] + m[2, 0]) / d4, (m[1, 2] + m[2, 1]) / d4, d]
    q = np.asarray(q, f)
    if q[0] < 0:
        q = -q
    acc = q[0] * q[0]
    for v in q[1:]:
        acc = f(np.float64(v) * np.float64(v) + np.float64(acc))
    return q / np.sqrt(acc)


def _tum_row(t, Tcw) -> str:
    Twc = _twc(np.asarray(Tcw, np.float64))
    q = _quat_wxyz(Twc[:3, :3])
    tx, ty, tz = Twc[:3, 3]
    return (f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
            f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def save_trajectory_tum(trajectory, path: str):
    """trajectory: [(timestamp, Tcw 4x4 or None, ok)]."""
    with open(path, "w") as f:
        for t, Tcw, ok in trajectory:
            if ok and Tcw is not None:
                f.write(_tum_row(t, Tcw))


def save_trajectory_kitti(trajectory, path: str):
    with open(path, "w") as f:
        for _, Tcw, ok in trajectory:
            if not ok or Tcw is None:
                continue
            row = _twc(np.asarray(Tcw, np.float64))[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_keyframe_trajectory_tum(state, kf_order, timestamps, path: str):
    """Keyframe-only trajectory; `timestamps` maps slot -> timestamp."""
    kf_pose = state.kf_pose.cpu().numpy()
    with open(path, "w") as f:
        for slot in kf_order:
            f.write(_tum_row(timestamps.get(slot, 0.0), kf_pose[slot]))


def load_trajectory_tum(path: str):
    """Inverse of save_trajectory_tum -> [(t, Tcw)]."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 8:
                continue
            t = float(parts[0])
            tx, ty, tz, qx, qy, qz, qw = [float(x) for x in parts[1:]]
            R = se3.quat_to_rot(torch.tensor([qw, qx, qy, qz], dtype=torch.float32)).numpy()
            Twc = np.eye(4)
            Twc[:3, :3] = R
            Twc[:3, 3] = [tx, ty, tz]
            out.append((t, np.linalg.inv(Twc)))
    return out

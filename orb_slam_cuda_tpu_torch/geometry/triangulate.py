"""Batched two-view triangulation and epipolar helpers (torch port of
orb_slam_cuda_tpu/geometry/triangulate.py)."""

from __future__ import annotations

import torch

from ..ops import dlt_kernel


def triangulate_dlt(P1, P2, xy1, xy2):
    """Linear (DLT) triangulation. P1, P2: (3,4); xy1, xy2: (N,2).
    Returns (N,3). On the card the hand-written kernel of
    ops/dlt_kernel.py (Jacobi in double, no host sync), on the CPU the
    plain version."""
    return dlt_kernel.triangulate_dlt(P1.float().contiguous(), P2.float().contiguous(),
                                      xy1.float().contiguous(), xy2.float().contiguous())


def triangulate_dlt_plain(P1, P2, xy1, xy2):
    """The plain version: the null vector is the smallest-eigenvalue
    eigenvector of A^T A, as the reference computes it (`eigh`, which on
    the card reads a status back)."""
    def rows(P, xy):
        r1 = xy[..., 0:1] * P[2] - P[0]
        r2 = xy[..., 1:2] * P[2] - P[1]
        return torch.stack([r1, r2], dim=-2)

    A = torch.cat([rows(P1, xy1), rows(P2, xy2)], dim=-2)
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)
    Xh = V[..., :, 0]
    w = Xh[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / w[..., None]


def projection_matrix(K, T):
    """K (3,3) and world->cam T (4,4) -> P = K [R|t] (3,4)."""
    return K @ T[:3, :4]


def cheirality_and_parallax(X, T1, T2):
    """(z1, z2, cos_parallax), each (N,), for world points X (N,3)."""
    C1 = -T1[:3, :3].T @ T1[:3, 3]
    C2 = -T2[:3, :3].T @ T2[:3, 3]
    z1 = (X @ T1[:3, :3].T + T1[:3, 3])[..., 2]
    z2 = (X @ T2[:3, :3].T + T2[:3, 3])[..., 2]
    d1 = X - C1
    d2 = X - C2
    n1 = torch.linalg.norm(d1, dim=-1)
    n2 = torch.linalg.norm(d2, dim=-1)
    cosp = torch.sum(d1 * d2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
    return z1, z2, cosp


def fundamental_from_poses(K1, T1w, K2, T2w):
    """F12 with x1^T F12 x2 = 0, from two world->cam poses."""
    T12 = T1w @ _inv(T2w)
    R12 = T12[:3, :3]
    t12 = T12[:3, 3]
    z = torch.zeros((), dtype=T1w.dtype, device=T1w.device)
    tx = torch.stack(
        [
            torch.stack([z, -t12[2], t12[1]]),
            torch.stack([t12[2], z, -t12[0]]),
            torch.stack([-t12[1], t12[0], z]),
        ]
    )
    return _inv(K1).T @ tx @ R12 @ _inv(K2)


def _inv(M):
    """`linalg.inv` without its error check, which reads a status back on
    the card (the same bits)."""
    return torch.linalg.inv_ex(M, check_errors=False).inverse


def epipolar_distance_sq(F12, xy1, xy2):
    """Squared distance of xy2 to the epipolar line F12^T x1 in image 2."""
    x1h = torch.cat([xy1, torch.ones_like(xy1[..., :1])], dim=-1)
    line = x1h @ F12
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    num = a * xy2[..., 0] + b * xy2[..., 1] + c
    den = torch.clamp(a * a + b * b, min=1e-12)
    return num * num / den

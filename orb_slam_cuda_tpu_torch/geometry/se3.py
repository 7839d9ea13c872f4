"""SE(3) / SO(3) manifold operations on torch tensors.

Port of orb_slam_cuda_tpu/geometry/se3.py. Conventions are unchanged:
poses are 4x4 world->camera transforms, tangent vectors are
(rho, phi) with translation first, quaternions are (w, x, y, z).
Small-angle cases use the same Taylor `where` selects, so results agree
with the reference to float32 rounding.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(phi):
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape[:-1] + (3, 3)
    )


def so3_exp(phi):
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    KK = K @ K
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return _eye3(phi) + a * K + b * KK


def so3_log(R):
    """(...,3,3) rotation matrix -> (...,3) axis-angle (atan2 form)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = 0.5 * torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-4
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    sin_safe = torch.where(small, torch.ones_like(sin_t), sin_t)
    scale = torch.where(
        small, 0.5 + theta * theta / 12.0, 0.5 * theta_safe / sin_safe
    )
    log_generic = scale[..., None] * w
    # Near theta == pi, w ~ 0: recover the axis from diag(R).
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_t[..., None]) / torch.clamp(1.0 - cos_t[..., None], min=_EPS),
        0.0, 1.0,
    )
    axis = torch.sqrt(axis2)
    s01 = R[..., 0, 1] + R[..., 1, 0]
    sx = torch.sign(torch.where(w[..., 0] == 0, s01, w[..., 0]))
    sx1 = torch.where(sx == 0, torch.ones_like(sx), sx)
    axis = axis * torch.stack(
        [
            sx1,
            torch.sign(s01 * sx1 + _EPS),
            torch.sign((R[..., 0, 2] + R[..., 2, 0]) * sx1 + _EPS),
        ],
        dim=-1,
    )
    log_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], log_pi, log_generic)


def _left_jacobian(phi):
    """SO(3) left Jacobian J_l(phi), used by se3 exp for the translation."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    KK = K @ K
    big = theta2 > _EPS
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(
        big, (theta - torch.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0
    )
    return _eye3(phi) + b * K + c * KK


def _left_jacobian_inv(phi):
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    KK = K @ K
    half = 0.5 * theta
    big = theta2 > _EPS
    cot = torch.where(big, half / torch.tan(half + _EPS), 1.0 - theta2 / 12.0)
    coef = torch.where(big, (1.0 - cot) / theta2, 1.0 / 12.0 + theta2 / 720.0)
    return _eye3(phi) - 0.5 * K + coef * KK


def make_T(R, t):
    """Assemble (...,4,4) from (...,3,3) and (...,3)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # `= 1.0` would copy a host scalar to the device
    return T


def exp(xi):
    """se(3) exp: (...,6) tangent (rho, phi) -> (...,4,4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return make_T(R, t)


def log(T):
    """(...,4,4) transform -> (...,6) tangent (rho, phi)."""
    phi = so3_log(T[..., :3, :3])
    rho = (_left_jacobian_inv(phi) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def orthonormalize(T):
    """Project the rotation block back onto SO(3) with two Newton steps of
    the polar iteration X <- X (3I - X^T X) / 2 (see the reference for why
    multiplicative pose chains need it)."""
    R = T[..., :3, :3]
    eye3 = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(2):
        R = R @ (3.0 * eye3 - R.transpose(-1, -2) @ R) * 0.5
    out = T.clone()
    out[..., :3, :3] = R
    return out


def inverse(T):
    """Inverse of (...,4,4) rigid transform without a general solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    Ti = torch.zeros_like(T)
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3:4] = -(Rt @ t)
    Ti[..., 3, 3].fill_(1.0)
    return Ti


def compose(A, B):
    """A @ B for (...,4,4) transforms."""
    return A @ B


def transform(T, X):
    """Apply (...,4,4) to points (...,N,3) (or (...,3)) -> same shape."""
    squeeze = X.dim() == T.dim() - 1
    if squeeze:
        X = X[..., None, :]
    Y = X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    return Y[..., 0, :] if squeeze else Y


def retract(T, xi):
    """Left-multiplicative update exp(xi) @ T (g2o SE3 oplus convention)."""
    return compose(exp(xi), T)


def quat_to_rot(q):
    """(...,4) quaternion (w,x,y,z) -> (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R):
    """(...,3,3) -> (...,4) quaternion (w,x,y,z), w >= 0 (branch-free
    Shepperd's method, as the reference)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw0 = _safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = _safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = _safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = _safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], dim=-1)

    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    w0 = q[..., 0:1]
    q = q * torch.sign(torch.where(w0 == 0, torch.ones_like(w0), w0))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)

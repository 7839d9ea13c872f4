"""Sim(3) similarity-transform manifold ops (torch port of
orb_slam_cuda_tpu/geometry/sim3.py).

A Sim3 is the tuple ``(R (...,3,3), t (...,3), s (...,))`` acting on points
as ``x -> s * R @ x + t``. Tangent vectors are (...,7): ``(rho, phi,
sigma)``, translation, rotation, log-scale, in g2o's order.
"""

from __future__ import annotations

import torch

from . import se3

_EPS = 1e-8


def identity(batch_shape=(), dtype=torch.float32, device="cpu"):
    R = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch_shape) + (3, 3))
    t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
    s = torch.ones(tuple(batch_shape), dtype=dtype, device=device)
    return R, t, s


def compose(a, b):
    """(Ra,ta,sa) o (Rb,tb,sb): x -> sa Ra (sb Rb x + tb) + ta."""
    Ra, ta, sa = a
    Rb, tb, sb = b
    R = Ra @ Rb
    t = sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta
    return R, t, sa * sb


def inverse(S):
    R, t, s = S
    Ri = R.transpose(-1, -2)
    si = 1.0 / s
    ti = -si[..., None] * (Ri @ t[..., None])[..., 0]
    return Ri, ti, si


def transform(S, X):
    """Apply a Sim3 to points (...,N,3) or (...,3)."""
    R, t, s = S
    squeeze = X.dim() == R.dim() - 1
    if squeeze:
        X = X[..., None, :]
    Y = s[..., None, None] * (X @ R.transpose(-1, -2)) + t[..., None, :]
    return Y[..., 0, :] if squeeze else Y


def exp(xi):
    """sim(3) exp: (...,7) (rho, phi, sigma) -> (R, t, s), the closed form
    of Strasdat's scale-drift-aware SLAM, as the reference."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = se3.so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    K = se3.hat(phi)
    KK = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)

    near_zero_sigma = torch.abs(sigma) < 1e-5
    near_zero_theta = theta2 < _EPS
    one = torch.ones_like(sigma)
    sig = torch.where(near_zero_sigma, one, sigma)
    th = torch.where(near_zero_theta, one, theta)
    C = torch.where(near_zero_sigma, one, (s - 1.0) / sig)

    a_ = s * torch.sin(th)
    b_ = s * torch.cos(th)
    th2_sig2 = th * th + sig * sig
    A_g = torch.where(
        near_zero_sigma,
        (1.0 - torch.cos(th)) / torch.clamp(th * th, min=_EPS),
        (a_ * sig + (1.0 - b_) * th) / torch.clamp(th * th2_sig2, min=_EPS),
    )
    B_g = torch.where(
        near_zero_sigma,
        (th - torch.sin(th)) / torch.clamp(th * th * th, min=_EPS),
        (C - ((b_ - 1.0) * sig + a_ * th) / th2_sig2) / torch.clamp(th * th, min=_EPS),
    )
    A = torch.where(near_zero_theta, torch.zeros_like(A_g), A_g)
    B = torch.where(near_zero_theta, torch.zeros_like(B_g), B_g)
    W = C[..., None, None] * eye + A[..., None, None] * K + B[..., None, None] * KK
    t = (W @ rho[..., None])[..., 0]
    return R, t, s


def _w_matrix(phi, sigma):
    """The 3x3 map rho -> t of `exp` at (phi, sigma), column by column."""
    zeros = torch.zeros(phi.shape[:-1] + (3,), dtype=phi.dtype, device=phi.device)
    basis = torch.eye(3, dtype=phi.dtype, device=phi.device)
    cols = []
    for i in range(3):
        rho = zeros + basis[i]
        cols.append(exp(torch.cat([rho, phi, sigma[..., None]], dim=-1))[1])
    return torch.stack(cols, dim=-1)


def log(S):
    """(R, t, s) -> (...,7) tangent; the inverse of `exp` (solves W rho = t)."""
    R, t, s = S
    phi = se3.so3_log(R)
    sigma = torch.log(s)
    # `solve_ex` without its error check, which reads a status back on the
    # card: the same bits.
    rho = torch.linalg.solve_ex(_w_matrix(phi, sigma), t[..., None], check_errors=False).result[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def retract(S, xi):
    """Left-multiplicative update exp(xi) o S."""
    return compose(exp(xi), S)


def from_se3(T, s=None):
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return T[..., :3, :3], T[..., :3, 3], s


def to_se3(S):
    """Fold the scale into the translation: [R t/s; 0 1]."""
    R, t, s = S
    return se3.make_T(R, t / s[..., None])


def tangent_jacobian(f, x0):
    """df/dx at x0 (...,7), one forward-mode jvp per tangent coordinate
    (each moving that coordinate of every batch entry at once, so batch
    entries of x0 must act independently): (...out, 7). Evaluated in
    float64, since forward-mode `where`/`clamp` can hand out float64
    tangents for float32 inputs; `torch.func.vmap` is avoided, its batching
    of this chain returned wrong derivatives."""
    x0 = x0.double()
    cols = []
    for c in range(x0.shape[-1]):
        tangent = torch.zeros_like(x0)
        tangent[..., c].fill_(1.0)
        cols.append(torch.func.jvp(f, (x0,), (tangent,))[1])
    return torch.stack(cols, dim=-1)


def stack(Ss):
    Rs, ts, ss = zip(*Ss)
    return torch.stack(Rs), torch.stack(ts), torch.stack(ss)

"""Monocular two-view initialization: batched H/F RANSAC + reconstruction
(torch port of orb_slam_cuda_tpu/solvers/initializer.py). Hypotheses
are a batch dimension; the minimal sets come from a torch.Generator, or
are passed in (`sets`) so tests can inject the reference's draws."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import triangulate

SIGMA = 1.0
TH_F = 3.841
TH_H = 5.991
TH_SCORE = 5.991


class InitResult(NamedTuple):
    success: torch.Tensor  # () bool
    R: torch.Tensor  # (3,3) cam1->cam2 rotation
    t: torch.Tensor  # (3,) unit translation
    points: torch.Tensor  # (M,3) triangulated in cam1 frame
    is_point: torch.Tensor  # (M,) bool
    used_homography: torch.Tensor  # () bool


def _eye3(ref, batch=()):
    return torch.eye(3, dtype=torch.float32, device=ref.device).expand(batch + (3, 3)).clone()


def _normalize(xy, valid):
    """Mean / mean-abs-dev normalization. Returns (xyn, T (3,3))."""
    w = valid.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(xy * w[:, None], dim=0) / n
    md = torch.sum(torch.abs(xy - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(md, min=1e-9)
    xyn = (xy - mean) * s
    T = _eye3(xy)
    T[0, 0] = s[0]
    T[1, 1] = s[1]
    T[0, 2] = -mean[0] * s[0]
    T[1, 2] = -mean[1] * s[1]
    return xyn, T


def _smallest_eigvec(A):
    """(...,R,9) -> (...,9) eigenvector of A^T A with the least eigenvalue."""
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0]


def _fit_f(x1, x2, w=None):
    """8-point fundamental (x2^T F x1 = 0), rank 2; optional row weights.
    x1, x2: (...,R,2)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)
    if w is not None:
        A = A * w[..., None]
    F = _smallest_eigvec(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = S.clone()
    S[..., 2] = 0.0
    return U @ torch.diag_embed(S) @ Vt


def _fit_h(x1, x2, w=None):
    """DLT homography x2 ~ H x1; optional row weights."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    zero = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    r1 = torch.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = torch.cat([r1, r2], dim=-2)
    return _smallest_eigvec(A).reshape(A.shape[:-2] + (3, 3))


def _epi_d2(F, a, b):
    """Batched epipolar_distance_sq: F (...,3,3), a/b (M,2) -> (...,M)."""
    ah = torch.cat([a, torch.ones_like(a[:, :1])], dim=-1)
    line = ah @ F  # (...,M,3)
    num = line[..., 0] * b[:, 0] + line[..., 1] * b[:, 1] + line[..., 2]
    den = torch.clamp(line[..., 0] ** 2 + line[..., 1] ** 2, min=1e-12)
    return num * num / den


def _score_f(F, xy1, xy2, valid):
    """Symmetric epipolar transfer score (CheckFundamental)."""
    inv_s2 = 1.0 / (SIGMA * SIGMA)
    d2_21 = _epi_d2(F.transpose(-1, -2), xy1, xy2) * inv_s2
    d2_12 = _epi_d2(F, xy2, xy1) * inv_s2
    ok1 = d2_21 < TH_F
    ok2 = d2_12 < TH_F
    zero = torch.zeros_like(d2_21)
    score = torch.where(ok1 & valid, TH_SCORE - d2_21, zero) + torch.where(ok2 & valid, TH_SCORE - d2_12, zero)
    return torch.sum(score, dim=-1), ok1 & ok2 & valid


def _apply_h(H, xy):
    xyh = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1)
    y = xyh @ H.transpose(-1, -2)
    z = y[..., 2:3]
    return y[..., :2] / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def _score_h(H, xy1, xy2, valid):
    """Symmetric transfer score (CheckHomography)."""
    inv_s2 = 1.0 / (SIGMA * SIGMA)
    Hinv = torch.linalg.inv(H)
    e12 = torch.sum((_apply_h(Hinv, xy2) - xy1) ** 2, dim=-1) * inv_s2
    e21 = torch.sum((_apply_h(H, xy1) - xy2) ** 2, dim=-1) * inv_s2
    ok1 = e12 < TH_H
    ok2 = e21 < TH_H
    zero = torch.zeros_like(e12)
    score = torch.where(ok1 & valid, TH_H - e12, zero) + torch.where(ok2 & valid, TH_H - e21, zero)
    return torch.sum(score, dim=-1), ok1 & ok2 & valid


def _check_rt(R, t, K, xy1, xy2, valid, th2: float = 4.0):
    """Good triangulations for one motion hypothesis (CheckRT)."""
    T1 = torch.eye(4, dtype=torch.float32, device=R.device)
    T2 = T1.clone()
    T2[:3, :3] = R
    T2[:3, 3] = t
    P1 = triangulate.projection_matrix(K, T1)
    P2 = triangulate.projection_matrix(K, T2)
    X = triangulate.triangulate_dlt(P1, P2, xy1, xy2)
    finite = torch.all(torch.isfinite(X), dim=-1)
    z1, z2, cosp = triangulate.cheirality_and_parallax(X, T1, T2)

    def reproj(P, xy):
        Xh = torch.cat([X, torch.ones_like(X[:, :1])], dim=-1)
        p = Xh @ P.T
        z = p[:, 2:3]
        uv = p[:, :2] / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
        return torch.sum((uv - xy) ** 2, dim=-1)

    good = (
        valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
        & (reproj(P1, xy1) < th2) & (reproj(P2, xy2) < th2)
    )
    cosp_sorted = torch.sort(torch.where(good, cosp, torch.full_like(cosp, 2.0))).values
    n_good = torch.sum(good)
    stat_idx = torch.clamp(torch.clamp(n_good, max=50) - 1, 0, cosp.shape[0] - 1)
    parallax_cos = torch.clamp(cosp_sorted[stat_idx], max=1.0)
    return n_good, good, X, parallax_cos


def _motions_from_f(F, K):
    """E = K^T F K; SVD -> 4 (R,t) candidates."""
    E = K.T @ F @ K
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=F.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_h(H, K):
    """Faugeras decomposition of A = K^-1 H K into 8 motions."""
    A = torch.linalg.inv(K) @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)
    Rs, ts = [], []
    st_base = (d1 - d3) * x1 * x3 / torch.clamp(d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp(d2 * (d1 + d3), min=1e-12)
    sp_base = (d1 + d3) * x1 * x3 / torch.clamp(d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp(d2 * (d1 - d3), min=1e-12)
    for case in (0, 1):
        for e1 in (1.0, -1.0):
            for e3 in (1.0, -1.0):
                if case == 0:
                    st = e1 * e3 * st_base
                    Rp = torch.stack([torch.stack([ct, zero, -st]),
                                      torch.stack([zero, one, zero]),
                                      torch.stack([st, zero, ct])])
                    tp = torch.stack([e1 * x1, zero, -e3 * x3]) * (d1 - d3)
                else:
                    sp = e1 * e3 * sp_base
                    Rp = torch.stack([torch.stack([cp, zero, sp]),
                                      torch.stack([zero, -one, zero]),
                                      torch.stack([sp, zero, -cp])])
                    tp = torch.stack([e1 * x1, zero, e3 * x3]) * (d1 + d3)
                t = U @ tp
                Rs.append(s * U @ Rp @ Vt)
                ts.append(t / torch.clamp(torch.linalg.norm(t), min=1e-12))
    return torch.stack(Rs), torch.stack(ts)


def sets_from_keys(keys, valid, set_size: int):
    """(NH,set_size) minimal sets from (NH,M) uniform keys: per hypothesis,
    the rows of the largest keys among the valid ones, the first index
    among equal keys (a stable descending sort), invalid rows (key -1) only
    once the valid ones are used up, lowest index first. `set_size` rounds
    of a first-maximum argmax, so it runs on the card without a read."""
    r = torch.where(valid.to(keys.device)[None, :], keys, torch.full_like(keys, -1.0))
    picks = []
    for _ in range(min(set_size, r.shape[1])):
        i = torch.argmax(r, dim=1, keepdim=True)  # the first maximum
        picks.append(i)
        r = r.scatter(1, i, torch.full_like(i, float("-inf"), dtype=r.dtype))
    return torch.cat(picks, dim=1)


def draw_sets(valid, n_hypotheses: int, generator: Optional[torch.Generator] = None,
              set_size: int = 8):
    """(NH,set_size) minimal sets: per hypothesis, the valid rows with the
    largest uniform keys (invalid rows never chosen while enough are valid)."""
    M = valid.shape[0]
    r = torch.rand((n_hypotheses, M), generator=generator,
                   device=generator.device if generator is not None else "cpu")
    return sets_from_keys(r, valid, set_size).to(valid.device)


# Minimal-set shapes (hypotheses, set size) of the RANSAC draw sites that
# the engine seeds per call: Sim3 in loop closing, EPnP in relocalization.
SAMPLE_SHAPES = {"sim3": (128, 3), "pnp": (512, 6)}


def default_keys(site: str, seed: int, m: int):
    """The uniform keys (NH,m) behind the engine's draws at `site`, from a
    CPU generator seeded with `seed`: they do not depend on which rows are
    valid."""
    n, _ = SAMPLE_SHAPES[site]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    return torch.rand((n, m), generator=gen)


def default_sampler(site: str, seed: int, valid):
    """The engine's draws: uniform keys from a CPU generator seeded with
    `seed`, so CPU and CUDA runs see the same sets, masked by `valid` on
    its device. On the card the keys go up through pinned memory without
    waiting for the stream, and nothing is read back."""
    keys = default_keys(site, seed, valid.shape[0])
    if valid.device.type == "cuda":
        keys = keys.pin_memory().to(valid.device, non_blocking=True)
    return sets_from_keys(keys, valid, SAMPLE_SHAPES[site][1])


def initialize_two_view(xy1, xy2, valid, K, generator=None, n_hypotheses: int = 200,
                        min_parallax_deg: float = 1.0, min_triangulated: int = 50,
                        sets=None) -> InitResult:
    """Two-view bootstrap on matched undistorted coords (M,2)."""
    n_valid = torch.sum(valid)
    xy1n, T1 = _normalize(xy1, valid)
    xy2n, T2 = _normalize(xy2, valid)
    if sets is None:
        sets = draw_sets(valid, n_hypotheses, generator)
    sets = torch.as_tensor(sets, device=xy1.device).long()

    # All hypotheses at once: (NH,8,2) minimal sets.
    F_n = _fit_f(xy1n[sets], xy2n[sets])
    Fs = T2.T @ F_n @ T1
    f22 = Fs[:, 2:3, 2:3]
    Fs = Fs / torch.where(torch.abs(f22) < 1e-12, torch.ones_like(f22), f22)
    sf, _ = _score_f(Fs, xy1, xy2, valid)
    H_n = _fit_h(xy1n[sets], xy2n[sets])
    Hs = torch.linalg.inv(T2) @ H_n @ T1
    sh, _ = _score_h(Hs, xy1, xy2, valid)
    F = Fs[torch.argmax(sf)]
    H = Hs[torch.argmax(sh)]
    _, inliers_f = _score_f(F, xy1, xy2, valid)
    _, inliers_h = _score_h(H, xy1, xy2, valid)

    # Two rounds of all-inlier weighted refit.
    for _ in range(2):
        F = T2.T @ _fit_f(xy1n, xy2n, inliers_f.to(torch.float32)) @ T1
        _, inliers_f = _score_f(F, xy1, xy2, valid)
        H = torch.linalg.inv(T2) @ _fit_h(xy1n, xy2n, inliers_h.to(torch.float32)) @ T1
        _, inliers_h = _score_h(H, xy1, xy2, valid)
    SF, _ = _score_f(F, xy1, xy2, valid)
    SH, _ = _score_h(H, xy1, xy2, valid)
    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40

    def best_of(Rs, ts, inl):
        checks = [_check_rt(Rs[i], ts[i], K, xy1, xy2, inl) for i in range(Rs.shape[0])]
        ngs = torch.stack([c[0] for c in checks])
        best = torch.argmax(ngs)
        n_good, good, X, par = checks[int(best)]
        n_similar = torch.sum(ngs > 0.7 * n_good)
        parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(par, -1.0, 1.0)))
        ok = (
            (n_good > 0.9 * torch.sum(inl)) & (n_similar == 1)
            & (parallax_deg > min_parallax_deg) & (n_good >= min_triangulated)
        )
        return ok, Rs[best], ts[best], X, good

    ok_f, R_f, t_f, X_f, g_f = best_of(*_motions_from_f(F, K), inliers_f)
    ok_h, R_h, t_h, X_h, g_h = best_of(*_motions_from_h(H, K), inliers_h)
    return InitResult(
        success=torch.where(use_h, ok_h, ok_f) & (n_valid >= 8),
        R=torch.where(use_h, R_h, R_f),
        t=torch.where(use_h, t_h, t_f),
        points=torch.where(use_h, X_h, X_f),
        is_point=torch.where(use_h, g_h, g_f),
        used_homography=use_h,
    )

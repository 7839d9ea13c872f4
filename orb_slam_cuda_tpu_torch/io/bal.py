"""BAL-format bundle-adjustment problem IO (port of
orb_slam_cuda_tpu/io/bal.py: the same text, read and written through the
port's BAProblem and se3).

Parity for the reference's PBA file bridge (reference:
`Converter::toPbaDataMatrix/printPbaMatrixToFile/dataFromPbaFile`
src/Converter.cc + include/Converter.h:57-60, consumed by the GBA dump at
src/Optimizer.cc:55-73 and by PBA's own loader
Thirdparty/pba/src/pba/util.h): header `<ncam> <npt> <nproj>`, then
observation rows `<cam> <pt> <x> <y>`, camera rows (Rodrigues rotation,
translation, focal, two zero distortion terms), and xyz point rows. The
reference used this to A/B its CUDA BA against g2o (SURVEY.md §4); here
it serves the same role: offline BA benchmarking fixtures
interchangeable with standard BAL tooling.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3
from ..solvers import bundle_adjust as ba
from ..utils.device import host, resolve


def save_bal(problem, path: str, focal: float):
    """Write a solvers.bundle_adjust.BAProblem (mono observations) to a
    BAL text file. Observations are written as stored (the reference's
    `printPbaMatrixToFile` writes measurement coordinates as-is)."""
    obs_valid = host(problem.obs_valid)
    oc = host(problem.obs_cam)[obs_valid]
    op = host(problem.obs_pt)[obs_valid]
    uv = host(problem.obs_uv)[obs_valid]
    cams = host(problem.cam_pose)
    pts = host(problem.xyz)
    pt_valid = host(problem.pt_valid)

    n_cam = cams.shape[0]
    n_pt = pts.shape[0]
    rods = se3.so3_log(torch.as_tensor(cams[:, :3, :3].astype(np.float32))).numpy()
    with open(path, "w") as f:
        f.write(f"{n_cam} {n_pt} {len(oc)}\n")
        for c, p, (x, y) in zip(oc, op, uv):
            f.write(f"{c} {p} {x:.6f} {y:.6f}\n")
        for c in range(n_cam):
            t = cams[c, :3, 3]
            rod = rods[c]
            f.write(
                f"{rod[0]:.9f} {rod[1]:.9f} {rod[2]:.9f} "
                f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} {focal:.6f} 0 0\n"
            )
        for p in range(n_pt):
            x, y, z = pts[p] if pt_valid[p] else (0.0, 0.0, 0.0)
            f.write(f"{x:.9f} {y:.9f} {z:.9f}\n")
    return path


def load_bal(path: str, device="cuda"):
    """Read a BAL file -> (BAProblem on `device`, focal): the card unless
    the caller passes `device="cpu"`. Accepts both this module's output
    and standard BAL datasets (9-param camera rows: angle-axis, t, f, k1,
    k2 — distortion ignored)."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    n_cam, n_pt, n_obs = int(next(it)), int(next(it)), int(next(it))
    oc = np.zeros(n_obs, np.int32)
    op = np.zeros(n_obs, np.int32)
    uv = np.zeros((n_obs, 2), np.float32)
    for i in range(n_obs):
        oc[i] = int(next(it))
        op[i] = int(next(it))
        uv[i, 0] = float(next(it))
        uv[i, 1] = float(next(it))
    rods = np.zeros((n_cam, 3), np.float32)
    cams = np.zeros((n_cam, 4, 4), np.float32)
    focal = 1.0
    for c in range(n_cam):
        rods[c] = [float(next(it)) for _ in range(3)]
        cams[c] = np.eye(4)
        cams[c, :3, 3] = [float(next(it)) for _ in range(3)]
        focal = float(next(it))
        _k1, _k2 = float(next(it)), float(next(it))
    if n_cam:
        cams[:, :3, :3] = se3.so3_exp(torch.as_tensor(rods)).numpy()
    pts = np.zeros((n_pt, 3), np.float32)
    for p in range(n_pt):
        pts[p] = [float(next(it)) for _ in range(3)]

    dev = resolve(device)
    problem = ba.BAProblem(
        cam_pose=torch.as_tensor(cams, device=dev),
        cam_fixed=torch.as_tensor(np.arange(n_cam) == 0, device=dev),
        xyz=torch.as_tensor(pts, device=dev),
        pt_valid=torch.ones((n_pt,), dtype=torch.bool, device=dev),
        obs_cam=torch.as_tensor(oc, device=dev),
        obs_pt=torch.as_tensor(op, device=dev),
        obs_uv=torch.as_tensor(uv, device=dev),
        obs_ur=torch.full((n_obs,), -1.0, dtype=torch.float32, device=dev),
        obs_inv_sigma2=torch.ones((n_obs,), dtype=torch.float32, device=dev),
        obs_valid=torch.ones((n_obs,), dtype=torch.bool, device=dev),
    )
    return problem, focal

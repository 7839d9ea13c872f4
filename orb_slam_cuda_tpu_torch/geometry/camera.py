"""Pinhole camera with radial-tangential distortion (torch port of
orb_slam_cuda_tpu/geometry/camera.py).

Intrinsics are plain Python floats, each rounded to float32 on creation
so that `tensor_f32 * cam.fx` multiplies by the same value the reference
holds in its float32 scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(float(v)))


class Camera(NamedTuple):
    """Intrinsics + distortion. `bf` is stereo baseline x fx; 0 for mono."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    bf: float
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
               width=640, height=480):
        return Camera(_f32(fx), _f32(fy), _f32(cx), _f32(cy), _f32(k1),
                      _f32(k2), _f32(p1), _f32(p2), _f32(k3), _f32(bf),
                      int(width), int(height))

    @property
    def K(self) -> np.ndarray:
        """(3,3) float32 intrinsics matrix as numpy."""
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            np.float32,
        )

    def K_on(self, device) -> torch.Tensor:
        """`K` on `device`, written by fills: no host-to-device copy, which
        a CUDA-graph capture would refuse."""
        K = torch.zeros((3, 3), dtype=torch.float32, device=device)
        for (i, j), v in (((0, 0), self.fx), ((0, 2), self.cx), ((1, 1), self.fy), ((1, 2), self.cy),
                          ((2, 2), 1.0)):
            K[i, j].fill_(v)
        return K

    @property
    def has_distortion(self) -> bool:
        return any(v != 0.0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


def distort_normalized(cam: Camera, xy):
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def project(cam: Camera, Xc, distort: bool = False):
    """Camera-frame points (...,3) -> pixel coords (...,2)."""
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xy = Xc[..., :2] * inv_z[..., None]
    if distort:
        xy = distort_normalized(cam, xy)
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Camera, Xc):
    """(...,3) -> (u, v, u_right), the stereo BA edge's measurement."""
    uv = project(cam, Xc)
    z = torch.clamp(Xc[..., 2], min=1e-9)
    ur = uv[..., 0] - cam.bf / z
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(cam: Camera, uv, depth):
    """Pixel coords (...,2) + depth (...,) -> camera-frame points (...,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def undistort_points(cam: Camera, uv, iters: int = 8):
    """Fixed-point undistortion of pixel coords (...,2), `iters` rounds
    (cv::undistortPoints semantics, as the reference)."""
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    gx, gy = x0, y0
    for _ in range(iters):
        r2 = gx * gx + gy * gy
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * gx * gy + cam.p2 * (r2 + 2.0 * gx * gx)
        dy = cam.p1 * (r2 + 2.0 * gy * gy) + 2.0 * cam.p2 * gx * gy
        gx, gy = (x0 - dx) / radial, (y0 - dy) / radial
    u = cam.fx * gx + cam.cx
    v = cam.fy * gy + cam.cy
    return torch.stack([u, v], dim=-1)


def undistorted_bounds(cam: Camera):
    """Undistorted image bounds (minX, maxX, minY, maxY) from the corners
    (Frame::ComputeImageBounds)."""
    corners = torch.tensor(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height], [cam.width, cam.height]],
        dtype=torch.float32,
    )
    und = undistort_points(cam, corners) if cam.has_distortion else corners
    min_x = torch.minimum(und[0, 0], und[2, 0])
    max_x = torch.maximum(und[1, 0], und[3, 0])
    min_y = torch.minimum(und[0, 1], und[1, 1])
    max_y = torch.maximum(und[2, 1], und[3, 1])
    return min_x, max_x, min_y, max_y

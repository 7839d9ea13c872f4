"""Synthetic textured scenes with exact ground-truth poses, rendered
without OpenCV (port of the planar-scene parts of
orb_slam_cuda_tpu/utils/synthetic.py).

The texture draws from the generator in the reference's order (same
rectangles); the Gaussian blurs are scipy's with reflect-101 borders and
the warp is an inverse-homography bilinear sample with coordinates
quantized to 1/32 px, as cv2.warpPerspective does. Pixels agree with the
OpenCV renderer to within a gray level or two, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from ..geometry import se3


def make_texture(h: int, w: int, rng, n_blobs: int | None = None) -> np.ndarray:
    """Corner-rich random texture: random rectangles over blurred noise."""
    if n_blobs is None:
        n_blobs = max(400, (h * w) // 1475)
    tex = rng.uniform(64, 192, size=(h, w)).astype(np.float32)
    tex = ndimage.gaussian_filter(tex, 3.0, mode="mirror", truncate=4.0)
    for _ in range(n_blobs):
        x, y = rng.integers(0, w - 12), rng.integers(0, h - 12)
        bw, bh = rng.integers(4, 24), rng.integers(4, 24)
        val = rng.uniform(0, 255)
        tex[int(y): int(y + bh) + 1, int(x): int(x + bw) + 1] = np.float32(val)
    tex = ndimage.gaussian_filter(tex, 0.8, mode="mirror", truncate=1.25)
    return np.clip(tex, 0, 255).astype(np.uint8)


class Plane:
    """A textured world plane: X(u,v) = origin + u*eu + v*ev, with texture
    pixel (col,row) at (u,v) = (col*scale, row*scale) meters."""

    def __init__(self, origin, eu, ev, tex, scale):
        self.origin = np.asarray(origin, np.float64)
        self.eu = np.asarray(eu, np.float64)
        self.ev = np.asarray(ev, np.float64)
        self.tex = tex
        self.scale = float(scale)


def _source_coords(H, width, height):
    """Texture coordinates of every output pixel under dst = H src."""
    Hinv = np.linalg.inv(H)
    us, vs = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    X = Hinv[0, 0] * us + Hinv[0, 1] * vs + Hinv[0, 2]
    Y = Hinv[1, 0] * us + Hinv[1, 1] * vs + Hinv[1, 2]
    W = Hinv[2, 0] * us + Hinv[2, 1] * vs + Hinv[2, 2]
    with np.errstate(divide="ignore"):
        W = np.where(W != 0, 1.0 / W, 0.0)
    lim = float(2**28)
    return np.clip(X * W, -lim, lim), np.clip(Y * W, -lim, lim)


def warp_bilinear(tex, H, width, height):
    """Bilinear inverse warp with a zero border (uint8 result)."""
    th, tw = tex.shape
    sx, sy = _source_coords(H, width, height)
    qx = np.rint(sx * 32).astype(np.int64)
    qy = np.rint(sy * 32).astype(np.int64)
    x0, y0 = qx >> 5, qy >> 5
    ax = (qx & 31).astype(np.float32) / 32.0
    ay = (qy & 31).astype(np.float32) / 32.0
    src = tex.astype(np.float32)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < th) & (xx >= 0) & (xx < tw)
        return np.where(inside, src[np.clip(yy, 0, th - 1), np.clip(xx, 0, tw - 1)], 0.0)

    val = ((1 - ay) * ((1 - ax) * tap(y0, x0) + ax * tap(y0, x0 + 1))
           + ay * ((1 - ax) * tap(y0 + 1, x0) + ax * tap(y0 + 1, x0 + 1)))
    return np.clip(np.rint(val), 0, 255).astype(np.uint8)


def warp_coverage(shape, H, width, height):
    """Nearest-neighbour inverse warp of an all-ones mask: True where the
    rounded source pixel lies inside the texture."""
    th, tw = shape
    sx, sy = _source_coords(H, width, height)
    x, y = np.rint(sx), np.rint(sy)
    return (x >= 0) & (x < tw) & (y >= 0) & (y < th)


class PlanarScene:
    """One or more textured planes; renders pinhole views at given poses."""

    def __init__(self, planes):
        self.planes = planes

    @staticmethod
    def default(rng, depth: float = 5.0, second_depth: float = 8.0,
                extent: float = 12.0, tex_size: int = 1024):
        """Two fronto-parallel planes at different depths (x right, y down,
        z forward)."""
        tex1 = make_texture(tex_size, tex_size, rng)
        tex2 = make_texture(tex_size, tex_size, rng)
        p_near = Plane(origin=[-extent / 2, -extent / 2, depth], eu=[1.0, 0, 0],
                       ev=[0, 1.0, 0], tex=tex1, scale=extent / tex_size)
        p_far = Plane(origin=[-extent, -extent, second_depth], eu=[1.0, 0, 0],
                      ev=[0, 1.0, 0], tex=tex2, scale=2 * extent / tex_size)
        return PlanarScene([p_far, p_near])

    def render(self, K, Tcw, width: int, height: int):
        """Grayscale uint8 (height,width) from world->cam pose Tcw. Each
        plane's texture->image map is H = K [R eu, R ev, R origin + t]
        diag(scale, scale, 1); ray-plane depths z-order the planes."""
        K = np.asarray(K, np.float64)
        Tcw = np.asarray(Tcw, np.float64)
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        out = np.zeros((height, width), np.uint8)
        depth = np.full((height, width), np.inf)
        us, vs = np.meshgrid(np.arange(width), np.arange(height))
        rays = np.stack([us, vs, np.ones_like(us)], axis=-1) @ np.linalg.inv(K).T
        for plane in self.planes:
            eu_c = R @ plane.eu
            ev_c = R @ plane.ev
            p0_c = R @ plane.origin + t
            n = np.cross(eu_c, ev_c)
            nn = np.linalg.norm(n)
            if nn < 1e-12:
                continue
            n = n / nn
            denom = rays @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                lam = (n @ p0_c) / denom
            lam = np.where(np.abs(denom) < 1e-9, np.inf, lam)
            H = K @ np.stack([eu_c * plane.scale, ev_c * plane.scale, p0_c], axis=1)
            if abs(np.linalg.det(H)) < 1e-12:
                continue
            warped = warp_bilinear(plane.tex, H, width, height)
            covered = warp_coverage(plane.tex.shape, H, width, height)
            visible = covered & (lam > 0.05) & (lam < depth)
            out = np.where(visible, warped, out)
            depth = np.where(visible, lam, depth)
        return out


def orbit_trajectory(n_frames: int, radius: float = 0.4, depth_amp: float = 0.15,
                     yaw_amp: float = 0.05):
    """Smooth sideways-arc camera trajectory (world->cam poses Tcw)."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        tx = radius * np.sin(2 * np.pi * s)
        ty = 0.08 * np.sin(4 * np.pi * s)
        tz = depth_amp * np.sin(2 * np.pi * s + 1.0)
        yaw = yaw_amp * np.sin(2 * np.pi * s)
        xi = torch.as_tensor(np.array([tx, ty, tz, 0.0, yaw, 0.0], np.float32))
        poses.append(se3.exp(xi).numpy().astype(np.float64))
    return poses

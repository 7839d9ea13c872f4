"""Synthetic textured scenes with exact ground-truth poses, rendered
without OpenCV (port of the planar-scene parts of
orb_slam_cuda_tpu/utils/synthetic.py).

The texture draws from the generator in the reference's order (same
rectangles); the Gaussian blurs are scipy's with reflect-101 borders.
`PlanarScene.render` runs in torch, in float64, on a given device: an
inverse-homography bilinear sample with coordinates quantized to 1/32 px,
as cv2.warpPerspective does, so pixels agree with the OpenCV renderer to
within a gray level or two, not bit for bit; a CUDA render equals the CPU
render. The per-plane 3x3 algebra stays on the host in numpy.
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
        self._tex_on = {}

    def texture_on(self, device) -> torch.Tensor:
        """The texture as a flat float32 tensor on `device` (cached)."""
        key = str(device)
        if key not in self._tex_on:
            self._tex_on[key] = torch.as_tensor(self.tex, device=device).to(torch.float32).reshape(-1)
        return self._tex_on[key]


def _source_coords(Hinv, us, vs):
    """Texture coordinates of every output pixel under dst = H src, from
    the host-side inverse homography (float64 pixel grids in, out)."""
    X = Hinv[0][0] * us + Hinv[0][1] * vs + Hinv[0][2]
    Y = Hinv[1][0] * us + Hinv[1][1] * vs + Hinv[1][2]
    W = Hinv[2][0] * us + Hinv[2][1] * vs + Hinv[2][2]
    W = torch.where(W != 0, 1.0 / W, torch.zeros_like(W))
    lim = float(2**28)
    return torch.clamp(X * W, -lim, lim), torch.clamp(Y * W, -lim, lim)


def _warp(tex, th: int, tw: int, sx, sy):
    """Bilinear inverse warp with a zero border, coordinates quantized to
    1/32 px (uint8 result), and the nearest-neighbour coverage mask: True
    where the rounded source pixel lies inside the texture."""
    qx = torch.round(sx * 32).to(torch.int64)
    qy = torch.round(sy * 32).to(torch.int64)
    x0, y0 = qx >> 5, qy >> 5
    ax = (qx & 31).to(torch.float32) / 32.0
    ay = (qy & 31).to(torch.float32) / 32.0

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < th) & (xx >= 0) & (xx < tw)
        val = tex[torch.clamp(yy, 0, th - 1) * tw + torch.clamp(xx, 0, tw - 1)]
        return torch.where(inside, val, torch.zeros_like(val))

    val = ((1 - ay) * ((1 - ax) * tap(y0, x0) + ax * tap(y0, x0 + 1))
           + ay * ((1 - ax) * tap(y0 + 1, x0) + ax * tap(y0 + 1, x0 + 1)))
    warped = torch.clamp(torch.round(val), 0, 255).to(torch.uint8)
    x, y = torch.round(sx), torch.round(sy)
    covered = (x >= 0) & (x < tw) & (y >= 0) & (y < th)
    return warped, covered


def _out_of_view(K, eu_c, ev_c, p0_c, plane, width: int, height: int) -> bool:
    """True when no pixel can see the plane: its texture rectangle, grown
    by one texel, lies wholly behind the 0.05 m depth floor or wholly
    beyond one image border. Depth is affine over the rectangle, so the
    corners bound it."""
    th, tw = plane.tex.shape
    s = plane.scale
    corners = np.array([p0_c + a * s * eu_c + b * s * ev_c
                        for a in (-1.0, tw) for b in (-1.0, th)])
    z = corners[:, 2]
    if z.max() <= 0.04:
        return True
    if z.min() <= 0.04:
        return False
    u = K[0, 0] * corners[:, 0] / z + K[0, 2]
    v = K[1, 1] * corners[:, 1] / z + K[1, 2]
    return bool(u.max() < -1 or u.min() > width or v.max() < -1 or v.min() > height)


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

    def render(self, K, Tcw, width: int, height: int, device="cpu",
               return_depth: bool = False):
        """Grayscale (height,width) torch.uint8 on `device` from world->cam
        pose Tcw, computed in float64 there. Each plane's texture->image
        map is H = K [R eu, R ev, R origin + t] diag(scale, scale, 1);
        ray-plane depths z-order the planes. With `return_depth`, also the
        z-depth in meters as float32 (0 where no surface)."""
        dev = torch.device(device)
        f64 = torch.float64
        K = np.asarray(K, np.float64)
        Tcw = np.asarray(Tcw, np.float64)
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        Kinv = np.linalg.inv(K)
        vs, us = torch.meshgrid(torch.arange(height, dtype=f64, device=dev),
                                torch.arange(width, dtype=f64, device=dev), indexing="ij")
        rays = [Kinv[j, 0] * us + Kinv[j, 1] * vs + Kinv[j, 2] for j in range(3)]
        out = torch.zeros((height, width), dtype=torch.uint8, device=dev)
        depth = torch.full((height, width), float("inf"), dtype=f64, device=dev)
        for plane in self.planes:
            eu_c = R @ plane.eu
            ev_c = R @ plane.ev
            p0_c = R @ plane.origin + t
            n = np.cross(eu_c, ev_c)
            nn = np.linalg.norm(n)
            if nn < 1e-12:
                continue
            n = n / nn
            H = K @ np.stack([eu_c * plane.scale, ev_c * plane.scale, p0_c], axis=1)
            if abs(np.linalg.det(H)) < 1e-12 or _out_of_view(K, eu_c, ev_c, p0_c, plane, width, height):
                continue
            denom = rays[0] * n[0] + rays[1] * n[1] + rays[2] * n[2]
            lam = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, float("inf")),
                              float(n @ p0_c) / denom)
            sx, sy = _source_coords(np.linalg.inv(H), us, vs)
            warped, covered = _warp(plane.texture_on(dev), *plane.tex.shape, sx, sy)
            visible = covered & (lam > 0.05) & (lam < depth)
            out = torch.where(visible, warped, out)
            depth = torch.where(visible, lam, depth)
        if return_depth:
            # lam scales rays (x, y, 1): it is the z-depth in meters.
            return out, torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth)).to(torch.float32)
        return out

    def render_with_depth(self, K, Tcw, width: int, height: int, device="cpu"):
        """(gray uint8, z-depth float32 meters, 0 = no surface)."""
        return self.render(K, Tcw, width, height, device=device, return_depth=True)

    def render_stereo(self, K, Tcw, baseline: float, width: int, height: int, device="cpu"):
        """Left/right pair; the right camera sits +baseline along cam x."""
        T_rl = np.eye(4)
        T_rl[0, 3] = -baseline
        left = self.render(K, Tcw, width, height, device=device)
        right = self.render(K, T_rl @ np.asarray(Tcw, np.float64), width, height, device=device)
        return left, right


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


def room_scene(rng, half_size: float = 8.0, tex_size: int = 1024, n_walls: int = 4):
    """A regular-polygon room of textured walls (camera inside);
    `half_size` is the apothem."""
    L = half_size
    half_w = L * np.tan(np.pi / n_walls)
    scale = 2 * L / tex_size  # walls are 2L tall
    tex_w = max(64, int(round(tex_size * half_w / L)))
    ev = np.array([0.0, 1.0, 0.0])  # y down
    walls = []
    for k in range(n_walls):
        phi = 2 * np.pi * k / n_walls
        d = np.array([np.sin(phi), 0.0, np.cos(phi)])  # outward normal
        eu = np.array([np.cos(phi), 0.0, -np.sin(phi)])  # wall tangent
        origin = L * d - half_w * eu - L * ev
        walls.append(Plane(origin, eu, ev, make_texture(tex_size, tex_w, rng), scale))
    return PlanarScene(walls)


def ring_obstacles(rng, n: int, ring_radius: float, height: float = 4.0,
                   width: float = 6.0, tex_size: int = 256, yaw_jitter: float = 0.4):
    """Billboard planes on a ring: roadside structures that give features
    a KITTI-like lifetime of a few seconds."""
    planes = []
    for k in range(n):
        phi = 2 * np.pi * (k + rng.uniform(-0.3, 0.3)) / n
        r = ring_radius * rng.uniform(0.92, 1.08)
        center = np.array([r * np.sin(phi), 0.0, -r * np.cos(phi)])
        yaw = phi + rng.uniform(-yaw_jitter, yaw_jitter)
        eu = np.array([np.cos(yaw), 0.0, -np.sin(yaw)])
        ev = np.array([0.0, 1.0, 0.0])
        w = width * rng.uniform(0.7, 1.4)
        h = height * rng.uniform(0.7, 1.3)
        scale = h / tex_size
        tex_w = max(32, int(round(w / scale)))
        origin = center - (w / 2) * eu - (h / 2) * ev
        planes.append(Plane(origin, eu, ev, make_texture(tex_size, tex_w, rng), scale))
    return planes


def loop_trajectory(n_frames: int, radius: float = 1.5, overshoot: float = 0.15):
    """Full in-place yaw loop: the camera walks a small circle while
    yawing 360*(1+overshoot) degrees, revisiting its starting view
    (world->cam poses Tcw)."""
    poses = []
    total = 2 * np.pi * (1.0 + overshoot)
    for i in range(n_frames):
        th = total * i / max(n_frames - 1, 1)
        c = np.array([radius * np.sin(th), 0.0, -radius * np.cos(th) + radius])
        Rcw = se3.so3_exp(torch.as_tensor(np.array([0.0, th, 0.0], np.float32))).numpy().T
        T = np.eye(4)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ c
        poses.append(T)
    return poses


def circuit_trajectory(n_frames: int, radius: float = 5.0, laps: float = 1.15,
                       start: float = 0.0):
    """KITTI-style circuit: the camera rides a circle of `radius` around
    the room centre looking forward along the tangent, for `laps` laps
    (world->cam poses Tcw)."""
    poses = []
    total = 2 * np.pi * laps
    for i in range(n_frames):
        th = 2 * np.pi * start + total * i / max(n_frames - 1, 1)
        c = np.array([radius * np.sin(th), 0.0, -radius * np.cos(th)])
        yaw = th + np.pi / 2
        Rcw = se3.so3_exp(torch.as_tensor(np.array([0.0, yaw, 0.0], np.float32))).numpy().T
        T = np.eye(4)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ c
        poses.append(T)
    return poses

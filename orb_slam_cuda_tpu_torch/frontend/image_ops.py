"""Image-level primitives for the ORB front-end (torch port of
orb_slam_cuda_tpu/frontend/image_ops.py): the half-pixel bilinear resize
formula and the reflect-101 separable Gaussian, written out as the
reference writes them so the samples agree bit for bit."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static (h, w) per level: round(dim / scale^level)."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def resize_bilinear(img, out_shape):
    """Bilinear resize (H,W) -> out_shape with half-pixel centres
    (cv::resize INTER_LINEAR alignment)."""
    h, w = img.shape
    oh, ow = out_shape
    if (oh, ow) == (h, w):
        return img
    dev = img.device
    sy = h / oh
    sx = w / ow
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    r0 = img[y0i]
    r1 = img[y1i]
    top = r0[:, x0i] * (1 - wx)[None, :] + r0[:, x1i] * wx[None, :]
    bot = r1[:, x0i] * (1 - wx)[None, :] + r1[:, x1i] * wx[None, :]
    return top * (1 - wy)[:, None] + bot * wy[:, None]


def build_pyramid(img, n_levels: int, scale_factor: float):
    """List of per-level float32 images, each resized from the previous."""
    img = img.to(torch.float32)
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lvl]))
    return levels


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel equivalent (float32 coefficients)."""
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def separable_gaussian(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with BORDER_REFLECT_101 (`F.pad` reflect is
    reflect-101), accumulated as shifted slices in the reference's order."""
    k = gaussian_kernel_1d(ksize, sigma)
    r = ksize // 2
    h, w = img.shape
    p = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
    rows = torch.zeros((h + 2 * r, w), dtype=p.dtype, device=p.device)
    for i in range(ksize):
        rows = rows + float(k[i]) * p[:, i:i + w]
    out = torch.zeros((h, w), dtype=p.dtype, device=p.device)
    for i in range(ksize):
        out = out + float(k[i]) * rows[i:i + h, :]
    return out

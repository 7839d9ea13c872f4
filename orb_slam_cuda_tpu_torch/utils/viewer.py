"""Headless map/frame visualization (port of
orb_slam_cuda_tpu/utils/viewer.py, without matplotlib).

Replaces the reference's Pangolin/OpenCV viewer stack (reference:
src/Viewer.cc:54-170 Run loop, src/FrameDrawer.cc:38-203 per-frame
overlay, src/MapDrawer.cc:44-233 DrawMapPoints/DrawKeyFrames/
DrawCurrentCamera) with server-side renderings written to PNG. The
content is the JAX package's: map points, keyframe centres, covisibility
edges of weight >= 100, the current camera; on a frame, features bound to
a map point in green and unbound detections in blue. The machine with the
card has no matplotlib, so this module draws into a numpy RGB canvas and
writes it as an 8-bit RGB PNG through io/png.py: the pixels differ from
matplotlib's (no axes, legend or title text), the content does not.
"""

from __future__ import annotations

import numpy as np

from ..io import png
from .device import host

WHITE = (255, 255, 255)
POINT = (153, 153, 153)  # black at matplotlib's alpha 0.4 on white
BLUE = (31, 119, 180)  # matplotlib's tab:blue, tab:green, tab:red
GREEN = (44, 160, 44)
RED = (214, 39, 40)
TOPVIEW_SIZE = 800
MARGIN = 20
COVIS_MIN = 100


def _twc_centers(kf_pose, kf_valid):
    centers = []
    for k in np.flatnonzero(kf_valid):
        T = kf_pose[k]
        centers.append((-T[:3, :3].T @ T[:3, 3], k))
    return centers


def _stamp(canvas, rows, cols, colour, offsets=((0, 0),)):
    """Paint `colour` at every (row + dr, col + dc) inside the canvas."""
    h, w = canvas.shape[:2]
    rows = np.asarray(rows, np.int64).reshape(-1)
    cols = np.asarray(cols, np.int64).reshape(-1)
    for dr, dc in offsets:
        r, c = rows + dr, cols + dc
        inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
        canvas[r[inside], c[inside]] = colour


def _square(half: int):
    return [(dr, dc) for dr in range(-half, half + 1) for dc in range(-half, half + 1)]


def _ring(radius: float):
    n = int(np.ceil(radius)) + 1
    return [(dr, dc) for dr in range(-n, n + 1) for dc in range(-n, n + 1)
            if abs(np.hypot(dr, dc) - radius) < 0.5]


def _triangle(half: int):
    """An upward triangle, apex `half` pixels above the centre."""
    return [(dr, dc) for dr in range(-half, half + 1) for dc in range(-half, half + 1)
            if 2 * abs(dc) <= dr + half]


def _line(canvas, p0, p1, colour):
    n = int(np.ceil(np.abs(np.subtract(p1, p0)).max())) + 1
    t = np.linspace(0.0, 1.0, n)
    _stamp(canvas, np.rint(p0[0] + t * (p1[0] - p0[0])), np.rint(p0[1] + t * (p1[1] - p0[1])), colour)


def topview_transform(xz, size: int = TOPVIEW_SIZE, margin: int = MARGIN):
    """The map from world (x, z) to (row, col) of the top view that frames
    the points `xz` (N, 2) with equal scale on both axes, x to the right
    and z up, as matplotlib's equal-aspect axes show them."""
    xz = np.asarray(xz, np.float64).reshape(-1, 2)
    lo, hi = (xz.min(0), xz.max(0)) if len(xz) else (np.zeros(2), np.ones(2))
    span = max(float((hi - lo).max()), 1e-6)
    scale = (size - 1 - 2 * margin) / span
    offset = margin + 0.5 * ((size - 1 - 2 * margin) - scale * (hi - lo))

    def to_pixel(p):
        p = np.asarray(p, np.float64).reshape(-1, 2)
        col = offset[0] + (p[:, 0] - lo[0]) * scale
        row = (size - 1) - (offset[1] + (p[:, 1] - lo[1]) * scale)
        return np.stack([row, col], -1)

    return to_pixel


def render_topview(state, covis=None, current_pose=None, size: int = TOPVIEW_SIZE) -> np.ndarray:
    """Top-down (x,z) map render as an (size, size, 3) uint8 canvas:
    points, keyframes, covisibility edges, current camera (MapDrawer
    equivalents)."""
    kf_pose = host(state.kf_pose).astype(np.float64)
    kf_valid = host(state.kf_valid).astype(bool)
    xyz = host(state.mp_xyz)[host(state.mp_valid).astype(bool)].astype(np.float64)
    centers = _twc_centers(kf_pose, kf_valid)
    cam_c = None
    if current_pose is not None:
        T = host(current_pose).astype(np.float64)
        cam_c = -T[:3, :3].T @ T[:3, 3]
    frame_pts = [xyz[:, [0, 2]]] + [np.array([[c[0], c[2]]]) for c, _ in centers]
    if cam_c is not None:
        frame_pts.append(np.array([[cam_c[0], cam_c[2]]]))
    to_pixel = topview_transform(np.concatenate(frame_pts), size)

    canvas = np.full((size, size, 3), WHITE, np.uint8)
    if len(xyz):
        rc = np.rint(to_pixel(xyz[:, [0, 2]]))
        _stamp(canvas, rc[:, 0], rc[:, 1], POINT)
    if centers and covis is not None:
        covis = host(covis)
        for ci, ki in centers:
            for cj, kj in centers:
                if kj > ki and covis[ki, kj] >= COVIS_MIN:
                    _line(canvas, to_pixel(ci[[0, 2]])[0], to_pixel(cj[[0, 2]])[0], GREEN)
    if centers:
        rc = np.rint(to_pixel(np.stack([c[[0, 2]] for c, _ in centers])))
        _stamp(canvas, rc[:, 0], rc[:, 1], BLUE, _square(2))
    if cam_c is not None:
        rc = np.rint(to_pixel(cam_c[[0, 2]]))
        _stamp(canvas, rc[:, 0], rc[:, 1], RED, _triangle(5))
    return canvas


def draw_map_topview(state, path: str, covis=None, current_pose=None):
    """Write the top view to `path` as PNG and return the path; with
    `path=None` return the PNG bytes."""
    canvas = render_topview(state, covis=covis, current_pose=current_pose)
    if path is None:
        return png.encode(canvas)
    return png.write(path, canvas)


def render_map_png(state, covis=None, current_pose=None) -> bytes:
    """In-memory top-view render — the live-viewer frame served over
    HTTP (io/serve.py GET /map.png)."""
    return draw_map_topview(state, None, covis=covis, current_pose=current_pose)


def render_frame(image, frame) -> np.ndarray:
    """Tracked-feature overlay (FrameDrawer::DrawFrame equivalent) as an
    (H, W, 3) uint8 canvas: green ring = feature bound to a map point,
    blue ring = unbound detection, on the gray image."""
    gray = host(image).astype(np.uint8)
    canvas = np.repeat(gray[..., None], 3, axis=2)
    uv = host(frame.uv_raw).astype(np.float64)
    valid = host(frame.valid).astype(bool)
    bound = host(frame.mp) >= 0
    for sel, colour, radius in ((valid & ~bound, BLUE, 3.0), (valid & bound, GREEN, 4.0)):
        _stamp(canvas, np.rint(uv[sel, 1]), np.rint(uv[sel, 0]), colour, _ring(radius))
    return canvas


def draw_frame(image, frame, path: str):
    """Write the tracked-feature overlay to `path` as PNG; returns the path."""
    return png.write(path, render_frame(image, frame))

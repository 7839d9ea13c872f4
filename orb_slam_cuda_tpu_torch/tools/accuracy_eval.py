"""Accuracy evaluation at the reference's operating points through the
port's CLI (port of tools/accuracy_eval.py, without OpenCV).

Builds the same full-resolution synthetic sequences as the JAX package's
tool (the same scenes, poses, seeds, photometric noise and settings
files), with lens distortion, photometric noise and exposure drift,
written to disk in the reference's dataset formats through the port's
PNG writer (io/png.py), then drives them through
`python -m orb_slam_cuda_tpu_torch.run` (the L6 layer) and scores the
trajectory as the JAX tool does (ATE after a sim(3) alignment, the
ground truth's extent, windowed ATE, scale drift per segment, gaps).

Configs (BASELINE.md names):
  mono_tum     640x480, TUM1.yaml intrinsics INCLUDING its k1..k3/p1/p2
               distortion (rendered pinhole into a padded frame, then
               warped through the lens model), 1000 features, TUM format.
  mono_kitti   1241x376, KITTI00-02.yaml intrinsics (rectified, no
               distortion), 2000 features, KITTI odometry format.
  stereo_kitti as mono_kitti + right camera at KITTI's 0.537 m baseline
               (Camera.bf=386.1448).
  rgbd_tum     as mono_tum geometry + ground-truth depth maps at TUM's
               5000 factor.

The lens warp: every pixel of the distorted frame is undistorted with
geometry/camera.py::undistort_points at UNDISTORT_ITERS rounds (the
fixed point converges there: distort(undistort(p)) - p is under 1e-8 px
over the 640x480 frame, where cv2.undistortPoints' 5 rounds leave up to
0.13 px in the corners) and sampled from the padded render bilinearly
with a zero border, coordinates at 1/32 px as cv2.remap's INTER_LINEAR
takes them (utils/synthetic.py::_warp). Renders run on `--device`.

Gate (BASELINE.md): ATE RMSE <= 1% of trajectory extent per config.
Usage (from the repository root; one config per command on the card):
  python -m orb_slam_cuda_tpu_torch.tools.accuracy_eval mono_tum
  python -m orb_slam_cuda_tpu_torch.tools.accuracy_eval rgbd_tum --device cpu
Prints one JSON line per config, with the card's name and power limit.
Sequences go under build/accuracy_eval/ (`--root`) and are reused.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..geometry.camera import Camera, distort_normalized, undistort_points
from ..io import png
from ..utils import synthetic
from ..utils.device import host
from ..utils.evaluation import ate_rmse

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROOT = os.path.join(REPO, "build", "accuracy_eval")
UNDISTORT_ITERS = 20
PAD = 48
CAPS = "SLAM.max_keyframes: 256\nSLAM.max_points: 32768\n"
TUM1 = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
            k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)
KITTI = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)
TUM_RGBD = dict(fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764)
N_FRAMES = {"mono_tum": 460, "mono_kitti": 340, "stereo_kitti": 340, "rgbd_tum": 400}


def _K(c) -> np.ndarray:
    return np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]])


def _photometric(img, i, rng):
    gain = 1.0 + 0.08 * np.sin(2 * np.pi * i / 180.0)
    noisy = img.astype(np.float32) * gain + rng.normal(0, 2.0, img.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def distort_maps(cam: Camera, pad: int = PAD, iters: int = UNDISTORT_ITERS, device="cpu"):
    """Remap tables turning a pinhole render padded by `pad` pixels into
    the distorted image: for each distorted pixel, its ideal pinhole
    source coordinates (float64 tensors on `device`), the padded camera
    matrix, and the largest |distort(undistort(p)) - p| over the frame in
    pixels."""
    W, H = cam.width, cam.height
    vs, us = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                            torch.arange(W, dtype=torch.float64, device=device), indexing="ij")
    uv = torch.stack([us, vs], -1)
    und = undistort_points(cam, uv, iters=iters)
    xy = torch.stack([(und[..., 0] - cam.cx) / cam.fx, (und[..., 1] - cam.cy) / cam.fy], -1)
    d = distort_normalized(cam, xy)
    back = torch.stack([d[..., 0] * cam.fx + cam.cx, d[..., 1] * cam.fy + cam.cy], -1)
    residual = float((back - uv).abs().max())
    K_pad = np.asarray(cam.K, np.float64).copy()
    K_pad[0, 2] += pad
    K_pad[1, 2] += pad
    mapx = xy[..., 0] * K_pad[0, 0] + K_pad[0, 2]
    mapy = xy[..., 1] * K_pad[1, 1] + K_pad[1, 2]
    return mapx, mapy, K_pad, residual


def remap(img, mapx, mapy) -> torch.Tensor:
    """Bilinear sample of `img` (H', W') uint8 at (mapx, mapy), zero
    outside, coordinates at 1/32 px (cv2.remap INTER_LINEAR with a
    constant 0 border)."""
    img = torch.as_tensor(img, device=mapx.device)
    h, w = img.shape
    warped, _ = synthetic._warp(img.to(torch.float32).reshape(-1), h, w, mapx, mapy)
    return warped


def _tum_quat(Twc):
    Rm = Twc[:3, :3]
    qw = np.sqrt(max(0.0, 1 + Rm[0, 0] + Rm[1, 1] + Rm[2, 2])) / 2
    qx = (Rm[2, 1] - Rm[1, 2]) / (4 * qw + 1e-12)
    qy = (Rm[0, 2] - Rm[2, 0]) / (4 * qw + 1e-12)
    qz = (Rm[1, 0] - Rm[0, 1]) / (4 * qw + 1e-12)
    return qx, qy, qz, qw


def _gt_line(ts, T):
    Twc = np.linalg.inv(T)
    c = Twc[:3, 3]
    qx, qy, qz, qw = _tum_quat(Twc)
    return f"{ts:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"


def gen_tum(root, cam: Camera, W, H, poses, dt, depth_factor=None, scene=None, device="cpu"):
    """A TUM-format sequence: rgb/<ts>.png, rgb.txt, groundtruth.txt, and
    with `depth_factor` depth/<ts>.png (uint16 z * factor) and assoc.txt.
    A camera with distortion renders padded and warps through the lens."""
    rng = np.random.default_rng(11)
    os.makedirs(f"{root}/rgb", exist_ok=True)
    if depth_factor:
        os.makedirs(f"{root}/depth", exist_ok=True)
    K = np.asarray(cam.K, np.float64)
    use_dist = cam.has_distortion
    if use_dist:
        mapx, mapy, K_pad, _ = distort_maps(cam, device=device)
    rgb_lines, gt_lines, assoc = [], [], []
    for i, T in enumerate(poses):
        ts = i * dt
        if depth_factor:
            img, depth = scene.render_with_depth(K, T, W, H, device=device)
        elif use_dist:
            img = remap(scene.render(K_pad, T, W + 2 * PAD, H + 2 * PAD, device=device), mapx, mapy)
        else:
            img = scene.render(K, T, W, H, device=device)
        png.write(f"{root}/rgb/{ts:.6f}.png", _photometric(host(img), i, rng))
        rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        if depth_factor:
            d16 = np.clip(host(depth) * depth_factor, 0, 65535).astype(np.uint16)
            png.write(f"{root}/depth/{ts:.6f}.png", d16)
            assoc.append(f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} depth/{ts:.6f}.png")
        gt_lines.append(_gt_line(ts, T))
    _write_lines(f"{root}/rgb.txt", rgb_lines)
    _write_lines(f"{root}/groundtruth.txt", gt_lines)
    if assoc:
        _write_lines(f"{root}/assoc.txt", assoc)


def gen_kitti(root, K, W, H, poses, dt, scene, baseline=None, device="cpu"):
    """A KITTI-odometry-format sequence: image_0/ (+ image_1/ with a
    baseline), times.txt, groundtruth.txt (TUM lines)."""
    rng = np.random.default_rng(11)
    os.makedirs(f"{root}/image_0", exist_ok=True)
    if baseline:
        os.makedirs(f"{root}/image_1", exist_ok=True)
    times, gt_lines = [], []
    for i, T in enumerate(poses):
        if baseline:
            left, right = scene.render_stereo(K, T, baseline, W, H, device=device)
            png.write(f"{root}/image_1/{i:06d}.png", _photometric(host(right), i, rng))
            img = left
        else:
            img = scene.render(K, T, W, H, device=device)
        png.write(f"{root}/image_0/{i:06d}.png", _photometric(host(img), i, rng))
        times.append(f"{i*dt:.6e}")
        gt_lines.append(_gt_line(i * dt, T))
    _write_lines(f"{root}/times.txt", times)
    _write_lines(f"{root}/groundtruth.txt", gt_lines)


def _write_lines(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def score(root, traj):
    """(ATE sim(3) m, ground-truth extent m, frames scored, extras) of a
    TUM trajectory against the sequence's groundtruth.txt, as the JAX
    package's tool scores it."""
    est_rows = np.loadtxt(traj)
    gt_rows = np.loadtxt(f"{root}/groundtruth.txt")
    gt_map = {round(r[0], 6): r[1:4] for r in gt_rows}
    est, gt, have = [], [], set()
    for r in est_rows:
        key = round(r[0], 6)
        if key in gt_map:
            est.append(r[1:4])
            gt.append(gt_map[key])
            have.add(key)
    gt_all = gt_rows[:, 1:4]
    extent = float(np.linalg.norm(gt_all.max(axis=0) - gt_all.min(axis=0)))
    E, G = np.asarray(est), np.asarray(gt)
    ate = float(ate_rmse(E, G))

    # Decomposition diagnostics: windowed ATE separates local pose noise
    # from global drift; segment scale medians expose mono scale drift;
    # gap ranges expose lost segments.
    extras = {}
    if len(E) > 90:
        w_errs = [ate_rmse(E[lo:lo + 60], G[lo:lo + 60])
                  for lo in range(0, len(E) - 60, 30)]
        extras["ate_windowed60_m"] = round(float(np.mean(w_errs)), 4)
    de = np.linalg.norm(np.diff(E, axis=0), axis=1)
    dg = np.linalg.norm(np.diff(G, axis=0), axis=1)
    m = dg > 1e-4
    if m.sum() > 30:
        r = de[m] / dg[m]
        n = len(r)
        segs = [float(np.median(r[int(n * i / 6):int(n * (i + 1) / 6)]))
                for i in range(6)]
        extras["scale_seg_ratio"] = round(max(segs) / max(min(segs), 1e-9), 3)
    gaps, start = [], None
    for t in sorted(gt_map):
        missing = t not in have
        if missing and start is None:
            start = t
        if not missing and start is not None:
            gaps.append([round(start, 2), round(t, 2)])
            start = None
    if start is not None:
        gaps.append([round(start, 2), round(max(gt_map), 2)])
    extras["gaps"] = gaps
    return ate, extent, len(est), extras


def settings_yaml(path, fx, fy, cx, cy, W, H, fps, nfeat,
                  k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
                  extra=""):
    with open(path, "w") as f:
        f.write(f"""%YAML:1.0
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: {k1}
Camera.k2: {k2}
Camera.p1: {p1}
Camera.p2: {p2}
Camera.k3: {k3}
Camera.bf: {bf}
Camera.width: {W}
Camera.height: {H}
Camera.fps: {fps}
ORBextractor.nFeatures: {nfeat}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
ThDepth: 40.0
{extra}""")
    return path


def _tum_room():
    return synthetic.room_scene(np.random.default_rng(5), half_size=4.5, tex_size=1024, n_walls=8)


def _kitti_circuit():
    rng = np.random.default_rng(5)
    scene = synthetic.room_scene(rng, half_size=36.0, tex_size=3072, n_walls=12)
    # Roadside-structure billboards: real KITTI features live ~2-4 s;
    # bare walls give unbounded feature lifetime, which starves the
    # reference keyframe policy (see synthetic.ring_obstacles).
    scene.planes.extend(synthetic.ring_obstacles(rng, 24, 28.0))
    scene.planes.extend(synthetic.ring_obstacles(rng, 16, 15.0, height=3.0, width=4.0))
    return scene, synthetic.circuit_trajectory(340, radius=22.0, laps=1.3)


def make_mono_tum(root, device="cpu", n_frames=N_FRAMES["mono_tum"]):
    """TUM1.yaml verbatim (fr1-class): 640x480, full distortion, 1000
    features, 30 fps handheld-style orbit with gentle yaw; the first
    `n_frames` of its 460. Returns the CLI's arguments."""
    cam = Camera.create(**TUM1, width=640, height=480)
    if not os.path.exists(f"{root}/rgb.txt"):
        poses = synthetic.circuit_trajectory(460, radius=1.8, laps=1.25)[:n_frames]
        gen_tum(root, cam, 640, 480, poses, 1 / 30.0, scene=_tum_room(), device=device)
    st = settings_yaml(f"{root}/settings.yaml", TUM1["fx"], TUM1["fy"], TUM1["cx"], TUM1["cy"],
                       640, 480, 30.0, 1000, k1=TUM1["k1"], k2=TUM1["k2"], p1=TUM1["p1"],
                       p2=TUM1["p2"], k3=TUM1["k3"], extra=CAPS)
    return ["--dataset", "tum", "--sensor", "mono", "--sequence", root, "--settings", st]


def make_mono_kitti(root, device="cpu", n_frames=N_FRAMES["mono_kitti"]):
    """KITTI00-02.yaml verbatim: 1241x376, 2000 features, 10 fps forward
    circuit in a large outdoor-scale ring."""
    if not os.path.exists(f"{root}/times.txt"):
        scene, poses = _kitti_circuit()
        gen_kitti(root, _K(KITTI), 1241, 376, poses[:n_frames], 0.1, scene, device=device)
    st = settings_yaml(f"{root}/settings.yaml", KITTI["fx"], KITTI["fy"], KITTI["cx"], KITTI["cy"],
                       1241, 376, 10.0, 2000, extra=CAPS)
    return ["--dataset", "kitti", "--sensor", "mono", "--sequence", root, "--settings", st]


def make_stereo_kitti(root, device="cpu", n_frames=N_FRAMES["stereo_kitti"]):
    if not os.path.exists(f"{root}/times.txt"):
        scene, poses = _kitti_circuit()
        gen_kitti(root, _K(KITTI), 1241, 376, poses[:n_frames], 0.1, scene, baseline=0.537,
                  device=device)
    st = settings_yaml(f"{root}/settings.yaml", KITTI["fx"], KITTI["fy"], KITTI["cx"], KITTI["cy"],
                       1241, 376, 10.0, 2000, bf=386.1448, extra=CAPS)
    return ["--dataset", "kitti", "--sensor", "stereo", "--sequence", root, "--settings", st]


def make_rgbd_tum(root, device="cpu", n_frames=N_FRAMES["rgbd_tum"]):
    """fr2/desk-class: 640x480 RGBD (TUM depth factor 5000), rectified
    intrinsics (TUM RGBD depth is registered to the undistorted frame in
    most tooling; distortion zero keeps depth/rgb consistent here)."""
    cam = Camera.create(**TUM_RGBD, width=640, height=480)
    if not os.path.exists(f"{root}/rgb.txt"):
        poses = synthetic.circuit_trajectory(400, radius=1.8, laps=1.25)[:n_frames]
        gen_tum(root, cam, 640, 480, poses, 1 / 30.0, depth_factor=5000.0, scene=_tum_room(),
                device=device)
    st = settings_yaml(f"{root}/settings.yaml", TUM_RGBD["fx"], TUM_RGBD["fy"], TUM_RGBD["cx"],
                       TUM_RGBD["cy"], 640, 480, 30.0, 1000, bf=40.0,
                       extra="DepthMapFactor: 5000.0\n" + CAPS)
    return ["--dataset", "tum", "--sensor", "rgbd", "--sequence", root, "--settings", st,
            "--association", f"{root}/assoc.txt"]


CONFIGS = {
    "mono_tum": make_mono_tum,
    "mono_kitti": make_mono_kitti,
    "stereo_kitti": make_stereo_kitti,
    "rgbd_tum": make_rgbd_tum,
}


def run_cli(args, device, timeout=5400, log_path=None):
    """Run the port's CLI in a fresh interpreter; returns the tracked
    percentage, loops closed and wall seconds read from its shutdown
    lines. A failed run raises."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "orb_slam_cuda_tpu_torch.run", *args, "--device", device],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )
    wall = time.perf_counter() - t0
    if log_path:
        with open(log_path, "w") as f:
            f.write(proc.stderr)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"orb_slam_cuda_tpu_torch.run failed rc={proc.returncode}")
    stats = {}
    for line in proc.stderr.splitlines():
        if line.startswith("tracked "):
            stats["tracked_pct"] = float(line.split("(")[1].split("%")[0])
        if line.startswith("loops closed:"):
            stats["loops"] = int(line.split(":")[1])
    stats["wall_s"] = round(wall, 1)
    return stats


def card_name() -> str:
    """`name, power limit` of the first card, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def decode_ms(seq, n=20) -> float:
    """Mean ms of io/png.py's native gray read over the sequence's first
    `n` left or colour frames."""
    sub = "rgb" if os.path.isdir(os.path.join(seq, "rgb")) else "image_0"
    paths = [os.path.join(seq, sub, f) for f in sorted(os.listdir(os.path.join(seq, sub)))[:n]]
    png.read_gray(paths[0])  # builds the native unfilter if it is not there yet
    t0 = time.perf_counter()
    for p in paths:
        png.read_gray(p)
    return (time.perf_counter() - t0) / len(paths) * 1e3


def evaluate(name, device="cuda", root=ROOT):
    """Generate `name`'s sequence if missing, run it through the CLI on
    `device`, and return its JSON record."""
    seq = os.path.join(root, name)
    os.makedirs(seq, exist_ok=True)
    t0 = time.perf_counter()
    args = CONFIGS[name](seq, device=device)
    gen_s = time.perf_counter() - t0
    traj = f"{seq}/traj.txt"
    stats = run_cli(args + ["--save-tum", traj, "--diag", f"{seq}/diag.csv"], device,
                    log_path=f"{seq}/run_stderr.log")
    ate, extent, n, extras = score(seq, traj)
    return {
        "metric": f"accuracy_{name}",
        "ate_rmse_m": round(ate, 4),
        "extent_m": round(extent, 2),
        "ate_pct_extent": round(100 * ate / extent, 2),
        "gate_1pct": ate <= 0.01 * extent,
        "n_scored": n,
        **stats,
        **extras,
        "generate_s": round(gen_s, 1),
        "png_decode_ms": round(decode_ms(seq), 3),
        "device": device,
        "card": card_name() if torch.device(device).type == "cuda" else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("configs", nargs="*", metavar="CONFIG",
                    help=f"configs to run, of {', '.join(CONFIGS)} (default: all four)")
    ap.add_argument("--device", default="cuda", help="device of the renders and of the CLI (default cuda)")
    ap.add_argument("--root", default=ROOT, help="directory of the generated sequences")
    args = ap.parse_args(argv)
    unknown = [c for c in args.configs if c not in CONFIGS]
    if unknown:
        ap.error(f"unknown config(s) {unknown}; choose from {list(CONFIGS)}")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("accuracy_eval: --device cuda but torch.cuda.is_available() is False; "
                         "pass --device cpu to run on the CPU")
    for name in args.configs or list(CONFIGS):
        print(json.dumps(evaluate(name, args.device, args.root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

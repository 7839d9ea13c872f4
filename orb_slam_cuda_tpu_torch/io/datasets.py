"""Dataset readers: KITTI odometry, TUM RGB-D, EuRoC MAV (port of
orb_slam_cuda_tpu/io/datasets.py, same constructors, iteration order and
frame dicts).

Replaces the reference's example-binary loaders (reference:
Examples/Monocular/mono_kitti.cc:177+ LoadImages reading times.txt +
image_0/%06d.png; Examples/RGB-D/rgbd_tum.cc association files;
Examples/Monocular/mono_euroc.cc + EuRoC_TimeStamps lists). Images load
lazily through the port's own PNG reader (io/png.py): numpy uint8 (H, W)
gray frames equal to cv2.imread(IMREAD_GRAYSCALE), uint16 depth as
stored; iteration yields (timestamp, frame-dict).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

from . import png


class KittiOdometryDataset:
    """KITTI odometry sequence dir: times.txt + image_0/ (+ image_1/ for
    stereo), %06d.png (reference mono_kitti.cc:177-199)."""

    def __init__(self, sequence_dir: str, stereo: bool = False):
        self.dir = sequence_dir
        self.stereo = stereo
        with open(os.path.join(sequence_dir, "times.txt")) as f:
            self.timestamps = [float(x) for x in f.read().split()]

    def __len__(self):
        return len(self.timestamps)

    def __iter__(self) -> Iterator[tuple]:
        for i, t in enumerate(self.timestamps):
            left = png.read_gray(
                os.path.join(self.dir, "image_0", f"{i:06d}.png")
            )
            if self.stereo:
                right = png.read_gray(
                    os.path.join(self.dir, "image_1", f"{i:06d}.png")
                )
                yield t, {"left": left, "right": right}
            else:
                yield t, {"image": left}


class TumRgbdDataset:
    """TUM RGB-D sequence with an association file (rgb<->depth pairs,
    reference Examples/RGB-D/associations/fr1_desk.txt + rgbd_tum.cc
    LoadImages). Falls back to rgb.txt-only for monocular use."""

    def __init__(self, sequence_dir: str, association_file: Optional[str] = None,
                 monocular: bool = False):
        self.dir = sequence_dir
        self.monocular = monocular
        self.entries = []
        if association_file is not None:
            with open(association_file) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split()
                    # t_rgb rgb_path t_depth depth_path
                    self.entries.append((float(parts[0]), parts[1], parts[3]))
        else:
            with open(os.path.join(sequence_dir, "rgb.txt")) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    t, p = line.split()[:2]
                    self.entries.append((float(t), p, None))

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        for t, rgb_rel, depth_rel in self.entries:
            img = png.read_gray(os.path.join(self.dir, rgb_rel))
            if self.monocular or depth_rel is None:
                yield t, {"image": img}
            else:
                depth = png.read(os.path.join(self.dir, depth_rel))
                yield t, {"image": img, "depth": depth}


class EurocDataset:
    """EuRoC MAV: mav0/cam0/data/<stamp>.png (+ cam1 for stereo), driven
    by a timestamp list file (reference Examples/Monocular/
    EuRoC_TimeStamps/MH01.txt + mono_euroc.cc/stereo_euroc.cc)."""

    def __init__(self, mav_dir: str, timestamp_file: str, stereo: bool = False):
        self.dir = mav_dir
        self.stereo = stereo
        with open(timestamp_file) as f:
            self.stamps = [ln.strip() for ln in f if ln.strip()]

    def __len__(self):
        return len(self.stamps)

    def __iter__(self):
        for s in self.stamps:
            t = float(s) / 1e9
            left = png.read_gray(os.path.join(self.dir, "cam0", "data", s + ".png"))
            if self.stereo:
                right = png.read_gray(
                    os.path.join(self.dir, "cam1", "data", s + ".png")
                )
                yield t, {"left": left, "right": right}
            else:
                yield t, {"image": left}

"""Command-line SLAM runner — the reference's Examples/ binaries as one CLI
(port of orb_slam_cuda_tpu/run.py: the same flags and shutdown lines,
plus `--device`).

Covers mono_kitti / mono_tum / mono_euroc / stereo_kitti / stereo_euroc /
rgbd_tum (reference: Examples/Monocular/mono_kitti.cc:37-175 and
siblings): dataset iteration, per-frame tracking, shutdown stats
(tracked-frame ratio, mean tracking time — the reference prints these at
src/Tracking.cc:166 and mono_kitti.cc:140-148) and trajectory export.
The System runs on `--device` (default `cuda`); with no card it raises at
start unless given `--device cpu`.

Usage:
  python -m orb_slam_cuda_tpu_torch.run --dataset kitti --sensor mono \
      --sequence /path/KITTI/odometry/03 --settings KITTI03.yaml \
      --save-tum traj.txt [--vocab ORBvoc.txt] [--save-map map.npz] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True,
                    choices=["kitti", "tum", "euroc"])
    ap.add_argument("--sensor", default="mono",
                    choices=["mono", "stereo", "rgbd"])
    ap.add_argument("--sequence", required=True, help="dataset directory")
    ap.add_argument("--settings", required=True, help="settings YAML")
    ap.add_argument("--vocab", default=None, help="ORBvoc.txt (optional)")
    ap.add_argument("--association", default=None, help="TUM association file")
    ap.add_argument("--timestamps", default=None, help="EuRoC timestamp list")
    ap.add_argument("--save-tum", default=None)
    ap.add_argument("--save-kitti", default=None)
    ap.add_argument("--save-kf-tum", default=None)
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--load-map", default=None)
    ap.add_argument("--localization-only", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--timing-dir", default=None,
                    help="write times*.csv here at shutdown")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve GET /status and /map_changed over HTTP "
                         "while running (the reference's ROS "
                         "query/response channel, ros_mono.cc:148-159)")
    ap.add_argument("--diag", default=None, metavar="CSV",
                    help="write per-frame diagnostics (timestamp, state, "
                         "local-map inliers, keyframes, relocs) — the "
                         "observability layer the reference gets from "
                         "its per-run printouts (src/Tracking.cc:166)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the System (default cuda; "
                         "`cpu` runs the plain versions of the kernels)")
    args = ap.parse_args(argv)

    from .engine import Sensor, System
    from .io import (
        EurocDataset,
        KittiOdometryDataset,
        TumRgbdDataset,
        load_settings,
    )
    from .utils.device import resolve

    device = resolve(args.device)
    sensor = {
        "mono": Sensor.MONOCULAR,
        "stereo": Sensor.STEREO,
        "rgbd": Sensor.RGBD,
    }[args.sensor]
    cfg = load_settings(args.settings, sensor=sensor)

    vocab = None
    if args.vocab:
        from .vocab import load_orbvoc_text

        t0 = time.time()
        vocab = load_orbvoc_text(args.vocab)
        print(f"vocabulary loaded in {time.time() - t0:.1f}s "
              f"({vocab.n_words} words)", file=sys.stderr)

    slam = System(cfg, vocab=vocab, device=device)
    if args.load_map:
        slam.load_map(args.load_map, localization_only=True)
    if args.localization_only:
        slam.set_localization_mode(True)

    if args.dataset == "kitti":
        ds = KittiOdometryDataset(args.sequence, stereo=sensor == Sensor.STEREO)
    elif args.dataset == "tum":
        ds = TumRgbdDataset(
            args.sequence, association_file=args.association,
            monocular=sensor == Sensor.MONOCULAR,
        )
    else:
        if not args.timestamps:
            ap.error("--timestamps required for euroc")
        ds = EurocDataset(args.sequence, args.timestamps,
                          stereo=sensor == Sensor.STEREO)

    server = None
    if args.serve is not None:
        from .io.serve import StatusServer

        server = StatusServer(slam, port=args.serve).start()
        print(f"status server on http://127.0.0.1:{server.port}",
              file=sys.stderr)

    times = []
    diag_rows = []
    try:
        for i, (t, frame) in enumerate(ds):
            if args.max_frames is not None and i >= args.max_frames:
                break
            t0 = time.time()
            if sensor == Sensor.MONOCULAR:
                slam.track_monocular(frame["image"], t)
            elif sensor == Sensor.STEREO:
                slam.track_stereo(frame["left"], frame["right"], t)
            else:
                slam.track_rgbd(frame["image"], frame["depth"], t)
            times.append(time.time() - t0)
            if args.diag:
                diag_rows.append(
                    f"{t:.6f},{slam.tracking_state.name},"
                    f"{slam.n_inliers_local},"
                    f"{slam.stats.n_keyframes},{slam.stats.n_reloc},"
                    f"{slam.ref_tracked}"
                )
            if i % 50 == 0:
                print(
                    f"frame {i} state={slam.tracking_state.name} "
                    f"kfs={slam.stats.n_keyframes} {times[-1]*1e3:.0f}ms",
                    file=sys.stderr,
                )
    finally:
        if server is not None:
            server.stop()

    import numpy as np

    # Shutdown stats (reference Tracking.cc:166, mono_kitti.cc:140-148).
    times_arr = np.asarray(times[5:]) if len(times) > 5 else np.asarray(times)
    print(
        f"tracked {slam.stats.n_tracked}/{slam.stats.n_frames} frames "
        f"({100*slam.tracked_ratio():.1f}%); "
        f"median tracking time {np.median(times_arr)*1e3:.1f}ms, "
        f"mean {times_arr.mean()*1e3:.1f}ms; "
        f"{slam.stats.n_keyframes} keyframes",
        file=sys.stderr,
    )
    print(f"p99 tracking time {np.percentile(times_arr, 99)*1e3:.1f}ms; "
          f"{slam.stats.n_reloc} relocalizations", file=sys.stderr)
    if slam.loop_closer is not None:
        print(f"loops closed: {slam.loop_closer.n_loops_closed}", file=sys.stderr)

    if args.diag:
        with open(args.diag, "w") as f:
            f.write("timestamp,state,inliers,keyframes,relocs,ref_tracked\n")
            f.write("\n".join(diag_rows) + "\n")
    if args.save_tum:
        slam.save_trajectory_tum(args.save_tum)
    if args.save_kitti:
        slam.save_trajectory_kitti(args.save_kitti)
    if args.save_kf_tum:
        slam.save_keyframe_trajectory_tum(args.save_kf_tum)
    if args.save_map:
        slam.save_map(args.save_map)
    if args.timing_dir:
        slam.timer.flush(args.timing_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())

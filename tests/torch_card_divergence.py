"""Where two runs of config_mono_tum on the card part: the port's CLI on the
accuracy tool's sequence (tools/accuracy_eval.py, its 460 frames of the
distorted TUM1 lens), one variant a process, each frame's map digest
recorded (live points, the sum and absolute sum of their coordinates, the
sum of the live keyframe poses, the tracking state and local inliers);
`compare` prints the first frame at which two runs' digests differ and
each run's ATE.

Variants (a diagnosis, not a mode of the port: they patch the modules of
the tree on `sys.path` from the outside):
  as_is        the tree as it runs (any tree of the port, this one or
               an older one unpacked with `git archive`);
  eager        every program run op by op (`programs.eager()`);
  plain_init   eager, and the initializer's DLT triangulation through
               its plain version (float32 `eigh`) instead of the kernel;
  plain        eager, both DLT entries (the initializer's and the
               mapper's) through their plain versions.

Usage, from the root of the tree to run (no JAX; one GPU):

    python -m orb_slam_cuda_tpu_torch.tools.accuracy_eval mono_tum   # makes build/accuracy_eval/mono_tum
    PYTHONPATH=$PWD python tests/torch_card_divergence.py run plain build/accuracy_eval/mono_tum OUT/plain
    PYTHONPATH=$PWD python tests/torch_card_divergence.py compare OUT/as_is OUT/plain --seq build/accuracy_eval/mono_tum

`--frames N` cuts a run to its first N frames (the first parting of
fault I shows by frame 31). `--device cpu` rehearses a variant on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _patch(variant: str):
    from orb_slam_cuda_tpu_torch.engine import programs

    if variant == "as_is":
        return None
    ctx = programs.eager()
    ctx.__enter__()  # kept for the process's life: its exit would end the eager mode
    if variant in ("plain_init", "plain"):
        from orb_slam_cuda_tpu_torch.geometry import triangulate
        from orb_slam_cuda_tpu_torch.ops import dlt_kernel

        dlt_kernel.triangulate_dlt = triangulate.triangulate_dlt_plain
        if variant == "plain":
            dlt_kernel.triangulate_gated = triangulate.triangulate_gated_plain
    return ctx


def digest(slam) -> dict:
    st = slam.state
    v = st.mp_valid
    xyz = st.mp_xyz[v].double()
    return dict(n_pts=int(v.sum()), xyz=float(xyz.sum()), xyz_abs=float(xyz.abs().sum()),
                pose=float(st.kf_pose[st.kf_valid].double().sum()), n_kf=int(st.kf_valid.sum()),
                state=slam.tracking_state.name, inliers=int(slam.n_inliers_local))


def run(variant: str, seq: str, out: str, device: str = "cuda", frames: int | None = None):
    """The CLI on `seq` under `variant`; writes traj.txt, diag.csv and
    digest.json (one digest a frame) into `out`."""
    os.makedirs(out, exist_ok=True)
    ctx = _patch(variant)  # noqa: F841
    from orb_slam_cuda_tpu_torch import run as cli
    from orb_slam_cuda_tpu_torch.engine import system

    rows, track = [], system.System.track_monocular

    def traced(self, image, t):
        pose = track(self, image, t)
        rows.append(dict(digest(self), frame=len(rows)))
        return pose

    system.System.track_monocular = traced
    argv = ["--dataset", "tum", "--sensor", "mono", "--sequence", seq, "--settings", os.path.join(seq, "settings.yaml"),
            "--save-tum", os.path.join(out, "traj.txt"), "--diag", os.path.join(out, "diag.csv"), "--device", device]
    try:
        cli.main(argv + ([] if frames is None else ["--max-frames", str(frames)]))
    finally:
        system.System.track_monocular = track
        with open(os.path.join(out, "digest.json"), "w") as f:
            json.dump(rows, f)


def compare(a: str, b: str, seq: str | None = None) -> dict:
    """The first frame whose digest differs between runs `a` and `b`, both
    digests there, and each run's ATE (sim(3)) if `seq` is given."""
    da, db = (json.load(open(os.path.join(d, "digest.json"))) for d in (a, b))
    first = next((i for i, (x, y) in enumerate(zip(da, db)) if x != y), None)
    out = {"runs": [a, b], "frames": [len(da), len(db)], "first_differing_frame": first}
    if first is not None:
        out["digests"] = [da[first], db[first]]
    if seq is not None:
        from orb_slam_cuda_tpu_torch.tools import accuracy_eval

        for key, d in (("ate_a", a), ("ate_b", b)):
            ate, extent, n, _ = accuracy_eval.score(seq, os.path.join(d, "traj.txt"))
            out[key] = dict(ate_m=round(ate, 5), pct_extent=round(100 * ate / extent, 3), scored=n)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("variant", choices=["as_is", "eager", "plain_init", "plain"])
    r.add_argument("seq")
    r.add_argument("out")
    r.add_argument("--device", default="cuda")
    r.add_argument("--frames", type=int, default=None)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--seq", default=None)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run(args.variant, args.seq, args.out, args.device, args.frames)
    else:
        print(json.dumps(compare(args.a, args.b, args.seq)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

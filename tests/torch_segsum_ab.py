"""The segment-sum kernels of this tree against another tree's source, in
one process on the card: both built from their sources, held bit for bit
against each other and timed in turns at the bundle adjustment's shapes.

This tree's source has three entries: `segsum`, which picks a kernel from
the segment count and K, and the two kernels' own, `segsum_block` and
`segsum_rows`; the other tree's `segsum` is timed against each, in the
turns other, segsum, block, rows, rows, block, segsum, other. For each
call it prints the kernel that this tree's rule picks.

The calls: a local BA's (24 cameras x 2,000 observation slots, 2,139 valid,
746 of them the new keyframe's) camera sums Hcc (K = 36) and bc (K = 6) and
point sums Hpp (K = 9 over 4,096 points) and bp (K = 3); a global BA's
(128 x 2,000 slots, 19,260 valid, 732 the longest camera's) Hcc and Hpp
(32,768 points); an essential graph's vertex sums Hd (K = 49) over 256
keyframes, 1,536 valid edge ends among 4,096 slots. Each time is the
median device time of one call by CUDA events around 10 calls queued
behind a long matrix product (warm L2), as chip_smoke.py times the
kernels.

    PYTHONPATH=$PWD python tests/torch_segsum_ab.py --other OLD.cu [--out OUT.json]

OLD.cu is, e.g., `git show <commit>:orb_slam_cuda_tpu_torch/csrc/segsum.cu`
written into a directory that the run can read. Needs one GPU; prints one
JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from orb_slam_cuda_tpu_torch.ops import segsum
from orb_slam_cuda_tpu_torch.ops.fast_kernel import BUILD_DIR, NVCC_FLAGS, _nvcc
from orb_slam_cuda_tpu_torch.utils import native_build

CALLS = {  # name: (segments, rows, slots a row, valid, the longest row's valid, cameras or points, K)
    "local Hcc": (24, 24, 2000, 2139, 746, "cams", (6, 6)),
    "local bc": (24, 24, 2000, 2139, 746, "cams", (6,)),
    "local Hpp": (4096, 24, 2000, 2139, 746, "points", (3, 3)),
    "local bp": (4096, 24, 2000, 2139, 746, "points", (3,)),
    "global Hcc": (128, 128, 2000, 19260, 732, "cams", (6, 6)),
    "global Hpp": (32768, 128, 2000, 19260, 732, "points", (3, 3)),
    "essential Hd": (256, 16, 256, 1536, 96, "points", (7, 7)),
}
TURNS = ("other", "segsum", "segsum_block", "segsum_rows", "segsum_rows", "segsum_block", "segsum", "other")


def problem(name, device, seed=0):
    """(SegmentIndex, vals) of one call: the valid slots of each row drawn
    at random, the first row holding the longest share."""
    n, rows, per_row, n_valid, longest, kind, tail = CALLS[name]
    rng = np.random.default_rng(seed)
    counts = np.full(rows, (n_valid - longest) // (rows - 1))
    counts[0] = longest
    counts[1:1 + n_valid - int(counts.sum())] += 1
    valid = np.zeros((rows, per_row), bool)
    for r, c in enumerate(counts):
        valid[r, rng.choice(per_row, size=c, replace=False)] = True
    valid = valid.reshape(-1)
    e = rows * per_row
    seg = np.repeat(np.arange(rows), per_row) if kind == "cams" else rng.integers(0, n, e)
    vals = rng.normal(0, 1e3, (e,) + tail).astype(np.float32)
    vals[~valid] = 0.0
    index = segsum.segment_index(n, torch.as_tensor(np.where(valid, seg, 0), device=device),
                                 torch.as_tensor(valid, device=device))
    return index, torch.as_tensor(vals, device=device)


def bind(path, entries=("segsum",)):
    lib = ctypes.CDLL(path)
    ptr = ctypes.c_void_p
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int, ptr, ptr]
        fn.restype = ctypes.c_int
    return lib


def launcher(fn, seg, vals):
    out = torch.empty((seg.n,) + vals.shape[1:], dtype=torch.float32, device=vals.device)
    k = int(np.prod(vals.shape[1:]))

    def run():
        rc = fn(vals.data_ptr(), seg.order.data_ptr(), seg.offsets.data_ptr(), seg.n, k, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"segsum launch failed: cudaError {rc}")
        return out

    return run


def device_ms(fn, reps=20, inner=10):
    fn()
    blocker = torch.ones((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    for _ in range(3):
        blocker @ blocker
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) / inner for a, b in pairs]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="the other tree's csrc/segsum.cu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_segsum_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    this = bind(segsum.build()[0], segsum.ENTRIES)
    other = bind(native_build.build(args.other, "the other segsum kernel", flags=tuple(NVCC_FLAGS),
                                    build_dir=BUILD_DIR, compiler=_nvcc()))
    res = {"card": card, "calls": {}}
    for name in CALLS:
        seg, vals = problem(name, torch.device("cuda"))
        k = int(np.prod(vals.shape[1:]))
        run = {"other": launcher(other.segsum, seg, vals)}
        run.update({entry: launcher(getattr(this, entry), seg, vals) for entry in segsum.ENTRIES})
        want = run["other"]().clone().view(torch.int32)
        equal = {entry: torch.equal(want, run[entry]().clone().view(torch.int32)) for entry in segsum.ENTRIES}
        times = {who: [] for who in run}
        for who in TURNS:
            times[who].append(device_ms(run[who]))
        res["calls"][name] = {"segments": seg.n, "k": k, "longest_segment": int(seg.lengths.max()),
                              "rule_picks": segsum.kernel_name(seg.n, k), "bit_equal": equal,
                              **{f"{who}_ms": t for who, t in times.items()}}
        print(f"{name}: longest segment {int(seg.lengths.max())}, the rule picks {segsum.kernel_name(seg.n, k)}, "
              f"bit-equal to the other {equal}; " + ", ".join(f"{who} {t} ms" for who, t in times.items()),
              file=sys.stderr, flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if all(all(c["bit_equal"].values()) for c in res["calls"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())

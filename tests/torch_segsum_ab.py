"""The segment-sum kernel of this tree against another tree's source, in one
process on the card: both built from their sources, held bit for bit
against each other and timed in turns (other, this, this, other) at the
bundle adjustment's shapes.

The calls: a local BA's (24 cameras x 2,000 observation slots, 2,139 valid,
746 of them the new keyframe's) camera sums Hcc (K = 36) and bc (K = 6) and
point sums Hpp (K = 9 over 4,096 points); a global BA's (128 x 2,000 slots,
19,260 valid, 732 the longest camera's) Hcc and Hpp (32,768 points). Each
time is the median device time of one call by CUDA events around 10 calls
queued behind a long matrix product (warm L2), as chip_smoke.py times the
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
    "global Hcc": (128, 128, 2000, 19260, 732, "cams", (6, 6)),
    "global Hpp": (32768, 128, 2000, 19260, 732, "points", (3, 3)),
}


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


def bind(path):
    lib = ctypes.CDLL(path)
    ptr = ctypes.c_void_p
    lib.segsum.argtypes = [ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int, ptr, ptr]
    lib.segsum.restype = ctypes.c_int
    return lib


def launcher(lib, seg, vals):
    out = torch.empty((seg.n,) + vals.shape[1:], dtype=torch.float32, device=vals.device)
    k = int(np.prod(vals.shape[1:]))

    def run():
        rc = lib.segsum(vals.data_ptr(), seg.order.data_ptr(), seg.offsets.data_ptr(), seg.n, k, out.data_ptr(),
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
    this = bind(segsum.build()[0])
    other = bind(native_build.build(args.other, "the other segsum kernel", flags=tuple(NVCC_FLAGS),
                                    build_dir=BUILD_DIR, compiler=_nvcc()))
    res = {"card": card, "calls": {}}
    for name in CALLS:
        seg, vals = problem(name, torch.device("cuda"))
        a, b = launcher(other, seg, vals), launcher(this, seg, vals)
        equal = torch.equal(a().clone().view(torch.int32), b().clone().view(torch.int32))
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            times[who].append(device_ms(a if who == "other" else b))
        res["calls"][name] = {"segments": seg.n, "k": int(np.prod(vals.shape[1:])),
                              "longest_segment": int(seg.lengths.max()), "bit_equal": equal,
                              "other_ms": times["other"], "this_ms": times["this"]}
        print(f"{name}: longest segment {int(seg.lengths.max())}, bit-equal {equal}; other {times['other']} ms, "
              f"this {times['this']} ms", file=sys.stderr, flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if all(c["bit_equal"] for c in res["calls"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())

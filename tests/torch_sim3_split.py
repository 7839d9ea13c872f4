"""Where the Sim3 RANSAC kernel's time goes on the card, and one tree's
kernel held against another's.

`record OUT` runs chip_smoke.py's loop path (the 340-frame circuit, ~5
min on one H100) and saves the arguments of its last Sim3 call whose
RANSAC passed, the call that chip_smoke.py's phase 6a holds the kernel
to. `split --call OUT --parent SRC` then, on that call and on a
full-width synthetic one (M = 2,000 matches, every pair valid, 128
minimal sets, `ops/sim3_kernel.py::synthetic_problem`):

  * builds a copy of each source (this tree's `csrc/sim3_ransac.cu` and
    `SRC`, an older tree's, e.g. written out with `git show`) under
    build/sim3_split/, as it is and with globaltimer and clock64 stamps
    written by thread 0 at the boundaries of the kernel's phases (a copy
    outside the tree: the committed source has no switch for them);
  * times each as it is (CUDA events around 10 launches queued behind a
    long product, chip_smoke.py's `device_median_ms`) and an empty
    kernel of the same grid (the launch alone), and reads each phase's
    median over 30 stamped runs, clock64 converted at the SM clock that a
    calibration kernel measures against globaltimer;
  * holds the tree's outputs against `SRC`'s on both calls: counts,
    choice, refit kept, mask and n_inliers equal, the largest difference
    of R, t, s.

Each source is recognised by its text: the stamps go at lines that the
two-launch design (PR 12's: `hypotheses_kernel`, then `refit_kernel`)
or the one-launch design (a block a hypothesis, the last one to finish
refits) holds; a source with neither fails. Prints one JSON object.

    PYTHONPATH=$PWD python tests/torch_sim3_split.py record CALL.pt
    git show <commit>:orb_slam_cuda_tpu_torch/csrc/sim3_ransac.cu > OLD.cu
    PYTHONPATH=$PWD python tests/torch_sim3_split.py split --call CALL.pt --parent OLD.cu [--out SPLIT.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "sim3_split")
BLOCK_SLOTS, LAST = 8, 4096  # stamps: block b at b * 8 + k; the refit's at 4096 + k
N_SLOTS = LAST + 32
CALIB = N_SLOTS - 1
REPS = 30

PRELUDE = r"""
__device__ unsigned long long split_stamps[%(n)d][2];
__device__ __forceinline__ unsigned long long split_gtime() {
  unsigned long long g;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(g));
  return g;
}
__device__ __forceinline__ void split_stamp(int k) {
  split_stamps[k][0] = split_gtime();
  split_stamps[k][1] = (unsigned long long)clock64();
}
__global__ void split_calib_kernel(long long cycles) {
  const unsigned long long g0 = split_gtime();
  const long long c0 = clock64();
  long long c = c0;
  while (c - c0 < cycles) c = clock64();
  split_stamps[%(calib)d][0] = split_gtime() - g0;
  split_stamps[%(calib)d][1] = (unsigned long long)(c - c0);
}
__global__ void split_empty_kernel() {}
extern "C" int split_calibrate(long long cycles) {
  split_calib_kernel<<<1, 1>>>(cycles);
  return (int)cudaDeviceSynchronize();
}
extern "C" int split_empty(int blocks, int threads, void* stream) {
  split_empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" int split_clear() {
  static unsigned long long zero[%(n)d][2];
  return (int)cudaMemcpyToSymbol(split_stamps, zero, sizeof(zero));
}
extern "C" int split_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, split_stamps, sizeof(split_stamps));
}
""" % dict(n=N_SLOTS, calib=CALIB)

# (anchor, text put before it, text put after it); each anchor must occur once.
TWO_LAUNCH = [
    ("  const int h = blockIdx.x;\n", "", "  if (threadIdx.x == 0) split_stamp(h * 8 + 0);\n"),
    ("    S = horn(M, y1sq, C, c1, c2, fix_scale != 0);\n", "", "    split_stamp(h * 8 + 1);\n"),
    ("  const int n = count_inliers(S, x1, x2, uv1, uv2, th1, th2, valid, cam, m);\n", "",
     "  if (threadIdx.x == 0) split_stamp(h * 8 + 2);\n"),
    ("    params[NPARAM * h + 12] = S.s;\n", "", "    split_stamp(h * 8 + 3);\n"),
    ("  __shared__ int n_best_s;\n", "", "  if (threadIdx.x == 0) split_stamp(4096 + 0);\n"),
    ("    info[0] = b;\n", "", "    split_stamp(4096 + 1);\n"),
    ("    double first[7], tot[7];\n", "    if (threadIdx.x == 0) split_stamp(4096 + 2);\n", ""),
    ("  // Pass 2: the centred moments over the same inliers.\n", "  if (threadIdx.x == 0) split_stamp(4096 + 3);\n",
     ""),
    ("  double tot[16];\n", "  if (threadIdx.x == 0) split_stamp(4096 + 4);\n", ""),
    ("    refit = horn(M, tot[9], C, c1, c2, fix_scale != 0);\n", "    split_stamp(4096 + 5);\n",
     "    split_stamp(4096 + 6);\n"),
    ("  const bool better = n_refit >= n_best_s;\n", "  if (threadIdx.x == 0) split_stamp(4096 + 7);\n", ""),
    ("    for (int k = 0; k < 9; ++k) R_out[k] = S.R[k];\n", "    split_stamp(4096 + 8);\n", ""),
    ("    info[1] = better;\n", "", "    split_stamp(4096 + 9);\n"),
]
ONE_LAUNCH = [
    ("  const int tiles = (m + TILE - 1) / TILE;\n", "", "  if (threadIdx.x == 0) split_stamp(h * 8 + 0);\n"),
    ("    if (threadIdx.x == 0) S = hypothesis(in, sets, h, fix_scale != 0);\n", "",
     "    if (threadIdx.x == 0) split_stamp(h * 8 + 1);\n"),
    ("    if (threadIdx.x == 32) n_first = n;\n", "", "    if (threadIdx.x == 32) split_stamp(h * 8 + 2);\n"),
    ("  const Sim3f hs = S;\n", "  if (threadIdx.x == 0) split_stamp(h * 8 + 5);\n", ""),
    ("  const int n_hyp = block_sum(mine, isum);\n", "", "  if (threadIdx.x == 0) split_stamp(h * 8 + 3);\n"),
    ("  if (!last) return;\n", "  if (threadIdx.x == 0) split_stamp(h * 8 + 4);\n",
     "  if (threadIdx.x == 0) split_stamp(4096 + 0);\n"),
    ("  const Sim3f best = S;\n", "", "  if (threadIdx.x == 0) split_stamp(4096 + 1);\n"),
    ("  block_sum<7>(a, dsum, dtot, reach);\n", "", "  if (threadIdx.x == 0) split_stamp(4096 + 2);\n"),
    ("  block_sum<16>(b, dsum, dtot, reach);\n", "", "  if (threadIdx.x == 0) split_stamp(4096 + 3);\n"),
    ("  const Sim3f rf = refit;\n", "", "  if (threadIdx.x == 0) split_stamp(4096 + 4);\n"),
    ("  const int n_refit = block_sum(c, isum);\n", "", "  if (threadIdx.x == 0) split_stamp(4096 + 5);\n"),
    ("    for (int k = 0; k < 9; ++k) R_out[k] = F.R[k];\n", "    split_stamp(4096 + 6);\n", ""),
    ("    info[1] = better;\n", "", "    split_stamp(4096 + 7);\n"),
]
# Each design: its anchors, the block's phases (stamp slots from, to; clock64
# of one block), the slot a block ends at, the refit's phases and end slot.
DESIGNS = {
    "two_launch": dict(anchors=TWO_LAUNCH, block={"horn": (0, 1), "count": (1, 2), "write": (2, 3)}, block_end=3,
                       refit={"choice": (0, 1), "pass1": (1, 2), "sum7": (2, 3), "pass2": (3, 4), "sum16": (4, 5),
                              "horn": (5, 6), "count": (6, 7), "mask": (7, 8), "outputs": (8, 9)}, refit_end=9),
    # block: thread 0's Horn, warp 1's staging of the first tile, the count
    # from both done to its sum, the outputs and ticket; refit: the last block.
    "one_launch": dict(anchors=ONE_LAUNCH, block={"horn": (0, 1), "stage": (0, 2), "count": (5, 3), "ticket": (3, 4)},
                       block_end=4, refit={"choice": (0, 1), "passA": (1, 2), "passB": (2, 3), "horn": (3, 4),
                                           "passC": (4, 5), "mask": (5, 6), "outputs": (6, 7)}, refit_end=7),
}


def _design(text: str) -> str:
    if "refit_kernel" in text and "hypotheses_kernel" in text:
        return "two_launch"
    if "ransac_kernel" in text:
        return "one_launch"
    raise SystemExit("torch_sim3_split: the source holds neither known design")


def instrument(text: str, anchors) -> str:
    head = '#include "jacobi4.cuh"\n'
    if text.count(head) != 1:
        raise SystemExit("torch_sim3_split: no jacobi4.cuh include to put the stamps after")
    text = text.replace(head, head + PRELUDE)
    for anchor, before, after in anchors:
        if text.count(anchor) != 1:
            raise SystemExit(f"torch_sim3_split: anchor {anchor.strip()!r} found {text.count(anchor)} times")
        text = text.replace(anchor, before + anchor + after)
    return text


def build(src: str, name: str, stamped: bool) -> tuple:
    """(library path, design) of a copy of `src` under build/sim3_split/."""
    from orb_slam_cuda_tpu_torch.ops import sim3_kernel
    from orb_slam_cuda_tpu_torch.ops.fast_kernel import NVCC_FLAGS, _nvcc
    from orb_slam_cuda_tpu_torch.utils import native_build

    os.makedirs(OUT_DIR, exist_ok=True)
    csrc = os.path.dirname(sim3_kernel.SOURCE)
    shutil.copy(os.path.join(csrc, "jacobi4.cuh"), OUT_DIR)
    with open(src) as f:
        text = f.read()
    design = _design(text)
    if stamped:
        text = instrument(text, DESIGNS[design]["anchors"])
    path = os.path.join(OUT_DIR, f"{name}{'_stamped' if stamped else ''}.cu")
    with open(path, "w") as f:
        f.write(text)
    return native_build.build(path, f"sim3 split {name}", flags=tuple(NVCC_FLAGS), compiler=_nvcc(),
                              build_dir=OUT_DIR), design


class Kernel:
    """One build of a Sim3 RANSAC source, called through ctypes with the
    C interface of its design."""

    def __init__(self, path: str, design: str):
        self.lib, self.design = ctypes.CDLL(path), design
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = 11 if design == "one_launch" else 10
        self.lib.sim3_ransac.argtypes = [ptr] * 8 + [i32] * 2 + [f32] * 4 + [i32] * 2 + [ptr] * tail
        self.lib.sim3_ransac.restype = i32
        self.ticket = None
        self.stamped = hasattr(self.lib, "split_read")
        if self.stamped:
            self.lib.split_empty.argtypes = [i32, i32, ptr]
            self.lib.split_calibrate.argtypes = [ctypes.c_longlong]

    def __call__(self, call):
        import torch

        a, cam = call["args"], call["cam"]
        dev = a["x1"].device
        m, nh = a["x1"].shape[0], call["sets"].shape[0]
        f32 = dict(dtype=torch.float32, device=dev)
        counts = torch.empty((nh,), dtype=torch.int32, device=dev)
        params = torch.empty((nh, 13), **f32)
        R, t, s = torch.empty((3, 3), **f32), torch.empty((3,), **f32), torch.empty((), **f32)
        inl = torch.empty((m,), dtype=torch.bool, device=dev)
        n_in = torch.empty((), dtype=torch.int64, device=dev)
        ok = torch.empty((), dtype=torch.bool, device=dev)
        info = torch.empty((2,), dtype=torch.int32, device=dev)
        outs = [counts, params, R, t, s, inl, n_in, ok, info]
        if self.design == "one_launch":
            if self.ticket is None:
                self.ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
            outs.append(self.ticket)
        rc = self.lib.sim3_ransac(*(a[k].data_ptr() for k in ("x1", "x2", "uv1", "uv2", "th1", "th2", "valid")),
                                  call["sets"].data_ptr(), nh, m, cam.fx, cam.fy, cam.cx, cam.cy,
                                  int(call["fix_scale"]), int(call["min_inliers"]), *(o.data_ptr() for o in outs),
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"sim3_ransac: cudaError {rc}")
        return dict(R=R, t=t, s=s, inliers=inl, n_inliers=n_in, ok=ok, info=info, counts=counts, params=params)

    def stamps(self):
        import numpy as np

        host = np.zeros((N_SLOTS, 2), np.uint64)
        rc = self.lib.split_read(host.ctypes.data)
        if rc:
            raise RuntimeError(f"split_read: cudaError {rc}")
        return host.astype(np.int64)


def sm_ghz(k: Kernel) -> float:
    """The SM clock in GHz: clock64 cycles over globaltimer ns of a 20 M
    cycle spin (~10 ms)."""
    k.lib.split_clear()
    rc = k.lib.split_calibrate(20_000_000)
    if rc:
        raise RuntimeError(f"split_calibrate: cudaError {rc}")
    st = k.stamps()
    return float(st[CALIB, 1]) / float(st[CALIB, 0])


def phases(k: Kernel, call, ghz: float) -> dict:
    """Each phase's median over REPS stamped runs, in µs: per-block
    phases (clock64, the median block), the span of the blocks and the
    refit's start after the last block (globaltimer), the refit's phases
    (clock64 of the block that refits)."""
    import numpy as np
    import torch

    d = DESIGNS[k.design]
    nh = call["sets"].shape[0]
    rows = []
    for _ in range(REPS):
        k.lib.split_clear()
        k(call)
        torch.cuda.synchronize()
        st = k.stamps()
        blocks = st[:nh * BLOCK_SLOTS].reshape(nh, BLOCK_SLOTS, 2)
        refit = st[LAST:LAST + 16]
        r = {}
        for name, (a, b) in d["block"].items():
            r[f"block_{name}"] = float(np.median(blocks[:, b, 1] - blocks[:, a, 1])) / ghz / 1e3
        first_in = int(blocks[:, 0, 0].min())
        last_out = int(blocks[:, d["block_end"], 0].max())
        r["blocks_start_spread"] = (int(blocks[:, 0, 0].max()) - first_in) / 1e3
        r["blocks_span"] = (last_out - first_in) / 1e3
        for name, (a, b) in d["refit"].items():
            r[f"refit_{name}"] = float(refit[b, 1] - refit[a, 1]) / ghz / 1e3
        r["refit_after_last_block"] = (int(refit[0, 0]) - last_out) / 1e3
        r["device_span"] = (int(refit[d["refit_end"], 0]) - first_in) / 1e3
        rows.append(r)
    return {key: statistics.median(r[key] for r in rows) for key in rows[0]}


def compare(a: dict, b: dict) -> dict:
    import torch

    same = {k: bool(torch.equal(a[k], b[k])) for k in ("counts", "inliers", "n_inliers", "ok")}
    same["choice"] = bool(torch.equal(a["info"][0], b["info"][0]))
    same["refit_kept"] = bool(torch.equal(a["info"][1], b["info"][1]))
    diff = max(float((a[k].double() - b[k].double()).abs().max()) for k in ("R", "t", "s"))
    return dict(equal=same, rts_max_abs_diff=diff, rts_bit_equal=all(torch.equal(a[k], b[k]) for k in ("R", "t", "s")))


def load_call(path: str, device):
    import torch

    from orb_slam_cuda_tpu_torch.geometry.camera import Camera

    d = torch.load(path)
    args = {k: v.to(device) for k, v in d["args"].items()}
    return dict(args=args, sets=d["sets"].to(device), cam=Camera(**d["cam"]), fix_scale=d["fix_scale"],
                min_inliers=d["min_inliers"])


def synthetic_call(device):
    from orb_slam_cuda_tpu_torch.engine.loop_closing import MIN_SIM3_INLIERS
    from orb_slam_cuda_tpu_torch.ops import sim3_kernel

    cam, p = sim3_kernel.synthetic_problem(device, 2000, seed=2000)
    return dict(args=p, sets=sim3_kernel.synthetic_sets(p, 131 * 15), cam=cam, fix_scale=False,
                min_inliers=MIN_SIM3_INLIERS)


def record(out: str) -> None:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from orb_slam_cuda_tpu_torch.engine.loop_closing import MIN_SIM3_INLIERS

    chip_smoke.phase_build()
    _, slam, call = chip_smoke.phase_loop_path(*chip_smoke.make_loop_fixture("cuda"))
    if call is None:
        raise SystemExit("torch_sim3_split: the loop path made no Sim3 call whose RANSAC passed")
    (_, valid, x1, x2, uv1, uv2, th1, th2), sets = call
    args = dict(x1=x1, x2=x2, uv1=uv1, uv2=uv2, th1=th1, th2=th2, valid=valid)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(dict(args={k: v.cpu() for k, v in args.items()}, sets=sets.cpu(), cam=slam.loop_closer.cam._asdict(),
                    fix_scale=bool(slam.loop_closer.fix_scale), min_inliers=MIN_SIM3_INLIERS), out)
    print(json.dumps({"recorded": out, "matches": int(x1.shape[0]), "valid": int(valid.sum())}))


def split(call_path: str, parent: str, out: str | None) -> None:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from orb_slam_cuda_tpu_torch.ops import sim3_kernel

    dev = torch.device("cuda")
    calls = {"real": load_call(call_path, dev), "full_width": synthetic_call(dev)}
    sources = {"tree": sim3_kernel.SOURCE, "parent": parent}
    with ThreadPoolExecutor(4) as pool:  # one nvcc a build, started together
        built = {(name, st): pool.submit(build, src, name, st) for name, src in sources.items() for st in (False, True)}
        kernels = {name: (Kernel(*built[name, False].result()), Kernel(*built[name, True].result()))
                   for name in sources}
    ghz = sm_ghz(kernels["tree"][1])
    res = {"card": torch.cuda.get_device_name(0), "sm_ghz": ghz, "calls": {}}
    for cname, call in calls.items():
        row = {"matches": int(call["args"]["x1"].shape[0]), "valid": int(call["args"]["valid"].sum()),
               "hypotheses": int(call["sets"].shape[0])}
        outs = {}
        for name, (plain, stamped) in kernels.items():
            outs[name] = plain(call)
            again = plain(call)
            torch.cuda.synchronize()
            warm = chip_smoke.device_median_ms(lambda: plain(call), inner=10)
            warm_stamped = chip_smoke.device_median_ms(lambda: stamped(call), inner=10)
            nh = call["sets"].shape[0]
            empty = chip_smoke.device_median_ms(
                lambda: stamped.lib.split_empty(nh, 256, torch.cuda.current_stream().cuda_stream), inner=10)
            row[name] = dict(design=plain.design, warm_ms=warm, stamped_warm_ms=warm_stamped, empty_grid_ms=empty,
                             two_launches_equal=all(torch.equal(outs[name][k], again[k]) for k in outs[name]),
                             best=int(outs[name]["info"][0]), refit_kept=int(outs[name]["info"][1]),
                             n_inliers=int(outs[name]["n_inliers"]),
                             phases_us=phases(stamped, call, ghz))
        row["tree_vs_parent"] = compare(outs["tree"], outs["parent"])
        res["calls"][cname] = row
    text = json.dumps(res, indent=1)
    print(text)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(text + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("record")
    r.add_argument("out")
    s = sub.add_parser("split")
    s.add_argument("--call", required=True)
    s.add_argument("--parent", required=True)
    s.add_argument("--out")
    a = ap.parse_args()
    if a.cmd == "record":
        record(a.out)
    else:
        split(a.call, a.parent, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

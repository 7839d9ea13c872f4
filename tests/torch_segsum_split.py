"""Where the segment sum's block kernel spends its time, on the card.

Two measurements in one process:

- a copy of csrc/segsum.cu with clock64 stamps at fixed points of block 0
  (segment 0 of the call: the longest of the local BA's camera sums Hcc
  and bc, 746 addends, and of the essential graph's Hd), taken by thread 0
  (an adder) and thread 64 (a producer): the offsets read, the prologue
  done, and for each tile the producer's wait on its copies, the barrier,
  the copies of later tiles issued and the adds done;
- a dependent `__fadd_rn` chain of 2^20 adds in one thread, in clock64
  cycles and in globaltimer ns: the floor of an ordered sum.

The calls' inputs are tests/torch_segsum_ab.py's. Needs one GPU; prints
one JSON line:

    PYTHONPATH=$PWD python tests/torch_segsum_split.py [--out OUT.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch_segsum_ab as ab
from torch_segsum_cases import block_tile_rows

from orb_slam_cuda_tpu_torch.ops import segsum
from orb_slam_cuda_tpu_torch.ops.fast_kernel import BUILD_DIR, NVCC_FLAGS, _nvcc
from orb_slam_cuda_tpu_torch.utils import native_build

CALLS = ("local Hcc", "local bc", "essential Hd")
SLOTS = 4096  # stamps a thread

FADD_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void chain(float x, int n, long long* out) {
  float acc = 0.f;
  long long c0 = clock64();
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int i = 0; i < n; i += 64) {
#pragma unroll
    for (int u = 0; u < 64; ++u) acc = __fadd_rn(acc, x);
  }
  long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  out[0] = c1 - c0;
  out[1] = (long long)(t1 - t0);
  out[2] = acc == 123.f;  // keeps the chain
}
extern "C" int fadd_chain(float x, int n, long long* host) {
  long long* dev;
  if (cudaMalloc(&dev, 3 * sizeof(long long))) return 1;
  for (int w = 0; w < 3; ++w) chain<<<1, 1>>>(x, n, dev);
  int rc = cudaMemcpy(host, dev, 3 * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(dev);
  return rc;
}
"""


def _sub(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"torch_segsum_split: the source no longer has {old!r} once")
    return text.replace(old, new)


def stamped_source() -> str:
    """csrc/segsum.cu with the stamps and an entry that copies them out."""
    with open(segsum.SOURCE) as f:
        src = f.read()
    src = _sub(src, "namespace {\n", f"__device__ long long g_st[{2 * SLOTS}];\nnamespace {{\n")
    src = _sub(src, "#include <stdint.h>\n",
               "#include <stdint.h>\n#define ST(i) do { if (blockIdx.x == 0 && (tid == 0 || tid == 64)) "
               f"g_st[(tid ? {SLOTS} : 0) + (i)] = clock64(); }} while (0)\n")
    src = _sub(src, "  const int64_t lo = __ldg(offsets + s), len = __ldg(offsets + s + 1) - lo;\n",
               "  ST(0);\n  const int64_t lo = __ldg(offsets + s), len = __ldg(offsets + s + 1) - lo;\n  ST(1);\n")
    src = _sub(src, "  float2 acc = make_float2(0.0f, 0.0f);\n", "  ST(2);\n  float2 acc = make_float2(0.0f, 0.0f);\n")
    src = _sub(src, "    __syncthreads();  // everyone's; and tile t - 1 is added, its slot free\n",
               "    ST(3 + 4 * t);\n    __syncthreads();\n    ST(4 + 4 * t);\n")
    src = _sub(src, "    if (tid < ADDERS) add_tile<K>", "    ST(5 + 4 * t);\n    if (tid < ADDERS) add_tile<K>")
    src = _sub(src, "rows_of(t), acc);\n  }\n", "rows_of(t), acc);\n    ST(6 + 4 * t);\n  }\n")
    return src + ('\nextern "C" int segsum_stamps(long long* host) '
                  "{ return (int)cudaMemcpyFromSymbol(host, g_st, sizeof(g_st)); }\n")


def build(name: str, text: str) -> str:
    """The library built from `text`, written as `name` into build/."""
    d = os.path.join(BUILD_DIR, "segsum_split")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write(text)
    return native_build.build(path, name, flags=tuple(NVCC_FLAGS), build_dir=d, compiler=_nvcc())


def split(lib, name):
    seg, vals = ab.problem(name, torch.device("cuda"))
    run = ab.launcher(lib.segsum_block, seg, vals)
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    buf = np.zeros(2 * SLOTS, np.int64)
    if lib.segsum_stamps(buf.ctypes.data):
        raise RuntimeError("torch_segsum_split: reading the stamps failed")
    a, p = buf[:SLOTS] - buf[0], buf[SLOTS:] - buf[0]
    rows, k = int(seg.lengths[0]), int(np.prod(vals.shape[1:]))
    t_rows = block_tile_rows(k)
    tiles = -(-rows // t_rows)
    per_tile = [{"landed": int(p[3 + 4 * t]), "barrier": int(a[4 + 4 * t]), "issued": int(p[5 + 4 * t]),
                 "adds_done": int(a[6 + 4 * t]), "adds": int(a[6 + 4 * t] - a[5 + 4 * t])} for t in range(tiles)]
    return {"k": k, "rows": rows, "tile_rows": t_rows, "offsets_read": int(a[1]), "prologue_done": int(a[2]),
            "tiles": per_tile, "end": int(a[6 + 4 * (tiles - 1)])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_segsum_split: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    fadd = ctypes.CDLL(build("fadd_chain.cu", FADD_SOURCE))
    out = np.zeros(3, np.int64)
    n = 1 << 20
    fadd.fadd_chain.argtypes = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    if fadd.fadd_chain(1e-3, n, out.ctypes.data):
        raise RuntimeError("torch_segsum_split: the FADD chain failed")
    res = {"card": card, "fadd": {"cycles_per_add": out[0] / n, "ns_per_add": out[1] / n,
                                  "clock_mhz": out[0] * 1e3 / out[1]}, "calls": {}}
    lib = ab.bind(build("segsum_stamped.cu", stamped_source()), ("segsum_block",))
    lib.segsum_stamps.argtypes = [ctypes.c_void_p]
    for name in CALLS:
        res["calls"][name] = split(lib, name)
        c = res["calls"][name]
        print(f"{name}: {c['rows']} rows in {len(c['tiles'])} tiles of {c['tile_rows']}; offsets read at "
              f"{c['offsets_read']}, prologue done {c['prologue_done']}, end {c['end']} cycles; tiles (landed, "
              f"barrier, issued, adds done, adds) " + "; ".join(
                  f"{t['landed']}, {t['barrier']}, {t['issued']}, {t['adds_done']}, {t['adds']}" for t in c["tiles"]),
              file=sys.stderr, flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

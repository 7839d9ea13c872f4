"""chip_smoke.py's RGB-D and stereo paths of two trees of the port on one
card, in turns: each run a process of its own that builds the tree's
kernels, then tracks the RGB-D path (120 frames and its localization probe)
and the stereo path (300 pairs, one loop closed), one after the other, with
nothing else on the card or the host. Gates as chip_smoke.py's.

Run from the root of the repository; `--other DIR` is the second tree (e.g.
an older commit unpacked with `git archive` into a gitignored directory that
the card's copy holds, such as `chipcmd/`). `--order` names the runs' trees
in turn, A this one and B the other (default ABBA).

    PYTHONPATH=$PWD python tests/torch_paths_ab.py --other DIR [--order ABBA] [--out OUT]

Each run's log (the per-frame mapping lines left out) goes to OUT/<i>_<tree>.txt
(default build/paths_ab);
the last line printed is one JSON object: per run, per path, the frames'
fps, p50, p99 and max ms, the seconds, the mapping stages' means
(timesMapping.csv: local_mapping, loop_sim3, loop_pose_graph, ...) and
whether every gate passed, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

CHILD = """
import sys, time
sys.path.insert(0, {tree!r})
import chip_smoke as cs
t0 = time.perf_counter()
cs.phase_build()
print(f"build {{time.perf_counter() - t0:.1f}} s", flush=True)
cs.phase_rgbd_path(*cs.make_rgbd_fixture("cuda"))
cs.phase_stereo_path(*cs.make_stereo_fixture("cuda"))
print("paths done", flush=True)
"""

FRAMES = re.compile(r"^(rgbd path|stereo path) frames 0-\d+: ([\d.]+) fps, p50 ([\d.]+) ms, p99 ([\d.]+) ms, "
                    r"max ([\d.]+) ms")
SECONDS = re.compile(r"^(rgbd path|stereo path): (\d+) frames in ([\d.]+) s")
MAPPING = re.compile(r"^stage means timesMapping.csv, frames 0-\d+: (.*)$")
STAGE = re.compile(r"(\w+) ([\d.]+) ms \(n=(\d+)\)")
GATES = re.compile(r"^(rgbd path|stereo path): all gates passed")


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def parse(text: str) -> dict:
    """The paths' numbers from a run's log."""
    paths, current = {}, None
    for line in text.splitlines():
        m = SECONDS.match(line)
        if m:
            current = paths.setdefault(m.group(1), {"gates": False})
            current.update(frames=int(m.group(2)), seconds=float(m.group(3)))
        m = FRAMES.match(line)
        if m:
            paths[m.group(1)].update(fps=float(m.group(2)), p50_ms=float(m.group(3)), p99_ms=float(m.group(4)),
                                     max_ms=float(m.group(5)))
        m = MAPPING.match(line)
        if m and current is not None and "mapping" not in current:
            current["mapping"] = {k: {"mean_ms": float(v), "n": int(n)} for k, v, n in STAGE.findall(m.group(1))}
        m = GATES.match(line)
        if m and m.group(1) in paths:
            paths[m.group(1)]["gates"] = True
    return paths


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=os.path.join("build", "paths_ab"))
    ap.add_argument("--timeout", type=float, default=900.0)
    a = ap.parse_args()
    trees = {"A": os.getcwd(), "B": os.path.abspath(a.other)}
    os.makedirs(a.out, exist_ok=True)
    runs = []
    for i, which in enumerate(a.order):
        tree = trees[which]
        env = dict(os.environ, PYTHONPATH=tree)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CHILD.format(tree=tree)], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=a.timeout)
        wall = time.perf_counter() - t0
        log = "\n".join(line for line in proc.stdout.splitlines() if not line.startswith("mapping/loop/gba"))
        with open(os.path.join(a.out, f"{i}_{which}.txt"), "w") as f:
            f.write(log + "\n--- stderr ---\n" + proc.stderr[-20000:])
        run = {"run": i, "tree": which, "rc": proc.returncode, "wall_s": round(wall, 1), "paths": parse(proc.stdout)}
        runs.append(run)
        print(json.dumps(run), flush=True)
    ok = all(r["rc"] == 0 and len(r["paths"]) == 2 and all(p["gates"] for p in r["paths"].values()) for r in runs)
    print(json.dumps({"trees": trees, "card": _card(), "ok": ok, "runs": runs}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Per-stage timing in the reference's CSV schema (torch port of
orb_slam_cuda_tpu/utils/timing.py): rows `(frame, name, level, ns)` per
logical CSV. `stage(..., sync=device)` synchronizes a CUDA device before
stopping the clock, so a stage's time includes its queued device work."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


class StageTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.rows: Dict[str, List[tuple]] = defaultdict(list)
        self.frame = 0

    def set_frame(self, frame: int):
        self.frame = frame

    @contextlib.contextmanager
    def stage(self, csv: str, name: str, level: int = -1, sync=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if sync is not None and torch.device(sync).type == "cuda":
                torch.cuda.synchronize(sync)
            t1 = time.perf_counter_ns()
            self.rows[csv].append((self.frame, name, level, t1 - t0))

    def summary(self, csv: str) -> Dict[str, float]:
        """Mean milliseconds per stage name."""
        acc: Dict[str, List[int]] = defaultdict(list)
        for frame, name, level, ns in self.rows.get(csv, []):
            acc[name].append(ns)
        return {k: sum(v) / len(v) / 1e6 for k, v in acc.items() if v}

    def flush(self, directory: str = "."):
        """Write one CSV per subsystem: `frame,name,level,time` (ns)."""
        paths = []
        for csv, rows in self.rows.items():
            path = os.path.join(directory, csv)
            with open(path, "w") as f:
                f.write("frame,name,level,time\n")
                for frame, name, level, ns in rows:
                    f.write(f"{frame},{name},{level},{ns}\n")
            paths.append(path)
        return paths

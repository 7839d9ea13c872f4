"""Runtime telemetry sampler (the Powermon counterpart; port of
orb_slam_cuda_tpu/utils/powermon.py, device memory from torch.cuda).

The reference drives an external serial power-measurement board around
its main loop (reference: include/powermon.hpp:48-197,
src/powermon.cpp:76-566 — 1 Mbaud TTY, async sampling thread,
prepare/startAsync/stopAsync/printStats used in mono_kitti.cc:53-154).
That hardware is TX2-specific; the counterpart here samples what a GPU
deployment can observe — the bytes PyTorch's caching allocator holds in
use on every visible CUDA device (`allocated_bytes.all.current` of
torch.cuda.memory_stats; 0 without a card), host CPU utilization and,
where the platform exposes it, RAPL energy counters — with the same
prepare/start/stop/print lifecycle so run scripts translate 1:1.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import torch


@dataclass
class Sample:
    t: float
    device_bytes_in_use: int = 0
    host_cpu_util: float = 0.0
    host_energy_uj: Optional[int] = None


class Powermon:
    """Async telemetry sampler with the reference's lifecycle API."""

    def __init__(self, period_s: float = 0.2):
        self.period = period_s
        self.samples: List[Sample] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_cpu = None
        self._rapl_path = self._find_rapl()

    # -- reference API surface (powermon.hpp:48-197) -------------------
    def prepare(self):
        self.samples = []
        self._last_cpu = self._read_cpu()
        return True

    def start_async(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop_async(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def read_sync(self) -> Sample:
        s = self._sample()
        self.samples.append(s)
        return s

    def print_stats(self, file=None):
        import sys

        file = file or sys.stderr
        if not self.samples:
            print("powermon: no samples", file=file)
            return
        mem = [s.device_bytes_in_use for s in self.samples]
        cpu = [s.host_cpu_util for s in self.samples]
        msg = (
            f"powermon: {len(self.samples)} samples over "
            f"{self.samples[-1].t - self.samples[0].t:.1f}s | "
            f"device mem peak {max(mem)/1e6:.1f} MB mean {sum(mem)/len(mem)/1e6:.1f} MB | "
            f"host cpu mean {sum(cpu)/len(cpu)*100:.0f}%"
        )
        e = self.energy_joules()
        if e is not None:
            msg += f" | host energy {e:.1f} J"
        print(msg, file=file)

    def energy_joules(self) -> Optional[float]:
        es = [s.host_energy_uj for s in self.samples if s.host_energy_uj is not None]
        if len(es) >= 2:
            # RAPL counters wrap; ignore wraps for short runs.
            return max(0.0, (es[-1] - es[0]) / 1e6)
        return None

    # -- internals ------------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            self.samples.append(self._sample())
            self._stop.wait(self.period)

    def _sample(self) -> Sample:
        dev_bytes = 0
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                dev_bytes += torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0)
        return Sample(
            t=time.time(),
            device_bytes_in_use=dev_bytes,
            host_cpu_util=self._cpu_util(),
            host_energy_uj=self._read_rapl(),
        )

    @staticmethod
    def _read_cpu():
        try:
            with open("/proc/stat") as f:
                parts = f.readline().split()[1:]
            vals = [int(x) for x in parts]
            idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
            return idle, sum(vals)
        except Exception:
            return None

    def _cpu_util(self) -> float:
        cur = self._read_cpu()
        if cur is None or self._last_cpu is None:
            self._last_cpu = cur
            return 0.0
        idle0, tot0 = self._last_cpu
        idle1, tot1 = cur
        self._last_cpu = cur
        dt = tot1 - tot0
        return 0.0 if dt <= 0 else max(0.0, 1.0 - (idle1 - idle0) / dt)

    @staticmethod
    def _find_rapl() -> Optional[str]:
        base = "/sys/class/powercap/intel-rapl:0/energy_uj"
        return base if os.path.exists(base) else None

    def _read_rapl(self) -> Optional[int]:
        if self._rapl_path is None:
            return None
        try:
            with open(self._rapl_path) as f:
                return int(f.read().strip())
        except Exception:
            return None

"""Device programs: the counterpart of the JAX package's `jax.jit`
functions, each one device dispatch. The System's per-frame ones
(orb_slam_cuda_tpu/engine/system.py: `_frame_fn`, `_pipe_fn`,
`_stereo_frame_fn`, `_rgbd_frame_fn`, and engine/tracking.py's
`full_track_step`) and the keyframe path's (keyframe insertion and depth
points in engine/system.py, the mapper's in engine/local_mapping.py, loop
detection and a global-BA chunk in engine/loop_closing.py).

`Program(fn, name)` runs `fn` as a captured CUDA graph on the card:

- On CPU tensors it calls `fn` directly (the plain version the tests use).
- On CUDA tensors the key is the structure of the arguments and the
  shape, dtype and device of every tensor in them, as `jit`'s trace cache
  keys on abstract values: it changes when a map capacity grows, not
  when a value does. Every value that changes from frame to frame must
  therefore be a tensor argument; a Python number among the arguments is
  part of the key, and a closure constant is frozen at capture.
- The first call with a new key runs `fn` eagerly (its result is that
  call's result, its launches real), then captures `fn` on static copies
  of the same inputs. A later call copies its inputs into those static
  buffers on the stream (no host sync) and replays the graph; it returns
  clones of the outputs, so the next replay of any graph cannot overwrite
  what the caller keeps.
- A failed capture raises `CaptureError` naming the last op dispatched
  before the failure; nothing falls back to eager on the card, and the
  next capture opens a new pool.

`to_device` and `read_async` move host arrays in and a packed result out
through pinned memory without waiting for the stream.

`eager()` makes every Program call `fn` directly (as `jax.disable_jit()`
does): for debugging and for comparisons of graphed against eager runs.
Live graphs share one memory pool (they never replay concurrently);
`Program.clear()` drops a program's graphs once their key cannot occur
again, and the pool reuses their memory. Once no graph of a pool is left
(a System's graphs go with it), the next capture opens a new pool: the
old one keeps only what a capture allocated for good (cuBLAS's workspace
for the capture stream), which PyTorch cannot hand to another capture. Kernel launches that a graph
recorded are counted once per replay (the `launches` of each entry in
`KERNELS`); a capture counts none. `captures`, `replays` and
`capture_s` sum every Program's counts, as `launches` does for the kernel.
"""

from __future__ import annotations

import contextlib
import time
import traceback
import weakref
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import dlt_kernel, fast_kernel

# The launch counts of the hand-written kernels' entries (`launches`, and
# `recorded` under capture): the FAST and DLT modules' own and the DLT
# kernel's gated entry's.
KERNELS = (fast_kernel, dlt_kernel, dlt_kernel.gated)


class CaptureError(RuntimeError):
    """A Program's CUDA-graph capture failed."""


captures = 0
replays = 0
capture_s = 0.0
_eager_depth = 0
_pools = {}  # device index -> [pool handle, live graphs in it]


@contextlib.contextmanager
def eager():
    """Run every Program eagerly inside this block (nests)."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def is_eager() -> bool:
    return _eager_depth > 0


class _Tensor:
    """Marks a tensor leaf in an argument structure."""

    def __repr__(self):
        return "<tensor>"


_TENSOR = _Tensor()


def _flatten(tree, leaves: list):
    """The structure of `tree` (tuples, lists, NamedTuples) with its tensors
    appended to `leaves`; any other leaf is kept in the structure."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return _TENSOR
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple(_flatten(x, leaves) for x in tree)
    return None, tree


def _unflatten(spec, tensors):
    if spec is _TENSOR:
        return next(tensors)
    kind, body = spec
    if kind is None:
        return body
    kids = [_unflatten(s, tensors) for s in body]
    if kind in (tuple, list):
        return kind(kids)
    return kind(*kids)


def _key(spec, tensors):
    return spec, tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def program_key(*args):
    """The capture key of a call: the argument structure with its non-tensor
    leaves, and (shape, dtype, device) of every tensor."""
    tensors = []
    return _key(_flatten(args, tensors), tensors)


def pow2_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power of two >= n, clamped to [lo, hi]: a static size
    that many counts share, so that they share one program."""
    b = lo
    while b < min(n, hi):
        b *= 2
    return min(b, hi)


def to_device(a, device):
    """A host array (or tensor) as a program input on `device`: to the card
    through pinned memory, queued without waiting for the stream (a
    capture refuses a copy from pageable memory, and it would wait)."""
    t = torch.as_tensor(a)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.contiguous().pin_memory().to(device, non_blocking=True)


def read_async(t: torch.Tensor):
    """Queue the copy of `t` to the host. Returns (host tensor, CUDA event
    recorded after the copy, or None for a CPU tensor): the host tensor is
    valid once the event has completed."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class LastOp(TorchDispatchMode):
    """Remembers the last aten op dispatched and the port's line that
    called it."""

    def __init__(self):
        super().__init__()
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        frames = [f for f in traceback.extract_stack() if "orb_slam_cuda_tpu_torch" in f.filename
                  and "tools" not in f.filename and not f.filename.endswith("programs.py")]
        where = f"{frames[-1].filename.split('orb_slam_cuda_tpu_torch/')[-1]}:{frames[-1].lineno}" if frames else "?"
        self.last = f"{func} at {where}"
        return func(*args, **(kwargs or {}))


def _pool(device: torch.device) -> list:
    """[handle, live graphs] of the device's shared pool, a new one if no
    graph is left in the last."""
    entry = _pools.get(device.index)
    if entry is None or entry[1] == 0:
        entry = _pools[device.index] = [torch.cuda.graph_pool_handle(), 0]
    return entry


def _release(entry: list):
    entry[1] -= 1


def _end_recording(device: torch.device, pool):
    """After a failed capture: PyTorch stops routing the capture stream's
    allocations into the graph's pool only once the capture has ended
    cleanly, so a failed one leaves the pool recording (and every later
    capture into it refused). End that here."""
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except RuntimeError:
        pass  # the capture ended it itself


def pool_bytes() -> int:
    """Bytes the card reserves for the pools that hold live graphs."""
    ids = {tuple(handle) for handle, live in _pools.values() if live > 0}
    if not ids:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in ids)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # static input tensors, in argument order
    out_spec: object
    outputs: list  # the graph's output tensors
    launches: tuple  # launches the graph recorded, one count per entry of KERNELS


class Program:
    """`fn` as one captured CUDA graph per key on the card; see the module
    docstring."""

    def __init__(self, fn, name: str):
        self.fn = fn
        self.name = name
        self._graphs = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def __call__(self, *args):
        global replays
        if _eager_depth:
            return self.fn(*args)
        tensors = []
        spec = _flatten(args, tensors)
        devices = {t.device for t in tensors}
        if not any(d.type == "cuda" for d in devices):
            return self.fn(*args)
        if len(devices) > 1:
            raise ValueError(f"program {self.name}: inputs on {sorted(map(str, devices))}; needs one CUDA device")
        key = _key(spec, tensors)
        g = self._graphs.get(key)
        if g is None:
            out = self.fn(*args)
            self._graphs[key] = self._capture(spec, tensors)
            return out
        for static, t in zip(g.inputs, tensors):
            static.copy_(t)
        g.graph.replay()
        self.replays += 1
        replays += 1
        for k, n in zip(KERNELS, g.launches):
            k.launches += n
        return _unflatten(g.out_spec, iter([o.clone() for o in g.outputs]))

    def _capture(self, spec, tensors) -> _Graph:
        global captures, capture_s
        device = tensors[0].device
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        inputs = [t.clone() for t in tensors]
        args = _unflatten(spec, iter(inputs))
        entry = _pool(device)
        pool = entry[0]
        graph = torch.cuda.CUDAGraph()
        recorded = [k.recorded for k in KERNELS]
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=pool):
                out = self.fn(*args)
        except Exception as e:
            _end_recording(device, pool)
            if _pools.get(device.index) is entry:
                del _pools[device.index]  # later captures open a new pool
            raise CaptureError(f"program {self.name}: CUDA graph capture failed; last op dispatched: "
                               f"{self._last_op(args, device)}; {type(e).__name__}: {e}") from e
        dt = time.perf_counter() - t0
        entry[1] += 1
        weakref.finalize(graph, _release, entry)
        self.capture_s += dt
        self.captures += 1
        captures += 1
        capture_s += dt
        outputs = []
        out_spec = _flatten(out, outputs)
        return _Graph(graph, inputs, out_spec, outputs, tuple(k.recorded - r for k, r in zip(KERNELS, recorded)))

    def _last_op(self, args, device):
        """Capture once more under LastOp, in a pool of its own, to name
        the op that broke the capture."""
        spy = LastOp()
        pool = torch.cuda.graph_pool_handle()
        try:
            with spy, torch.cuda.graph(torch.cuda.CUDAGraph(), pool=pool):
                self.fn(*args)
        except Exception:
            _end_recording(device, pool)
        return spy.last

    def clear(self):
        """Drop every graph (their key can no longer occur): the pool
        reuses their memory."""
        if self._graphs:
            torch.cuda.synchronize()
            self._graphs.clear()

    def stats(self) -> dict:
        return dict(captures=self.captures, replays=self.replays, capture_s=self.capture_s,
                    graphs=len(self._graphs))

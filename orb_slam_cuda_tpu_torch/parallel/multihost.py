"""Process-group bootstrap and the covisibility clustering (torch port of
orb_slam_cuda_tpu/parallel/multihost.py).

A JAX device mesh becomes a `torch.distributed` process group here: one
rank per process, one device per rank. The distributed solvers use only
`all_reduce` (and `barrier`), which gloo also runs on CUDA tensors, so two
ranks can share one card through gloo while the same code runs one rank
per card through NCCL.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def default_backend(num_processes: int, device="cuda") -> str:
    """NCCL when every rank of this host has a card of its own; gloo when
    ranks share a card or run on the CPU (NCCL puts no two ranks on one
    card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= num_processes else "gloo"


def join_group(init_method: str, world: int, rank: int, backend: str | None = None, device="cuda"):
    """Join the default process group of `world` ranks, whatever its size
    (a 1-rank group too). `init_method` is the rendezvous: a `file://`
    path (what tests under several workers need: no port to clash) or
    `tcp://host:port`; a bare `host:port`, as the JAX tool passes, means
    tcp. Whatever fails here raises: nothing switches backend or device."""
    if "://" not in init_method:
        init_method = "tcp://" + init_method
    backend = backend or default_backend(world, device)
    kw = {}
    if backend == "nccl":  # bind the rank's card now rather than let NCCL guess it from the rank
        dev = torch.device(device)
        kw["device_id"] = dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device="cuda") -> bool:
    """Join the default process group (`join_group`); a no-op returning
    False for one process, as the reference's bootstrap."""
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator is None:
        raise ValueError("a coordinator (file:// or tcp:// address) is required for several processes")
    join_group(coordinator, num_processes, process_id, backend, device)
    return True


def _rank_main(rank: int, world: int, root: str, backend, device: str, fn, args):
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:  # ranks on one host's CPU split its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    join_group(f"file://{os.path.join(root, 'store')}", world, rank, backend, device)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start_ranks(fn, world: int, args=(), root: str = ".", backend: str | None = None, device="cuda"):
    """Spawn `world` processes that join one process group (a file store
    in the directory `root`, so that no port is needed) and call
    `fn(rank, world, *args)`; `fn` must be a function of an importable
    module. Returns at once; `join_ranks` waits and collects."""
    os.makedirs(root, exist_ok=True)
    for name in ["store"] + [f"rank{r}.pkl" for r in range(world)]:  # left by an earlier run
        if os.path.exists(os.path.join(root, name)):
            os.remove(os.path.join(root, name))
    ctx = mp.start_processes(_rank_main, args=(world, os.path.abspath(root), backend, str(device), fn, args),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, os.path.abspath(root)


def join_ranks(handle, timeout: float | None = None) -> list:
    """Wait for the ranks of `start_ranks`; each rank's return value, in
    rank order. A rank that raised or died makes this raise (with its
    traceback), after the others are stopped."""
    ctx, root = handle
    t_end = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=2):
            if t_end is not None and time.monotonic() > t_end:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(len(ctx.processes)):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def run_ranks(fn, world: int, args=(), root: str = ".", backend: str | None = None, device="cuda",
              timeout: float | None = None) -> list:
    """`start_ranks` then `join_ranks`."""
    return join_ranks(start_ranks(fn, world, args, root, backend, device), timeout)


def covisibility_clusters(covis: np.ndarray, kf_valid: np.ndarray,
                          n_clusters: int) -> np.ndarray:
    """Partition keyframes into `n_clusters` balanced clusters that keep
    covisibility-heavy pairs together: seeded by keyframe order (temporal
    locality), then boundary keyframes move toward their heaviest-linked
    cluster. Host side, once per refinement round. Returns (K,) int32
    cluster ids, -1 for invalid keyframes."""
    K = covis.shape[0]
    valid = np.flatnonzero(kf_valid)
    assign = np.full(K, -1, np.int64)
    if len(valid) == 0:
        return assign.astype(np.int32)
    order = sorted(valid.tolist())
    target = int(np.ceil(len(valid) / n_clusters))
    cluster_of = {}
    sizes = [0] * n_clusters
    for i, k in enumerate(order):
        c = min(i // target, n_clusters - 1)
        cluster_of[k] = c
        sizes[c] += 1
    for _ in range(3):
        for k in order:
            weights = np.zeros(n_clusters)
            for j in valid:
                if j != k and covis[k, j] > 0:
                    weights[cluster_of[j]] += covis[k, j]
            best = int(np.argmax(weights))
            cur = cluster_of[k]
            if (
                weights[best] > weights[cur] * 1.2
                and sizes[best] < target + 2
                and sizes[cur] > 1
            ):
                sizes[cur] -= 1
                sizes[best] += 1
                cluster_of[k] = best
    for k, c in cluster_of.items():
        assign[k] = c
    return assign.astype(np.int32)

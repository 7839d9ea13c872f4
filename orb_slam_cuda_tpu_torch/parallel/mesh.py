"""The distributed back end's "mesh" (torch port of
orb_slam_cuda_tpu/parallel/mesh.py).

JAX shards over a 1-D `jax.sharding.Mesh` of devices; here the mesh is a
`torch.distributed` process group, one device per rank. Every `psum` of
the JAX solvers becomes an `all_reduce(SUM)` over the group
(`solvers/bundle_adjust.group_sum`).
No other collective is used, so gloo serves CUDA tensors as well as NCCL
does, and ranks that share one card run on gloo.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..utils.device import resolve


class Mesh(NamedTuple):
    """A process group seen from one rank: `size` plays the part of the
    JAX mesh's `devices.size`, `device` is this rank's torch.device."""

    group: object
    rank: int
    size: int
    device: torch.device


def make_mesh(group=None, device="cuda") -> Mesh:
    """The mesh of `group` (default: the whole default group, which must
    have been initialized, e.g. by `multihost.initialize_distributed`).
    On CUDA, rank r takes card r modulo the cards this host has, so ranks
    share a card when there are fewer cards than ranks."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.multihost.initialize_distributed first")
    group = dist.group.WORLD if group is None else group
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return Mesh(group=group, rank=rank, size=size, device=dev)


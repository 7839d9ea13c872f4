"""The device rule of the port's entry points: on the card unless the
caller asks for the CPU."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device="cuda") -> torch.device:
    """The torch.device an entry point runs on. A CUDA device that this
    process cannot reach raises here, at construction: nothing carries on
    on the CPU unless the caller passed `device="cpu"`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def host(x) -> np.ndarray:
    """A tensor on any device, or anything `np.asarray` takes, as numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

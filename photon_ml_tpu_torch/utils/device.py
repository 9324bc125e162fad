"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device. A
request for CUDA on a machine without a card raises: nothing falls back to
the CPU behind the caller's back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises when a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (no-op off CUDA)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def to_numpy(x, dtype=None):
    """A tensor (on any device, bfloat16 widened to float64) or array-like
    as a host numpy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float64)
        x = x.numpy()
    import numpy as np

    return np.asarray(x, dtype)

"""Device resolution for the port's entry points.

The port's work belongs on the GPU: an entry point given no device runs
on CUDA, and raises when CUDA is absent instead of carrying on quietly on
the CPU. The CPU is used only when a caller names it (the tests do).
"""

from __future__ import annotations

from typing import List, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (error without CUDA); anything else as given,
    with a CUDA device checked for availability up front."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """Every device a per-device check covers: all CUDA devices for
    ``None`` or ``"cuda"`` (the counterpart of ``jax.local_devices()``),
    else the one device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


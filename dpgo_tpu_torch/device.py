"""Device resolution shared by the package's entry points.

Every entry point takes ``device`` (default ``"cuda"``) and passes it
through ``resolve_device``: asking for CUDA where there is none raises, so
work never moves to the CPU unless the caller asked for ``"cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent — an entry point never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """float32 on a CUDA device (the kernel's type, as the TPU ran with
    x64 off), float64 on the CPU (the JAX package's default)."""
    return torch.float32 if device.type == "cuda" else torch.float64

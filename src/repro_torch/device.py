"""Device selection shared by every entry point of the port.

``device=None`` means the card: the port's entry points run on CUDA
unless the caller explicitly asks for the CPU.  There is no silent CPU
fallback — a missing card is an error, not a slower run.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises when CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def check_on(dev: torch.device, **tensors) -> None:
    """Raise unless every tensor lies on ``dev`` (no implicit moves)."""
    for name, t in tensors.items():
        if t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")

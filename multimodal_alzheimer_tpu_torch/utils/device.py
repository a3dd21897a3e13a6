"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA where there is
    none, rather than running elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not "
                           f"available")
    return device

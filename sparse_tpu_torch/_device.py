"""The device a constructor builds on.

The card is the port's default device: a constructor that takes host data
(Python lists, NumPy arrays) builds on ``cuda`` unless the caller asks for
another device, or hands it a tensor that already lies somewhere.  There is
no fallback: without a CUDA device, building on the default raises torch's
own error, and nothing quietly moves to the CPU.  Ask for the CPU with
``device="cpu"`` or with CPU tensors.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None, *xs) -> torch.device:
    """``device`` when given; else the device of the first tensor among
    ``xs``; else ``torch.device("cuda")``."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")

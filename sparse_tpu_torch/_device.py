"""The device a constructor builds on, and values on their way to the host.

The card is the port's default device: a constructor that takes host data
(Python lists, NumPy arrays) builds on ``cuda`` unless the caller asks for
another device, or hands it a tensor that already lies somewhere.  There is
no fallback: without a CUDA device, building on the default raises torch's
own error, and nothing quietly moves to the CPU.  Ask for the CPU with
``device="cpu"`` or with CPU tensors.

Host passes (re-blocking, splits) work on NumPy arrays, and NumPy has no
bfloat16: :func:`host_values` hands a bf16 tensor over as its int16 bit
pattern and :func:`device_values` takes it back, so stored values round-trip
bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "host_values", "device_values"]


def resolve_device(device=None, *xs) -> torch.device:
    """``device`` when given; else the device of the first tensor among
    ``xs``; else ``torch.device("cuda")``."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def host_values(x: torch.Tensor):
    """``x`` as a NumPy array on the host; bfloat16 as its int16 bits."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy()


def device_values(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Inverse of :func:`host_values`: the array ``a`` as a ``dtype`` tensor
    on ``device``."""
    t = torch.from_numpy(a)
    if dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(device)

"""Matmul precision policy: "f32 means full f32".

Port of ``sparse_tpu/utils/precision.py``.  The reference passes
``precision=HIGHEST`` to every float32 contraction because the TPU's default
float32 matmul is a single bf16 pass.  On an NVIDIA card the analogue is
TF32: PyTorch's float32 matmuls default to full float32
(``torch.backends.cuda.matmul.allow_tf32`` is False) but a caller may have
turned TF32 on process-wide, and cuDNN convolutions default to it.  Every
contraction in this package therefore runs inside :func:`full_precision`,
which pins full float32 for float32 operands and restores the caller's
settings afterwards.  Reduced precision is opt-in only, by the caller's own
dtype choice.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["matmul_precision", "full_precision"]


def matmul_precision(*dtypes) -> str | None:
    """``"highest"`` when any operand dtype is float32, else None (the
    default is already exact for that dtype)."""
    if any(d == torch.float32 for d in dtypes):
        return "highest"
    return None


@contextlib.contextmanager
def full_precision(*dtypes):
    """Run the enclosed contractions in full float32 when any of ``dtypes``
    is float32 (TF32 off for matmul and cuDNN), restoring the previous
    settings on exit."""
    if matmul_precision(*dtypes) is None:
        yield
        return
    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
        torch.backends.cudnn.allow_tf32 = prev[2]

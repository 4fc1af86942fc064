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

:func:`contract` is the one contraction rule of the package's plain paths:
an ``einsum`` in full precision for floating operands, and for integer
operands an exact sum of elementwise products on the operands' own device,
since CUDA has no integer matmul (``einsum``, ``matmul`` and ``bmm`` raise
on integer CUDA tensors).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["matmul_precision", "full_precision", "contract"]


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


def contract(spec: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, *xs)`` over operands of one dtype: floating
    types in full precision (:func:`full_precision`); integer types on any
    device as an exact sum of elementwise products on that device (integer
    sums wrap alike in every order, so the result equals the CPU's
    ``einsum``), one position of the largest summed index at a time, which
    bounds the transient to the output times the other summed indices."""
    dt = xs[0].dtype
    if any(x.dtype != dt for x in xs):
        raise TypeError(f"contract: operands of one dtype, got "
                        f"{[str(x.dtype) for x in xs]}")
    if dt.is_floating_point or dt.is_complex:
        with full_precision(dt):
            return torch.einsum(spec, *xs)
    ins, out = spec.replace(" ", "").split("->")
    subs = ins.split(",")
    size = {}
    for s, x in zip(subs, xs):
        if len(s) != x.dim() or len(set(s)) != len(s) or any(
                size.setdefault(c, d) != d for c, d in zip(s, x.shape)):
            raise ValueError(f"contract: {spec!r} does not fit operands of "
                             f"shapes {[tuple(x.shape) for x in xs]}")
    if len(subs) != len(xs) or not set(out) <= set(size):
        raise ValueError(f"contract: {spec!r} does not fit {len(xs)} "
                         "operands")
    summed = [c for c in dict.fromkeys("".join(subs)) if c not in out]
    res = torch.zeros([size[c] for c in out], dtype=dt, device=xs[0].device)
    loop = max(summed, key=lambda c: size[c]) if summed else None
    order = out + "".join(c for c in summed if c != loop)
    dims = tuple(range(len(out), len(order)))
    for j in range(size[loop] if summed else 1):
        prod = _product(subs, xs, order, loop, j)
        res += prod.sum(dims, dtype=dt) if dims else prod
    return res


def _product(subs, xs, order, loop, j) -> torch.Tensor:
    """The elementwise product of the operands laid over the axes ``order``
    (each taken at position ``j`` of index ``loop``; an axis an operand
    lacks broadcasts)."""
    prod = None
    for s, x in zip(subs, xs):
        if loop is not None and loop in s:
            x = x.select(s.index(loop), j)
            s = s.replace(loop, "")
        x = x.permute([s.index(c) for c in order if c in s])
        x = x[tuple(slice(None) if c in s else None for c in order)]
        prod = x if prod is None else prod * x
    return prod

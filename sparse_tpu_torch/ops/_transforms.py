"""A kernel launch under autograd and ``torch.func``, as the reference's
``pallas_call`` behaves under JAX's transforms.

A hand-written kernel writes raw memory through ``ctypes``: autograd and
``torch.func`` cannot see into it.  Every kernel wrapper hands its launcher
and its tensor inputs to :func:`kernel_call`, which gives the launch the
reference's semantics:

- ``torch.func.vmap`` works, over any of the inputs: the rule launches the
  kernel once per slice, so each slice is bitwise equal to a single call;
- differentiation raises ``NotImplementedError`` when a gradient or a
  tangent is asked for — reverse mode (``.backward()``,
  ``torch.autograd.grad``, ``torch.func.grad``) and forward mode
  (``torch.func.jvp``, a ``torch.autograd.forward_ad`` dual) — where the
  launch would otherwise return a result with no link to its inputs and a
  silently wrong derivative.  A forward pass with inputs that require grad
  still computes.

With no transform in play — no input that requires grad under grad mode,
no ``torch.func`` transform, no forward-AD level open — the launcher runs
directly: an ``autograd.Function`` costs tens of microseconds of host time
a call, as much as a small kernel.
"""

from __future__ import annotations

import torch
from torch._C._functorch import peek_interpreter_stack
from torch.autograd import forward_ad

__all__ = ["KernelCall", "kernel_call", "not_differentiable", "vmap_loop"]


def not_differentiable(name: str, mode: str) -> str:
    """The error of a derivative asked through a kernel launch."""
    return (f"{name}: {mode}-mode differentiation through a CUDA kernel is "
            "not implemented (the reference's pallas_call is not "
            "differentiable either). Differentiate on CPU tensors, where "
            "the plain PyTorch versions run, or, for block SpGEMM, through "
            "bsr_smsmm_apply_slab_ad.")


def _direct(tensors) -> bool:
    """True when no transform could see the launch (kept to a few attribute
    reads: it runs on every launch)."""
    # forward_ad keeps its open level here; -1 when none is open
    if peek_interpreter_stack() is not None or forward_ad._current_level >= 0:
        return False
    if torch.is_grad_enabled():
        for t in tensors:
            if t.requires_grad:
                return False
    return True


def vmap_loop(info, in_dims, call, tensors):
    """A loop ``vmap`` rule: ``call`` once per slice (each batched input's
    slice a fresh contiguous copy, aligned as a single call's operand
    would be), the results stacked along dimension 0."""
    outs = []
    for i in range(info.batch_size):
        outs.append(call(*(
            t if d is None else
            t.select(d, i).clone(memory_format=torch.contiguous_format)
            for t, d in zip(tensors, in_dims))))
    return torch.stack(outs), 0


class KernelCall(torch.autograd.Function):
    """``launch(*tensors)`` as one opaque operation: a ``vmap`` rule that
    launches once per slice, and derivatives that raise."""

    @staticmethod
    def forward(name, launch, *tensors):
        return launch(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.kernel_name = inputs[0]

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(not_differentiable(ctx.kernel_name,
                                                     "reverse"))

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(not_differentiable(ctx.kernel_name,
                                                     "forward"))

    @staticmethod
    def vmap(info, in_dims, name, launch, *tensors):
        return vmap_loop(info, in_dims[2:],
                         lambda *ts: KernelCall.apply(name, launch, *ts),
                         tensors)


def kernel_call(name: str, launch, *tensors):
    """``launch(*tensors)`` (one tensor out) with the reference's transform
    semantics; ``tensors`` are every input a transform may batch or
    differentiate (values and operands).  ``launch`` may capture index
    tensors, but must derive any tensor it hands the kernel inside itself:
    one made by an op under ``torch.func.grad`` before the call is wrapped
    and has no data pointer."""
    if _direct(tensors):
        return launch(*tensors)
    return KernelCall.apply(name, launch, *tensors)

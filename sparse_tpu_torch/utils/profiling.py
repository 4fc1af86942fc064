"""Profiling helpers: a ``torch.profiler`` trace and card-only op timing.

Port of ``sparse_tpu/utils/profiling.py``.  ``trace`` records host and CUDA
activity and writes a Chrome trace; ``timed_op`` keeps the reference's
dependency-chained timing protocol — each application's output, scaled by
``1 / (max|w| + 1)``, feeds the next, so no call can be skipped or hoisted
— and times the chain with CUDA events.  It times the card only: on a CPU
tensor it raises, so a CPU time is never reported as a device time.
"""

from __future__ import annotations

import contextlib
import math
from pathlib import Path

import torch

__all__ = ["trace", "timed_op"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host and, where there is a card, CUDA activity)
    and write ``logdir/trace.json`` for chrome://tracing or Perfetto.
    Yields the ``torch.profiler.profile`` object (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def timed_op(step, v0, *operands, iters: int = 10, reps: int = 3) -> float:
    """Seconds per application of ``step(v, *operands)`` on the card, whose
    output is feedable back as ``v``: ``iters`` dependency-chained
    applications between two CUDA events, best of ``reps`` after one
    warm-up chain.  ``ValueError`` unless ``v0`` is a CUDA tensor."""
    if not (isinstance(v0, torch.Tensor) and v0.is_cuda):
        raise ValueError("timed_op: times the card only; v0 must be a CUDA "
                         "tensor (a CPU time is never a device time)")

    def run():
        v = v0
        for _ in range(iters):
            w = step(v, *operands)
            v = w / (w.abs().max() + 1.0)
        return v.sum()

    with torch.cuda.device(v0.device):
        float(run())  # warm-up: builds the kernels, fills the caches
        best = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = run()
            end.record()
            end.synchronize()
            float(r)
            best = min(best, start.elapsed_time(end) / 1e3)
    return best / iters

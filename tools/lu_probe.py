"""Time the block LU's numeric phase and sweeps on one card, replayed as
one CUDA graph and run step by step from Python, on the block bands of
``benchmarks/suite.py`` (``chip_smoke._suite_bands``), and profile one
LU's kernels.

    python3 tools/lu_probe.py

For nb 256, 1024 (and 4096, graph only) prints the host seconds, the
card synchronised, of ``bsr_lu_numeric_apply`` and of both sweeps in
each mode, checks the two modes (and two graph runs) bitwise equal and
the solve's residual, then the ILU(0) set-up and apply on the SPD band,
and the kernel count and device time of one LU at nb 256 (graph) from
``torch.profiler``.  Each line carries the card's name and power limit.
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def step_loop(step, count, device):
    for _ in range(count):
        step()


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import sparse_tpu_torch as pt

    lu_mod = importlib.import_module("sparse_tpu_torch.solve.bsr_lu")
    graph = lu_mod._repeat
    card = cs.phase0_device()
    bands, spd = cs._suite_bands()
    for nb in (256, 1024, 4096):
        a, _ = cs._band_bsr(nb, bands[nb])
        plan = pt.bsr_lu_numeric_prepare(a)
        gen = torch.Generator(device="cuda").manual_seed(nb)
        b = torch.randn(a.n, device="cuda", generator=gen)
        runs = {}
        modes = (("graph", graph), ("steps", step_loop), ("graph2", graph))
        for name, repeat in modes:
            if name == "steps" and nb == 4096:
                continue
            lu_mod._repeat = repeat
            t, (lu, p) = cs._host_s(lambda: pt.bsr_lu_numeric_apply(plan, a))
            fplan = pt.bsr_tri_plan(lu, True)
            bplan = pt.bsr_tri_plan(lu, False)
            tf, y = cs._host_s(lambda: pt.bsr_forsolve(lu, b[p.long()],
                                                       fplan))
            tb, x = cs._host_s(lambda: pt.bsr_backsolve(lu, y, bplan))
            runs[name] = (lu.blocks, p, x)
            print(f"nb {nb} {name}: bsr_lu_numeric_apply {t:.3f} s "
                  f"({t / nb * 1e3:.3f} ms per block column), forsolve "
                  f"{tf:.3f} s, backsolve {tb:.3f} s [{card}]", flush=True)
        lu_mod._repeat = graph
        for name, got in runs.items():
            if not all(torch.equal(g, w) for g, w in zip(got, runs["graph"])):
                raise AssertionError(f"nb {nb}: {name} differs from graph")
        resid = cs._rel(pt.bsr_smvm(a, runs["graph"][2]), b)
        print(f"nb {nb}: {sorted(runs)} bitwise equal; residual "
              f"{resid:.3e}", flush=True)
    a, _ = cs._band_bsr(2000, spd)
    t, m = cs._host_s(lambda: pt.bsr_ilu0_preconditioner(a))
    v = torch.randn(a.n, device="cuda")
    t2, w = cs._host_s(lambda: m(v))
    print(f"ILU(0) on the SPD band nb 2000: set-up {t:.3f} s, apply "
          f"{t2:.3f} s, residual {cs._rel(pt.bsr_smvm(a, w), v):.3e} "
          f"[{card}]", flush=True)
    a, _ = cs._band_bsr(256, bands[256])
    plan = pt.bsr_lu_numeric_prepare(a)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pt.bsr_lu_numeric_apply(plan, a)
        torch.cuda.synchronize()
    # the kernels' own records (the graph's nodes), not the ops above them
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in ev)
    kernels = sum(e.count for e in ev)
    print(f"one LU at nb 256, replayed as a graph: {kernels} kernels, "
          f"{device_us / 1e3:.1f} ms of device time ({kernels / 256:.0f} "
          f"kernels, {device_us / 256 / 1e3:.3f} ms a block column) "
          f"[{card}]", flush=True)


if __name__ == "__main__":
    main()

"""End-to-end smoke run of sparse_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``sparse_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version, then drives the user's three
main paths.  SpMV — CSR from triples or COO, ``smvm_prepare``,
``plan.apply(v)`` — on the README fixture and on two matrices at realistic
size: a 500k-row, ~10M-nnz band (the ``segtile`` rung, kernel K1) and the
400k-row vector-FEM elasticity matrix of ``benchmarks/gen_fixtures.py`` (the
``blockseg`` rung, kernel K2).  SpMM — ``bell_spmm`` on ``bench.py``'s
80M-entry block band (nb 15,625, bsz 32, k 128, float32) with the banded kit
(K4), without a plan (K3) and with the transposed kit at k = 32 (K5), K6
called directly, a 5-step chain ``b <- A b``, and ``spmm`` at
``__graft_entry__.entry()``'s shape.  SpGEMM — ``spgemm(a, a)`` on the
reference's block SpGEMM fixture (``benchmarks/measure_auto_block.py``: nb
2,000, bsz 32, 181,214 block products, float32), routed to the block path
and its slab kernel K7, then K7 on the prepared plan, a 5-step chain and
the differentiable apply's forward and backward.  Results are checked
against SciPy in float64, then the kernels, their plain versions and the
entry points are timed with CUDA events.  The fourth slice: the segment-tile
variants (32-row tiles, the rigid layout, the tensor-core lane reduction:
kernels K1-r32 and K1-mxu) on the 10M-nnz band built through the default
device and on the three Matrix Market files of ``benchmarks/matrices``
read onto the card with ``mm_read``, and the dense-band SpMM of
``benchmarks/measure_dband.py`` (K8) on ``bench.py``'s band, each against
SciPy, then timed beside its bound on this card (the larger of its bytes
over 3.35 TB/s and its flops over the peak for its type) and one PyTorch
library call computing the same function (timed here only; the port never
calls it).  The SpMV kernels K1, K1-r32, K1-mxu and K2 read each plan's
compact stream (one value and one int32 column per stored entry, built
once with the plan): phases 2 and 13 hold them against their plain
versions over that stream (a 20,000-entry row, stored zeros, the
raw-array route, refresh), phases 6 and 15 time them through
``csr_smvm_segtile`` / ``bsr_smvm_segtile_block`` against
``torch.sparse_csr_tensor(...) @ v`` with int32 and with int64 indices,
with each entry's host microseconds a call, and a profiler trace lists
the kernels of one apply.  The elasticity plan carries the folded view of
its stream (the block RCM folded into K2's columns and output rows):
phase 6 holds the folded K2 bitwise to the unfolded K2 gathered back,
times both and the apply, and fails unless the apply's trace names one
kernel, launched once.  K4 and K8 share one
body for float32 and bf16 streams that skips the tiles' all-zero 32 x 32
chunks: phases 9 and 15 time both streams (K4's bf16 stream through
``compute_dtype=bfloat16``) beside ``BSR @ B`` in the same type, and
read the work the body issued from a counter the kernel keeps on the card,
which must stay within 1.25x the useful flops and equal this script's host
model of the vote (the tiles' non-zero chunks).  K4 on a kit
(``bell_spmm(plan=kit)``, "K4-kit" in the records) walks the kit's chunk
mask instead of voting: phase 7 holds it bit for bit to the vote body at
the card tests' shapes and on hand-built kits, phase 8 runs both routes
on the main path (the vote body through a bare ``BandedPlan``), and
phases 9, 15, 21 and 22 time it in every kind with the vote route on the
kit's tiles and K8 beside it, its count checked against the vote's model.
K3's float32 and bf16
streams run the same body on each block row's wide row, and K5's four
kinds (float32, bf16, bf16x3 and float64) walk the transposed kit's chunk
mask (built once per kit): phase 7 holds both against their plain
versions at the card tests' shapes, phase 9 reads their counters at the
bench shape the same way (K5 also the tile bytes it read, beside the
kit's) and times their bf16 streams with bf16 operands beside ``BSR @ B``
in bf16.  K6's float32 and bf16 streams run a
persistent body that votes once per stored block: phase 7 holds it
against its plain version at the card tests' shapes, phase 9 reads its
counter at the bench shape and times its bf16 stream (bf16 blocks and
operand) beside ``BSR @ B`` in bf16.  K7 walks a product list built once
per plan (``prod_ptr`` / ``prod_ab``): phases 10 and 12 hold the prepared
route (the plan's list) and the raw route (a list with the pads, built per
call) against their plain versions and read the kernel's count of the
products it multiplied, which must equal ``prod_ptr[-1]``.  K7's yardstick
is two library calls, the gathered block pairs through ``torch.bmm`` and
``index_add_`` into the output blocks, since cuSPARSE refuses the
fixture's ``A_csr @ A_csr`` (timed in float32, bf16 and float64).  The
fifth slice is plain PyTorch: phase 16 runs the direct solver on
``benchmarks/suite.py``'s 32 x 32-block band (half-width 2, seed 21) at nb
256, 1024 and 4096 (``bsr_lu_find_fills`` + ``bsr_lu_numeric_prepare``,
``bsr_lu_numeric_apply``, ``bsr_factorize(a).solve(b)``, ``bsr_forsolve``,
on the host clock), with the residual through the SpMV main path and the
solution against SciPy's ``spsolve``; phase 17 runs block-Jacobi and
ILU(0) on the suite's SPD band, ``csr_sub`` / ``csr_add`` on band-10M,
``bsr_add`` / ``bsr_mul`` on elasticity-400k, ``tri_smm`` / ``trap_smm`` at
n = 8192 and ``msr_smvm`` on 500,000 rows against float64 oracles, and
validates every matrix it built.  The sixth slice is the distributed
layer (``sparse_tpu_torch.parallel``): phase 18 runs it on an in-process
mesh of 4 shards on the card — ``pcsr_spmv``, the three halo SpMVs and
``halo_spmm`` (k = 32) on band-10M, ``halo_spmv_segtile`` launching K1
once per shard per apply, and at one shard beside the bare K1 on the same
compact stream; ``phub_spmv`` on the 1M-row power-law graph; ``pbell_smvm``
/ ``pbell_spmm`` on bench.py's band; CG, PCG (Jacobi, block-Jacobi,
ILU(0)), BiCGSTAB and GMRES on the suite's SPD band through ``PCSR`` and
``HaloSegtile`` at 1 and 4 shards, float64, each residual against the same
iterations in NumPy; ``pcsr_spgemm_aa`` / ``pcsr_transpose_device`` on
elasticity-400k and ``pbsr_smsmm`` / ``pbsr_smsmm_slab`` (K7 once per
shard per apply) on the SpGEMM fixture, each against SciPy — then the
process-group route on NCCL at world size 1 against the in-process
results, and prints a ``dist`` JSON line of times and ratios.  Phase 19
holds every kernel route to the reference's transform semantics:
``torch.func.vmap`` over 4 vectors through band-10M's ``plan.apply``
launches K1 4 times, each slice bitwise equal to one apply, and the same
for K2 (elasticity-400k), K1-r32, K1-mxu, K3-K6, K7 (prepared and raw) and
K8 over 2 operands; ``.backward()``, ``torch.autograd.grad``,
``torch.func.grad``, ``torch.func.jvp`` and a forward-AD dual through each
raise ``NotImplementedError``; ``bsr_smsmm_apply_slab_ad`` keeps its
gradients and vmaps; and the ``autograd.Function``'s host cost is timed
in turns with a direct launch.  Phase 20 runs the five port examples
(``examples/torch_*.py``) at size: PageRank on the 1M-row power-law graph,
the 1024 x 1024 Poisson problem and the fast distributed CG at n = 500,000
on 4 shards, the Galerkin update at n = 2^20 and the block LU at nb 4096,
each held to the reference script's assertion or to float64 NumPy running
the same iterations, and prints a ``transforms`` / ``examples`` JSON line.
Phase 21 times the public paths no earlier phase runs or times at size,
each against its float64 gate: the plain SpMV and SpMM entry points and
the ``xla`` / ``bell`` rungs on band-10M and elasticity-400k, the SpMMs
at ``__graft_entry__``'s shape, ``bell_smvm``, the bf16x3 kind of K3-K6
(K3's and K4's on the band body's tensor cores, K5's on its chunk-mask
body, K6's on its persistent body, with their issued work) and the
float64 kinds of K3-K6 and K8 (K3's, K4's and K8's on the band body's
DMMA tiles, K6's on its persistent body's, with their issued work; K5's on
the chunk-mask body, with its issued work and tile bytes) on the
80M-entry band, each beside ``BSR @ B`` in its dtype (float32 for
bf16x3), K6 at bsz 128 in every kind (``bench.py``'s block band at nb
3,907, where K6 runs its wide-block body in float32, bf16, bf16x3 and
float64 and K3's band body in int32: its main path, plain version, SciPy,
issued work, bound, the SM clock under load and ``BSR @ B``, each naming
its body, and in float32 and bf16 the kernels both sides run), the ESC and
dense SpGEMM cores on cuts of the SpGEMM fixture, ``pcsr_spmm`` /
``halo_spmm_overlapped`` / ``pcsr_spgemm`` over 4 shards, and an int32
pass exact to NumPy, and prints a ``surface`` JSON line; the kinds'
records join their kernels' entries in the ``kernels`` line.  Phase 22
drives the int32 and bf16 kinds of every kernel route and the float64
kinds of K1, K1-r32, K1-mxu and K2 through their main paths, K2's kernel
timed alone (as its float32 sibling is) and its apply beside it.

Every phase has a deadline; any failure exits non-zero before the result
line.  The last two lines of standard output are one JSON object per kernel
run, then ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository, the script fails.
"""

from __future__ import annotations

import faulthandler
import contextlib
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
#: A bf16 result rounded once from a float32 sum, or a float32 sum of
#: bf16-rounded inputs held against full float32, may differ by one bf16
#: ulp (2^-7 relative).  Where both sides take the same bf16 operands and
#: return the float32 sum (K8's stream), float32's tolerance applies.
BF16_TOL = 2.0 ** -7 + 1e-5
TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: BF16_TOL}
N_TIMED = 20


class Phase:
    """A named phase with a deadline: past it the process dumps every
    thread's stack and exits non-zero (faulthandler), even inside a CUDA
    call that never returns."""

    def __init__(self, name: str, seconds: float):
        self.name, self.seconds = name, seconds

    def __enter__(self):
        print(f"== {self.name} (deadline {self.seconds:.0f} s)", flush=True)
        self.t0 = time.perf_counter()
        faulthandler.dump_traceback_later(self.seconds, exit=True)
        return self

    def __exit__(self, *exc):
        faulthandler.cancel_dump_traceback_later()
        if exc[0] is None:
            print(f"   {self.name}: done in "
                  f"{time.perf_counter() - self.t0:.1f} s", flush=True)
        return False


def check_close(label, got, ref, bound_rows, dtype):
    """|got - ref| <= tol(dtype) * (|A||v|) elementwise; returns max err."""
    err = (got.double() - ref.double()).abs()
    bound = TOL[dtype] * bound_rows
    worst = float((err - bound).max()) if err.numel() else 0.0
    if worst > 0:
        raise AssertionError(f"{label}: error exceeds {TOL[dtype]} * |A||v| "
                             f"by {worst:.3e}")
    return float(err.max()) if err.numel() else 0.0


def abs_bound(s, v):
    """(|A| |v|) per row in float64 on the card, from a SciPy CSR."""
    import scipy.sparse as sp

    a = sp.csr_matrix(abs(s), dtype=np.float64)
    return torch.from_numpy(a @ np.abs(v.astype(np.float64))).cuda()


def median_ms(fn, warmup=3, n=N_TIMED):
    """Median per-call time of ``fn`` in ms (CUDA events around each call,
    after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pipelined_ms(fn, warmup=3, n=N_TIMED, windows=5):
    """Per-call times in ms of ``n`` calls issued back to back between two
    CUDA events, over ``windows`` such windows: (median, fastest).  The
    median is the reported time; the fastest shows how near the card's own
    rate a window came once the host kept up (``median_ms`` times each call
    alone, host included).  For a kernel of tens of us the host's Python per
    call is of the same order and the host is shared, so a window can be
    slower than the card, never faster."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times), min(times)


def bound_ms(nbytes, ops, dtype=torch.float32):
    """The least time in ms the card could take for work that must move
    ``nbytes`` and do ``ops`` operations on inputs of ``dtype``
    (``utils.stats.kernel_bound_s``: data-sheet peaks); returns (ms, what
    binds)."""
    from sparse_tpu_torch.utils.stats import kernel_bound_s

    t, by = kernel_bound_s(nbytes, ops, dtype)
    return t * 1e3, by


def csr_spmv_cost(a):
    """Bytes (``utils.stats.csr_bound_bytes``) and flops of y = A v that
    the pattern needs."""
    from sparse_tpu_torch.utils.stats import csr_bound_bytes

    return csr_bound_bytes(a), 2 * int(a.indptr[-1])


def spmm_cost(nbz, bsz, n, k, itemsize=4, out_bytes=4):
    """Bytes (``utils.stats.blocked_bound_bytes``: A and B at ``itemsize``,
    C at ``out_bytes`` per entry) and flops of C = A B for A in ``nbz``
    stored bsz x bsz blocks."""
    from sparse_tpu_torch.utils.stats import blocked_bound_bytes

    return (blocked_bound_bytes(nbz, bsz, n, k, value_bytes=itemsize,
                                out_bytes=out_bytes),
            2 * nbz * bsz * bsz * k)


#: label -> torch's reason, for each library call refused on the card.
LIBRARY_REFUSALS = {}


def library_ms(label, fn, card, n=N_TIMED):
    """Back-to-back time of one PyTorch library call computing a kernel's
    function (a yardstick only: the port never calls it), or None with the
    reason printed and kept in ``LIBRARY_REFUSALS`` when torch refuses it
    on the card."""
    try:
        ms, fastest = pipelined_ms(fn, warmup=2, n=n)
    except RuntimeError as e:  # torch's refusal (cuSPARSE, CUDA)
        LIBRARY_REFUSALS[label] = " ".join(str(e).split())[:160]
        print(f"   library {label}: refused on the card "
              f"({LIBRARY_REFUSALS[label]})", flush=True)
        return None
    print(f"   library {label}: {ms:.4f} ms back to back (median window; "
          f"fastest {fastest:.4f}) [{card}]", flush=True)
    return ms


def torch_csr(a, index_dtype=torch.int64):
    """The port's CSR as a ``torch.sparse_csr_tensor`` with ``index_dtype``
    row pointers and columns (for the library yardstick)."""
    nnz = int(a.indptr[-1])
    return torch.sparse_csr_tensor(a.indptr.to(index_dtype),
                                   a.indices[:nnz].to(index_dtype),
                                   a.data[:nnz], size=a.shape)


def library_csr_ms(label, a, v, card):
    """``torch.sparse_csr_tensor(...) @ v`` timed with int32 and with int64
    indices; returns (the faster ms, {index dtype: ms})."""
    times = {}
    for idx in (torch.int32, torch.int64):
        t = torch_csr(a, idx)
        times[str(idx)[6:]] = library_ms(f"{label}, {str(idx)[6:]} indices",
                                         lambda: t @ v, card)
        del t
    done = [ms for ms in times.values() if ms is not None]
    return (min(done) if done else None), times


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, cost,
                 lib_ms, lib_call, dtype=torch.float32, **extra):
    """One kernel's record for the ``kernels`` line; prints its bound.
    ``extra`` keys (bytes per stored entry, both library times) are added
    to the record."""
    b_ms, b_by = bound_ms(*cost, dtype)
    print(f"   {name}: {ms:.4f} ms back to back, bound {b_ms:.4f} ms "
          f"({b_by}: {cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.3f} GFLOP), "
          f"{b_ms / ms:.1%} of it; plain {plain_ms:.4f} ms; library "
          f"{'refused' if lib_ms is None else f'{lib_ms:.4f} ms'} "
          f"({lib_call}){''.join(f'; {k} {v}' for k, v in extra.items())}",
          flush=True)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "library_call": lib_call,
            **extra}


def _report(cell, label, fn, nnz, stream_bytes, card):
    """Median alone and back-to-back per-call times of ``fn``, with the
    rates they give (``stream_bytes``: what one compact-stream apply
    moves); returns (alone, back to back) ms."""
    ms = median_ms(fn)
    ms_b2b, fastest = pipelined_ms(fn)
    print(f"   {cell} {label:9s}: {ms:.4f} ms alone (median of {N_TIMED}), "
          f"{ms_b2b:.4f} ms back to back (median window; fastest "
          f"{fastest:.4f}); {nnz / ms / 1e6:.3f} / "
          f"{nnz / ms_b2b / 1e6:.3f} Gnnz/s; {stream_bytes / ms / 1e6:.1f} / "
          f"{stream_bytes / ms_b2b / 1e6:.1f} GB/s of stream bytes [{card}]",
          flush=True)
    return ms, ms_b2b


def phase0_device():
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}", flush=True)
    return card


def phase1_build():
    if not (ROOT / "sparse_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no sparse_tpu_torch/csrc beside "
                         f"{Path(__file__).name}; run it from the repository")
    sys.path.insert(0, str(ROOT))
    from sparse_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.load()
    print(f"   kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_kernels.build_seconds} s) -> "
          f"{_kernels.library_path().name}", flush=True)
    for line in _kernels.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print(f"   {line.strip()}", flush=True)


def _band_triples(n, per_row, half, rng):
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = np.clip(rows + rng.integers(-half, half, rows.size), 0, n - 1)
    return rows, cols


def _spill_band(n, rng):
    """A band of 24 draws per row within +-1500 columns, every 7th row
    empty, and row 0 with 16 entries on lane 5 within 2048 columns (one slot
    spilled 16 deep); N(0, 1) values.  Returns (SciPy CSR, rows, cols,
    vals)."""
    import scipy.sparse as sp

    rows, cols = _band_triples(n, 24, 1500, rng)
    keep = rows % 7 != 3  # every 7th row empty
    rows, cols = rows[keep], cols[keep]
    rows = np.concatenate([np.zeros(16, np.int64), rows])
    cols = np.concatenate([5 + 128 * np.arange(16), cols])
    vals = rng.standard_normal(rows.size)
    s = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return s, rows, cols, vals


def phase2_kernels_vs_plain():
    """K1 over the compact stream at wsub 8/16/32 in f32 and f64 (empty
    rows, a slot spilled 16 deep) against its plain version on the card,
    twice for bitwise repeatability, and the raw-array route (exact, then
    with padded and shuffled tiles) against the plan route; K1 and K1-mxu
    on a rectangular matrix with a 20,000-entry row and stored zeros, and a
    refreshed plan against a rebuilt one; K2 likewise; then the README
    fixtures straight through K1."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_csr, cuda_csr_block

    rng = np.random.default_rng(0)
    n = 20_000
    s, rows, cols, vals = _spill_band(n, rng)
    v_np = rng.standard_normal(n)
    bound = abs_bound(s, v_np)
    for dtype in (torch.float32, torch.float64):
        coo = pt.coo_make((n, n), torch.from_numpy(rows).cuda(),
                          torch.from_numpy(cols).cuda(),
                          torch.from_numpy(vals).to(dtype).cuda())
        a = pt.csr_from_coo(coo)
        v = torch.from_numpy(v_np).to(dtype).cuda()
        for wsub in (8, 16, 32):
            plan = pt.build_seg_tiles(a, wsub=wsub)
            # the 16 entries of row 0 on lane 5 share one slot: 16 tiles
            spill = int(((plan.rb == 0) & (plan.vals[:, 0, 5] != 0)).sum())
            if spill != 16:
                raise AssertionError(f"K1 wsub={wsub}: {spill} tiles hold "
                                     "slot (row 0, lane 5), expected 16")
            st = plan.stream
            if st.nnz != s.nnz:
                raise AssertionError(f"K1 wsub={wsub}: the stream holds "
                                     f"{st.nnz} entries, the CSR {s.nnz}")
            label = f"K1 wsub={wsub} {dtype}"
            err, y1 = _twice_vs_plain(
                label, lambda: pt.csr_smvm_segtile(a, v, plan),
                lambda: cuda_csr.segtile_stream_plain(st, v), bound, dtype)
            if not torch.all(y1[3:n:7] == 0):
                raise AssertionError(f"{label}: an empty row is not exactly 0")
            raw = dict(n=n, wsub=wsub, rows=8, kstep=plan.kstep,
                       chunks=plan.chunks)
            arrs = (plan.vals, plan.q, plan.seg_of, plan.rb)
            if not torch.equal(cuda_csr.segtile_apply(*arrs, v, **raw), y1):
                raise AssertionError(f"{label}: the raw-array route differs "
                                     "from the plan route")
            # padded raw-array call: 37 inert tiles (rb 0 and last block),
            # whole tile order shuffled
            pad = 37
            t = plan.n_tiles
            gen = torch.Generator("cuda").manual_seed(1)
            p = torch.randperm(t + pad, device="cuda", generator=gen)
            rbp = torch.cat([plan.rb, torch.tensor(
                [0, -(-n // 8) - 1] * (pad // 2) + [0], dtype=torch.int32,
                device="cuda")])
            vp = torch.cat([plan.vals, plan.vals.new_zeros(pad, 8, 128)])
            qp = torch.cat([plan.q, plan.q.new_zeros(pad, 8, 128)])
            sp_ = torch.cat([plan.seg_of, plan.seg_of.new_zeros(pad)])
            y3 = cuda_csr.segtile_apply(vp[p], qp[p], sp_[p], rbp[p], v,
                                        **raw)
            torch.cuda.synchronize()
            err3 = check_close(f"K1 padded wsub={wsub} {dtype}", y3[:n],
                               y1, bound, dtype)
            print(f"   K1 wsub={wsub:2d} {str(dtype):13s} tiles "
                  f"{plan.n_tiles:6d} ({spill} spill tiles on one slot), "
                  f"stream {st.nnz} entries, group {st.group}: "
                  f"max|kernel-plain| {err:.3e}, raw route equal, padded+"
                  f"shuffled {err3:.3e}; bitwise repeatable", flush=True)
    for dtype in (torch.float32, torch.float64):
        _long_row_case(dtype, rng)
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from gen_fixtures import elasticity_fem

    s = elasticity_fem(n_points=3_000, seed=1, scramble=False)
    ne = s.shape[0]
    v_np = rng.standard_normal(ne)
    bound = abs_bound(s, v_np)
    for dtype in (torch.float32, torch.float64):
        c = s.tocoo()
        a = pt.csr_from_coo(pt.coo_make(
            s.shape, torch.from_numpy(c.row).cuda(),
            torch.from_numpy(c.col).cuda(),
            torch.from_numpy(c.data).to(dtype).cuda()))
        ab = pt.csr_to_bsr(a, 2)
        plan = pt.build_seg_tiles_block(ab, wsub=16, refreshable=True)
        v = torch.from_numpy(v_np).to(dtype).cuda()
        st = plan.stream
        err, _ = _twice_vs_plain(
            f"K2 {dtype}", lambda: cuda_csr_block.bsr_smvm_segtile_block(
                ab, v, plan),
            lambda: cuda_csr_block.block_stream_plain(st, v), bound, dtype)
        # refresh against a rebuild: the same stream, the same bits
        blocks = ab.blocks * -1.5 + 0.25
        ab2 = pt.BSR(indices=ab.indices, blocks=blocks, n=ab.n, bsz=2)
        y_ref = cuda_csr_block.bsr_smvm_segtile_block(
            ab2, v, pt.block_seg_tiles_refresh(plan, blocks))
        y_new = cuda_csr_block.bsr_smvm_segtile_block(
            ab2, v, pt.build_seg_tiles_block(ab2, wsub=16))
        if not torch.equal(y_ref, y_new):
            raise AssertionError(f"K2 {dtype}: a refreshed plan differs "
                                 "from a rebuilt one")
        print(f"   K2 wsub=16 {str(dtype):13s} tiles {plan.n_tiles:6d}, "
              f"stream {st.nnz} blocks, group {st.group}: max|kernel-plain| "
              f"{err:.3e}; bitwise repeatable; refresh equals rebuild",
              flush=True)
    for a, v, want in _readme_cases():
        y = pt.csr_smvm_segtile(a, v, pt.build_seg_tiles(a))
        if not torch.equal(y, want):
            raise AssertionError(f"README fixture {a.shape} through K1: got "
                                 f"{y.tolist()}")
        print(f"   README fixture {a.shape[0]}x{a.shape[1]} through K1: "
              f"{y.tolist()}", flush=True)


def _long_row_case(dtype, rng):
    """300 x 50,000, row 7 holding 20,000 entries, row 8 empty, every 9th
    stored value an explicit zero: K1 and K1-mxu against their plain
    version and SciPy, the stream holding every stored entry; a refreshed
    plan gives a rebuilt plan's bits."""
    import scipy.sparse as sp

    import sparse_tpu_torch as pt
    from sparse_tpu_torch import interop
    from sparse_tpu_torch.ops import cuda_csr

    n, m = 300, 50_000
    base = sp.random(n, m, density=0.002, random_state=5, format="coo")
    rows = np.r_[base.row, np.full(20_000, 7)]
    cols = np.r_[base.col, rng.choice(m, 20_000, replace=False)]
    keep = rows != 8
    s = sp.coo_matrix((rng.standard_normal(keep.sum()),
                       (rows[keep], cols[keep])), shape=(n, m)).tocsr()
    s.sum_duplicates()
    s.data[::9] = 0.0  # stored zeros stay stored
    v_np = rng.standard_normal(m)
    bound = abs_bound(s, v_np)
    a = interop.csr_from_arrays(s.data, s.indices, s.indptr, s.shape,
                                device="cuda")
    a = pt.CSR(data=a.data.to(dtype), indices=a.indices, indptr=a.indptr,
               shape=a.shape)
    v = torch.from_numpy(v_np).to(dtype).cuda()
    plan = pt.build_seg_tiles(a, wsub=32, refreshable=True)
    st = plan.stream
    if st.nnz != s.nnz or st.n_long < 1:
        raise AssertionError(f"long-row case: stream {st.nnz} entries (CSR "
                             f"{s.nnz}), {st.n_long} long rows")
    ref = torch.from_numpy(s @ v_np).cuda()
    errs = []
    for reduce in ("vpu", "mxu"):
        label = f"K1 {reduce} long row {str(dtype)[6:]}"
        err, y = _twice_vs_plain(
            label, lambda: pt.csr_smvm_segtile(a, v, plan, reduce=reduce),
            lambda: cuda_csr.segtile_stream_plain(st, v), bound, dtype)
        errs.append(max(err, check_close(f"{label} vs scipy", y, ref, bound,
                                         dtype)))
        if y[8] != 0:
            raise AssertionError(f"{label}: the empty row is not exactly 0")
    new = a.data * -1.5 + 0.25
    a2 = pt.CSR(data=new, indices=a.indices, indptr=a.indptr, shape=a.shape)
    y_ref = pt.csr_smvm_segtile(a2, v, pt.seg_tiles_refresh(plan, new))
    y_new = pt.csr_smvm_segtile(a2, v, pt.build_seg_tiles(a2, wsub=32))
    if not torch.equal(y_ref, y_new):
        raise AssertionError("long-row case: a refreshed plan differs from "
                             "a rebuilt one")
    print(f"   K1 long row {str(dtype)[6:]}: 300x50000, {st.nnz} entries "
          f"({int((a.data == 0).sum())} stored zeros), {st.n_long} long "
          f"row(s) in {st.n_pieces} pieces: max err vpu {errs[0]:.3e}, mxu "
          f"{errs[1]:.3e}; refresh equals rebuild", flush=True)


def _readme_cases():
    """README fixture (BASELINE config 1) and the 5x5 golden in f64, built
    from triples with no ``device=`` (the card is the default device):
    ``(csr, v, want)``."""
    import sparse_tpu_torch as pt

    cases = [
        (2, 3, [(0, 0, 2), (1, 2, 3)], [10, 20, 30], [20, 90]),
        (5, 5, list(zip([0, 0, 0, 1, 1, 2, 2, 2, 3, 4, 4],
                        [0, 1, 3, 1, 2, 1, 2, 3, 3, 3, 4],
                        [1, 2, 11, 3, 4, 5, 6, 7, 8, 9, 10])),
         [3, 1, 2, 6, 5], [71, 11, 59, 48, 104]),
    ]
    for n, m, triples, vec, want in cases:
        yield (pt.csr_from_triples(n, m, triples, dtype=torch.float64),
               torch.tensor(vec, dtype=torch.float64, device="cuda"),
               torch.tensor(want, dtype=torch.float64, device="cuda"))


def phase3_readme():
    """The README fixtures, built with no ``device=``, through the main path
    on the card, with the default ladder and with prefer="segtile" (whose
    fill gate sends these tiny matrices to the row-binned rung, as in the
    reference)."""
    import sparse_tpu_torch as pt

    for a, v, want in _readme_cases():
        if a.data.device != torch.device("cuda", 0):
            raise AssertionError(f"README fixture built on {a.data.device}, "
                                 "not on the default device cuda:0")
        kinds = []
        for prefer in (None, "segtile"):
            plan = pt.smvm_prepare(a, prefer=prefer)
            y = plan.apply(v)
            if y.device.type != "cuda" or not torch.equal(y, want):
                raise AssertionError(f"README fixture {a.shape} prefer="
                                     f"{prefer}: got {y.tolist()}")
            kinds.append(plan.kind)
        print(f"   {a.shape[0]}x{a.shape[1]}: {y.tolist()} on {y.device} "
              f"(rungs: default {kinds[0]}, prefer=segtile {kinds[1]})",
              flush=True)


def phase4_band():
    """500k rows, ~20 entries per row within +-1000 columns, f32, from
    default_rng(4) (benchmarks/suite.py's band): the segtile rung."""
    import scipy.sparse as sp

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_csr

    rng = np.random.default_rng(4)
    n = 500_000
    rows, cols = _band_triples(n, 20, 1000, rng)
    vals = (rng.standard_normal(rows.size) * 0.01).astype(np.float32)
    v_np = rng.standard_normal(n).astype(np.float32)
    t0 = time.perf_counter()
    coo = pt.coo_make((n, n), torch.from_numpy(rows).cuda(),
                      torch.from_numpy(cols).cuda(),
                      torch.from_numpy(vals).cuda())
    a = pt.csr_from_coo(coo)
    torch.cuda.synchronize()
    t_csr = time.perf_counter() - t0
    launches0 = cuda_csr.K1_LAUNCHES
    with _timed_stream_builds() as builds:
        t0 = time.perf_counter()
        plan = pt.smvm_prepare(a)
        t_prep = time.perf_counter() - t0
    v = torch.from_numpy(v_np).cuda()
    y = plan.apply(v)
    torch.cuda.synchronize()
    if plan.kind != "segtile":
        raise AssertionError(f"band: rung {plan.kind!r}, expected segtile")
    if cuda_csr.K1_LAUNCHES <= launches0:
        raise AssertionError("band: apply did not launch K1")
    s = sp.coo_matrix((vals.astype(np.float64), (rows, cols)),
                      shape=(n, n)).tocsr()
    ref = torch.from_numpy(s @ v_np.astype(np.float64)).cuda()
    bound = abs_bound(s, v_np)
    err = check_close("band vs scipy", y, ref, bound, torch.float32)
    st = plan.state[1]
    print(f"   band: n={n} nnz={s.nnz} rung={plan.kind} wsub={st.wsub} "
          f"fill={st.fill:.4f} n_tiles={st.n_tiles}; csr_from_coo "
          f"{t_csr:.2f} s, smvm_prepare {t_prep:.2f} s (host); "
          f"max|y-scipy| {err:.3e}", flush=True)
    _plan_memory("band", st)
    _stream_build_time("band", builds, t_prep)
    return dict(plan=plan, v=v, nnz=s.nnz, bound=bound)


@contextlib.contextmanager
def _timed_stream_builds():
    """Host seconds of each compact-stream build run inside the block,
    timed where the planners call ``_stream_from_slots`` (``cuda_csr`` and
    ``cuda_csr_block``), with the card synchronised on each side."""
    from sparse_tpu_torch.ops import cuda_csr, cuda_csr_block

    build = cuda_csr._stream_from_slots
    spent = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    mods = (cuda_csr, cuda_csr_block)
    for mod in mods:
        mod._stream_from_slots = timed
    try:
        yield spent
    finally:
        for mod in mods:
            mod._stream_from_slots = build


def _stream_build_time(cell, spent, t_prep):
    """Prints the stream builds' share of ``smvm_prepare``."""
    t = sum(spent)
    print(f"   {cell}: smvm_prepare ran {len(spent)} compact-stream build(s), "
          f"{t * 1e3:.1f} ms (host clock), {t / t_prep:.1%} of its "
          f"{t_prep:.2f} s", flush=True)


def _plan_memory(cell, plan):
    """What one segment-tile plan holds on the card: the slot tensors and
    the compact stream, in bytes."""
    slots = sum(t.numel() * t.element_size()
                for t in (plan.vals, plan.q, plan.seg_of, plan.rb))
    st = plan.stream
    stream = sum(t.numel() * t.element_size()
                 for t in (st.vals, st.cols, st.row_ptr, st.long_rows,
                           st.piece_ptr, st.piece_row))
    print(f"   {cell} plan on the card: slots {slots / 1e6:.1f} MB, compact "
          f"stream {stream / 1e6:.1f} MB ({st.nnz} entries, lane group "
          f"{st.group}, {st.n_long} long rows in {st.n_pieces} pieces)",
          flush=True)


def phase5_elasticity():
    """gen_fixtures.elasticity_fem(200k points, seed 7): ~400k rows with
    natural 2x2 blocks, f32 (benchmarks/suite.py:487): the blockseg rung."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from gen_fixtures import elasticity_fem

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_csr_block

    t0 = time.perf_counter()
    s = elasticity_fem(n_points=200_000, seed=7)
    t_gen = time.perf_counter() - t0
    s = s.astype(np.float32).astype(np.float64)  # the f32 matrix, exactly
    n = s.shape[0]
    c = s.tocoo()
    rng = np.random.default_rng(7)
    v_np = rng.standard_normal(n).astype(np.float32)
    t0 = time.perf_counter()
    a = pt.csr_from_coo(pt.coo_make(
        (n, n), torch.from_numpy(c.row.astype(np.int64)).cuda(),
        torch.from_numpy(c.col.astype(np.int64)).cuda(),
        torch.from_numpy(c.data.astype(np.float32)).cuda()))
    torch.cuda.synchronize()
    t_csr = time.perf_counter() - t0
    launches0 = cuda_csr_block.K2_LAUNCHES
    with _timed_stream_builds() as builds:
        t0 = time.perf_counter()
        plan = pt.smvm_prepare(a)
        t_prep = time.perf_counter() - t0
    v = torch.from_numpy(v_np).cuda()
    y = plan.apply(v)
    torch.cuda.synchronize()
    if plan.kind != "blockseg":
        raise AssertionError(f"elasticity: rung {plan.kind!r}, expected "
                             "blockseg")
    if cuda_csr_block.K2_LAUNCHES <= launches0:
        raise AssertionError("elasticity: apply did not launch K2")
    ref = torch.from_numpy(s @ v_np.astype(np.float64)).cuda()
    bound = abs_bound(s, v_np)
    err = check_close("elasticity vs scipy", y, ref, bound, torch.float32)
    st = plan.state[1]
    print(f"   elasticity: n={n} nnz={s.nnz} rung={plan.kind} "
          f"wsub={st.wsub} fill={st.fill:.4f} n_tiles={st.n_tiles} "
          f"(generated in {t_gen:.1f} s); csr_from_coo {t_csr:.2f} s, "
          f"smvm_prepare {t_prep:.2f} s (host); max|y-scipy| {err:.3e}",
          flush=True)
    _plan_memory("elasticity", st)
    _stream_build_time("elasticity", builds, t_prep)
    return dict(plan=plan, v=v, nnz=s.nnz)


def _time_in_turns(cell, kname, kernel, plain, apply, nnz, stream_bytes,
                   card):
    """Plain, kernel, kernel, plain (so each pair shows its own spread),
    then ``apply`` when given; returns the first kernel and first plain
    back-to-back times."""
    _, ms_p = _report(cell, "plain", plain, nnz, stream_bytes, card)
    _, ms_k = _report(cell, f"{kname} kernel", kernel, nnz, stream_bytes,
                      card)
    _report(cell, f"{kname} kernel", kernel, nnz, stream_bytes, card)
    _report(cell, "plain", plain, nnz, stream_bytes, card)
    if apply is not None:
        _report(cell, "apply", apply, nnz, stream_bytes, card)
    return ms_k, ms_p


def phase6_timing(card, band, ela, launches):
    """K1 and K2 against their plain versions at the main path's shapes
    (tolerance, bitwise repeat), the median times of the kernel through its
    entry point and of its plain version in turns, then of apply, and the
    host us a call of each kernel's entry; a profiler trace names the
    kernels of one apply.  K2 is timed on the plan's folded view (the
    blockseg apply's one launch, in the caller's numbering) and on the
    unfolded stream (the permuted operand), bitwise equal once gathered
    back; the elasticity apply must be that one K2 launch."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_csr, cuda_csr_block

    out = []
    # K1 on the band plan, through the plan route
    plan, v = band["plan"], band["v"]
    a, st = plan.state

    def k1():
        return pt.csr_smvm_segtile(a, v, st)

    def p1():
        return cuda_csr.segtile_stream_plain(st.stream, v)

    err1, _ = _twice_vs_plain("K1 vs plain (band)", k1, p1, band["bound"],
                              torch.float32)
    ms_k, ms_p = _time_in_turns("band", "K1", k1, p1, lambda: plan.apply(v),
                                band["nnz"], cuda_csr.segtile_stream_bytes(st),
                                card)
    host1 = _host_us(k1)
    print(f"   band K1 csr_smvm_segtile: {host1:.2f} host us a call "
          "(enqueue, 200 calls back to back)", flush=True)
    _apply_kernels("band apply", lambda: plan.apply(v))
    lib, libs = library_csr_ms("CSR @ v (band)", a, v, card)
    band["library_ms"] = (lib, libs)
    out.append(kernel_entry(
        "K1 segtile_csr", "sparse_tpu_torch/csrc/segtile_csr.cu",
        "sparse_tpu/ops/pallas_csr.py:492", launches["K1"], err1, ms_k, ms_p,
        csr_spmv_cost(a), lib, LIBRARY_CSR,
        bytes_per_stored_entry=st.stream.bytes_per_entry,
        library_ms_by_index=libs, host_us=host1))
    # K2 on the elasticity plan: its folded view, v as the caller holds it
    plan, v = ela["plan"], ela["v"]
    ab, st = plan.state
    vp = v.reshape(-1, 2)[plan.perm].reshape(-1)

    def k2():
        return cuda_csr_block.block_folded_apply(ab, v, st)

    def p2():
        return cuda_csr_block.block_stream_plain(st.folded, v)

    def k2_unfolded():
        return cuda_csr_block.bsr_smvm_segtile_block(ab, vp, st)

    # |A||v| in the caller's numbering
    bound = _block_bound(ab, vp.abs().double()).reshape(-1, 2)[
        plan.inv_perm].reshape(-1)
    err2, y2 = _twice_vs_plain("K2 vs plain (elasticity)", k2, p2, bound,
                               torch.float32)
    y_unf = k2_unfolded().reshape(-1, 2)[plan.inv_perm].reshape(-1)
    if not torch.equal(y2.view(torch.int32), y_unf.view(torch.int32)):
        raise AssertionError("elasticity: the folded K2 differs from the "
                             "unfolded K2 gathered back")
    ms_k, ms_p = _time_in_turns(
        "elasticity", "K2", k2, p2, lambda: plan.apply(v), ela["nnz"],
        cuda_csr_block.block_stream_bytes(st), card)
    _, ms_unf = _report("elasticity", "K2 unfolded", k2_unfolded, ela["nnz"],
                        cuda_csr_block.block_stream_bytes(st), card)
    _, ms_apply = _report("elasticity", "apply", lambda: plan.apply(v),
                          ela["nnz"], cuda_csr_block.block_stream_bytes(st),
                          card)
    host2 = _host_us(k2)
    host_apply = _host_us(lambda: plan.apply(v))
    print(f"   elasticity K2 block_folded_apply: {host2:.2f} host us a call, "
          f"plan.apply {host_apply:.2f} (enqueue, 200 calls back to back); "
          "folded K2 bitwise the unfolded K2 gathered back", flush=True)
    apply_kernels = _apply_kernels("elasticity apply", lambda: plan.apply(v),
                                   one=True)
    # the same kernel on the unfolded stream: its device time beside
    unfolded_kernels = _apply_kernels("elasticity K2 unfolded", k2_unfolded,
                                      one=True)
    lib2, libs2 = library_csr_ms("CSR @ v (elasticity)", pt.bsr_to_csr(ab),
                                 vp, card)
    # the 2x2 blocks once (values and block column), block row pointers,
    # the operand and the output
    from sparse_tpu_torch.utils.stats import blocked_bound_bytes

    nb = ab.nb
    nbz = int((ab.indices.long() < nb * nb).sum())
    cost2 = (blocked_bound_bytes(nbz, 2, ab.n, row_pointers=True),
             2 * 4 * nbz)
    out.append(kernel_entry(
        "K2 segtile_block", "sparse_tpu_torch/csrc/segtile_block.cu",
        "sparse_tpu/ops/pallas_csr_block.py:229", launches["K2"], err2, ms_k,
        ms_p, cost2, lib2, LIBRARY_CSR,
        bytes_per_stored_entry=st.stream.bytes_per_entry,
        library_ms_by_index=libs2, unfolded_ms=ms_unf, apply_ms=ms_apply,
        apply_kernels=apply_kernels, unfolded_kernels=unfolded_kernels,
        host_us=host2, apply_host_us=host_apply))
    return out


#: The library call every SpMV kernel is held against.
LIBRARY_CSR = ("torch.sparse_csr_tensor(...) @ v, the faster of int32 and "
               "int64 indices")


def _apply_kernels(label, fn, calls=5, forbid=("sort", "search"),
                   one=False):
    """The device kernels ``calls`` runs of ``fn`` launch, from a
    ``torch.profiler`` trace: name, launches per call and device us per
    call; returns {name: [launches a call, us a call]}.  A session in
    this process at times holds no device record at all, torch's own
    kernels included, so each ends with a kernel of torch's own
    (``torch.cuda._sleep``'s spin kernel): a session that sees
    it but none of ``fn``'s tells a kernel the trace misses from a session
    that came back empty; a session that sees none of ``fn``'s is said so
    and run again, up to three sessions.  Fails if a kernel named with a
    word of ``forbid`` runs (for a plan's apply: a sort or a search, since
    the plan holds the order), and with ``one`` unless the trace names
    exactly one kernel, launched once a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in (1, 2, 3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = kernels.get(e.name, (0, 0.0))
                kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
        marker = [k for k in kernels if "spin_kernel" in k]
        for k in marker:
            del kernels[k]
        if kernels:
            break
        print(f"   {label}: profiler session {session} of 3 saw no "
              f"kernel of the call, {'but' if marker else 'nor'} torch's "
              "marker kernel", flush=True)
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        print(f"   {label} kernel: {n / calls:g} launch(es) a call, "
              f"{us / calls:.1f} us a call: {name[:110]}", flush=True)
    bad = [k for k in kernels if any(w in k.lower() for w in forbid)]
    if bad:
        raise AssertionError(f"{label}: a sort or search runs per call: "
                             f"{bad}")
    if one and [n for n, _ in kernels.values()] != [calls]:
        raise AssertionError(f"{label}: {len(kernels)} kernels, expected "
                             f"one launched once a call: {sorted(kernels)}")
    return {k: [n / calls, us / calls] for k, (n, us) in kernels.items()}


def _block_bound(ab, vabs):
    """(|A||v|) per scalar row of a 2x2 BSR, on the card."""
    nb = ab.nb
    idx = ab.indices.long()
    r, c = idx // nb, idx % nb
    blk = ab.blocks.abs().double()  # (nbz, 2, 2)
    vb = vabs.reshape(nb, 2)[c]  # (nbz, 2)
    contrib = torch.einsum("bij,bj->bi", blk, vb)
    out = torch.zeros(nb, 2, dtype=torch.float64, device=vabs.device)
    out.index_add_(0, r, contrib)
    return out.reshape(-1)


# -- SpMM: the blocked-ELL kernels K3-K6 -------------------------------------


def _bell(cols, valid, bsz, dtype, seed):
    """BELL on the card from a host pattern; values N(0, 1) from ``seed``,
    zero in padding slots."""
    from sparse_tpu_torch.formats.bell import BELL

    rng = np.random.default_rng(seed)
    nb, Lb = cols.shape
    blocks = rng.standard_normal((nb, Lb, bsz, bsz)) * valid[:, :, None, None]
    return BELL(cols=torch.from_numpy(cols.astype(np.int32)).cuda(),
                blocks=torch.from_numpy(blocks).to(dtype).cuda(),
                n=nb * bsz, bsz=bsz)


def _band_pattern(nb, hb, empty=()):
    """Block band of half-width ``hb``: row r stores columns r-hb..r+hb
    clipped to [0, nb), in order, padded at the end (column 0)."""
    offs = np.arange(-hb, hb + 1)
    c = np.arange(nb)[:, None] + offs[None, :]
    ok = (c >= 0) & (c < nb)
    ok[list(empty)] = False
    order = np.argsort(~ok, axis=1, kind="stable")  # valid slots first
    cols = np.where(ok, c, 0)[np.arange(nb)[:, None], order]
    return cols, np.take_along_axis(ok, order, 1)


def _scattered_pattern(nb, lmax, rng):
    """Random block columns, 0..lmax per row (sorted, padded at the end)."""
    cols = np.zeros((nb, lmax), np.int64)
    valid = np.zeros((nb, lmax), bool)
    for r, n in enumerate(rng.integers(0, lmax + 1, nb)):
        cols[r, :n] = np.sort(rng.choice(nb, n, replace=False))
        valid[r, :n] = True
    return cols, valid


def _abs_bound(a, b, stream):
    """|A||B| in float64 on the card for A and B rounded to ``stream``."""
    from sparse_tpu_torch.formats.bell import BELL
    from sparse_tpu_torch.ops import cuda_bell as cb

    ab = BELL(cols=a.cols, blocks=a.blocks.to(stream).abs().double(),
              n=a.n, bsz=a.bsz)
    return cb.bell_spmm_fused_plain(ab, b.to(stream).abs().double())


def _twice_vs_plain(label, kernel, plain, bound, tol_dtype):
    """Kernel twice (bitwise equal), against the plain version within
    tol(dtype) * bound; returns (max |kernel - plain|, kernel result)."""
    y1 = kernel()
    torch.cuda.synchronize()
    y2 = kernel()
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        raise AssertionError(f"{label}: two runs differ bitwise")
    yp = plain()
    if y1.shape != yp.shape or not torch.isfinite(y1).all():
        raise AssertionError(f"{label}: shape {tuple(y1.shape)} vs plain "
                             f"{tuple(yp.shape)}, or non-finite values")
    return check_close(label, y1, yp, bound, tol_dtype), y1


def _with_values(a, values):
    """``a`` with other values: "band" keeps them, "zero" makes every block
    zero, "lone" leaves one stored element (1.5, in a stored slot of an
    interior row), "nan" puts a NaN into a stored block."""
    from sparse_tpu_torch.formats.bell import BELL

    if values == "band":
        return a
    blocks = a.blocks.clone()
    if values in ("zero", "lone"):
        blocks.zero_()
    if values == "lone":
        blocks[a.nb // 3, 1, a.bsz - 1, a.bsz // 2] = 1.5
    elif values == "nan":
        blocks[a.nb // 3, 1, 1, 0] = float("nan")
    return BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=a.bsz)


def _bits(y):
    return y.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[y.element_size()])


def _values_vs_plain(label, kernel, plain, bound, values,
                     tol_dtype=torch.float32):
    """``_twice_vs_plain`` for the special values of ``_with_values``: a NaN
    in A must give NaN exactly where the plain version has it (two runs
    equal bit for bit), a lone element exactly as many non-zeros as the
    plain version (one row of C or column of C^T), all-zero blocks exact
    zeros; returns the max |kernel - plain| elsewhere, within
    TOL[tol_dtype] (bf16 where both round a float32 sum to bf16)."""
    if values != "nan":
        err, y = _twice_vs_plain(label, kernel, plain, bound, tol_dtype)
        nz = int((plain() != 0).sum())
        if values in ("zero", "lone") and (
                int((y != 0).sum()) != nz or (nz > 0) != (values == "lone")):
            raise AssertionError(f"{label}: {int((y != 0).sum())} non-zeros,"
                                 f" the plain version {nz}")
        return err
    y1 = kernel()
    y2 = kernel()
    torch.cuda.synchronize()
    if not torch.equal(_bits(y1), _bits(y2)):
        raise AssertionError(f"{label}: two runs differ bitwise")
    yp = plain()
    nan = torch.isnan(yp)
    if not bool(nan.any()) or not torch.equal(torch.isnan(y1), nan):
        raise AssertionError(f"{label}: NaN pattern differs from the plain "
                             "version's")
    return check_close(label, y1.masked_fill(nan, 0), yp.masked_fill(nan, 0),
                       bound.masked_fill(torch.isnan(bound), 0), tol_dtype)


def check_counted(label, counted, model, useful):
    """A body's own count of the operations it issued, printed beside the
    useful flops and the host model; fails past 1.25x the useful flops
    (where there are any) or where the count is not the model's."""
    ratio = counted / useful if useful else float("nan")
    print(f"   {label}: {counted / 1e9:.6f} GFLOP issued (the kernel's "
          f"count) for {useful / 1e9:.6f} useful = {ratio:.4f}x; host model "
          f"{model / 1e9:.6f}", flush=True)
    if useful and counted > 1.25 * useful:
        raise AssertionError(f"{label}: issues {ratio:.3f}x the useful "
                             "flops, past 1.25x")
    if counted != model:
        raise AssertionError(f"{label}: the kernel counted {counted}, its "
                             f"host model {model}")
    return counted


def _hand_kit_t(a, valid, rt, max_window, stream):
    """A BandedKitT built by hand from K4's plan (any rt, unaligned
    starts); its chunk mask comes from ``__post_init__``."""
    from sparse_tpu_torch.ops import cuda_bell as cb

    plan = cb.build_banded_plan(a, row_tile=rt, max_window=max_window,
                                slot_valid=valid)
    tiles = cb._densify_band_tiles(a, plan, stream)
    return cb.BandedKitT(plan=plan,
                         tiles_t=tiles.transpose(1, 2).contiguous())


def _mask_bodies_vs_plain(rng):
    """K3's vote body (float32, bf16 and bf16x3 streams), K6's persistent
    body and K5's mask body (float32, bf16, bf16x3 and float64) against
    their plain versions at tests/test_torch_cuda.py's shapes, each with
    the body's own count of its work against the host model."""
    from sparse_tpu_torch.formats.bell import BELL
    from sparse_tpu_torch.ops import cuda_bell as cb

    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    # K3: (nb, bsz, hb, k, values); edge rows and an empty row hold
    # padding slots
    for nb, bsz, hb, k, values in (
            (37, 3, 2, 200, "band"), (40, 24, 2, 70, "band"),
            (30, 32, 2, 32, "band"), (29, 33, 1, 33, "band"),
            (12, 64, 1, 200, "band"), (50, 8, 3, 1, "band"),
            (30, 32, 2, 128, "zero"), (30, 32, 2, 128, "lone"),
            (30, 32, 2, 128, "nan")):
        cols, valid = _band_pattern(nb, hb, empty=(nb // 2,))
        a = _with_values(_bell(cols, valid, bsz, f32, seed=nb * k + bsz),
                         values)
        b = torch.from_numpy(rng.standard_normal((a.n, k))).float().cuda()
        for cd, prec in ((None, None), (bf16, None), (None, "bf16x3")):
            label = (f"K3 body nb={nb} bsz={bsz} k={k} {values} stream="
                     f"{str(cd or f32)[6:]} precision={prec}")
            kw = dict(compute_dtype=cd, precision=prec)
            err = _values_vs_plain(
                label, lambda: cb.bell_spmm_fused(a, b, **kw),
                lambda: cb.bell_spmm_fused_plain(a, b, **kw),
                _abs_bound(a, b, cd or f32), values)
            counted = cb.fused_issued_flops(a, b, **kw)
            model = cb.fused_issued_model(a, k, compute_dtype=cd or f32)
            if counted != model:
                raise AssertionError(f"{label}: counted {counted} operations"
                                     f", host model {model}")
            print(f"   {label}: max|kernel-plain| {err:.3e}; bitwise "
                  f"repeatable; issued {counted} = host model", flush=True)
        # K6's persistent body streams at the result dtype: float32, and
        # bf16 blocks with a bf16 operand
        for stream in (f32, bf16):
            a6 = _with_values(_bell(cols, valid, bsz, stream,
                                    seed=nb * k + bsz), values)
            b6 = b.to(stream)
            label = (f"K6 body nb={nb} bsz={bsz} k={k} {values} stream="
                     f"{str(stream)[6:]}")
            err = _values_vs_plain(
                label, lambda: cb.bell_spmm_block(a6, b6),
                lambda: cb.bell_spmm_block_plain(a6, b6),
                _abs_bound(a6, b6, stream), values, stream)
            counted = cb.block_issued_flops(a6, b6)
            model = cb.block_issued_model(a6, k)
            if counted != model:
                raise AssertionError(f"{label}: counted {counted} operations"
                                     f", host model {model}")
            print(f"   {label}: max|kernel-plain| {err:.3e}; bitwise "
                  f"repeatable; issued {counted} = host model", flush=True)
    # K5: (nb, bsz, k, values, hand-built kit's rt or None), each with an
    # unpadded and a padded operand
    for nb, bsz, k, values, hand_rt in (
            (45, 16, 7, "band", None), (100, 24, 70, "band", None),
            (250, 32, 32, "band", None), (70, 64, 200, "band", None),
            (1000, 3, 1, "band", 7), (130, 33, 33, "band", 2),
            (250, 32, 32, "zero", None), (250, 32, 32, "lone", None),
            (250, 32, 32, "nan", None)):
        cols, valid = _band_pattern(nb, 2)
        a32 = _with_values(_bell(cols, valid, bsz, f32, seed=nb + bsz * k),
                           values)
        b32 = torch.from_numpy(rng.standard_normal((a32.n, k))).float().cuda()
        # (stream, precision): float32, bf16, the bf16x3 split of a float32
        # kit, float64 (A and B in float64, C^T in float64)
        for stream, prec in ((f32, None), (bf16, None), (f32, "bf16x3"),
                             (f64, None)):
            a, b = a32, b32
            if stream == f64:
                a = BELL(cols=a32.cols, blocks=a32.blocks.double(), n=a32.n,
                         bsz=bsz)
                b = b32.double()
            if hand_rt:
                kit = _hand_kit_t(a, valid, hand_rt, 128, stream)
            else:
                kit = cb.bell_banded_prepare_t(a, max_window=128,
                                               compute_dtype=stream,
                                               slot_valid=valid)
            n_pad = kit.plan.offs.shape[0] * bsz
            bound = _abs_bound(a, b, stream).T
            for padded in (False, True):
                bt = b.T.contiguous()
                bnd = bound
                if padded:
                    bt = torch.cat([bt, bt.new_zeros(k, n_pad - a.n)], 1)
                    bnd = torch.cat([bound, bound.new_zeros(k, n_pad - a.n)],
                                    1)
                label = (f"K5 body nb={nb} bsz={bsz} k={k} {values} "
                         f"rt={kit.plan.rt} stream={str(stream)[6:]} "
                         f"precision={prec} operand "
                         f"{'padded' if padded else 'n'}")
                err = _values_vs_plain(
                    label, lambda: cb.bell_spmm_banded_t(a, bt, kit,
                                                         precision=prec),
                    lambda: cb.bell_spmm_banded_t_plain(a, bt, kit,
                                                        precision=prec),
                    bnd, values, f64 if stream == f64 else f32)
                counted = cb.banded_t_issued(a, bt, kit, precision=prec)
                model = cb.banded_t_issued_model(kit, k)
                if counted != model:
                    raise AssertionError(f"{label}: counted {counted} "
                                         f"(operations, tile bytes), host "
                                         f"model {model}")
                print(f"   {label}: max|kernel-plain| {err:.3e}; bitwise "
                      f"repeatable; issued, tile bytes {counted} = host "
                      "model", flush=True)


def _kit_vs_vote(label, a, b, kit, prec, bound, tol_dtype):
    """K4's kit route (``bell_spmm(plan=kit)``: the mask body, counted in
    ``K4_KIT_LAUNCHES``) twice against the plain version within
    TOL[tol_dtype] * ``bound``, bitwise equal to the vote body on the kit's
    tiles, its own count of issued work the vote body's model; returns the
    max |kernel - plain|."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bell as cb

    kw = dict(tiles=kit.tiles, compute_dtype=kit.tiles.dtype, precision=prec)
    before = (cb.K4_KIT_LAUNCHES, cb.K4_LAUNCHES)
    err, y = _twice_vs_plain(
        label, lambda: pt.bell_spmm(a, b, plan=kit, precision=prec),
        lambda: cb.bell_spmm_banded_plain(a, b, kit.plan, **kw), bound,
        tol_dtype)
    if (cb.K4_KIT_LAUNCHES, cb.K4_LAUNCHES) != (before[0] + 2, before[1]):
        raise AssertionError(f"{label}: not two launches of the mask body")
    if not torch.equal(_bits(y), _bits(cb.bell_spmm_banded(
            a, b, kit.plan, **kw))):
        raise AssertionError(f"{label}: differs from the vote body")
    counted = cb.banded_issued_flops(kit.tiles, kit.plan.start, b, a.bsz,
                                     precision=prec, mask=kit.chunk_nz)
    model = cb.banded_issued_model(kit.tiles, b.shape[1])
    if counted != model:
        raise AssertionError(f"{label}: counted {counted} operations, host "
                             f"model {model}")
    return err


def _kit_edges_vs_vote(rng):
    """K4's mask body on hand-built kits in float32, bf16 and float64: no
    marked chunk, one, all of them, and a window of 3 panels at bsz 24 and
    13 (K = 72 and 39, not multiples of 32; 16-byte and element copies),
    each bitwise the vote body with its count."""
    from sparse_tpu_torch.ops import cuda_bell as cb

    f32 = torch.float32
    for bsz, W, fill in ((32, None, "none"), (32, None, "one"),
                         (32, None, "all"), (24, 3, "band"),
                         (13, 3, "band")):
        nb = 12 if W is None else 30
        cols, valid = _band_pattern(nb, 1, (7,) if W else ())
        a = _bell(cols, valid, bsz, f32, seed=nb + bsz)
        plan = (cb.build_banded_plan(a, row_tile=2, slot_valid=valid)
                if W is None else _narrow_plan(a, valid, W))
        for stream in (f32, torch.bfloat16, torch.float64):
            tiles = cb._densify_band_tiles(a, plan, stream)
            if fill == "none":
                tiles.zero_()
            elif fill == "one":
                tiles.zero_()
                tiles[1, 37, 70] = 1.5
            elif fill == "all":
                tiles.normal_()
            kit = cb.BandedKit(plan=plan, tiles=tiles)
            k = 40
            b = torch.from_numpy(rng.standard_normal((a.n, k))).to(f32).cuda()
            bound = (_abs_bound(a, b, stream) if fill == "band" else
                     cb.bell_spmm_banded_plain(a, b.abs(), plan,
                                               tiles=tiles.abs(),
                                               compute_dtype=stream))
            label = (f"K4 kit bsz={bsz} W={plan.W} K={tiles.shape[2]} "
                     f"{fill} stream={str(stream)[6:]}")
            err = _kit_vs_vote(label, a, b, kit, None, bound,
                               torch.float64 if stream == torch.float64
                               else f32)
            print(f"   {label}: {int(kit.chunk_nz.sum())} of "
                  f"{kit.chunk_nz.numel()} chunks marked; max|kernel-plain| "
                  f"{err:.3e}; bitwise the vote body's", flush=True)


def _narrow_plan(a, valid, W):
    """A one-row-tile banded plan whose window is ``W`` panels, so the
    tiles' K = W*bsz need not be a multiple of 32 (the planner rounds W to
    128 lanes): each row's first stored column, its window start clamped
    into [0, nb - W]."""
    from sparse_tpu_torch.ops import cuda_bell as cb

    cols = a.cols.cpu().numpy().astype(np.int64)
    first = np.where(valid.any(1), cols[:, 0], 0)
    start = np.minimum(first, a.nb - W)

    def i32(x):
        return torch.from_numpy(np.asarray(x, np.int32)).cuda()

    return cb.BandedPlan(offs=i32(first - start), start=i32(start),
                         rel=i32(np.zeros(a.nb)), sup=i32(start), W=W,
                         rt=1, S=1, SW=W)


def phase7_bell_kernels_vs_plain():
    """K3-K6 against their plain versions on the card: bsz 4/8/24/32, k
    1/8/32/33/100/128/200, float32, float64, a bf16 stream and bf16x3,
    padding slots and empty rows, nb not divisible by rt, plans with S > 1
    and S = 1, K5 with an unpadded and a padded operand; each case twice
    for bitwise repeatability, K4's vote body with its issued-work count,
    and K4's kit route (``bell_spmm(plan=kit)``, the mask body) at the same
    shapes and on hand-built kits (no, one, every chunk marked; K not a
    multiple of 32), bitwise the vote body's, with its count.
    Then K3's float32 / bf16 / bf16x3, K5's float32 / bf16 / bf16x3 /
    float64 and K6's float32 / bf16 bodies at the card tests' shapes (bsz
    3/8/16/24/32/33/64, k 1/7/32/33/70/128/200, all-zero blocks, a lone
    element, a NaN in A, hand-built K5 kits) with their issued-work
    counters.  Then K3 in every kind on more tiles than resident blocks
    (``_k3_walk_vs_plain``) and the band body's float64 kind on
    m16n8k8 at ragged shapes (``_band_f64_vs_plain``)."""
    from sparse_tpu_torch.ops import cuda_bell as cb

    rng = np.random.default_rng(7)
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    # rowwise kernels: (bsz, nb, lmax, k, dtype, compute_dtype, precision)
    for bsz, nb, lmax, k, dt, cd, prec in (
            (4, 500, 6, 1, f32, None, None),
            (8, 300, 5, 8, f64, None, None),
            (32, 200, 5, 128, f32, None, None),
            (32, 200, 5, 100, f32, bf16, None),
            (8, 300, 5, 128, f32, None, "bf16x3")):
        cols, valid = _scattered_pattern(nb, lmax, rng)
        a = _bell(cols, valid, bsz, dt, seed=nb + k)
        b = torch.from_numpy(rng.standard_normal((a.n, k))).to(dt).cuda()
        stream = cd or dt
        bound = _abs_bound(a, b, stream)
        tol = f64 if dt == f64 else f32
        names = [("K3", cb.bell_spmm_fused, cb.bell_spmm_fused_plain,
                  dict(compute_dtype=cd, precision=prec))]
        if cd is None:  # K6 streams at the result dtype
            names.append(("K6", cb.bell_spmm_block, cb.bell_spmm_block_plain,
                          dict(precision=prec)))
        for kname, fk, fp, kw in names:
            label = (f"{kname} bsz={bsz} k={k} {str(dt)[6:]} stream="
                     f"{str(stream)[6:]} precision={prec}")
            err, _ = _twice_vs_plain(label, lambda: fk(a, b, **kw),
                                     lambda: fp(a, b, **kw), bound, tol)
            print(f"   {label}: max|kernel-plain| {err:.3e}; bitwise "
                  "repeatable", flush=True)
    # K4: (nb, bsz, hb, rt, k, dtype, compute_dtype, precision, empty rows)
    s_seen = set()
    for nb, bsz, hb, rt, k, dt, cd, prec, empty in (
            (301, 8, 2, 4, 128, f32, None, None, (150,)),
            (240, 32, 2, 5, 32, f64, None, None, ()),
            (49, 4, 1, 7, 1, f32, None, None, (3,)),
            (240, 32, 2, 5, 128, f32, bf16, None, ()),
            (240, 32, 2, 5, 8, f32, None, "bf16x3", ()),
            # the vote body's ragged edges: bsz 24 divides no 32-row block
            # (rt*bsz = 72), k 200 ends in a part column block, k 33 takes
            # element copies; bf16x3 runs the same body
            (40, 24, 2, 3, 200, f32, None, None, (2,)),
            (130, 24, 1, 7, 33, f32, bf16, None, (5,)),
            (40, 24, 2, 3, 200, f32, None, "bf16x3", (2,)),
            (130, 24, 1, 7, 33, f32, None, "bf16x3", (5,))):
        cols, valid = _band_pattern(nb, hb, empty)
        a = _bell(cols, valid, bsz, dt, seed=nb * k)
        b = torch.from_numpy(rng.standard_normal((a.n, k))).to(dt).cuda()
        kit = cb.bell_banded_prepare(a, row_tile=rt, compute_dtype=cd,
                                     slot_valid=valid)
        plan = kit.plan
        s_seen.add(plan.S > 1)
        stream = kit.tiles.dtype
        bound = _abs_bound(a, b, stream)
        kw = dict(tiles=kit.tiles, compute_dtype=stream, precision=prec)
        label = (f"K4 nb={nb} bsz={bsz} rt={rt} W={plan.W} S={plan.S} k={k} "
                 f"{str(dt)[6:]} stream={str(stream)[6:]} precision={prec}")
        err, _ = _twice_vs_plain(
            label, lambda: cb.bell_spmm_banded(a, b, plan, **kw),
            lambda: cb.bell_spmm_banded_plain(a, b, plan, **kw), bound,
            f64 if dt == f64 else f32)
        issued = ""
        if dt == f32:  # the vote body's own count (bf16x3: float32's)
            counted = cb.banded_issued_flops(kit.tiles, plan.start, b, bsz,
                                             precision=prec)
            model = cb.banded_issued_model(kit.tiles, k)
            if counted != model:
                raise AssertionError(f"{label}: counted {counted} "
                                     f"operations, host model {model}")
            issued = f"; issued {counted} = host model"
        print(f"   {label}: max|kernel-plain| {err:.3e}; bitwise "
              f"repeatable{issued}", flush=True)
        err = _kit_vs_vote(f"{label} kit route", a, b, kit, prec, bound,
                           f64 if dt == f64 else f32)
        print(f"   {label} kit route (mask body): max|kernel-plain| "
              f"{err:.3e}; bitwise the vote body's; issued = host model",
              flush=True)
    if s_seen != {True, False}:
        raise AssertionError("K4 cases must cover plans with S > 1 and S = 1")
    _kit_edges_vs_vote(rng)
    # K5: (nb, bsz, k, dtype, compute_dtype, precision, padded operand)
    for nb, bsz, k, dt, cd, prec, padded in (
            (250, 32, 32, f32, None, None, False),
            (250, 32, 32, f32, None, None, True),
            (301, 8, 8, f64, None, None, False),
            (250, 32, 1, f32, None, "bf16x3", True),
            (250, 32, 32, f32, bf16, None, False)):
        cols, valid = _band_pattern(nb, 2)
        a = _bell(cols, valid, bsz, dt, seed=nb + bsz + k)
        b = torch.from_numpy(rng.standard_normal((a.n, k))).to(dt).cuda()
        kit = cb.bell_banded_prepare_t(a, compute_dtype=cd, slot_valid=valid)
        n_pad = kit.plan.offs.shape[0] * bsz
        bt = b.T.contiguous()
        if padded:
            bt = torch.cat([bt, bt.new_zeros(k, n_pad - a.n)], 1)
        stream = kit.tiles_t.dtype
        bound = _abs_bound(a, b, stream).T
        if padded:
            bound = torch.cat([bound, bound.new_zeros(k, n_pad - a.n)], 1)
        label = (f"K5 nb={nb} bsz={bsz} rt={kit.plan.rt} S={kit.plan.S} "
                 f"k={k} {str(dt)[6:]} stream={str(stream)[6:]} "
                 f"precision={prec} operand {'padded' if padded else 'n'}")
        err, y = _twice_vs_plain(
            label, lambda: cb.bell_spmm_banded_t(a, bt, kit, precision=prec),
            lambda: cb.bell_spmm_banded_t_plain(a, bt, kit, precision=prec),
            bound, f64 if dt == f64 else f32)
        if y.shape != (k, n_pad if padded else a.n):
            raise AssertionError(f"{label}: output {tuple(y.shape)}")
        print(f"   {label}: max|kernel-plain| {err:.3e}; bitwise "
              "repeatable", flush=True)
    _mask_bodies_vs_plain(rng)
    _k3_walk_vs_plain(rng)
    _band_f64_vs_plain(rng)


def _k3_walk_vs_plain(rng):
    """K3 on its grid in every kind (bf16, bf16x3 and float64 walk their
    tiles on at most the thread blocks resident at once, one ring each,
    ``band::run_tiles``; float32 and int32 take a thread block a tile), on
    bands of five slots a block row holding more than twice as many tiles
    as resident blocks (``cuda_bell.fused_geometry``): bsz 32 / k 128 (the
    bench band's tile), 20 / 129 and 100 / 31 (ragged row and column
    blocks; element copies), two block rows of zero blocks only and, in
    the float kinds, a NaN in A.  Twice, bitwise equal and launched each
    time, against the plain version (int32: equal), the zero rows exact
    zeros, the issued count its host model, the geometry printed."""
    from sparse_tpu_torch.formats.bell import BELL
    from sparse_tpu_torch.ops import cuda_bell as cb

    f32, f64, bf16, i32 = (torch.float32, torch.float64, torch.bfloat16,
                           torch.int32)
    # kind: (blocks' dtype, compute dtype, precision, tolerance dtype)
    kinds = {"float32": (f32, None, None, f32),
             "float64": (f64, None, None, f64),
             "bf16": (f32, bf16, None, f32),
             "bf16x3": (f32, None, "bf16x3", f32),
             "int32": (i32, None, None, None)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bsz, k in ((32, 128), (20, 129), (100, 31)):
        per_row = -(-bsz // 32) * -(-k // 128)
        for kind, (dt, cd, prec, tol) in kinds.items():
            stream = cd or dt
            walks = kind in ("float64", "bf16", "bf16x3")
            geo = cb.fused_geometry(1, 5, bsz, k, stream, prec)
            if geo["walks"] != walks:
                raise AssertionError(f"K3 {kind}: walks {geo['walks']}")
            resident = geo["blocks_per_sm"] * sms
            nb = (2 * resident + 3) // per_row + 1
            empty = (nb // 4, 3 * nb // 4)
            cols, valid = _band_pattern(nb, 2, empty)
            a = _bell(cols, valid, bsz, f64, seed=nb + bsz + k)
            if kind == "int32":
                blocks = (a.blocks * 2 ** 20).round().to(i32)
                b = torch.from_numpy(rng.integers(
                    -2 ** 20, 2 ** 20, (a.n, k)).astype(np.int32)).cuda()
            else:
                blocks = a.blocks.to(dt)
                blocks[nb // 2, 1, 1, 0] = float("nan")
                b = torch.from_numpy(rng.standard_normal((a.n, k))).to(
                    dt).cuda()
            a = BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=bsz)
            geo = cb.fused_geometry(nb, a.Lb, bsz, k, stream, prec)
            if geo["grid"] != (resident if walks else geo["tiles"]) or \
                    geo["tiles"] <= 2 * resident:
                raise AssertionError(f"K3 {kind}: {geo} against {resident} "
                                     "resident blocks")
            label = (f"K3 {kind} bsz={bsz} k={k} nb={nb} "
                     f"({'walk' if walks else 'a thread block a tile'})")
            kw = dict(compute_dtype=cd, precision=prec)

            def kern():
                return cb.bell_spmm_fused(a, b, **kw)

            def plain():
                return cb.bell_spmm_fused_plain(a, b, **kw)

            before = cb.K3_LAUNCHES
            if kind == "int32":
                y1, y2 = kern(), kern()
                err = 0.0
                if not (torch.equal(y1, y2) and torch.equal(y1, plain())):
                    raise AssertionError(f"{label}: differs from its plain "
                                         "version, or between two runs")
            else:
                err = _values_vs_plain(label, kern, plain,
                                       _abs_bound(a, b, stream), "nan", tol)
            if cb.K3_LAUNCHES != before + 2:
                raise AssertionError(f"{label}: not two launches")
            y = kern()
            for r in empty:
                if bool(y[r * bsz:(r + 1) * bsz].any()):
                    raise AssertionError(f"{label}: block row {r} of zero "
                                         "blocks is not zero")
            counted = cb.fused_issued_flops(a, b, **kw)
            if counted != cb.fused_issued_model(a, k, compute_dtype=stream):
                raise AssertionError(f"{label}: counted {counted}, not the "
                                     "host model")
            print(f"   {label}: {geo['tiles']} tiles on {geo['grid']} "
                  f"thread blocks ({geo['blocks_per_sm']} an SM, "
                  f"{geo['registers']} registers, {geo['local_bytes']} local "
                  f"bytes a thread); max|kernel-plain| {err:.3e}; bitwise "
                  "repeatable; zero rows zero; issued = host model",
                  flush=True)
            del a, b, y


def _band_f64_vs_plain(rng):
    """The band body's float64 kind (m16n8k8) at ragged shapes: K4's vote
    route against its plain version within 1e-12 |A||B|, its kit route
    bitwise the vote's with the vote's count (``_kit_vs_vote``), and K8 on
    the same plan and tiles bitwise the vote's."""
    from sparse_tpu_torch.ops import cuda_bell as cb
    from sparse_tpu_torch.ops import cuda_dband

    f64 = torch.float64
    for nb, bsz, hb, rt, mw, k in ((130, 13, 1, 3, 128, 129),
                                   (40, 24, 2, 3, 64, 31),
                                   (130, 33, 1, 2, 128, 200),
                                   (130, 3, 2, 7, 128, 1)):
        cols, valid = _band_pattern(nb, hb, (nb // 2,))
        a = _bell(cols, valid, bsz, f64, seed=nb * k + bsz)
        b = torch.from_numpy(rng.standard_normal((a.n, k))).cuda()
        kit = cb.bell_banded_prepare(a, row_tile=rt, max_window=mw,
                                     slot_valid=valid)
        plan, bound = kit.plan, _abs_bound(a, b, f64)
        kw = dict(tiles=kit.tiles, compute_dtype=f64)
        label = (f"K4 / K8 float64 nb={nb} bsz={bsz} rt={plan.rt} "
                 f"W={plan.W} k={k}")
        err, vote = _twice_vs_plain(
            label, lambda: cb.bell_spmm_banded(a, b, plan, **kw),
            lambda: cb.bell_spmm_banded_plain(a, b, plan, **kw), bound, f64)
        _kit_vs_vote(f"{label} kit route", a, b, kit, None, bound, f64)
        b3 = torch.cat([b.reshape(nb, bsz, k), b.new_zeros(plan.W, bsz, k)])
        y = cuda_dband.dband_spmm(kit.tiles, plan.start, b3, nb, bsz, k,
                                  plan.W, plan.rt, f64)
        if not torch.equal(_bits(y), _bits(vote)):
            raise AssertionError(f"{label}: K8 differs from K4's vote route")
        print(f"   {label}: max|kernel-plain| {err:.3e}; kit route and K8 "
              "bitwise the vote route's", flush=True)


def _bench_bell(nb=None, bsz=None):
    """``bench.py``'s block band (``build_block_band(nb, bsz)``, its NB
    and BSZ unless given) as a BELL on the card, built as its ``tpu_time``
    does: the pattern and ``slot_valid`` on the host, the values from a
    seeded pool of N(0, 0.01^2) blocks on the device."""
    sys.path.insert(0, str(ROOT))
    from bench import BSZ, NB, build_block_band

    from sparse_tpu_torch.formats.bell import BELL

    nb, bsz = nb or NB, bsz or BSZ
    rows, cols, _, _ = build_block_band(nb=nb, bsz=bsz)
    lens = np.bincount(rows, minlength=nb)
    Lb = int(lens.max())
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    slot = np.arange(rows.size) - starts[rows]
    cols_np = np.zeros((nb, Lb), np.int32)
    cols_np[rows, slot] = cols
    slot_valid = np.arange(Lb)[None, :] < lens[:, None]
    gen = torch.Generator(device="cuda").manual_seed(0)
    pool = torch.randn(1021, bsz, bsz, device="cuda", generator=gen) * 0.01
    idx = torch.arange(nb * Lb, device="cuda") % 1021
    blocks = pool[idx].reshape(nb, Lb, bsz, bsz) * torch.from_numpy(
        slot_valid).cuda()[:, :, None, None]
    a = BELL(cols=torch.from_numpy(cols_np).cuda(), blocks=blocks,
             n=nb * bsz, bsz=bsz)
    return a, cols_np, slot_valid, gen


class _ScipyRows:
    """SciPy BSR in float64 of a fixed subset of the BELL's block rows
    (every ``step``-th and the last), the oracle of phase 8."""

    def __init__(self, a, cols_np, slot_valid, step=8):
        import scipy.sparse as sp

        nb, bsz = a.nb, a.bsz
        self.sub = np.unique(np.r_[np.arange(0, nb, step), nb - 1])
        v = slot_valid[self.sub]
        blk = a.blocks[torch.from_numpy(self.sub).cuda()].double().cpu() \
            .numpy()[v]
        indptr = np.r_[0, np.cumsum(v.sum(1))]
        shape = (self.sub.size * bsz, a.n)
        self.s = sp.bsr_matrix((blk, cols_np[self.sub][v], indptr),
                               shape=shape)
        self.abs = sp.bsr_matrix((np.abs(blk), cols_np[self.sub][v], indptr),
                                 shape=shape)
        rows = (self.sub[:, None] * bsz + np.arange(bsz)).reshape(-1)
        self.rows = torch.from_numpy(rows).cuda()

    def check(self, label, c, b, tol_dtype=torch.float32):
        """C's rows of the subset against SciPy's A @ B, B = ``b`` (n, k),
        within TOL[tol_dtype] * |A||B|; returns the max abs error."""
        bh = b.double().cpu().numpy()
        ref = torch.from_numpy(self.s @ bh).cuda()
        bound = torch.from_numpy(self.abs @ np.abs(bh)).cuda()
        if c.shape != b.shape or not torch.isfinite(c).all():
            raise AssertionError(f"{label}: shape {tuple(c.shape)} or "
                                 "non-finite values")
        return check_close(label, c[self.rows], ref, bound, tol_dtype)


def phase8_spmm_main_path():
    """The SpMM main path at full size through the public entry points; the
    kernels' launch counts are read by the caller around this phase."""
    import scipy.sparse as sp

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bell as cb

    t0 = time.perf_counter()
    a, cols_np, slot_valid, gen = _bench_bell()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    oracle = _ScipyRows(a, cols_np, slot_valid)
    sys.path.insert(0, str(ROOT))
    from bench import K, K_CHAIN

    b = torch.randn(a.n, K, device="cuda", generator=gen) * 0.01
    t0 = time.perf_counter()
    kit = pt.bell_banded_prepare(a, row_tile=5, slot_valid=slot_valid)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    plan = kit.plan
    counts = {}
    out = {}
    for label, fn, kname in (
            ("bell_spmm(plan=kit) [K4-kit, the mask body]",
             lambda: pt.bell_spmm(a, b, plan=kit), "K4-kit"),
            ("bell_spmm(plan=kit.plan) [K4, the vote body]",
             lambda: pt.bell_spmm(a, b, plan=kit.plan), "K4"),
            ("bell_spmm(a, b) [K3]", lambda: pt.bell_spmm(a, b), "K3"),
            ("bell_spmm_block [K6]", lambda: cb.bell_spmm_block(a, b), "K6")):
        attr = kname.replace("-", "_").upper() + "_LAUNCHES"
        before = getattr(cb, attr)
        c = fn()
        torch.cuda.synchronize()
        counts[kname] = getattr(cb, attr) - before
        err = oracle.check(label, c, b)
        out[kname] = c
        print(f"   {label}: {tuple(c.shape)} max|C-scipy| {err:.3e} on "
              f"{oracle.rows.numel()} rows", flush=True)
    t0 = time.perf_counter()
    kit_t = pt.bell_banded_prepare_t(a, slot_valid=slot_valid)
    torch.cuda.synchronize()
    t_prep_t = time.perf_counter() - t0
    b32 = b[:, :32].contiguous()
    before = cb.K5_LAUNCHES
    c = pt.bell_spmm(a, b32, plan=kit_t)
    torch.cuda.synchronize()
    counts["K5"] = cb.K5_LAUNCHES - before
    err = oracle.check("bell_spmm(plan=kit_t) k=32 [K5]", c, b32)
    print(f"   bell_spmm(plan=kit_t) k=32 [K5]: rt={kit_t.plan.rt} "
          f"W={kit_t.plan.W} S={kit_t.plan.S} {tuple(c.shape)} "
          f"max|C-scipy| {err:.3e}", flush=True)
    for kname, n in counts.items():
        if n < 1:
            raise AssertionError(f"{kname} was not launched by its call")
    # the bench's chain b <- A b, each step against SciPy on the previous b
    x = b
    for step in range(K_CHAIN):
        y = pt.bell_spmm(a, x, plan=kit)
        torch.cuda.synchronize()
        err = oracle.check(f"chain step {step + 1}", y, x)
        x = y
    print(f"   chain b <- A b x{K_CHAIN} [K4-kit]: every step within "
          f"1e-5|A||b| of scipy (last max err {err:.3e}); |b_5| / |b| = "
          f"{float(x.norm() / b.norm()):.3e}", flush=True)
    # spmm at __graft_entry__.entry()'s shape: 512 x 512 at 5 %, k = 64
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((512, 512)).astype(np.float32) * (
        rng.random((512, 512)) < 0.05)
    bb = rng.standard_normal((512, 64)).astype(np.float32)
    ca = pt.csr_from_dense(torch.from_numpy(dense).cuda())
    cc = pt.spmm(ca, torch.from_numpy(bb).cuda())
    s = sp.csr_matrix(dense.astype(np.float64))
    err = check_close("spmm entry shape", cc,
                      torch.from_numpy(s @ bb.astype(np.float64)).cuda(),
                      torch.from_numpy(abs(s) @ np.abs(bb).astype(
                          np.float64)).cuda(), torch.float32)
    print(f"   spmm at entry()'s shape 512x512 k=64: max|C-scipy| "
          f"{err:.3e}", flush=True)
    print(f"   bench BELL nb={a.nb} bsz={a.bsz} Lb={a.Lb} built on the card "
          f"in {t_build:.2f} s; bell_banded_prepare {t_prep:.2f} s (W="
          f"{plan.W} rt={plan.rt} S={plan.S} SW={plan.SW}, tiles "
          f"{tuple(kit.tiles.shape)}), prepare_t {t_prep_t:.2f} s",
          flush=True)
    return dict(a=a, b=b, b32=b32, kit=kit, kit_t=kit_t,
                nnz=int(slot_valid.sum()) * a.bsz * a.bsz, k=K,
                chain=K_CHAIN, counts=counts, oracle=oracle,
                cols_np=cols_np, slot_valid=slot_valid)


def torch_bsr(m, dtype=torch.float32):
    """The bench BELL's stored blocks in ``dtype`` as a
    ``torch.sparse_bsr_tensor`` (for the library yardstick)."""
    a, valid = m["a"], m["slot_valid"]
    crow = np.zeros(a.nb + 1, np.int64)
    np.cumsum(valid.sum(1), out=crow[1:])
    keep = torch.from_numpy(valid).cuda()
    return torch.sparse_bsr_tensor(
        torch.from_numpy(crow).cuda(),
        torch.from_numpy(m["cols_np"][valid].astype(np.int64)).cuda(),
        a.blocks[keep].to(dtype).contiguous(), size=(a.n, a.n))


def library_spmm(m, b, card, label):
    """``A @ B`` by torch's BSR product on the bench band in ``b``'s dtype,
    or, where torch refuses BSR on the card, by its CSR product; returns
    (ms, the call).  Timed once per width and dtype of ``b``: a later
    request (another kernel's record, another phase) reuses that reading,
    so every record of one width and dtype compares against the same one
    (at k 32 the call's back-to-back windows spread by up to 1.8x from one
    reading to the next, PERF.md section 6)."""
    key = ("library", b.shape[1], b.dtype)
    if key in m:
        ms, call = m[key]
        print(f"   library {label}: the reading of k {b.shape[1]} "
              f"{str(b.dtype)[6:]} taken earlier in this run, "
              f"{'refused' if ms is None else f'{ms:.4f} ms'}", flush=True)
        return ms, call
    m[key] = _library_spmm(m, b, card, label)
    return m[key]


def _library_spmm(m, b, card, label):
    bsr = m.get(("bsr", b.dtype))
    if bsr is None:
        bsr = m[("bsr", b.dtype)] = torch_bsr(m, b.dtype)
    st = torch.cuda.memory_stats()
    print(f"   allocator before BSR @ B ({label}): "
          f"{st['allocated_bytes.all.current'] / 1e9:.2f} GB allocated, "
          f"{st['reserved_bytes.all.current'] / 1e9:.2f} GB reserved, "
          f"{st.get('num_alloc_retries')} retries, "
          f"{st.get('num_device_alloc')} device allocations so far",
          flush=True)
    ms = library_ms(f"BSR @ B ({label})", lambda: bsr @ b, card)
    if ms is not None:
        return ms, "torch.sparse_bsr_tensor(...) @ B"
    csr = m.get(("csr", b.dtype))
    if csr is None:
        csr = m[("csr", b.dtype)] = bsr.to_sparse_csr()
    ms = library_ms(f"CSR @ B ({label})", lambda: csr @ b, card)
    return ms, "torch.sparse_csr_tensor(...) @ B (BSR refused on the card)"


def check_issued(label, tiles, start, b, bsz, useful, precision=None,
                 mask=None):
    """The work the vote body of K4 / K8 (with ``mask``, a kit's chunk
    mask: K4's mask body, the kit route) issues on ``tiles`` against the
    operand ``b`` (rows, k), read from the kernel's own counter (one launch
    of ``banded_issued_flops``) beside the dense tile product's, checked as
    ``check_counted`` does against the host model (the non-zero chunks;
    bf16x3 keeps the float32 stream's; the mask body the vote's)."""
    from sparse_tpu_torch.ops import cuda_bell as cb

    k = b.shape[1]
    dense = 2 * tiles.shape[0] * tiles.shape[1] * tiles.shape[2] * k
    print(f"   {label}: the dense tile product is {dense / 1e9:.3f} GFLOP",
          flush=True)
    return check_counted(
        label, cb.banded_issued_flops(tiles, start, b, bsz,
                                      precision=precision, mask=mask),
        cb.banded_issued_model(tiles, k), useful)


def kit_beside(label, rec, card, **others):
    """A record ``rec`` of K4's kit route (or of K8) with the back-to-back
    times of the calls ``others`` (name -> fn: the vote route on the kit's
    tiles, the kit route, K8 on the same band) taken right after it, under
    ``beside_ms``; printed with their ratios to ``rec``'s time."""
    beside = {name: pipelined_ms(fn, warmup=2)[0]
              for name, fn in others.items()}
    rec["beside_ms"] = beside
    print(f"   {label}: {rec['ms']:.4f} ms; beside it "
          + "; ".join(f"{name} {ms:.4f} ms ({ms / rec['ms']:.2f}x)"
                      for name, ms in beside.items()) + f" [{card}]",
          flush=True)
    return rec


#: the sha256 of each float32 K4 / K8 result the phases digest, by label:
#: every phase that digests a label on the same inputs must find the same
#: bits (phases 9, 15, 21 and 22)
F32_DIGESTS: dict[str, str] = {}


def f32_digest(label, fn, card):
    """``fn``'s (K4's kit or vote route, or K8, in float32 at the bench
    shape) back-to-back time and the sha256 of its C, which must equal the
    first digest taken under ``label`` in this run; returns both."""
    import hashlib

    ms, fastest = pipelined_ms(fn, warmup=1)
    y = fn()
    torch.cuda.synchronize()
    sha = hashlib.sha256(y.contiguous().cpu().view(torch.uint8).numpy()
                         .tobytes()).hexdigest()
    del y
    first = F32_DIGESTS.setdefault(label, sha)
    if sha != first:
        raise AssertionError(f"{label}: C's sha256 {sha[:16]} is not the "
                             f"first phase's {first[:16]}")
    print(f"   {label}: {ms:.4f} ms back to back (fastest {fastest:.4f}); "
          f"sha256 {sha[:16]}, the same in every phase [{card}]",
          flush=True)
    return dict(ms=ms, fastest_ms=fastest, sha256=sha)


def band_geometry_line(label, tiles, k, card, masked=False):
    """Print and return the geometry K4's vote body (``masked``: its mask
    body, the kit route) or K8 launches on ``tiles`` (., M, K) at width
    ``k`` in the tiles' dtype (``cuda_bell.banded_geometry``)."""
    from sparse_tpu_torch.ops import cuda_bell as cb

    _, M, K = tiles.shape
    geo = cb.banded_geometry(M, K, k, tiles.dtype, masked=masked)
    print(f"   {label} geometry on ({M}, {K}) tiles, k {k}: "
          f"{geo['rows_per_block']} output rows a thread block, "
          f"{geo['registers']} registers and {geo['local_bytes']} local "
          f"bytes a thread, {geo['shared_bytes']} shared bytes and "
          f"{geo['blocks_per_sm']} blocks of 128 threads an SM [{card}]",
          flush=True)
    return geo


def check_k5_counts(label, a, bt, kit, useful, precision=None):
    """K5's own counts on ``kit`` against ``bt`` (any kind; bf16x3 with
    ``precision``): the operations, checked as ``check_counted`` does, and
    the tile bytes it copied, which must equal the host model and are
    printed beside the kit's bytes; returns the record's keys."""
    from sparse_tpu_torch.ops import cuda_bell as cb

    ops, nbytes = cb.banded_t_issued(a, bt, kit, precision=precision)
    model_ops, model_bytes = cb.banded_t_issued_model(kit, bt.shape[0])
    if nbytes != model_bytes:
        raise AssertionError(f"{label}: copied {nbytes} tile bytes, host "
                             f"model {model_bytes}")
    kit_bytes = kit.tiles_t.numel() * kit.tiles_t.element_size()
    print(f"   {label}: read {nbytes / 1e6:.1f} MB of tile chunks (the "
          f"kernel's count) of the kit's {kit_bytes / 1e6:.1f} MB "
          f"({nbytes / kit_bytes:.1%}); chunk mask "
          f"{int(kit.chunk_nz.sum())} of {kit.chunk_nz.numel()} chunks",
          flush=True)
    return {"issued_gflop": check_counted(label, ops, model_ops, useful) / 1e9,
            "tile_mb_read": nbytes / 1e6, "tile_mb_kit": kit_bytes / 1e6}


def _report_spmm(label, fn, flops, nbytes, card):
    """Median alone and back-to-back times of ``fn`` with GB/s by the bytes
    model and useful GFLOP/s; returns (alone, back to back) ms."""
    ms = median_ms(fn)
    ms_b2b, fastest = pipelined_ms(fn)
    print(f"   {label:24s}: {ms:.4f} ms alone (median of {N_TIMED}), "
          f"{ms_b2b:.4f} ms back to back (median window; fastest "
          f"{fastest:.4f}); {nbytes / ms / 1e6:.1f} / "
          f"{nbytes / ms_b2b / 1e6:.1f} GB/s; {flops / ms / 1e6:.1f} / "
          f"{flops / ms_b2b / 1e6:.1f} useful GFLOP/s [{card}]", flush=True)
    return ms, ms_b2b


def bf16_stream_record(kname, kern, plain, bound, m, b, card,
                       tol_dtype=torch.float32):
    """The bf16 stream of K3, K4, K5 or K8 at the bench shape (A and the
    operand in bf16, float32 sums): against its plain version — both take
    the same bf16 operands and sum in float32, so float32's tolerance on
    the rounded |A||B| — twice for bitwise repeatability, timed in turns
    beside its bound and ``BSR @ B`` in bf16; returns the record kept in
    the kernel's entry.  ``b`` is the (n, k) operand.  ``tol_dtype``: bf16
    where both sides round the float32 sums to a bf16 result (K6)."""
    label = f"{kname} bf16 stream"
    err, y = _twice_vs_plain(f"{label} at the bench shape", kern, plain,
                             bound, tol_dtype)
    a, k = m["a"], b.shape[1]
    # A and B in bf16, C written once at the result's width (bf16 for K6)
    cost = spmm_cost(int(m["slot_valid"].sum()), a.bsz, a.n, k, 2,
                     y.element_size())
    _, ms_p = _report_spmm(f"{label} plain", plain, cost[1], cost[0], card)
    _, ms_k = _report_spmm(f"{label} kernel", kern, cost[1], cost[0], card)
    _report_spmm(f"{label} kernel", kern, cost[1], cost[0], card)
    _report_spmm(f"{label} plain", plain, cost[1], cost[0], card)
    lib, call = library_spmm(m, b.to(torch.bfloat16), card,
                             f"k {k} bf16, {kname}")
    b_ms, b_by = bound_ms(*cost, torch.bfloat16)
    print(f"   {label}: {ms_k:.4f} ms back to back, bound {b_ms:.4f} ms "
          f"({b_by}), {b_ms / ms_k:.1%} of it; plain {ms_p:.4f} ms; max"
          f"|kernel-plain| {err:.3e}; library "
          f"{'refused' if lib is None else f'{lib:.4f} ms'} ({call}) "
          f"[{card}]", flush=True)
    return {"ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err, "library_ms": lib, "library_call": call,
            "useful_gflop": cost[1] / 1e9}


def phase9_bell_timing(card, m):
    """Each of K3-K6 against its plain version at the main path's shape
    (tolerance, bitwise repeat over all rows), then timed in turns — plain,
    kernel, kernel, plain — alone and back to back, with the work the
    float32 bodies of K3, K4, K5 and K6 issue (K5 also the tile bytes it
    reads) and the bf16x3 split of K3 and K4 issues; K4 twice: through
    ``bell_spmm(plan=kit)`` (K4-kit, the mask body) and on the kit's tiles
    (``bell_spmm_banded(..., tiles=kit.tiles)``, the vote body), the vote
    route timed again beside the kit route; the bf16 streams of
    K4 (both routes), K3 (``compute_dtype=bfloat16``), K6 (bf16 blocks) and
    K5 (a bf16 kit at k 32), each with a bf16 operand,
    the same way beside ``BSR @ B`` in bf16; then bell_spmm beside K6, and
    the chain.  The SM clock and power under K3's and K4's float32 kernels
    (the band body's float32 map) and K3's bf16 stream are read beside
    their times, with K3's grid (``cuda_bell.fused_geometry``: tiles,
    thread blocks, registers)."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.formats.bell import BELL
    from sparse_tpu_torch.ops import cuda_bell as cb

    a, b, b32, kit, kit_t = m["a"], m["b"], m["b32"], m["kit"], m["kit_t"]
    nnz, k = m["nnz"], m["k"]
    bsz, nb, Lb = a.bsz, a.nb, a.Lb
    # the reference's fused CostEstimate bytes: blocks, one panel per slot,
    # the output
    fused_bytes = nb * (bsz * Lb * bsz + Lb * bsz * k + bsz * k) * 4
    bound = _abs_bound(a, b, torch.float32)
    bound32 = bound[:, :32].T.contiguous()
    bt32 = b32.T.contiguous()  # K5's operand layout, outside the timing
    cases = (
        ("K4-kit bell_banded_masked", "sparse_tpu/ops/pallas_bell.py:430",
         "bell_banded.cu", lambda: pt.bell_spmm(a, b, plan=kit),
         lambda: cb.bell_spmm_banded_plain(a, b, kit.plan, tiles=kit.tiles),
         bound, 2 * nnz * k, cb.banded_spmm_hbm_bytes(kit, bsz, a.n, k)),
        ("K4 bell_banded", "sparse_tpu/ops/pallas_bell.py:430",
         "bell_banded.cu",
         lambda: cb.bell_spmm_banded(a, b, kit.plan, tiles=kit.tiles),
         lambda: cb.bell_spmm_banded_plain(a, b, kit.plan, tiles=kit.tiles),
         bound, 2 * nnz * k, cb.banded_spmm_hbm_bytes(kit, bsz, a.n, k)),
        ("K3 bell_fused", "sparse_tpu/ops/pallas_bell.py:141",
         "bell_spmm.cu", lambda: cb.bell_spmm_fused(a, b),
         lambda: cb.bell_spmm_fused_plain(a, b), bound, 2 * nnz * k,
         fused_bytes),
        ("K5 bell_banded_t", "sparse_tpu/ops/pallas_bell.py:675",
         "bell_banded.cu",
         lambda: cb.bell_spmm_banded_t(a, bt32, kit_t),
         lambda: cb.bell_spmm_banded_t_plain(a, bt32, kit_t),
         bound32, 2 * nnz * 32,
         cb.banded_spmm_t_hbm_bytes(kit_t, bsz, a.n, 32)),
        ("K6 bell_block", "sparse_tpu/ops/pallas_bell.py:58", "bell_spmm.cu",
         lambda: cb.bell_spmm_block(a, b),
         lambda: cb.bell_spmm_block_plain(a, b), bound, 2 * nnz * k,
         fused_bytes),
    )
    out = {}
    nbz = int(m["slot_valid"].sum())
    for name, replaces, src, kern, plain, bnd, flops, nbytes in cases:
        kname = name.split()[0]
        err, _ = _twice_vs_plain(f"{kname} at the bench shape", kern, plain,
                                 bnd, torch.float32)
        print(f"   {kname} at the bench shape: max|kernel-plain| {err:.3e} "
              f"over all rows; bitwise repeatable", flush=True)
        _, ms_p = _report_spmm(f"{kname} plain", plain, flops, nbytes, card)
        _, ms_k = _report_spmm(f"{kname} kernel", kern, flops, nbytes, card)
        _report_spmm(f"{kname} kernel", kern, flops, nbytes, card)
        _report_spmm(f"{kname} plain", plain, flops, nbytes, card)
        kk = 32 if kname == "K5" else k
        lib, call = library_spmm(m, b32 if kname == "K5" else b, card,
                                 f"k {kk}")
        if kname == "K5":  # what the k 32 yardstick's time is made of
            bsr = m[("bsr", torch.float32)]
            print(f"   library BSR @ B (k 32): "
                  f"{_host_us(lambda: bsr @ b32):.1f} us of host time a "
                  f"call issued back to back [{card}]", flush=True)
            _apply_kernels("library BSR @ B (k 32)", lambda: bsr @ b32,
                           forbid=())
        out[kname] = kernel_entry(
            name, f"sparse_tpu_torch/csrc/{src}", replaces,
            m["counts"][kname], err, ms_k, ms_p,
            spmm_cost(nbz, bsz, a.n, kk), lib, call)
        if kname in ("K3", "K4", "K4-kit"):  # the band body's float32 map
            out[kname]["sm_clock_power"] = _clock_line(
                f"{kname} float32 kernel", kern, card)
        if kname in ("K4", "K4-kit"):
            out[kname]["geometry"] = band_geometry_line(
                f"{kname} float32", kit.tiles, k, card,
                masked=kname == "K4-kit")
            out[kname]["sha256"] = f32_digest(f"{kname} float32", kern,
                                              card)["sha256"]
    useful = 2 * nnz * k
    out["K4"]["issued_gflop"] = check_issued(
        "K4 float32", kit.tiles, kit.plan.start, b, bsz, useful) / 1e9
    out["K4"]["useful_gflop"] = useful / 1e9
    # the kit route: the mask body's count is the vote's model
    out["K4-kit"]["issued_gflop"] = check_issued(
        "K4-kit float32", kit.tiles, kit.plan.start, b, bsz, useful,
        mask=kit.chunk_nz) / 1e9
    out["K4-kit"]["useful_gflop"] = useful / 1e9
    kit_beside("K4-kit float32", out["K4-kit"], card, **{
        "K4 (vote body, the kit's tiles)": lambda: cb.bell_spmm_banded(
            a, b, kit.plan, tiles=kit.tiles)})
    # K3's vote and K5's mask, read from their own counters
    out["K3"]["issued_gflop"] = check_counted(
        "K3 float32", cb.fused_issued_flops(a, b),
        cb.fused_issued_model(a, k), useful) / 1e9
    out["K3"]["useful_gflop"] = useful / 1e9
    # the bf16x3 split on the same vote body keeps float32's chunks (phase
    # 21 times it)
    check_issued("K4 bf16x3", kit.tiles, kit.plan.start, b, bsz, useful,
                 precision="bf16x3")
    check_issued("K4-kit bf16x3", kit.tiles, kit.plan.start, b, bsz, useful,
                 precision="bf16x3", mask=kit.chunk_nz)
    check_counted("K3 bf16x3", cb.fused_issued_flops(a, b,
                                                     precision="bf16x3"),
                  cb.fused_issued_model(a, k), useful)
    useful32 = 2 * nnz * 32
    out["K6"]["issued_gflop"] = check_counted(
        "K6 float32", cb.block_issued_flops(a, b),
        cb.block_issued_model(a, k), useful) / 1e9
    out["K6"]["useful_gflop"] = useful / 1e9
    out["K5"]["useful_gflop"] = useful32 / 1e9
    out["K5"].update(check_k5_counts("K5 float32 k=32", a, bt32, kit_t,
                                     useful32))
    bf16 = torch.bfloat16
    kit_bf = cb.bell_banded_prepare(a, row_tile=5, compute_dtype=bf16,
                                    slot_valid=m["slot_valid"])
    kw = dict(tiles=kit_bf.tiles, compute_dtype=bf16)
    b_bf = b.to(bf16)  # the stream's operand, as K8's b3 is
    rec = out["K4"]["bf16_stream"] = bf16_stream_record(
        "K4", lambda: cb.bell_spmm_banded(a, b_bf, kit_bf.plan, **kw),
        lambda: cb.bell_spmm_banded_plain(a, b_bf, kit_bf.plan, **kw),
        _abs_bound(a, b, bf16), m, b, card)
    rec["issued_gflop"] = check_issued(
        "K4 bf16 stream", kit_bf.tiles, kit_bf.plan.start, b_bf, bsz,
        useful) / 1e9
    rec = out["K4-kit"]["bf16_stream"] = bf16_stream_record(
        "K4-kit", lambda: pt.bell_spmm(a, b_bf, plan=kit_bf),
        lambda: cb.bell_spmm_banded_plain(a, b_bf, kit_bf.plan, **kw),
        _abs_bound(a, b, bf16), m, b, card)
    rec["issued_gflop"] = check_issued(
        "K4-kit bf16 stream", kit_bf.tiles, kit_bf.plan.start, b_bf, bsz,
        useful, mask=kit_bf.chunk_nz) / 1e9
    kit_beside("K4-kit bf16 stream", rec, card, **{
        "K4 (vote body, the kit's tiles)": lambda: cb.bell_spmm_banded(
            a, b_bf, kit_bf.plan, **kw)})
    # a float32 operand: the wrapper rounds it to bf16 on every call
    _report_spmm("K4 bf16, float32 B", lambda: cb.bell_spmm_banded(
        a, b, kit_bf.plan, **kw), useful,
        cb.banded_spmm_hbm_bytes(kit_bf, bsz, a.n, k), card)
    del kit_bf, kw
    # K3's bf16 stream, a bf16 operand
    kw = dict(compute_dtype=bf16)
    rec = out["K3"]["bf16_stream"] = bf16_stream_record(
        "K3", lambda: cb.bell_spmm_fused(a, b_bf, **kw),
        lambda: cb.bell_spmm_fused_plain(a, b_bf, **kw),
        _abs_bound(a, b, bf16), m, b, card)
    rec["issued_gflop"] = check_counted(
        "K3 bf16 stream", cb.fused_issued_flops(a, b_bf, **kw),
        cb.fused_issued_model(a, k, compute_dtype=bf16), useful) / 1e9
    rec["sm_clock_power"] = _clock_line(
        "K3 bf16 stream kernel", lambda: cb.bell_spmm_fused(a, b_bf, **kw),
        card)
    # K3's grid: bf16 walks its tiles on the resident thread blocks,
    # float32 takes a thread block a tile
    for kind, dt in (("float32", torch.float32), ("bf16", bf16)):
        geo = cb.fused_geometry(nb, Lb, bsz, k, dt)
        (out["K3"] if dt == torch.float32 else rec)["geometry"] = geo
        print(f"   K3 {kind}: {geo['tiles']} tiles of "
              f"{geo['chunks_per_tile']} chunks on {geo['grid']} thread "
              f"blocks ({geo['blocks_per_sm']} an SM; walks: "
              f"{geo['walks']}), {geo['registers']} registers and "
              f"{geo['local_bytes']} local bytes a thread", flush=True)
    # K6's bf16 stream: bf16 blocks and a bf16 operand, a bf16 result
    a_bf = BELL(cols=a.cols, blocks=a.blocks.to(bf16), n=a.n, bsz=bsz)
    rec = out["K6"]["bf16_stream"] = bf16_stream_record(
        "K6", lambda: cb.bell_spmm_block(a_bf, b_bf),
        lambda: cb.bell_spmm_block_plain(a_bf, b_bf),
        _abs_bound(a, b, bf16), m, b, card, tol_dtype=bf16)
    rec["issued_gflop"] = check_counted(
        "K6 bf16 stream", cb.block_issued_flops(a_bf, b_bf),
        cb.block_issued_model(a_bf, k), useful) / 1e9
    del b_bf, a_bf
    # K5's bf16 kit at k 32, a bf16 operand
    kit_tbf = cb.bell_banded_prepare_t(a, compute_dtype=bf16,
                                       slot_valid=m["slot_valid"])
    bt_bf = bt32.to(bf16)
    rec = out["K5"]["bf16_stream"] = bf16_stream_record(
        "K5", lambda: cb.bell_spmm_banded_t(a, bt_bf, kit_tbf),
        lambda: cb.bell_spmm_banded_t_plain(a, bt_bf, kit_tbf),
        _abs_bound(a, b32, bf16).T.contiguous(), m, b32, card)
    rec.update(check_k5_counts("K5 bf16 stream k=32", a, bt_bf, kit_tbf,
                               useful32))
    del kit_tbf, bt_bf
    banded_bytes = cb.banded_spmm_hbm_bytes(kit, bsz, a.n, k)
    _, ms_route = _report_spmm("bell_spmm(plan=kit)",
                               lambda: pt.bell_spmm(a, b, plan=kit),
                               2 * nnz * k, banded_bytes, card)
    ms_k6 = out["K6"]["ms"]
    print(f"   bell_spmm(plan=kit) runs K4's mask body: {ms_route:.4f} ms "
          f"back to back against K6's {ms_k6:.4f} ({ms_route / ms_k6:.2f}x); "
          f"the route is recorded, not changed [{card}]", flush=True)

    def chain():
        x = b
        for _ in range(m["chain"]):
            x = pt.bell_spmm(a, x, plan=kit)
        return x

    _report_spmm(f"chain, {m['chain']} steps", chain,
                 2 * nnz * k * m["chain"], banded_bytes * m["chain"], card)
    return list(out.values())


# -- SpGEMM: the block-SpGEMM slab kernel K7 ---------------------------------

def _slab_tol(dtype):
    return BF16_TOL if dtype == torch.bfloat16 else TOL[dtype]


def _rand_bsr(nb, bsz, density, dtype, rng, parity=None):
    """Random stored blocks (N(0, 1) values) of a BSR on the card; with
    ``parity`` the stored-block count is made odd (1) or even (0)."""
    import sparse_tpu_torch as pt

    r, c = np.nonzero(rng.random((nb, nb)) < density)
    if parity is not None and r.size % 2 != parity:
        r, c = r[:-1], c[:-1]
    blocks = rng.standard_normal((r.size, bsz, bsz))
    return pt.BSR(indices=torch.from_numpy((r * nb + c).astype(
        np.int32)).cuda(), blocks=torch.from_numpy(blocks).to(dtype).cuda(),
                  n=nb * bsz, bsz=bsz)


def _slab_args(pp, z1, z2, out_dtype):
    """The raw-array call of K7 and of its plain version for plan ``pp``."""
    return ((pp.a_idx, pp.b_idx, pp.oloc, pp.first, pp.slab, z1, z2),
            dict(chunks=pp.chunks, bsz=pp.bsz, g=pp.g, p=pp.p,
                 nbz_out=pp.nbz_out, out_dtype=out_dtype, paired=pp.paired))


def _slab_vs_plain(label, pp, z1, z2, out_dtype):
    """K7 twice (bitwise equal) against its plain version on the same
    inputs, within tol(dtype) * (|z1||z2|) per element (the plain version on
    the absolute values in float64); returns (max |kernel - plain|, the
    kernel's result)."""
    from sparse_tpu_torch.ops import cuda_bsr

    args, kw = _slab_args(pp, z1, z2, out_dtype)
    bound = cuda_bsr.run_slabs_arrays_plain(
        *args[:5], z1.abs().double(), z2.abs().double(),
        **{**kw, "out_dtype": torch.float64})
    y1 = cuda_bsr.run_slabs_arrays(*args, **kw, slab_start=pp.slab_start)
    torch.cuda.synchronize()
    y2 = cuda_bsr.run_slabs_arrays(*args, **kw)  # ranges from `first`
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        raise AssertionError(f"{label}: two runs differ bitwise")
    yp = cuda_bsr.run_slabs_arrays_plain(*args, **kw)
    if y1.shape != yp.shape or y1.dtype != out_dtype \
            or not torch.isfinite(y1).all():
        raise AssertionError(f"{label}: {tuple(y1.shape)} {y1.dtype} vs "
                             f"plain {tuple(yp.shape)}, or non-finite")
    err = (y1.double() - yp.double()).abs()
    worst = float((err - _slab_tol(out_dtype) * bound).max()) \
        if err.numel() else 0.0
    if worst > 0:
        raise AssertionError(f"{label}: error exceeds {_slab_tol(out_dtype)}"
                             f" * |A||B| by {worst:.3e}")
    return (float(err.max()) if err.numel() else 0.0), y1


def _prepared_vs_plain(label, pp, a, b, dtype):
    """The prepared apply (K7 on the plan's product list, the blocks as they
    are) twice, bitwise equal, against the list walk's plain version within
    tol(dtype) * (|A||B|), outputs with no product zero, and the kernel's
    own count of the products it multiplied against ``prod_ptr[-1]``;
    returns (max |kernel - plain|, products counted)."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bsr

    y1 = pt.bsr_smsmm_apply_slab(pp, a, b).blocks
    torch.cuda.synchronize()
    y2 = pt.bsr_smsmm_apply_slab(pp, a, b).blocks
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        raise AssertionError(f"{label}: two runs differ bitwise")
    lst = (pp.prod_ptr, pp.prod_ab)
    yp = cuda_bsr.slab_list_plain(*lst, a.blocks, b.blocks, out_dtype=dtype)
    bound = cuda_bsr.slab_list_plain(*lst, a.blocks.abs().double(),
                                     b.blocks.abs().double(),
                                     out_dtype=torch.float64)
    if y1.shape != yp.shape or y1.dtype != dtype \
            or not torch.isfinite(y1).all() \
            or y1[torch.diff(pp.prod_ptr) == 0].any():
        raise AssertionError(f"{label}: {tuple(y1.shape)} {y1.dtype} vs "
                             f"plain {tuple(yp.shape)}, non-finite, or an "
                             "output with no product is not zero")
    err = (y1.double() - yp.double()).abs()
    worst = float((err - _slab_tol(dtype) * bound).max()) \
        if err.numel() else 0.0
    if worst > 0:
        raise AssertionError(f"{label}: error exceeds {_slab_tol(dtype)} * "
                             f"|A||B| by {worst:.3e}")
    issued = cuda_bsr.bsr_slab_issued(*lst, a.blocks, b.blocks,
                                      out_dtype=dtype)
    model = cuda_bsr.bsr_slab_issued_model(pp.prod_ptr)
    if issued != model:
        raise AssertionError(f"{label}: the kernel multiplied {issued} "
                             f"products, the list holds {model}")
    return (float(err.max()) if err.numel() else 0.0), issued


def phase10_slab_kernel_vs_plain():
    """K7 against its plain versions on the card: bsz 8/16/32/64, float32,
    float64 and bf16, unpaired and paired schedules (odd and even A block
    counts), the raw route (a list with the pads, built per call) and the
    prepared route (the plan's list, with the kernel's product count), a
    plan split into several reference chunks, one output of 40 products,
    an empty product set, and the gradient's two schedules (dA, dB); then
    float64 at bsz 1, 8, 16, 20, 32, 33 and 64 on both routes; each case
    twice for bitwise repeatability."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bsr

    rng = np.random.default_rng(10)
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    # (bsz, nb, density, dtype, paired, A parity, g, p)
    cases = [(8, 60, 0.1, f32, False, None, None, None),
             (16, 40, 0.12, f64, False, None, None, None),
             (32, 30, 0.15, f32, False, None, None, None),
             (64, 14, 0.25, f32, False, None, None, None),
             (32, 30, 0.15, bf16, False, None, None, None),
             (64, 14, 0.25, f64, True, 1, None, None),
             (16, 40, 0.12, bf16, True, 0, None, None),
             (32, 30, 0.15, f32, True, 1, 6, 4),
             (8, 60, 0.1, f32, True, 0, 8, 16)]
    for bsz, nb, dens, dt, paired, parity, g, p in cases:
        a = _rand_bsr(nb, bsz, dens, dt, rng, parity)
        b = _rand_bsr(nb, bsz, dens, dt, rng)
        plan = pt.bsr_smsmm_prepare(a, b)
        pp = pt.bsr_smsmm_slab_prepare(plan, a.nbz, b.nbz, g=g, p=p,
                                       paired=paired)
        ka = 2 + (a.nbz & 1) if paired else 1
        z1 = cuda_bsr._append_zero(a.blocks, dt, ka)
        z2 = cuda_bsr._append_zero(b.blocks, dt)
        label = (f"K7 bsz={bsz} {str(dt)[6:]} paired={paired} A blocks "
                 f"{a.nbz} products {plan.n_products} g={pp.g} p={pp.p}")
        err, _ = _slab_vs_plain(label, pp, z1, z2, dt)
        err_p, issued = _prepared_vs_plain(f"{label} prepared", pp, a, b, dt)
        print(f"   {label}: max|kernel-plain| {err:.3e} raw route (slots, "
              f"pads kept), {err_p:.3e} prepared (the plan's list, "
              f"{issued} products counted); bitwise repeatable", flush=True)
    # float64 at the card tests' sizes: the FMA tile to bsz 8, the DMMA
    # body past it (element copies where bsz is not 8, 16, 32 or 64)
    for bsz in (1, 8, 16, 20, 32, 33, 64):
        a = _rand_bsr(max(12, 240 // bsz), bsz, 0.2, f64, rng)
        plan = pt.bsr_smsmm_prepare(a, a)
        pp = pt.bsr_smsmm_slab_prepare(plan, a.nbz, a.nbz)
        z = cuda_bsr._append_zero(a.blocks, f64)
        label = f"K7 float64 bsz={bsz} products {plan.n_products}"
        err, _ = _slab_vs_plain(label, pp, z, z, f64)
        err_p, issued = _prepared_vs_plain(f"{label} prepared", pp, a, a,
                                           f64)
        print(f"   {label}: max|kernel-plain| {err:.3e} raw, {err_p:.3e} "
              f"prepared ({issued} products counted); bitwise repeatable",
              flush=True)
    # several reference chunks: the step cap lowered to 256 at g = 2
    a = _rand_bsr(60, 8, 0.1, f32, rng)
    plan = pt.bsr_smsmm_prepare(a, a)
    old = cuda_bsr._SMEM_BUDGET
    try:
        cuda_bsr._SMEM_BUDGET = (3 * 2 + 2) * 4 * 256
        pp = pt.bsr_smsmm_slab_prepare(plan, a.nbz, a.nbz, g=2, p=2)
    finally:
        cuda_bsr._SMEM_BUDGET = old
    if len(pp.chunks) < 3:
        raise AssertionError(f"K7 chunked: {len(pp.chunks)} chunks")
    z = cuda_bsr._append_zero(a.blocks, f32)
    err, _ = _slab_vs_plain("K7 chunked", pp, z, z, f32)
    err_p, _ = _prepared_vs_plain("K7 chunked prepared", pp, a, a, f32)
    print(f"   K7 plan in {len(pp.chunks)} reference chunks: max|kernel-"
          f"plain| {err:.3e} raw, {err_p:.3e} prepared; bitwise repeatable",
          flush=True)
    # one output block of 40 products: a block row times a block column
    r40 = torch.arange(40, dtype=torch.int32, device="cuda")
    blk = torch.from_numpy(rng.standard_normal((2, 40, 32, 32))).float()
    a = pt.BSR(indices=r40, blocks=blk[0].cuda(), n=40 * 32, bsz=32)
    b = pt.BSR(indices=r40 * 40, blocks=blk[1].cuda(), n=40 * 32, bsz=32)
    pp = pt.bsr_smsmm_slab_prepare(pt.bsr_smsmm_prepare(a, b), 40, 40)
    err_p, issued = _prepared_vs_plain("K7 one output", pp, a, b, f32)
    if pp.nbz_out != 1 or issued != 40:
        raise AssertionError(f"K7 one output: {pp.nbz_out} outputs, "
                             f"{issued} products")
    print(f"   K7 one output of 40 products: max|kernel-plain| "
          f"{err_p:.3e}; bitwise repeatable", flush=True)
    # no block product at all: one stored block at (0, 1), squared
    e = pt.BSR(indices=torch.tensor([1], dtype=torch.int32, device="cuda"),
               blocks=torch.ones(1, 32, 32, device="cuda"), n=64, bsz=32)
    pe = pt.bsr_smsmm_slab_prepare(pt.bsr_smsmm_prepare(e, e), 1, 1)
    ce = pt.bsr_smsmm_apply_slab(pe, e, e)
    if ce.blocks.shape != (0, 32, 32):
        raise AssertionError(f"K7 empty: {tuple(ce.blocks.shape)}")
    # the gradient: dA and dB are K7 on the permuted schedules
    for dt in (f32, f64):
        a = _rand_bsr(30, 32, 0.15, dt, rng)
        b = _rand_bsr(30, 32, 0.15, dt, rng)
        plans = pt.bsr_smsmm_slab_prepare_ad(pt.bsr_smsmm_prepare(a, b),
                                             a.nbz, b.nbz)
        ct = torch.from_numpy(rng.standard_normal(
            (plans.fwd.nbz_out, 32, 32))).to(dt).cuda()
        ab = a.blocks.clone().requires_grad_(True)
        bb = b.blocks.clone().requires_grad_(True)
        c = pt.bsr_smsmm_apply_slab_ad(
            plans, pt.BSR(indices=a.indices, blocks=ab, n=a.n, bsz=32),
            pt.BSR(indices=b.indices, blocks=bb, n=b.n, bsz=32))
        c.blocks.backward(ct)
        zc = cuda_bsr._append_zero(ct, dt)
        zbt = cuda_bsr._append_zero(b.blocks.transpose(1, 2), dt)
        zat = cuda_bsr._append_zero(a.blocks.transpose(1, 2), dt)
        errs = []
        for name, pp, z1, z2, got in (("dA", plans.da, zc, zbt, ab.grad),
                                      ("dB", plans.db, zat, zc, bb.grad)):
            err, y = _slab_vs_plain(f"K7 {name} {str(dt)[6:]}", pp, z1, z2,
                                    dt)
            if not torch.equal(got, y):
                raise AssertionError(f"K7 {name}: autograd's gradient is not "
                                     "the kernel's result")
            errs.append(err)
        print(f"   K7 gradient {str(dt)[6:]}: dA {errs[0]:.3e}, dB "
              f"{errs[1]:.3e} max|kernel-plain|; bitwise repeatable",
              flush=True)


#: Block rows of the SpGEMM fixture (measure_auto_block.py's).
SPGEMM_NB = 2_000


def _spgemm_fixture():
    """``benchmarks/measure_auto_block.py``'s fixture, not cut: nb 2,000
    block rows of 32 x 32 blocks, 10 draws per block row within +-50 block
    columns (duplicates merged), N(0, 0.01^2) float32 values from
    ``default_rng(9)``, every block fully stored.  Returns the SciPy BSR
    (float64 copy of the float32 values) and the scalar CSR's arrays."""
    import scipy.sparse as sp

    nb, bsz = SPGEMM_NB, 32
    rng = np.random.default_rng(9)
    rows = np.repeat(np.arange(nb, dtype=np.int64), 10)
    cols = np.clip(rows + rng.integers(-50, 50, rows.size), 0, nb - 1)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    keep = np.ones(rows.size, bool)
    keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    rows, cols = rows[keep], cols[keep]
    bvals = rng.standard_normal((rows.size, bsz, bsz)).astype(
        np.float32) * 0.01
    bvals[bvals == 0] = 0.01
    s = sp.bsr_matrix((bvals.astype(np.float64), cols,
                       np.searchsorted(rows, np.arange(nb + 1))),
                      shape=(nb * bsz, nb * bsz))
    return s, rows, cols, bvals


class _ScipyBlockRows:
    """SciPy float64 ``A @ A`` on a fixed subset of block rows (every 8th
    and the last), with ``|A||A|`` for the bound: the oracle of phase 11."""

    def __init__(self, s):
        import scipy.sparse as sp

        nb = s.shape[0] // 32
        self.sub = np.unique(np.r_[np.arange(0, nb, 8), nb - 1])
        rows = (self.sub[:, None] * 32 + np.arange(32)).reshape(-1)
        rows = s.tocsr()[rows].tobsr(blocksize=(32, 32))
        self.ref = rows @ s
        self.abs = abs(rows) @ abs(s)
        for m in (self.ref, self.abs):
            m.sort_indices()

    def check(self, label, c):
        """The scalar CSR ``c`` on the subset: every stored position of the
        product's blocks, in order, and values within 1e-5 |A||A|."""
        indptr = c.indptr.cpu().numpy()
        ref, bnd = self.ref, self.abs
        worst = 0.0
        for j, br in enumerate(self.sub):
            lo, hi = int(indptr[br * 32]), int(indptr[br * 32 + 32])
            k0, k1 = ref.indptr[j], ref.indptr[j + 1]
            want_cols = (ref.indices[k0:k1, None] * 32
                         + np.arange(32)).reshape(-1)
            if hi - lo != 32 * want_cols.size or not np.array_equal(
                    np.diff(indptr[br * 32:br * 32 + 33]),
                    np.full(32, want_cols.size)):
                raise AssertionError(f"{label}: block row {br} stores "
                                     f"{hi - lo} entries, expected "
                                     f"{32 * want_cols.size}")
            got_cols = c.indices[lo:hi].cpu().numpy().reshape(32, -1)
            if not (got_cols == want_cols[None, :]).all():
                raise AssertionError(f"{label}: block row {br}: column "
                                     "structure differs from SciPy's")
            got = c.data[lo:hi].double().cpu().numpy().reshape(32, -1)
            want = ref.data[k0:k1].transpose(1, 0, 2).reshape(32, -1)
            bound = bnd.data[k0:k1].transpose(1, 0, 2).reshape(32, -1)
            err = np.abs(got - want)
            over = float((err - TOL[torch.float32] * bound).max())
            if over > 0:
                raise AssertionError(f"{label}: block row {br}: error "
                                     f"exceeds 1e-5 |A||A| by {over:.3e}")
            worst = max(worst, float(err.max()))
        return worst


def phase11_spgemm_main_path():
    """``spgemm(a, a)`` at the reference's SpGEMM fixture through the public
    entry points (COO on the card -> CSR -> spgemm, method "auto"); the
    caller reads K7's launch count around this phase."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import spgemm as sg

    t0 = time.perf_counter()
    s, rows, cols, bvals = _spgemm_fixture()
    sc = s.tocsr()
    t_gen = time.perf_counter() - t0
    oracle = _ScipyBlockRows(s)
    coo = sc.tocoo()
    t0 = time.perf_counter()
    a = pt.csr_from_coo(pt.coo_make(
        sc.shape, torch.from_numpy(coo.row.astype(np.int64)).cuda(),
        torch.from_numpy(coo.col.astype(np.int64)).cuda(),
        torch.from_numpy(coo.data.astype(np.float32)).cuda()))
    torch.cuda.synchronize()
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    route = sg._spgemm_route(a, a)
    t_route = time.perf_counter() - t0
    if route != ("block", 32):
        raise AssertionError(f"spgemm route {route}, expected ('block', 32)")
    t0 = time.perf_counter()
    c = pt.spgemm(a, a)
    torch.cuda.synchronize()
    t_spgemm = time.perf_counter() - t0
    if c.data.dtype != torch.float32 or not torch.isfinite(c.data).all():
        raise AssertionError(f"spgemm: dtype {c.data.dtype} or non-finite")
    err = oracle.check("spgemm(a, a) vs scipy", c)
    c2 = pt.spgemm(a, a)
    torch.cuda.synchronize()
    for f in ("data", "indices", "indptr"):
        if not torch.equal(getattr(c, f), getattr(c2, f)):
            raise AssertionError(f"spgemm(a, a): two runs differ in {f}")
    nbz_out = c.nse // (32 * 32)
    print(f"   fixture: n={a.shape[0]} nnz={a.nse} stored blocks "
          f"{rows.size} (generated in {t_gen:.1f} s); csr_from_coo "
          f"{t_csr:.2f} s; route {route} in {t_route:.2f} s (host)",
          flush=True)
    print(f"   spgemm(a, a): {nbz_out} output blocks, nse {c.nse}, "
          f"{t_spgemm:.2f} s one-shot; max|C-scipy| {err:.3e} on "
          f"{oracle.sub.size} block rows; bitwise repeatable", flush=True)
    return dict(a=a, t_spgemm=t_spgemm, oracle=oracle)


def phase12_slab_timing(card, m, launches):
    """K7 against its plain versions at the fixture's shapes (the prepared
    plan's list with the kernel's product count, the raw route, the
    gradient's schedules, the bf16 and float64 kinds), then timed in turns
    — plain, kernel, kernel, plain — alone and back to back: K7 on the
    plan's list, the prepared ``bsr_smsmm_apply_slab`` (also bf16 and
    float64), the raw slab apply, a 5-step chain and the AD forward +
    backward; the host prepare and the one-shot ``spgemm`` separately."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bsr
    from sparse_tpu_torch.utils.precision import full_precision

    a = m["a"]
    t0 = time.perf_counter()
    ab = pt.csr_to_bsr(a, 32)
    torch.cuda.synchronize()
    t_rebl = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = pt.bsr_smsmm_prepare(ab, ab)
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    pp = pt.bsr_smsmm_slab_prepare(plan, ab.nbz, ab.nbz)
    t_slab = time.perf_counter() - t0
    t0 = time.perf_counter()
    plans = pt.bsr_smsmm_slab_prepare_ad(plan, ab.nbz, ab.nbz)
    t_ad = time.perf_counter() - t0
    F, bsz = plan.n_products, ab.bsz
    steps, nslabs = pp.first.numel(), -(-pp.nbz_out // pp.p)
    print(f"   host prepare: csr_to_bsr {t_rebl:.2f} s, bsr_smsmm_prepare "
          f"{t_sym:.2f} s, slab prepare {t_slab:.2f} s ({steps} steps, "
          f"g={pp.g}, p={pp.p}, {nslabs} slabs, {len(pp.chunks)} reference "
          f"chunks), AD prepare "
          f"{t_ad:.2f} s; F={F} block products, {plan.nbz_out} output "
          f"blocks", flush=True)
    z = cuda_bsr._append_zero(ab.blocks, torch.float32)
    err_raw, _ = _slab_vs_plain("K7 raw route at the fixture", pp, z, z,
                                torch.float32)
    err, issued = _prepared_vs_plain("K7 at the fixture", pp, ab, ab,
                                     torch.float32)
    if issued != F:
        raise AssertionError(f"K7 at the fixture: {issued} products "
                             f"multiplied, {F} in the product")
    print(f"   K7 at the fixture: max|kernel-plain| {err:.3e} prepared "
          f"(the plan's list), {err_raw:.3e} raw route, over all output "
          f"blocks; bitwise repeatable; products multiplied {issued} (the "
          f"kernel's count) = prod_ptr[-1] for {F} useful = "
          f"{issued / F:.4f}x; the slot tables hold {pp.b_idx.numel()} "
          "slots, pads included", flush=True)
    # the gradient's schedules at the fixture's shapes
    rng = torch.Generator(device="cuda").manual_seed(12)
    ct = torch.randn(plan.nbz_out, bsz, bsz, device="cuda", generator=rng)
    zc = cuda_bsr._append_zero(ct, torch.float32)
    zt = cuda_bsr._append_zero(ab.blocks.transpose(1, 2), torch.float32)
    for name, q, z1, z2 in (("dA", plans.da, zc, zt),
                            ("dB", plans.db, zt, zc)):
        e, _ = _slab_vs_plain(f"K7 {name} at the fixture", q, z1, z2,
                              torch.float32)
        print(f"   K7 {name} at the fixture: max|kernel-plain| {e:.3e}; "
              "bitwise repeatable", flush=True)
    args, kw = _slab_args(pp, z, z, torch.float32)
    flops = 2 * F * bsz ** 3
    # bytes model: both factor blocks of every product read once, every
    # output block written once (tables and the zero pads left out)
    nbytes = (2 * F + plan.nbz_out) * bsz * bsz * 4

    lst = (pp.prod_ptr, pp.prod_ab)

    def kern():  # K7 on the plan's list, through its launcher
        return cuda_bsr._launch_list("K7", *lst, ab.blocks, ab.blocks, bsz,
                                     torch.float32)

    def plain():
        return cuda_bsr.slab_list_plain(*lst, ab.blocks, ab.blocks,
                                        out_dtype=torch.float32)

    _, ms_p = _report_spmm("K7 plain", plain, flops, nbytes, card)
    _, ms_k = _report_spmm("K7 kernel", kern, flops, nbytes, card)
    _report_spmm("K7 kernel", kern, flops, nbytes, card)
    _report_spmm("K7 plain", plain, flops, nbytes, card)
    _report_spmm("bsr_smsmm_apply_slab", lambda: pt.bsr_smsmm_apply_slab(
        pp, ab, ab), flops, nbytes, card)
    _report_spmm("run_slabs_arrays (raw)", lambda: cuda_bsr.run_slabs_arrays(
        *args, **kw, slab_start=pp.slab_start), flops, nbytes, card)
    # The yardstick: the same block products as gathered block pairs
    # through torch.bmm, summed into the output blocks by index_add_ (two
    # library calls, the gathers included; the port never calls it)
    a_pos, b_pos = plan.a_pos.long(), plan.b_pos.long()
    seg = plan.seg.long()

    def yardstick(blocks=ab.blocks):
        out = blocks.new_zeros(plan.nbz_out, bsz, bsz)
        return out.index_add_(0, seg, torch.bmm(blocks[a_pos],
                                                blocks[b_pos]))

    kinds = {}
    # how often consecutive products of the list share an A slot (a copy
    # the producer could skip), counted on the host
    ab_np = pp.prod_ab.cpu().numpy()
    share_a = float((ab_np[1:, 0] == ab_np[:-1, 0]).mean()) \
        if len(ab_np) > 1 else 0.0
    print(f"   K7 product list: {share_a:.1%} of consecutive products share "
          "their A slot (host count)", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        listed, grouped = _a_slot_share(pp.prod_ptr, pp.prod_ab,
                                        cuda_bsr.slab_geometry(dt, bsz))
        print(f"   K7 {str(dt)[6:]} walk: {listed:.1%} of consecutive "
              f"products within a team's piece share their A slot as "
              f"listed, {grouped:.1%} if each piece's outputs were grouped "
              "by their first product's A slot (host count on the launched "
              "pieces)", flush=True)
    _slab_geometry_line("K7 int32", torch.int32, bsz, card)
    for dt in (torch.bfloat16, torch.float64):
        x = pt.BSR(indices=ab.indices, blocks=ab.blocks.to(dt), n=ab.n,
                   bsz=bsz)
        kind, size = str(dt)[6:], x.blocks.element_size()
        e, _ = _prepared_vs_plain(f"K7 {kind} at the fixture", pp, x, x, dt)
        # this kind's path: one prepared apply, counted from 0
        cuda_bsr.K7_LAUNCHES = 0
        pt.bsr_smsmm_apply_slab(pp, x, x)
        torch.cuda.synchronize()
        ran = cuda_bsr.K7_LAUNCHES
        if ran == 0:
            raise AssertionError(f"K7 {kind}: the prepared apply launched "
                                 "no K7")
        _, ms_dt = _report_spmm(f"bsr_smsmm_apply_slab {kind}",
                                lambda: pt.bsr_smsmm_apply_slab(pp, x, x),
                                flops, nbytes * size // 4, card)
        _, plain_dt = _report_spmm(
            f"K7 plain {kind}", lambda: cuda_bsr.slab_list_plain(
                *lst, x.blocks, x.blocks, out_dtype=dt),
            flops, nbytes * size // 4, card)
        # C = A A in this kind: A's blocks once, the output blocks once, at
        # its element size; the flops at its peak
        b_ms, b_by = bound_ms((ab.nbz + plan.nbz_out) * bsz * bsz * size,
                              flops, dt)
        print(f"   K7 {kind} at the fixture: max|kernel-plain| {e:.3e}; "
              f"prepared apply {ms_dt:.4f} ms back to back, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms_dt:.1%} of it [{card}]",
              flush=True)
        lib_dt = library_ms(f"torch.bmm + index_add_ in {kind} (K7's "
                            "yardstick)", lambda: yardstick(x.blocks), card)
        kinds[kind] = {"apply_ms": ms_dt, "plain_ms": plain_dt,
                       "launches": ran, "bound_ms": b_ms,
                       "bound_by": b_by, "max_abs_err": e,
                       "library_ms": lib_dt,
                       "geometry": _slab_geometry_line(f"K7 {kind}", dt,
                                                       bsz, card)}
        del x

    def chain():
        for _ in range(5):
            out = pt.bsr_smsmm_apply_slab(pp, ab, ab)
        return out

    _report_spmm("chain, 5 applies", chain, 5 * flops, 5 * nbytes, card)
    leaf = ab.blocks.clone().requires_grad_(True)

    def ad():
        x = pt.BSR(indices=ab.indices, blocks=leaf, n=ab.n, bsz=bsz)
        out = pt.bsr_smsmm_apply_slab_ad(plans, x, x)
        out.blocks.backward(ct)
        leaf.grad = None
        return out

    # forward + dA + dB: three slab applies of F products each
    _report_spmm("AD forward + backward", ad, 3 * flops, 3 * nbytes, card)
    print(f"   spgemm(a, a) one-shot {m['t_spgemm']:.2f} s (host clock: "
          f"re-block, host prepare, K7, back to scalar CSR) [{card}]",
          flush=True)
    csr = torch_csr(a)
    csr_ms = library_ms("A_csr @ A_csr", lambda: csr @ csr, card, n=5)
    del csr
    with full_precision(torch.float32):  # no TF32, as K7 computes
        c7 = pt.bsr_smsmm_apply_slab(pp, ab, ab).blocks
        e7 = check_close("two-call yardstick vs K7", yardstick(), c7,
                         yardstick(ab.blocks.abs()), torch.float32)
        lib = library_ms("torch.bmm + index_add_ (K7's yardstick)", yardstick,
                         card)
    del c7
    call = ("two-call yardstick: torch.bmm(A[a_pos], B[b_pos]) (F = "
            f"{F} gathered block pairs) + index_add_ into the output blocks"
            ", gathers included")
    print(f"   {call}: max|yardstick-K7| {e7:.3e}; cuSPARSE's A_csr @ A_csr "
          f"{'refused' if csr_ms is None else f'{csr_ms:.4f} ms'}",
          flush=True)
    # C = A A: A's blocks once (z1 and z2 are one buffer), the output
    # blocks once; 2 F bsz^3 flops
    cost = ((ab.nbz + plan.nbz_out) * bsz * bsz * 4, flops)
    geometry = _slab_geometry_line("K7 float32", torch.float32, bsz, card)
    return kernel_entry("K7 bsr_slab", "sparse_tpu_torch/csrc/bsr_slab.cu",
                        "sparse_tpu/ops/pallas_bsr.py:467", launches, err,
                        ms_k, ms_p, cost, lib, call,
                        library_ms_csr=csr_ms,
                        issued_gflop=issued * 2 * bsz ** 3 / 1e9,
                        useful_gflop=flops / 1e9, products_issued=issued,
                        products_useful=F, share_a=share_a,
                        geometry=geometry, **kinds)


def _slab_geometry_line(label, dtype, bsz, card):
    """Print and return the geometry K7 launches for ``dtype`` at ``bsz``
    (``cuda_bsr.slab_geometry``: ring stages of k-slices, shared bytes a
    block, blocks an SM, registers, spills, the body, pieces a team)."""
    from sparse_tpu_torch.ops import cuda_bsr

    geo = cuda_bsr.slab_geometry(dtype, bsz)
    print(f"   {label} geometry at bsz {bsz}: {geo['body']}, "
          f"{geo['stages']} stages a team of k-slices of {geo['k_slice']}, "
          f"{geo['teams']} teams a 128-thread block, {geo['pieces']} "
          f"pieces a team, {geo['shared_bytes']} shared bytes a block, "
          f"{geo['blocks_per_sm']} blocks an SM, {geo['registers']} "
          f"registers and {geo['local_bytes']} local bytes a thread "
          f"[{card}]", flush=True)
    return geo


def _a_slot_share(prod_ptr, prod_ab, geo):
    """Shares of consecutive products within one of K7's pieces (the output
    ranges a team walks, cut as the kernel cuts them for the launched
    geometry ``geo`` on this card) that have the A slot of the product
    before: as the list orders them, and if each piece walked its outputs
    grouped (stably) by their first product's A slot.  Host count."""
    ptr = prod_ptr.long().cpu().numpy()
    a = prod_ab[:, 0].long().cpu().numpy()
    n = ptr.size - 1
    if a.size < 2:
        return 0.0, 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    teams = min(-(-n // geo["teams"]),
                sms * geo["blocks_per_sm"]) * geo["teams"]
    npieces = teams * geo["pieces"]
    total = int(ptr[-1]) + n
    cuts = np.searchsorted(ptr + np.arange(n + 1),
                           total * np.arange(npieces + 1) // npieces)
    piece = np.searchsorted(cuts, np.arange(n), side="right") - 1
    counts = np.diff(ptr)

    def share(order):
        c = counts[order]
        start = np.repeat(ptr[:-1][order] - np.cumsum(c) + c, c)
        f = start + np.arange(c.sum())
        pc = np.repeat(piece[order], c)
        same = pc[1:] == pc[:-1]
        return float((a[f][1:] == a[f][:-1])[same].mean()) \
            if same.any() else 0.0

    first = np.where(counts > 0, a[np.minimum(ptr[:-1], a.size - 1)], -1)
    return share(np.arange(n)), share(np.lexsort((first, piece)))


# -- slice 4: the K1 variants, K8, Matrix Market input, roofline -----------

_VARIANTS = ((8, "ff"), (8, "rigid"), (32, "ff"), (32, "rigid"))


def phase13_variants_vs_plain():
    """K1 over the compact stream at rows 8/32 x reduce vpu/mxu x
    float32/float64 x wsub 8/16/32 on first-fit and rigid plans (empty
    rows, one slot spilled 16 deep), the raw-array route equal to the plan
    route, and
    K8 in float32 and the bf16 stream at odd shapes (nb % rt != 0, an empty
    block row), each against its plain version on the card, twice for
    bitwise repeatability."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bell as cb
    from sparse_tpu_torch.ops import cuda_csr, cuda_dband

    rng = np.random.default_rng(13)
    n = 20_000
    s, rows, cols, vals = _spill_band(n, rng)
    v_np = rng.standard_normal(n)
    bound = abs_bound(s, v_np)
    for dtype in (torch.float32, torch.float64):
        a = pt.csr_from_coo(pt.coo_make(
            (n, n), rows, cols, torch.from_numpy(vals).to(dtype).cuda()))
        v = torch.from_numpy(v_np).to(dtype).cuda()
        for r, layout in _VARIANTS:
            for wsub in (8, 16, 32):
                plan = pt.build_seg_tiles(a, wsub=wsub, rows=r, layout=layout)
                raw = dict(n=n, wsub=wsub, rows=r, kstep=plan.kstep,
                           chunks=plan.chunks)
                arrs = (plan.vals, plan.q, plan.seg_of, plan.rb)
                errs = []
                for reduce in ("vpu", "mxu"):
                    label = (f"K1 rows={r} {layout} wsub={wsub} {reduce} "
                             f"{str(dtype)[6:]}")
                    err, y = _twice_vs_plain(
                        label,
                        lambda: pt.csr_smvm_segtile(a, v, plan,
                                                    reduce=reduce),
                        lambda: cuda_csr.segtile_stream_plain(plan.stream,
                                                              v),
                        bound, dtype)
                    if not torch.all(y[3::7] == 0):
                        raise AssertionError(f"{label}: an empty row is not "
                                             "exactly 0")
                    if not torch.equal(cuda_csr.segtile_apply(
                            *arrs, v, reduce=reduce, **raw), y):
                        raise AssertionError(f"{label}: the raw-array route "
                                             "differs from the plan route")
                    errs.append(err)
                print(f"   K1 rows={r:2d} {layout:5s} wsub={wsub:2d} "
                      f"{str(dtype)[6:]:7s} tiles {plan.n_tiles:6d} fill "
                      f"{plan.fill:.4f}: max|kernel-plain| vpu {errs[0]:.3e}"
                      f", mxu {errs[1]:.3e}; bitwise repeatable, raw route "
                      "equal", flush=True)
    # K8: (nb, bsz, rt, k, stream)
    for nb, bsz, rt, k, stream in ((301, 8, 4, 40, torch.float32),
                                   (301, 8, 4, 40, torch.bfloat16),
                                   (53, 16, 5, 7, torch.float32),
                                   (130, 24, 3, 200, torch.float32),
                                   (64, 24, 3, 33, torch.bfloat16)):
        cols_b, valid = _band_pattern(nb, 2, empty=(nb // 2,))
        a = _bell(cols_b, valid, bsz, torch.float32, seed=nb + k)
        plan = cb.build_banded_plan(a, row_tile=rt, max_window=96,
                                    slot_valid=valid)
        tiles = cuda_dband.densify_tiles(a, plan, stream)
        b = torch.from_numpy(rng.standard_normal((a.n, k))).float().cuda()
        b3 = torch.cat([b.reshape(nb, bsz, k), b.new_zeros(plan.W, bsz, k)])
        args = (tiles, plan.start, b3, nb, bsz, k, plan.W, rt, torch.float32)
        label = (f"K8 nb={nb} bsz={bsz} rt={rt} W={plan.W} k={k} "
                 f"stream={str(stream)[6:]}")
        # both sides take the same operands rounded to the stream and sum
        # in float32: float32's tolerance on the rounded inputs' |A||B|
        err, _ = _twice_vs_plain(label, lambda: cuda_dband.dband_spmm(*args),
                                 lambda: cuda_dband.dband_spmm_plain(*args),
                                 _abs_bound(a, b, stream), torch.float32)
        print(f"   {label}: max|kernel-plain| {err:.3e}; bitwise repeatable",
              flush=True)


def _band_csr_default_device():
    """band-10M (phase 4's draws) built from host arrays with no
    ``device=``: (CSR, v, SciPy CSR)."""
    import scipy.sparse as sp

    import sparse_tpu_torch as pt

    rng = np.random.default_rng(4)
    n = 500_000
    rows, cols = _band_triples(n, 20, 1000, rng)
    vals = (rng.standard_normal(rows.size) * 0.01).astype(np.float32)
    v_np = rng.standard_normal(n).astype(np.float32)
    a = pt.csr_from_coo(pt.coo_make((n, n), rows, cols, vals))
    if a.data.device != torch.device("cuda", 0):
        raise AssertionError(f"band built on {a.data.device}, not cuda:0")
    s = sp.coo_matrix((vals.astype(np.float64), (rows, cols)),
                      shape=(n, n)).tocsr()
    return a, torch.from_numpy(v_np).cuda(), s, v_np


def phase14_slice(wsub0, m):
    """The slice at full width through the entry points: band-10M on the
    default device, plans at (rows, layout) in {8, 32} x {ff, rigid} at the
    wsub smvm_prepare picked (the next wider one if a plan overflows int32
    slot positions), each through ``csr_smvm_segtile`` with reduce vpu and
    mxu against SciPy; ``dband_spmm`` on bench.py's band with
    ``build_banded_plan(a, row_tile=5, max_window=96)`` (measure_dband.py's
    call) in float32 and the bf16 stream against K4's ``bell_spmm(plan=kit)``
    and SciPy; ``mm_read`` of the three Matrix Market files onto the card,
    ``smvm_prepare(...).apply(v)`` and the variant plans against SciPy."""
    import scipy.io
    import scipy.sparse as sp

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_dband

    t0 = time.perf_counter()
    a, v, s, v_np = _band_csr_default_device()
    torch.cuda.synchronize()
    print(f"   band-10M built on {a.data.device} from host arrays in "
          f"{time.perf_counter() - t0:.2f} s; smvm_prepare's wsub {wsub0}",
          flush=True)
    ref = torch.from_numpy(s @ v_np.astype(np.float64)).cuda()
    bound = abs_bound(s, v_np)
    plans = {}
    for r, layout in _VARIANTS:
        wsub = wsub0
        t0 = time.perf_counter()
        while True:
            try:
                plan = pt.build_seg_tiles(a, wsub=wsub, rows=r, layout=layout)
                break
            except ValueError as e:
                wider = {8: 16, 16: 32}.get(wsub)
                print(f"   rows={r} {layout} wsub={wsub}: {e}; next wider "
                      f"wsub {wider}", flush=True)
                if wider is None:
                    raise
                wsub = wider
        t_plan = time.perf_counter() - t0
        errs = []
        for reduce in ("vpu", "mxu"):
            y = pt.csr_smvm_segtile(a, v, plan, reduce=reduce)
            torch.cuda.synchronize()
            errs.append(check_close(f"band rows={r} {layout} {reduce} vs "
                                    "scipy", y, ref, bound, torch.float32))
        plans[(r, layout)] = plan
        print(f"   band rows={r:2d} {layout:5s} wsub={plan.wsub:2d}: tiles "
              f"{plan.n_tiles} fill {plan.fill:.4f} (plan {t_plan:.2f} s "
              f"host); max|y-scipy| vpu {errs[0]:.3e}, mxu {errs[1]:.3e}",
              flush=True)
    # K8 on bench.py's band, measure_dband.py's flow
    ab, b, kit, oracle = m["a"], m["b"], m["kit"], m["oracle"]
    nb, bsz, k = ab.nb, ab.bsz, b.shape[1]
    t0 = time.perf_counter()
    dplan = pt.build_banded_plan(ab, row_tile=5, max_window=96)
    c4 = pt.bell_spmm(ab, b, plan=kit)
    dband = dict(plan=dplan, b=b, nb=nb, bsz=bsz, k=k)
    for stream in (torch.float32, torch.bfloat16):
        tiles = cuda_dband.densify_tiles(ab, dplan, stream)
        b3 = torch.cat([b.reshape(nb, bsz, k),
                        b.new_zeros(dplan.W, bsz, k)]).to(stream)
        c8 = cuda_dband.dband_spmm(tiles, dplan.start, b3, nb, bsz, k,
                                   dplan.W, 5, torch.float32)
        torch.cuda.synchronize()
        name = str(stream)[6:]
        e4 = check_close(f"K8 {name} vs K4", c8, c4,
                         _abs_bound(ab, b, stream), stream)
        es = oracle.check(f"K8 {name} vs scipy", c8, b, stream)
        dband[stream] = (tiles, b3)
        print(f"   dband_spmm {name}: W={dplan.W} rt=5 tiles "
              f"{tuple(tiles.shape)} -> {tuple(c8.shape)}; max|C8-C4| "
              f"{e4:.3e}, max|C8-scipy| {es:.3e} on {oracle.rows.numel()} "
              f"rows", flush=True)
    print(f"   K8 plan + densify + runs {time.perf_counter() - t0:.2f} s",
          flush=True)
    # Matrix Market files onto the card
    rng = np.random.default_rng(14)
    for path in sorted((ROOT / "benchmarks" / "matrices").glob("*.mtx")):
        t0 = time.perf_counter()
        am = pt.mm_read(path)
        if not (am.data.is_cuda and am.indptr.is_cuda):
            raise AssertionError(f"mm_read({path.name}) is not on the card")
        t_read = time.perf_counter() - t0
        sm = sp.csr_matrix(scipy.io.mmread(path))
        vm_np = rng.standard_normal(am.shape[1])
        vm = torch.from_numpy(vm_np).cuda()
        want = torch.from_numpy(sm @ vm_np).cuda()
        bnd = abs_bound(sm, vm_np)
        prep = pt.smvm_prepare(am)
        errs = [check_close(f"{path.stem} apply", prep.apply(vm), want, bnd,
                            torch.float64)]
        for r, layout in _VARIANTS:
            plan = pt.build_seg_tiles(am, wsub="auto", rows=r, layout=layout)
            for reduce in ("vpu", "mxu"):
                errs.append(check_close(
                    f"{path.stem} rows={r} {layout} {reduce}",
                    pt.csr_smvm_segtile(am, vm, plan, reduce=reduce), want,
                    bnd, torch.float64))
        print(f"   {path.name}: {am.shape[0]}x{am.shape[1]} nnz "
              f"{int(am.indptr[-1])} float64 read in {t_read:.2f} s; rung "
              f"{prep.kind}; apply and 8 variant runs max|y-scipy| "
              f"{max(errs):.3e}", flush=True)
    return dict(a=a, v=v, s=s, plans=plans, dband=dband, kit=kit)


def phase15_timing(card, sl, m, band_lib, launches):
    """Every band-10M variant plan x reduce through ``csr_smvm_segtile``
    and K8 (float32, bf16 stream, each with the work its vote body issues,
    K4's kit route and vote route on the same band timed beside it)
    against their plain versions in turns
    (plain, kernel, kernel, plain), alone and back to back, with
    nnz_roofline at csr_min_bytes and the compact stream's bytes, and the
    entry point's dependency-chained time
    (``timed_op``); a 1 GiB device copy as the card's streaming rate."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bell as cb
    from sparse_tpu_torch.ops import cuda_csr, cuda_dband
    from sparse_tpu_torch.utils.profiling import timed_op
    from sparse_tpu_torch.utils.stats import (HBM_CEILING_GBPS,
                                              csr_min_bytes, nnz_roofline)

    a, v = sl["a"], sl["v"]
    n = a.shape[0]
    nnz = int(a.indptr[-1])
    min_bytes = csr_min_bytes(a)
    cost = csr_spmv_cost(a)
    print(f"   band-10M kernel bound: csr_bound_bytes {cost[0]} B = "
          f"csr_min_bytes {min_bytes} B + {cost[0] - min_bytes} B of CSR "
          f"indices; {bound_ms(*cost)[0]:.4f} ms", flush=True)
    ref = None
    out = []
    # the yardstick again, in this phase's conditions (phase 6's reading
    # stays in its K1 entry)
    lib, libs = library_csr_ms("CSR @ v (band-10M, phase 15)", a, v, card)
    print(f"   phase 6 read the library at {band_lib[0]:.4f} ms", flush=True)
    for (r, layout), plan in sl["plans"].items():
        stream_bytes = cuda_csr.segtile_stream_bytes(plan)
        for reduce in ("vpu", "mxu"):
            def kern():
                return pt.csr_smvm_segtile(a, v, plan, reduce=reduce)

            def plain():
                return cuda_csr.segtile_stream_plain(plan.stream, v)

            cell = f"band r{r} {layout} {reduce}"
            y, yp = kern(), plain()
            if ref is None:
                ref = abs_bound(sl["s"], v.double().cpu().numpy())
            err = check_close(cell, y, yp, ref, torch.float32)
            ms_k, ms_p = _time_in_turns(cell, "K1", kern, plain, None, nnz,
                                        stream_bytes, card)
            rl = nnz_roofline(nnz, min_bytes=min_bytes,
                              plan_bytes=stream_bytes, seconds=ms_k / 1e3)
            print(f"   {cell}: nnz_roofline at {HBM_CEILING_GBPS:.0f} GB/s: "
                  + ", ".join(f"{key} {val:.4g}" for key, val in rl.items()),
                  flush=True)
            chained = timed_op(
                lambda w, plan=plan, reduce=reduce: pt.csr_smvm_segtile(
                    a, w, plan, reduce=reduce), v)
            print(f"   {cell}: csr_smvm_segtile chained (timed_op, 10 "
                  f"dependent applies, each rescaled): {chained * 1e3:.4f} "
                  f"ms per apply [{card}]", flush=True)
            if (r, layout, reduce) == (32, "ff", "vpu"):
                out.append(kernel_entry(
                    "K1-r32 segtile_csr rows=32",
                    "sparse_tpu_torch/csrc/segtile_csr.cu",
                    "sparse_tpu/ops/pallas_csr.py:531", launches["K1-r32"],
                    err, ms_k, ms_p, cost, lib, LIBRARY_CSR,
                    bytes_per_stored_entry=plan.stream.bytes_per_entry,
                    library_ms_by_index=libs))
            if (r, layout, reduce) == (8, "ff", "mxu"):
                out.append(kernel_entry(
                    "K1-mxu segtile_mxu",
                    "sparse_tpu_torch/csrc/segtile_mxu.cu",
                    "sparse_tpu/ops/pallas_csr.py:565", launches["K1-mxu"],
                    err, ms_k, ms_p, cost, lib, LIBRARY_CSR,
                    bytes_per_stored_entry=plan.stream.bytes_per_entry,
                    library_ms_by_index=libs))
    d = sl["dband"]
    plan, nb, bsz, k = d["plan"], d["nb"], d["bsz"], d["k"]
    nbz = int(m["slot_valid"].sum())
    for stream in (torch.float32, torch.bfloat16):
        tiles, b3 = d[stream]
        args = (tiles, plan.start, b3, nb, bsz, k, plan.W, 5, torch.float32)

        def kern():
            return cuda_dband.dband_spmm(*args)

        def plain():
            return cuda_dband.dband_spmm_plain(*args)

        bound = _abs_bound(m["a"], d["b"], stream)
        c = spmm_cost(nbz, bsz, nb * bsz, k)
        if stream == torch.bfloat16:
            rec = entry["bf16_stream"] = bf16_stream_record(
                "K8", kern, plain, bound, m, d["b"], card)
            rec["issued_gflop"] = check_issued(
                "K8 bf16 stream", tiles, plan.start, b3.reshape(-1, k), bsz,
                c[1]) / 1e9
            kit_bf = cb.bell_banded_prepare(m["a"], row_tile=5,
                                            compute_dtype=stream,
                                            slot_valid=m["slot_valid"])
            b_bf = d["b"].to(stream)
            kit_beside("K8 bf16 stream", rec, card, **{
                "K4-kit": lambda: pt.bell_spmm(m["a"], b_bf, plan=kit_bf),
                "K4 (vote body, the kit's tiles)":
                    lambda: cb.bell_spmm_banded(
                        m["a"], b_bf, kit_bf.plan, tiles=kit_bf.tiles,
                        compute_dtype=stream)})
            del kit_bf, b_bf
            continue
        err, _ = _twice_vs_plain("K8 float32 at the bench shape", kern,
                                 plain, bound, torch.float32)
        _, ms_p = _report_spmm("K8 float32 plain", plain, c[1], c[0], card)
        _, ms_k = _report_spmm("K8 float32 kernel", kern, c[1], c[0], card)
        _report_spmm("K8 float32 kernel", kern, c[1], c[0], card)
        _report_spmm("K8 float32 plain", plain, c[1], c[0], card)
        issued = check_issued("K8 float32", tiles, plan.start,
                              b3.reshape(-1, k), bsz, c[1])
        lib, call = library_spmm(m, d["b"], card, "k 128, K8")
        entry = kernel_entry(
            "K8 dband_spmm", "sparse_tpu_torch/csrc/bell_banded.cu",
            "benchmarks/measure_dband.py:57", launches["K8"], err, ms_k,
            ms_p, c, lib, call, issued_gflop=issued / 1e9,
            useful_gflop=c[1] / 1e9,
            sm_clock_power=_clock_line("K8 float32 kernel", kern, card))
        entry["geometry"] = band_geometry_line("K8 float32", tiles, k, card)
        entry["sha256"] = f32_digest("K8 float32", kern, card)["sha256"]
        kit = m["kit"]
        kit_beside("K8 float32", entry, card, **{
            "K4-kit": lambda: pt.bell_spmm(m["a"], d["b"], plan=kit),
            "K4 (vote body, the kit's tiles)": lambda: cb.bell_spmm_banded(
                m["a"], d["b"], kit.plan, tiles=kit.tiles)})
    out.append(entry)
    # the card's streaming rate: 20 chained copies of 1 GiB
    x = torch.empty(1 << 28, device="cuda").normal_()
    y = torch.empty_like(x)

    def copies():
        for i in range(20):
            (y if i % 2 == 0 else x).copy_(x if i % 2 == 0 else y)

    ms = median_ms(copies, warmup=1, n=5)
    rate = 20 * 2 * x.numel() * 4 / (ms / 1e3) / 1e12
    print(f"   device copy, 20 x 1 GiB chained: {ms:.3f} ms = {rate:.3f} "
          f"TB/s read + write, against 3.35 TB/s on the data sheet "
          f"[{card}]", flush=True)
    del x, y
    return out


# -- slice 5: the direct solver, preconditioners, algebra, packed formats ---

#: benchmarks/suite.py:1134-1189: the block band's block size and
#: half-width, and the block-column counts of its LU section
LU_BSZ, LU_HALF = 32, 2
LU_NBS = (256, 1024, 4096)
#: the SPD band of its solver section (suite.py:1207-1208)
SPD_NB = 2000
#: the size of the packed-format products (the blocked packed path) and of
#: the mono matrix
PACKED_N = 8192
MONO_N = 500_000
#: a solve's relative residual ||A x - b|| / ||b|| (float32), and its
#: relative distance from SciPy's float64 solve
RESID_TOL = 1e-4
SOLVE_TOL = 1e-3


def _suite_bands(nbs=(256, 1024, 4096), spd_nb=SPD_NB):
    """The float32 block bands of ``benchmarks/suite.py:1137-1166``
    (``block_band``: bsz 32, half-width 2, one pool of 521 blocks of
    N(0, 0.05^2) from ``default_rng(21)``, +4 I on the diagonal blocks; the
    SPD variant mirrors the blocks and symmetrizes the diagonal ones) in the
    suite's draw order: the band and the sweep's right-hand side for nb
    256, 1024 and 4096, then the SPD band at nb 2000.  Returns ({nb: (rows,
    cols, blocks)}, (rows, cols, blocks) of the SPD band)."""
    bsz, half = LU_BSZ, LU_HALF
    rng = np.random.default_rng(21)

    def block_band(nb, spd=False):
        rows, cols = [], []
        for off in range(-half, half + 1):
            r = np.arange(max(0, -off), min(nb, nb - off), dtype=np.int64)
            rows.append(r)
            cols.append(r + off)
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        pool = rng.standard_normal(521 * bsz * bsz).astype(np.float32) * 0.05
        blocks = pool.reshape(521, bsz, bsz)[np.arange(rows.size) % 521]
        if spd:
            mirror = {(int(r), int(c)): i
                      for i, (r, c) in enumerate(zip(rows, cols))}
            for i, (r, c) in enumerate(zip(rows, cols)):
                if r < c:
                    blocks[mirror[(int(c), int(r))]] = blocks[i].T
                elif r == c:
                    blocks[i] = (blocks[i] + blocks[i].T) / 2 \
                        + np.eye(bsz, dtype=np.float32) * 4.0
        else:
            blocks[rows == cols] += np.eye(bsz, dtype=np.float32) * 4.0
        return rows, cols, blocks

    bands = {}
    for nb in nbs:
        bands[nb] = block_band(nb)
        rng.standard_normal(nb * bsz)  # the suite's sweep right-hand side
    return bands, block_band(spd_nb, spd=True)


def _band_bsr(nb, band):
    """The port's BSR (on the card) and SciPy's float64 CSR of a band."""
    import scipy.sparse as sp

    from sparse_tpu_torch import interop

    rows, cols, blocks = band
    a = interop.bsr_from_arrays(rows * nb + cols, blocks, nb * LU_BSZ,
                                LU_BSZ)
    s = sp.bsr_matrix((blocks.astype(np.float64), cols,
                       np.searchsorted(rows, np.arange(nb + 1))),
                      shape=(nb * LU_BSZ,) * 2).tocsr()
    return a, s


def _host_s(fn):
    """Host seconds of ``fn()`` with the card synchronised on each side;
    returns (seconds, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _same_bits(label, *pairs):
    for x, y in pairs:
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: two runs differ")


def _rel(x, y):
    """||x - y|| / ||y|| in float64."""
    return float(torch.linalg.vector_norm(x.double() - y.double())
                 / torch.linalg.vector_norm(y.double()))


def phase16_direct_solver(card, bands):
    """The direct solver at the suite's block band (nb in ``LU_NBS``):
    ``bsr_lu_find_fills`` + ``bsr_lu_numeric_prepare`` (host),
    ``bsr_lu_numeric_apply(pivot=True)``, ``bsr_factorize(a).solve(b)`` and
    ``bsr_forsolve``, each on the host clock around the card; the residual
    through ``smvm_prepare(bsr_to_csr(a)).apply``, the port's SpMV main
    path (the caller reads its kernel's launch count around this phase);
    ``x`` against SciPy's float64 ``spsolve``; two runs bitwise equal.
    Plain PyTorch: no hand-written kernel runs in the factorization."""
    import scipy.sparse.linalg as spla

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.utils.validate import validate_bsr, validate_csr

    out = {}
    for nb in LU_NBS:
        a, s = _band_bsr(nb, bands[nb])
        n = a.n
        rng = np.random.default_rng(1600 + nb)
        b_np = rng.standard_normal(n).astype(np.float32)
        b = torch.from_numpy(b_np).cuda()
        t_sym, (fills, plan) = _host_s(lambda: (pt.bsr_lu_find_fills(a),
                                                pt.bsr_lu_numeric_prepare(a)))
        if fills.size:
            raise AssertionError(f"nb {nb}: the band has {len(fills)} fills")
        t_lu, (lu, p) = _host_s(lambda: pt.bsr_lu_numeric_apply(plan, a))
        t_lu2, (lu2, p2) = _host_s(lambda: pt.bsr_lu_numeric_apply(plan, a))
        _same_bits(f"nb {nb} bsr_lu_numeric_apply", (lu.blocks, lu2.blocks),
                   (p, p2))
        del lu2, p2
        t_fact, fact = _host_s(lambda: pt.bsr_factorize(a))
        _same_bits(f"nb {nb} bsr_factorize vs the numeric apply",
                   (fact.lu.blocks, lu.blocks), (fact.p, p))
        t_solve, x = _host_s(lambda: fact.solve(b))
        _same_bits(f"nb {nb} solve", (x, fact.solve(b)))
        t_fwd, y = _host_s(lambda: pt.bsr_forsolve(fact.lu, b[p.long()],
                                                   fact.fplan))
        if not torch.isfinite(x).all() or not torch.isfinite(y).all():
            raise AssertionError(f"nb {nb}: non-finite solve")
        # the residual through the SpMV main path
        t_csr, csr = _host_s(lambda: pt.bsr_to_csr(a))
        t_prep, splan = _host_s(lambda: pt.smvm_prepare(csr))
        resid = _rel(splan.apply(x), b)
        if not resid <= RESID_TOL:
            raise AssertionError(f"nb {nb}: ||Ax - b|| / ||b|| = {resid:.3e} "
                                 f"> {RESID_TOL}")
        t0 = time.perf_counter()
        x_ref = spla.spsolve(s.tocsc(), b_np.astype(np.float64),
                             permc_spec="NATURAL")
        t_sp = time.perf_counter() - t0
        err = _rel(x, torch.from_numpy(x_ref).cuda())
        if not err <= SOLVE_TOL:
            raise AssertionError(f"nb {nb}: ||x - x_spsolve|| / ||x_spsolve||"
                                 f" = {err:.3e} > {SOLVE_TOL}")
        t_val, _ = _host_s(lambda: (validate_bsr(a), validate_bsr(fact.lu),
                                    validate_csr(csr)))
        mb = a.blocks.numel() * a.blocks.element_size() / 1e6
        print(f"   nb {nb}: n {n}, {a.nbz} blocks ({mb:.1f} MB), no fill; "
              f"find_fills + numeric_prepare {t_sym:.3f} s; "
              f"bsr_lu_numeric_apply {t_lu:.3f} s, again {t_lu2:.3f} s "
              f"({t_lu / nb * 1e3:.3f} ms per block column); bsr_factorize "
              f"{t_fact:.3f} s; solve {t_solve:.3f} s; bsr_forsolve "
              f"{t_fwd:.3f} s (host clock around the card) [{card}]",
              flush=True)
        print(f"   nb {nb}: residual through smvm_prepare(bsr_to_csr(a))"
              f".apply, rung {splan.kind}: {resid:.3e}; |x - spsolve| / "
              f"|spsolve| {err:.3e} (SciPy float64, {t_sp:.2f} s); "
              f"bsr_to_csr {t_csr:.2f} s, smvm_prepare {t_prep:.2f} s; "
              f"validate_bsr x2 + validate_csr {t_val:.2f} s; bitwise "
              "repeatable", flush=True)
        out[nb] = dict(rung=splan.kind, find_fills_prepare_s=t_sym,
                       numeric_apply_s=t_lu, factorize_s=t_fact,
                       solve_s=t_solve, forsolve_s=t_fwd, residual=resid,
                       vs_spsolve=err)
        del a, s, lu, fact, x, y, csr, splan
    return out


def _check_rel(label, got, want, tol):
    err = _rel(got, want)
    if not err <= tol:
        raise AssertionError(f"{label}: relative error {err:.3e} > {tol}")
    return err


def _timed(label, fn, card):
    """One call's host seconds (first call), then back-to-back ms."""
    t, out = _host_s(fn)
    ms, fastest = pipelined_ms(fn, warmup=1, n=5, windows=3)
    print(f"   {label}: first call {t:.3f} s; {ms:.4f} ms back to back "
          f"(median window; fastest {fastest:.4f}) [{card}]", flush=True)
    return out, ms


def _phase17_preconditioners(card, spd):
    """block-Jacobi and ILU(0) on the SPD band at nb 2000, against NumPy /
    SciPy in float64."""
    import scipy.sparse.linalg as spla

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.utils.validate import validate_bsr, validate_csr

    rows, cols, blocks = spd
    nb = int(rows.max()) + 1
    a, s = _band_bsr(nb, spd)
    n = a.n
    rng = np.random.default_rng(17)
    v_np = rng.standard_normal(n).astype(np.float32)
    v = torch.from_numpy(v_np).cuda()
    a_csr = pt.bsr_to_csr(a)
    inv, ms_prep = _timed("block_jacobi_prepare(bs 32)",
                          lambda: pt.block_jacobi_prepare(a_csr, LU_BSZ), card)
    z, ms_app = _timed("block_jacobi_apply",
                       lambda: pt.block_jacobi_apply(inv, v), card)
    inv64 = np.linalg.inv(blocks[rows == cols].astype(np.float64))
    vb = v_np.astype(np.float64).reshape(nb, LU_BSZ)
    z_ref = np.einsum("bij,bj->bi", inv64, vb).reshape(-1)
    bound = np.einsum("bij,bj->bi", np.abs(inv64), np.abs(vb)).reshape(-1)
    e_bj = check_close("block_jacobi_apply vs numpy", z,
                       torch.from_numpy(z_ref).cuda(),
                       torch.from_numpy(bound).cuda(), torch.float32)
    if pt.bsr_lu_find_fills(a).size:
        raise AssertionError("the SPD band has fill: ILU(0) is not exact")
    t_ilu, m = _host_s(lambda: pt.bsr_ilu0_preconditioner(a))
    t_app, w = _host_s(lambda: m(v))
    _same_bits("ILU(0) apply", (w, m(v)))
    w64 = w.double().cpu().numpy()
    back = _check_rel("A M(v) vs v", torch.from_numpy(s @ w64),
                      torch.from_numpy(v_np.astype(np.float64)), RESID_TOL)
    x_ref = spla.spsolve(s.tocsc(), v_np.astype(np.float64),
                         permc_spec="NATURAL")
    e_ilu = _check_rel("M(v) vs spsolve", w, torch.from_numpy(x_ref).cuda(),
                       SOLVE_TOL)
    validate_bsr(a)
    validate_csr(a_csr)
    print(f"   SPD band nb {nb} (n {n}): block-Jacobi max|z - numpy| "
          f"{e_bj:.3e} (within 1e-5 |M||v|); ILU(0) set-up {t_ilu:.3f} s, "
          f"apply {t_app:.3f} s (host clock), ||A M(v) - v|| / ||v|| "
          f"{back:.3e}, |M(v) - spsolve| / |spsolve| {e_ilu:.3e} [{card}]",
          flush=True)
    return dict(block_jacobi_prepare_ms=ms_prep, block_jacobi_apply_ms=ms_app,
                ilu0_setup_s=t_ilu, ilu0_apply_s=t_app, ilu0_residual=back)


def _phase17_csr_algebra(card, a, s):
    """``csr_sub(A, σ·csr_eye)`` and ``csr_add`` on band-10M: stored
    structure, capacity and nnz exactly against SciPy's union pattern,
    values within 1e-5 of |A| + σ against SciPy in float64 on A's stored
    float32 values (``s``, the float64 draws, gives the pattern)."""
    import scipy.sparse as sp

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.utils.validate import validate_csr

    n = a.shape[0]
    k0 = int(a.indptr[-1])
    sa = sp.csr_matrix((a.data[:k0].double().cpu().numpy(),
                        a.indices[:k0].cpu().numpy(),
                        a.indptr.cpu().numpy()), shape=a.shape)
    if not (np.array_equal(sa.indptr, s.indptr)
            and np.array_equal(sa.indices, s.indices)):
        raise AssertionError("band-10M: stored pattern differs from SciPy's")
    sigma = 0.5
    eye = pt.csr_scale(sigma, pt.csr_eye(n, n, a.dtype))
    sub, ms_sub = _timed("csr_sub(A, σ I) on band-10M",
                         lambda: pt.csr_sub(a, eye), card)
    add, ms_add = _timed("csr_add(A - σ I, A)", lambda: pt.csr_add(sub, a),
                         card)
    i64 = sp.identity(n, format="csr")
    union = (abs(sa) + i64).tocsr()
    union.sort_indices()
    for label, c, nse, ref, bnd in (
            ("csr_sub", sub, a.nse + n, sa - sigma * i64,
             abs(sa) + sigma * i64),
            ("csr_add", add, 2 * a.nse + n, 2 * sa - sigma * i64,
             2 * abs(sa) + sigma * i64)):
        if c.nse != nse:
            raise AssertionError(f"{label}: capacity {c.nse}, expected {nse}")
        k = int(c.indptr[-1])
        if not (np.array_equal(c.indptr.cpu().numpy(), union.indptr)
                and np.array_equal(c.indices[:k].cpu().numpy(),
                                   union.indices)):
            raise AssertionError(f"{label}: stored structure differs from "
                                 "the union pattern")
        ref, bnd = ref.tocsr(), bnd.tocsr()
        for m in (ref, bnd):
            m.sort_indices()
        if ref.nnz != k or bnd.nnz != k:  # SciPy drops exact zeros
            raise AssertionError(f"{label}: an entry cancelled exactly")
        nnz = int(pt.csr_nnz(c))
        if nnz != k:
            raise AssertionError(f"{label}: nnz {nnz} != {k} stored")
        err = check_close(f"{label} values", c.data[:k],
                          torch.from_numpy(ref.data).cuda(),
                          torch.from_numpy(bnd.data).cuda(), torch.float32)
        validate_csr(c)
        print(f"   {label}: capacity {c.nse}, {k} stored = SciPy's union of "
              f"A's pattern and I, nnz {nnz}; max|value - SciPy| "
              f"{err:.3e}", flush=True)
    validate_csr(a)
    return dict(csr_sub_ms=ms_sub, csr_add_ms=ms_add)


def _phase17_bsr_algebra(card, ab):
    """``bsr_add`` / ``bsr_mul`` of the elasticity BSR and a BSR on every
    third of its blocks (random values): structure, capacity and nnz
    exactly, values against NumPy in float64."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.utils.validate import validate_bsr

    idx = ab.indices.cpu().numpy().astype(np.int64)
    blocks = ab.blocks.double().cpu().numpy()
    sel = np.flatnonzero(idx % 3 == 0)
    rng = np.random.default_rng(171)
    bvals = rng.standard_normal((sel.size, 2, 2)).astype(np.float32)
    b = pt.BSR(indices=ab.indices[torch.from_numpy(sel).cuda()],
               blocks=torch.from_numpy(bvals).cuda(), n=ab.n, bsz=2)
    add, ms_add = _timed(f"bsr_add ({ab.nbz} + {b.nbz} 2x2 blocks)",
                         lambda: pt.bsr_add(ab, b), card)
    mul, ms_mul = _timed("bsr_mul", lambda: pt.bsr_mul(ab, b), card)
    want_add = blocks.copy()
    want_add[sel] += bvals
    bnd_add = np.abs(blocks)
    bnd_add[sel] += np.abs(bvals)
    want_mul = blocks[sel] * bvals
    for label, c, nbz, want_idx, want, bnd in (
            ("bsr_add", add, ab.nbz + b.nbz, idx, want_add, bnd_add),
            ("bsr_mul", mul, ab.nbz, idx[sel], want_mul, np.abs(want_mul))):
        k = want_idx.size
        got_idx = c.indices.cpu().numpy().astype(np.int64)
        if c.nbz != nbz or not np.array_equal(got_idx[:k], want_idx) \
                or not (got_idx[k:] == ab.sentinel).all():
            raise AssertionError(f"{label}: stored structure or capacity "
                                 "differs")
        err = check_close(f"{label} values", c.blocks[:k],
                          torch.from_numpy(want).cuda(),
                          torch.from_numpy(bnd).cuda(), torch.float32)
        nnz = int(pt.bsr_nnz(c))
        if nnz != int(np.count_nonzero(want)):
            raise AssertionError(f"{label}: nnz {nnz} != NumPy's")
        validate_bsr(c)
        print(f"   {label}: capacity {c.nbz}, {k} stored blocks, nnz {nnz}; "
              f"max|value - numpy| {err:.3e}", flush=True)
    validate_bsr(ab)
    validate_bsr(b)
    return dict(bsr_add_ms=ms_add, bsr_mul_ms=ms_mul)


def _packed_oracle(label, got, dense_a, dense_b, lower):
    """Every packed entry against the float64 product on the card, within
    1e-5 (|A||B|)."""
    ref = dense_a.double() @ dense_b.double()
    bnd = dense_a.double().abs() @ dense_b.double().abs()
    mask = torch.tril if lower else torch.triu
    return check_close(label, got.double(), mask(ref), mask(bnd),
                       torch.float32)


def _phase17_packed(card):
    """``tri_smm`` and ``trap_smm`` at n = PACKED_N (the blocked packed
    path) against the float64 product, every entry, and NumPy float64 on
    sampled entries; ``msr_smvm`` on a MONO_N-row permutation with scale,
    bit for bit against NumPy's float32 product."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.formats import trapezoidal as trap_mod
    from sparse_tpu_torch.formats import triangular as tri_mod
    from sparse_tpu_torch.utils.validate import validate_msr

    n = PACKED_N
    if n <= tri_mod._TRI_DENSE_MAX:
        raise AssertionError("PACKED_N does not reach the blocked path")
    gen = torch.Generator(device="cuda").manual_seed(172)
    P = pt.tri_elements(n)
    ta = pt.Triangular(torch.randn(P, device="cuda", generator=gen), n, True)
    tb = pt.Triangular(torch.randn(P, device="cuda", generator=gen), n, True)
    tc, ms_tri = _timed(f"tri_smm n {n} ({P} packed entries, "
                        f"{P * 4 / 1e6:.1f} MB)", lambda: pt.tri_smm(ta, tb),
                        card)
    e_tri = _packed_oracle("tri_smm vs float64", pt.tri_todense(tc),
                           pt.tri_todense(ta), pt.tri_todense(tb), True)
    # NumPy float64 on sampled entries of the packed data
    ad, bd, cd = (x.data.cpu().numpy() for x in (ta, tb, tc))
    rng = np.random.default_rng(173)
    B = tri_mod._TRI_BLOCK  # sample both sides of a tile boundary
    rows = np.r_[0, n - 1, n - 1, B - 1, B, rng.integers(0, n, 120)]
    cols = np.r_[0, 0, n - 1, B - 1, 0,
                 [rng.integers(0, r + 1) for r in rows[5:]]]
    for r, c in zip(rows, cols):
        k = np.arange(c, r + 1)
        ar = ad[r * (r + 1) // 2 + k].astype(np.float64)
        bc = bd[k * (k + 1) // 2 + c].astype(np.float64)
        if abs(cd[r * (r + 1) // 2 + c] - ar @ bc) \
                > TOL[torch.float32] * (np.abs(ar) @ np.abs(bc)):
            raise AssertionError(f"tri_smm ({r}, {c}) vs numpy")
    del ta, tb, tc, ad, bd, cd
    m, k = n * 3 // 4, n
    xa = pt.Trapezoidal(torch.randn(pt.trap_elements(n, m), device="cuda",
                                    generator=gen), n, m, True)
    xb = pt.Trapezoidal(torch.randn(pt.trap_elements(m, k), device="cuda",
                                    generator=gen), m, k, True)
    if max(n, m, k) <= trap_mod._TRAP_DENSE_MAX:
        raise AssertionError("trap_smm does not reach the blocked path")
    xc, ms_trap = _timed(f"trap_smm ({n} x {m}) @ ({m} x {k})",
                         lambda: pt.trap_smm(xa, xb), card)
    e_trap = _packed_oracle("trap_smm vs float64", pt.trap_todense(xc),
                            pt.trap_todense(xa), pt.trap_todense(xb), True)
    del xa, xb, xc
    # mono: a permutation with scale
    perm = np.random.default_rng(174).permutation(MONO_N)
    vals = np.random.default_rng(175).standard_normal(MONO_N).astype(
        np.float32)
    v_np = np.random.default_rng(176).standard_normal(MONO_N).astype(
        np.float32)
    msr = pt.msr_from_triples(MONO_N, MONO_N, zip(range(MONO_N),
                                                  perm.tolist(),
                                                  vals.tolist()),
                              dtype=torch.float32)
    v = torch.from_numpy(v_np).cuda()
    y, ms_mono = _timed(f"msr_smvm ({MONO_N} rows)",
                        lambda: pt.msr_smvm(msr, v), card)
    if not np.array_equal(y.cpu().numpy(), vals * v_np[perm]):
        raise AssertionError("msr_smvm differs from numpy's float32 product")
    validate_msr(msr)
    print(f"   tri_smm max|C - float64| {e_tri:.3e}, trap_smm {e_trap:.3e} "
          f"(within 1e-5 |A||B| at every entry; tri_smm also against numpy "
          f"float64 at {rows.size} sampled entries); msr_smvm equal to "
          "numpy's float32 product", flush=True)
    return dict(tri_smm_ms=ms_tri, trap_smm_ms=ms_trap, msr_smvm_ms=ms_mono)


def phase17_precond_algebra_packed(card, spd, band, ela_bsr):
    """Preconditioners on the SPD band, the CSR algebra on band-10M, the
    BSR algebra on elasticity-400k, the packed formats at n = 8192 and the
    mono SpMV, each against SciPy / NumPy in float64, with the matrices
    validated."""
    out = _phase17_preconditioners(card, spd)
    out.update(_phase17_csr_algebra(card, *band))
    out.update(_phase17_bsr_algebra(card, ela_bsr))
    out.update(_phase17_packed(card))
    return out


# -- slice 6: the distributed layer ------------------------------------------

#: shards of the distributed phase's in-process mesh, and the solver
#: section's iteration count (benchmarks/suite.py:1220)
DIST_D = 4
DIST_ITERS = 15
#: benchmarks/gen_fixtures.powerlaw_graph's size for the hub-split cell
POWERLAW_N = 1_000_000
#: a relative residual at or below this is at the float64 rounding floor of
#: a 64,000-row system (~sqrt(n) eps): two runs of the same iterations can
#: only agree that both are there (relative agreement is held above it)
RESID_FLOOR = 1e-13


def _dist_ms(label, fn, card, n=N_TIMED, windows=5):
    """Back-to-back ms of ``fn`` (median window), printed with the card."""
    ms, fastest = pipelined_ms(fn, warmup=2, n=n, windows=windows)
    print(f"   {label}: {ms:.4f} ms back to back (median window of {n}; "
          f"fastest {fastest:.4f}) [{card}]", flush=True)
    return ms


def _launched(label, module, name, fn, want):
    """Run ``fn`` once; the kernel counter ``module.name`` must rise by
    exactly ``want``."""
    before = getattr(module, name)
    out = fn()
    torch.cuda.synchronize()
    got = getattr(module, name) - before
    if got != want:
        raise AssertionError(f"{label}: {name} rose by {got}, expected "
                             f"{want}")
    return out


def _dist_vs_scipy(label, y, s, v64, n):
    """The first ``n`` rows of a distributed product against SciPy's in
    float64, within 1e-5 |A||v|."""
    ref = torch.from_numpy(s @ v64).cuda()
    bound = torch.from_numpy(abs(s) @ np.abs(v64)).cuda()
    if not torch.isfinite(y).all():
        raise AssertionError(f"{label}: non-finite values")
    return check_close(label, y[:n], ref, bound, torch.float32)


def _phase18_band(card, a, s, v_np):
    """band-10M on an in-process mesh of ``DIST_D`` shards: the five halo
    / all-gather entry points against SciPy, K1 once per shard per
    ``halo_spmv_segtile`` apply; then, at D = 1, ``halo_spmv_segtile``
    beside the bare K1 on the same compact stream (the reference's claim
    that a 1-device mesh runs within ~10% of the bare kernel,
    parallel/halo.py:600-603)."""
    import sparse_tpu_torch.parallel as par
    from sparse_tpu_torch.ops import cuda_csr

    n = a.shape[0]
    d = DIST_D
    mesh = par.make_1d_mesh(d)
    v64 = v_np.astype(np.float64)
    t = {}
    host = {}
    for name, build in (("pcsr", par.pcsr_from_csr),
                        ("halo", par.halo_partition),
                        ("halo_overlapped", par.halo_partition_overlapped),
                        ("halo_segtile", par.halo_partition_segtile)):
        host[name], t[name] = _host_s(lambda: build(a, mesh))
    v = par.shard_vector(torch.from_numpy(v_np), t["pcsr"], mesh)
    calls = {"pcsr_spmv": lambda: par.pcsr_spmv(t["pcsr"], v, mesh),
             "halo_spmv": lambda: par.halo_spmv(t["halo"], v, mesh),
             "halo_spmv_overlapped": lambda: par.halo_spmv_overlapped(
                 t["halo_overlapped"], v, mesh),
             "halo_spmv_segtile": lambda: par.halo_spmv_segtile(
                 t["halo_segtile"], v, mesh)}
    errs = {}
    for name, fn in calls.items():
        y = _launched(name, cuda_csr, "K1_LAUNCHES", fn,
                      d if name == "halo_spmv_segtile" else 0)
        errs[name] = _dist_vs_scipy(f"band-10M {name}", y, s, v64, n)
    rng = np.random.default_rng(18)
    b_np = rng.standard_normal((n, 32)).astype(np.float32)
    bm = par.shard_vector(torch.from_numpy(b_np), t["pcsr"], mesh)
    calls["halo_spmm_k32"] = lambda: par.halo_spmm(t["halo"], bm, mesh)
    errs["halo_spmm_k32"] = _dist_vs_scipy(
        "band-10M halo_spmm k=32", calls["halo_spmm_k32"](), s,
        b_np.astype(np.float64), n)
    hs = t["halo_segtile"]
    print(f"   band-10M over {d} shards: host build s "
          f"{ {k: round(x, 3) for k, x in host.items()} }; halo "
          f"{t['halo'].halo}, overlapped / segtile halo {hs.halo} "
          f"({hs.comm_entries_per_device} entries a shard), segtile wsub "
          f"{hs.wsub} fill {hs.fill:.4f}; max|y - scipy| "
          f"{ {k: float(f'{e:.3e}') for k, e in errs.items()} } "
          f"(within 1e-5 |A||v|); K1 {d} launches a segtile apply",
          flush=True)
    ms = {name: _dist_ms(f"band-10M D={d} {name}", fn, card,
                         n=5 if name in ("halo_spmm_k32",) else N_TIMED)
          for name, fn in calls.items()}
    # the 1-shard claim: the same compact stream, bare and through the mesh
    mesh1 = par.make_1d_mesh(1)
    hs1 = par.halo_partition_segtile(a, mesh1)
    v1 = par.shard_vector(torch.from_numpy(v_np), hs1, mesh1)
    stream = hs1.plans[0].stream
    v_op = torch.cat([v1, v1.new_zeros(hs1.halo)])
    y1 = _launched("D=1 halo_spmv_segtile", cuda_csr, "K1_LAUNCHES",
                   lambda: par.halo_spmv_segtile(hs1, v1, mesh1), 1)
    bare = cuda_csr.segtile_stream_apply(stream, v_op)
    if not torch.equal(y1, bare[:n]):
        raise AssertionError("D=1 halo_spmv_segtile differs from the bare "
                             "K1 on its stream")
    turns = []
    for which in ("bare", "dist", "dist", "bare"):
        fn = (lambda: cuda_csr.segtile_stream_apply(stream, v_op)) \
            if which == "bare" else \
            (lambda: par.halo_spmv_segtile(hs1, v1, mesh1))
        turns.append((which, pipelined_ms(fn, warmup=2)[0]))
    bare_ms = statistics.median([m for w, m in turns if w == "bare"])
    dist_ms = statistics.median([m for w, m in turns if w == "dist"])
    print(f"   D=1: halo_spmv_segtile {dist_ms:.4f} ms, bare K1 on the same "
          f"stream {bare_ms:.4f} ms back to back, in turns "
          f"{[(w, round(m, 4)) for w, m in turns]}: ratio "
          f"{dist_ms / bare_ms:.3f} (bitwise equal) [{card}]", flush=True)
    ms.update(d1_halo_spmv_segtile=dist_ms, d1_bare_k1=bare_ms)
    return dict(ms=ms, errs=errs, d1_ratio=dist_ms / bare_ms,
                host_build_s=host, halo=hs.halo, hs1=hs1, y1=y1, v1=v1)


def _phase18_phub(card):
    """``phub_spmv`` over ``DIST_D`` shards on ``gen_fixtures.
    powerlaw_graph(n=1_000_000, m=8, seed=2)`` (PERF.md's hub-split cell),
    float32, against SciPy."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from gen_fixtures import powerlaw_graph

    import sparse_tpu_torch.parallel as par
    from sparse_tpu_torch import interop

    t_gen, s = _host_s(lambda: powerlaw_graph(n=POWERLAW_N, m=8, seed=2))
    n = s.shape[0]
    a = interop.csr_from_arrays(s.data.astype(np.float32), s.indices,
                                s.indptr, s.shape)
    s = sp_csr_f64(a)
    mesh = par.make_1d_mesh(DIST_D)
    t_part, ph = _host_s(lambda: par.phub_partition(a, mesh))
    v_np = np.random.default_rng(19).standard_normal(n).astype(np.float32)
    pa_len = -(-n // DIST_D) * DIST_D
    v = par.put_sharded(np.concatenate(
        [v_np, np.zeros(pa_len - n, np.float32)]), mesh)
    err = _dist_vs_scipy("powerlaw phub_spmv", par.phub_spmv(ph, v, mesh),
                         s, v_np.astype(np.float64), n)
    print(f"   powerlaw graph n={n} nnz={s.nnz} (generated in {t_gen:.1f} "
          f"s): phub_partition {t_part:.2f} s (hubs {ph.n_hub}, "
          f"{ph.hub_comm_entries_per_device} hub entries a shard); "
          f"max|y - scipy| {err:.3e}", flush=True)
    ms = _dist_ms(f"powerlaw D={DIST_D} phub_spmv",
                  lambda: par.phub_spmv(ph, v, mesh), card, n=5)
    return dict(ms={"phub_spmv": ms}, errs={"phub_spmv": err}, nnz=s.nnz,
                gen_s=t_gen, graph=s)


def sp_csr_f64(a):
    """SciPy float64 CSR of the port's CSR (its stored entries)."""
    import scipy.sparse as sp

    k = int(a.indptr[-1])
    return sp.csr_matrix((a.data[:k].double().cpu().numpy(),
                          a.indices[:k].cpu().numpy(),
                          a.indptr.cpu().numpy()), shape=a.shape)


def _phase18_pbell(card, m):
    """``pbell_smvm`` and ``pbell_spmm`` (k = 128) over ``DIST_D`` shards
    on bench.py's block band (phase 8's BELL), against SciPy on phase 8's
    subset of block rows."""
    import sparse_tpu_torch.parallel as par

    a, b, oracle = m["a"], m["b"], m["oracle"]
    n = a.n
    mesh = par.make_1d_mesh(DIST_D)
    t_part, pe = _host_s(lambda: par.pbell_from_bell(a, mesh))
    v = b[:, :1].contiguous()
    vs = par.pbell_shard_vector(v[:, 0], pe, mesh)
    bs = par.pbell_shard_vector(b, pe, mesh)
    errs = {"pbell_smvm": oracle.check("pbell_smvm",
                                       par.pbell_smvm(pe, vs, mesh)[:n]
                                       .reshape(n, 1), v),
            "pbell_spmm_k128": oracle.check(
                "pbell_spmm k=128", par.pbell_spmm(pe, bs, mesh)[:n], b)}
    print(f"   bench BELL over {DIST_D} shards: pbell_from_bell "
          f"{t_part:.2f} s, rows_p {pe.rows_per_shard}; max|y - scipy| "
          f"{ {k: float(f'{e:.3e}') for k, e in errs.items()} } on "
          f"{oracle.rows.numel()} rows", flush=True)
    ms = {"pbell_smvm": _dist_ms(f"bell-band-80M D={DIST_D} pbell_smvm",
                                 lambda: par.pbell_smvm(pe, vs, mesh), card),
          "pbell_spmm_k128": _dist_ms(
              f"bell-band-80M D={DIST_D} pbell_spmm k=128",
              lambda: par.pbell_spmm(pe, bs, mesh), card, n=5)}
    return dict(ms=ms, errs=errs)


# -- float64 NumPy / SciPy runs of the solvers' own iterations ---------------


def _np_safe(den):
    return 1.0 if den == 0 else den


def _np_pcg(s, b, M, iters):
    x, r = np.zeros_like(b), b.copy()
    z = M(r)
    p, rz = z.copy(), r @ z
    for _ in range(iters):
        ap = s @ p
        alpha = rz / _np_safe(p @ ap)
        x, r = x + alpha * p, r - alpha * ap
        z = M(r)
        rz_new = r @ z
        p = z + rz_new / _np_safe(rz) * p
        rz = rz_new
    return x


def _np_bicgstab(s, b, iters):
    x, r, p, r_hat = np.zeros_like(b), b.copy(), b.copy(), b.copy()
    rho = b @ b
    for _ in range(iters):
        v = s @ p
        alpha = rho / _np_safe(r_hat @ v)
        sv = r - alpha * v
        t = s @ sv
        omega = (t @ sv) / _np_safe(t @ t)
        x = x + alpha * p + omega * sv
        r = sv - omega * t
        rho_new = r_hat @ r
        p = r + rho_new / _np_safe(rho) * (alpha / _np_safe(omega)) \
            * (p - omega * v)
        rho = rho_new
    return x


def _np_normalize(x, thresh=None):
    norm = np.sqrt(x @ x)
    thresh = np.finfo(np.float64).eps if thresh is None else thresh
    return (x / norm, norm) if norm > thresh else (np.zeros_like(x), 0.0)


def _np_gmres(s, b, restart, iters):
    """One or more restarts of the batched GMRES the port and the reference
    run (jax.scipy's ``_gmres_batched``), unpreconditioned."""
    x = np.zeros_like(b)
    unit, norm = _np_normalize(b - s @ x)
    for _ in range(iters):
        if not norm > 0:
            break
        V = np.zeros((b.size, restart + 1))
        V[:, 0] = unit
        H = np.eye(restart, restart + 1)
        for k in range(restart):
            v = s @ V[:, k]
            _, n0 = _np_normalize(v)
            h = V.T @ v
            v = v - V @ h
            u, n1 = _np_normalize(v, np.finfo(np.float64).eps * n0)
            h[k + 1] = n1
            V[:, k + 1], H[k] = u, h
            if n1 == 0:
                break
        beta = np.zeros(restart + 1)
        beta[0] = norm
        A = H.T
        y = np.linalg.solve(A.T @ A, A.T @ beta)
        x = x + V[:, :-1] @ y
        unit, norm = _np_normalize(b - s @ x)
    return x


def _resid_agree(label, r, r_ref):
    """The port's relative residual against the float64 run's, within 1e-3
    relative, or both at the float64 floor."""
    if r_ref > RESID_FLOOR:
        ok = abs(r - r_ref) <= 1e-3 * r_ref
    else:
        ok = r <= RESID_FLOOR
    if not ok:
        raise AssertionError(f"{label}: residual {r:.3e}, float64 NumPy "
                             f"{r_ref:.3e}")


def _phase18_solvers(card, spd):
    """The solvers on the suite's SPD block band at nb 2000 (64,000 rows,
    suite.py:1197-1208), ``DIST_ITERS`` iterations, through ``PCSR`` and
    ``HaloSegtile`` (K1 per shard) at D = 1 and ``DIST_D``: CG, PCG with
    Jacobi, block-Jacobi and ILU(0), BiCGSTAB and GMRES(15) — in float64
    (the suite's float32 draws, widened: after 15 steps these systems sit
    below float32's resolution, so only float64 can be held against
    NumPy's same iterations).  ms per iteration of the second call on the
    host clock around the card; each relative residual against the same
    iterations in float64 NumPy / SciPy."""
    import scipy.sparse.linalg as spla

    import sparse_tpu_torch as pt
    import sparse_tpu_torch.parallel as par
    from sparse_tpu_torch import interop

    rows, cols, blocks = spd
    nb = int(rows.max()) + 1
    a_bsr = interop.bsr_from_arrays(rows * nb + cols,
                                    blocks.astype(np.float64),
                                    nb * LU_BSZ, LU_BSZ)
    a = pt.bsr_to_csr(a_bsr)
    s = sp_csr_f64(a)
    n = a.shape[0]
    b_np = np.random.default_rng(20).standard_normal(n)
    b_norm = np.linalg.norm(b_np)
    inv_d = 1.0 / s.diagonal()
    inv_blocks64 = np.linalg.inv(blocks[rows == cols].astype(np.float64))
    lu = spla.splu(s.tocsc(), permc_spec="NATURAL")
    refs = {
        "cg": _np_pcg(s, b_np, lambda r: r, DIST_ITERS),
        "pcg_jacobi": _np_pcg(s, b_np, lambda r: inv_d * r, DIST_ITERS),
        "pcg_block_jacobi": _np_pcg(
            s, b_np, lambda r: np.einsum(
                "bij,bj->bi", inv_blocks64,
                r.reshape(nb, LU_BSZ)).reshape(-1), DIST_ITERS),
        "pcg_ilu0": _np_pcg(s, b_np, lu.solve, DIST_ITERS),
        "bicgstab": _np_bicgstab(s, b_np, DIST_ITERS),
        "gmres": _np_gmres(s, b_np, DIST_ITERS, 1)}
    r_ref = {k: float(np.linalg.norm(b_np - s @ x) / b_norm)
             for k, x in refs.items()}
    out = {}
    for d in (1, DIST_D):
        mesh = par.make_1d_mesh(d)
        parts = {"pcsr": par.pcsr_from_csr(a, mesh),
                 "segtile": par.halo_partition_segtile(a, mesh)}
        pa = parts["pcsr"]
        L = pa.rows_per_shard * d
        bv = par.shard_vector(torch.from_numpy(b_np), pa, mesh)
        invv = par.shard_vector(torch.from_numpy(inv_d), pa, mesh)
        bj = pt.block_jacobi_prepare(a, LU_BSZ, padded_n=L)
        ilu = pt.bsr_ilu0_preconditioner(a_bsr, padded_n=L)
        for kind, part in parts.items():
            runs = {
                "cg": lambda: par.cg_solve(part, bv, mesh, iters=DIST_ITERS),
                "pcg_jacobi": lambda: par.pcg_solve(part, bv, invv, mesh,
                                                    iters=DIST_ITERS),
                "pcg_block_jacobi": lambda: par.pcg_solve(
                    part, bv, bj, mesh, iters=DIST_ITERS),
                "pcg_ilu0": lambda: par.pcg_solve(part, bv, ilu, mesh,
                                                  iters=DIST_ITERS),
                "bicgstab": lambda: par.bicgstab_solve(part, bv, mesh,
                                                       iters=DIST_ITERS),
                "gmres": lambda: par.gmres_solve(part, bv, mesh,
                                                 restart=DIST_ITERS,
                                                 iters=1)}
            for name, fn in runs.items():
                x = fn()
                t, x2 = _host_s(fn)
                if not torch.equal(x, x2):
                    raise AssertionError(f"{name} {kind} D={d}: two runs "
                                         "differ")
                xh = x[:n].cpu().numpy()
                r = float(np.linalg.norm(b_np - s @ xh) / b_norm)
                label = f"{name} {kind} D={d}"
                _resid_agree(label, r, r_ref[name])
                out[label] = dict(ms_per_iter=t / DIST_ITERS * 1e3,
                                  residual=r, residual_float64=r_ref[name])
                print(f"   spd-band-2000 {label}: "
                      f"{t / DIST_ITERS * 1e3:.4f} ms per iteration "
                      f"({DIST_ITERS} iterations, host clock); residual "
                      f"{r:.3e}, float64 NumPy {r_ref[name]:.3e} [{card}]",
                      flush=True)
    return dict(solvers=out, b=b_np, a=a, s=s)


def _csr_of_pcsr(p):
    """SciPy float64 CSR of a row-partitioned CSR on an in-process mesh."""
    import scipy.sparse as sp

    ptr = p.indptr.long().cpu().numpy()
    rows_p = p.rows_per_shard
    data, idx, lens = [], [], []
    for i in range(ptr.shape[0]):
        k = ptr[i, -1]
        data.append(p.data[i, :k].double().cpu().numpy())
        idx.append(p.indices[i, :k].cpu().numpy())
        lens.append(np.diff(ptr[i]))
    indptr = np.concatenate([[0], np.cumsum(np.concatenate(lens))])
    return sp.csr_matrix((np.concatenate(data), np.concatenate(idx),
                          indptr[: p.shape[0] + 1]), shape=p.shape)


def _sparse_vs(label, got, want, bound):
    """The same non-zero pattern as SciPy's, values within 1e-5 |A||B|
    (exact zeros dropped on both sides); returns the max abs error."""
    got, want = got.tocsr(), want.tocsr()
    for m in (got, want):
        m.eliminate_zeros()
        m.sort_indices()
    if not (np.array_equal(got.indptr, want.indptr)
            and np.array_equal(got.indices, want.indices)):
        raise AssertionError(f"{label}: stored pattern differs from SciPy's")
    diff = abs(got - want)
    over = (diff - TOL[torch.float32] * bound).max()
    if over > 0:
        raise AssertionError(f"{label}: error exceeds 1e-5 |A||B| by "
                             f"{over:.3e}")
    return float(diff.max())


def _phase18_spgemm(card, ela_bsr):
    """``pcsr_spgemm_aa`` (A @ A) and ``pcsr_transpose_device`` over
    ``DIST_D`` shards on elasticity-400k taken as CSR, against SciPy, then
    ``pbsr_smsmm`` and ``pbsr_smsmm_slab`` (K7 once per shard per apply)
    on spgemm-block-181k against SciPy's product on phase 11's subset of
    block rows."""
    import sparse_tpu_torch as pt
    import sparse_tpu_torch.parallel as par
    from sparse_tpu_torch import interop
    from sparse_tpu_torch.ops import cuda_bsr

    d = DIST_D
    mesh = par.make_1d_mesh(d)
    a = pt.bsr_to_csr(ela_bsr)
    s = sp_csr_f64(a)
    pa = par.pcsr_from_csr(a, mesh)
    t_plan, plan = _host_s(lambda: par.build_pspgemm_plan(pa, pa, mesh))
    c = par.pcsr_spgemm_aa(pa, pa, mesh, plan)
    cs = _csr_of_pcsr(c)
    err_aa = _sparse_vs("elasticity pcsr_spgemm_aa", cs, s @ s,
                        abs(s) @ abs(s))
    t_tplan, tplan = _host_s(lambda: par.build_transpose_plan(pa, mesh))
    at = par.pcsr_transpose_device(pa, mesh, tplan)
    ats = _csr_of_pcsr(at)
    err_t = _sparse_vs("elasticity pcsr_transpose_device", ats,
                       s.T.tocsr(), abs(s).T.tocsr())
    print(f"   elasticity-400k as CSR over {d} shards: build_pspgemm_plan "
          f"{t_plan:.2f} s (cap {plan.cap}, {plan.comm_entries_per_device} "
          f"entries a shard), build_transpose_plan {t_tplan:.2f} s; A @ A "
          f"nnz {cs.nnz} max|C - scipy| {err_aa:.3e}; A^T max err "
          f"{err_t:.3e}", flush=True)
    ms = {"pcsr_spgemm_aa": _dist_ms(
        f"elasticity D={d} pcsr_spgemm_aa",
        lambda: par.pcsr_spgemm_aa(pa, pa, mesh, plan), card, n=3,
        windows=3),
        "pcsr_transpose_device": _dist_ms(
        f"elasticity D={d} pcsr_transpose_device",
        lambda: par.pcsr_transpose_device(pa, mesh, tplan), card)}
    del c, cs, at, ats

    sb, rows, cols, bvals = _spgemm_fixture()
    nb = 2_000
    oracle = _ScipyBlockRows(sb)
    ab = interop.bsr_from_arrays(rows * nb + cols, bvals, nb * 32, 32)
    pb = par.pbsr_from_bsr(ab, mesh)
    t_bplan, bplan = _host_s(lambda: par.build_pbsr_smsmm_plan(pb, pb, mesh))
    t_splan, splan = _host_s(
        lambda: par.build_pbsr_smsmm_plan_slab(pb, pb, mesh))
    pc = par.pbsr_smsmm(pb, pb, mesh, bplan)
    err_b = oracle.check("pbsr_smsmm",
                         pt.bsr_to_csr(par.pbsr_to_bsr(pc)))
    ps = _launched("pbsr_smsmm_slab", cuda_bsr, "K7_LAUNCHES",
                   lambda: par.pbsr_smsmm_slab(pb, pb, mesh, splan), d)
    err_s = oracle.check("pbsr_smsmm_slab",
                         pt.bsr_to_csr(par.pbsr_to_bsr(ps)))
    print(f"   spgemm-block-181k over {d} shards: build_pbsr_smsmm_plan "
          f"{t_bplan:.2f} s, _slab {t_splan:.2f} s ({bplan.cap} products "
          f"a shard at most, {bplan.comm_entries_per_device} values a "
          f"shard); max|C - scipy| {err_b:.3e} / {err_s:.3e} (slab, K7 "
          f"{d} launches an apply)", flush=True)
    ms["pbsr_smsmm"] = _dist_ms(f"spgemm-block-181k D={d} pbsr_smsmm",
                                lambda: par.pbsr_smsmm(pb, pb, mesh, bplan),
                                card, n=5)
    ms["pbsr_smsmm_slab"] = _dist_ms(
        f"spgemm-block-181k D={d} pbsr_smsmm_slab",
        lambda: par.pbsr_smsmm_slab(pb, pb, mesh, splan), card, n=5)
    return dict(ms=ms, errs={"pcsr_spgemm_aa": err_aa,
                             "pcsr_transpose_device": err_t,
                             "pbsr_smsmm": err_b, "pbsr_smsmm_slab": err_s})


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _phase18_nccl(card, a, band, solver):
    """The process-group route on NCCL at world size 1: the mesh's
    collectives are NCCL's ``all_to_all_single`` / ``all_gather`` /
    ``all_reduce``; ``halo_spmv_segtile`` on band-10M and ``cg_solve``
    (PCSR) on the SPD band must equal the in-process D = 1 results within
    rtol 1e-6."""
    import torch.distributed as dist

    import sparse_tpu_torch.parallel as par

    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
        rank=0)
    try:
        mesh = par.make_1d_mesh(1, group=dist.group.WORLD)
        hs = par.halo_partition_segtile(a, mesh)
        y = par.halo_spmv_segtile(hs, band["v1"], mesh)
        pa = par.pcsr_from_csr(solver["a"], mesh)
        bv = par.shard_vector(torch.from_numpy(solver["b"]), pa, mesh)
        x = par.cg_solve(pa, bv, mesh, iters=DIST_ITERS)
        mesh1 = par.make_1d_mesh(1)
        x_in = par.cg_solve(par.pcsr_from_csr(solver["a"], mesh1),
                            par.shard_vector(torch.from_numpy(solver["b"]),
                                             pa, mesh1), mesh1,
                            iters=DIST_ITERS)
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    errs = {}
    for label, got, want in (("halo_spmv_segtile", y, band["y1"]),
                             ("cg_solve", x, x_in)):
        e = float((got.double() - want.double()).abs().max()
                  / want.double().abs().max())
        if not e <= 1e-6:
            raise AssertionError(f"NCCL world 1 {label}: {e:.3e} from the "
                                 "in-process mesh")
        errs[label] = e
    print(f"   {backend} world 1 on {mesh.device}: halo_spmv_segtile and "
          f"cg_solve against the in-process D=1 results, max rel diff "
          f"{errs}", flush=True)
    return errs


def phase18_distributed(card, band_run, spmm_run, spd, ela_bsr, launches):
    """The distributed layer (``sparse_tpu_torch.parallel``) at the cells'
    sizes: band-10M, the 1M-row power-law graph, bell-band-80M, the SPD
    band, elasticity-400k and spgemm-block-181k, each against SciPy; the
    process-group route on NCCL.  ``launches`` gets the K1 / K7 counts of
    the checked runs, read before the timed ones.  Returns the ``dist``
    record and the power-law graph (SciPy, float64) for phase 20."""
    from sparse_tpu_torch.ops import cuda_bsr, cuda_csr

    band = _phase18_band(card, band_run["a"], band_run["s"],
                         band_run["v"].cpu().numpy())
    phub = _phase18_phub(card)
    pbell = _phase18_pbell(card, spmm_run)
    solver = _phase18_solvers(card, spd)
    spgemm = _phase18_spgemm(card, ela_bsr)
    nccl = _phase18_nccl(card, band_run["a"], band, solver)
    launches.update(K1=cuda_csr.K1_LAUNCHES, K7=cuda_bsr.K7_LAUNCHES)
    ms = {**band["ms"], **phub["ms"], **pbell["ms"], **spgemm["ms"]}
    errs = {**band["errs"], **phub["errs"], **pbell["errs"],
            **spgemm["errs"]}
    return {"dist": {"shards": DIST_D, "ms": ms, "max_abs_err": errs,
                     "d1_segtile_over_bare_k1": band["d1_ratio"],
                     "solvers": solver["solvers"], "nccl_world1": nccl,
                     "card": card}}, phub["graph"]


# -- phase 19: the kernel routes under torch.func and autograd ---------------

#: slices of the main path's vmap (band-10M ``plan.apply``) and of the others
VMAP_MAIN, VMAP_OTHER = 4, 2
DERIVATIVE_MODES = ("backward", "autograd.grad", "func.grad", "func.jvp",
                    "forward-AD dual")


def _ask_derivative(fn, x, mode):
    """One way of asking for a derivative through ``fn`` at ``x``."""
    import torch.autograd.forward_ad as fwad

    if mode == "backward":
        xr = x.clone().requires_grad_(True)
        (fn(xr).sum() + xr.sum()).backward()  # no silent gradient of ones
        return xr.grad
    if mode == "autograd.grad":
        xr = x.clone().requires_grad_(True)
        return torch.autograd.grad(fn(xr).sum(), xr)
    if mode == "func.grad":
        return torch.func.grad(lambda y: fn(y).sum())(x)
    if mode == "func.jvp":
        return torch.func.jvp(fn, (x,), (torch.ones_like(x),))
    with fwad.dual_level():
        return fwad.unpack_dual(fn(fwad.make_dual(
            x, torch.ones_like(x)))).tangent


def _vmap_only(label, fn, xs, module, counter):
    """``torch.func.vmap(fn)(xs)``: ``module.counter`` must rise once a
    slice and each slice equal a single call bitwise.  Returns (launches,
    the batched result)."""
    before = getattr(module, counter)
    got = torch.func.vmap(fn)(xs)
    torch.cuda.synchronize()
    launched = getattr(module, counter) - before
    if launched != xs.shape[0]:
        raise AssertionError(f"{label}: vmap over {xs.shape[0]} launched "
                             f"{counter} {launched} times")
    for i in range(xs.shape[0]):
        if not torch.equal(got[i], fn(xs[i].clone())):
            raise AssertionError(f"{label}: vmap slice {i} differs from a "
                                 "single call")
    return launched, got


def _transforms_hold(label, fn, xs, module, counter):
    """``torch.func.vmap`` of ``fn`` over ``xs`` launches the kernel once a
    slice, each slice bitwise equal to a single call; every derivative
    through it raises ``NotImplementedError`` naming the two routes that
    differentiate; a forward on inputs that require grad still computes,
    bitwise.  Returns the vmap's launches."""
    launched, got = _vmap_only(label, fn, xs, module, counter)
    for mode in DERIVATIVE_MODES:
        try:
            _ask_derivative(fn, xs[0], mode)
        except NotImplementedError as e:
            if "CPU tensors" not in str(e) or \
                    "bsr_smsmm_apply_slab_ad" not in str(e):
                raise AssertionError(f"{label} {mode}: message {e}")
            continue
        raise AssertionError(f"{label}: {mode} returned a derivative "
                             "through the kernel")
    y = fn(xs[0].clone().requires_grad_(True))
    if not (y.requires_grad and torch.equal(y.detach(), got[0])):
        raise AssertionError(f"{label}: forward on a grad input differs")
    return launched


def _slab_ad_holds(label, a, b):
    """``bsr_smsmm_apply_slab_ad``: gradients through K7 (three launches)
    against autograd through the plain ``bsr_smsmm_apply`` within 1e-5 of
    |dC||B|-scaled; vmap over A's blocks bitwise equal to single applies;
    forward mode raises."""
    import dataclasses

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bsr

    plan = pt.bsr_smsmm_prepare(a, b)
    plans = pt.bsr_smsmm_slab_prepare_ad(plan, a.nbz, b.nbz)
    ct = torch.randn(plan.nbz_out, a.bsz, a.bsz, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(19))
    grads = []
    for apply in (lambda x: pt.bsr_smsmm_apply_slab_ad(plans, x, b),
                  lambda x: pt.bsr_smsmm_apply(plan, x, b)):
        leaf = a.blocks.clone().requires_grad_(True)
        before = cuda_bsr.K7_LAUNCHES
        apply(dataclasses.replace(a, blocks=leaf)).blocks.backward(ct)
        torch.cuda.synchronize()
        grads.append((leaf.grad, cuda_bsr.K7_LAUNCHES - before))
    (g, k7), (r, k7_plain) = grads
    if (k7, k7_plain) != (2, 0):  # forward + dA (B needs no gradient)
        raise AssertionError(f"{label}: K7 launches {k7} / {k7_plain}")
    # the bound: the same gradient of |dC| through |A| |B|
    leaf = a.blocks.abs().requires_grad_(True)
    pt.bsr_smsmm_apply(plan, dataclasses.replace(a, blocks=leaf),
                       dataclasses.replace(b, blocks=b.blocks.abs())
                       ).blocks.backward(ct.abs())
    over = float(((g - r).abs() - 2e-5 * leaf.grad).max())
    if over > 0:
        raise AssertionError(f"{label}: dA exceeds 2e-5 |dC||B| by "
                             f"{over:.3e}")
    err = float((g - r).abs().max())

    def fwd(x):
        return pt.bsr_smsmm_apply_slab_ad(
            plans, dataclasses.replace(a, blocks=x), b).blocks

    launched, _ = _vmap_only(label, fwd, torch.stack([a.blocks, -a.blocks]),
                             cuda_bsr, "K7_LAUNCHES")
    try:
        torch.func.jvp(fwd, (a.blocks,), (a.blocks,))
    except NotImplementedError:
        pass
    else:
        raise AssertionError(f"{label}: jvp through the AD route")
    return dict(grad_err=err, vmap_launches=launched)


def _host_us(fn, n=200):
    """Host microseconds per call of ``fn`` issued back to back (the
    enqueue: the card is synchronised before and after, not between)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


@contextlib.contextmanager
def _through_function():
    """Every kernel launch through the ``autograd.Function`` even with no
    transform in play (its cost beside the direct launch)."""
    from sparse_tpu_torch.ops import _transforms

    direct = _transforms._direct
    _transforms._direct = lambda tensors: False
    try:
        yield
    finally:
        _transforms._direct = direct


def _function_cost(card, apply):
    """Host us per call and back-to-back ms of ``apply`` launched directly
    and through the ``Function``, in turns (direct, function, function,
    direct)."""
    turns = []
    for which in ("direct", "function", "function", "direct"):
        ctx = _through_function() if which == "function" else \
            contextlib.nullcontext()
        with ctx:
            turns.append((which, _host_us(apply), pipelined_ms(apply)[0]))
    out = {}
    for which in ("direct", "function"):
        out[which] = dict(
            host_us=statistics.median(u for w, u, _ in turns if w == which),
            ms=statistics.median(m for w, _, m in turns if w == which))
    extra = out["function"]["host_us"] - out["direct"]["host_us"]
    print(f"   band-10M plan.apply host us per call / ms back to back, in "
          f"turns: {[(w, round(u, 2), round(m, 4)) for w, u, m in turns]}; "
          f"the Function adds {extra:.2f} us a call [{card}]", flush=True)
    return dict(turns=turns, **out)


def phase19_transforms(card, band, ela, spmm_run, slice_run, launches):
    """Every kernel route under ``torch.func`` and autograd, as the
    reference's ``pallas_call`` behaves under JAX's transforms: vmap over
    ``VMAP_MAIN`` vectors through band-10M's ``plan.apply`` (the main path,
    K1; ``launches`` gets its count, read with the count set to 0 just
    before) and over ``VMAP_OTHER`` operands of K2 (elasticity-400k's
    ``plan.apply``), K1-r32 / K1-mxu (band-10M's variant plans), K3-K6
    (bench.py's band), K7 (prepared and raw) and K8; each derivative
    through each raises; the differentiable K7 route keeps its gradients;
    the ``Function``'s host cost beside a direct launch."""
    import dataclasses

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import (cuda_bell, cuda_bsr, cuda_csr,
                                      cuda_csr_block, cuda_dband)

    gen = torch.Generator(device="cuda").manual_seed(19)
    plan, v = band["plan"], band["v"]
    vs = torch.randn(VMAP_MAIN, v.shape[0], device="cuda", generator=gen)
    cuda_csr.K1_LAUNCHES = 0
    got = torch.func.vmap(plan.apply)(vs)
    torch.cuda.synchronize()
    launches["K1"] = cuda_csr.K1_LAUNCHES  # read before the checks' calls
    if launches["K1"] != VMAP_MAIN:
        raise AssertionError(f"vmap over {VMAP_MAIN} band-10M vectors "
                             f"launched K1 {launches['K1']} times")
    for i in range(VMAP_MAIN):
        if not torch.equal(got[i], plan.apply(vs[i].clone())):
            raise AssertionError(f"band-10M vmap slice {i} differs")
    print(f"   band-10M plan.apply under vmap over {VMAP_MAIN} vectors: K1 "
          f"rose by {launches['K1']}, each slice bitwise equal to one "
          "apply", flush=True)
    sl, m = slice_run, spmm_run
    a, b, b32 = m["a"], m["b"], m["b32"]
    bs = torch.stack([b, -0.5 * b])
    rng = np.random.default_rng(19)
    ka = _rand_bsr(400, 32, 0.02, torch.float32, rng)
    kb = _rand_bsr(400, 32, 0.02, torch.float32, rng)
    kplan = pt.bsr_smsmm_prepare(ka, kb)
    pp = pt.bsr_smsmm_slab_prepare(kplan, ka.nbz, kb.nbz)
    z1 = cuda_bsr._append_zero(ka.blocks, torch.float32)
    z2 = cuda_bsr._append_zero(kb.blocks, torch.float32)
    raw_args, raw_kw = _slab_args(pp, z1, z2, torch.float32)
    dp = sl["dband"]
    tiles, b3 = dp[torch.float32]
    ev = ela["v"]
    p8, p32 = sl["plans"][(8, "ff")], sl["plans"][(32, "ff")]
    sv = torch.randn(VMAP_OTHER, sl["v"].shape[0], device="cuda",
                     generator=gen)
    cases = [
        ("band-10M plan.apply", plan.apply, vs, cuda_csr, "K1_LAUNCHES"),
        ("elasticity-400k plan.apply", ela["plan"].apply,
         torch.stack([ev, -ev]), cuda_csr_block, "K2_LAUNCHES"),
        ("K1-r32 csr_smvm_segtile", lambda x: pt.csr_smvm_segtile(
            sl["a"], x, p32), sv, cuda_csr, "K1_R32_LAUNCHES"),
        ("K1-mxu csr_smvm_segtile", lambda x: pt.csr_smvm_segtile(
            sl["a"], x, p8, reduce="mxu"), sv, cuda_csr, "K1_MXU_LAUNCHES"),
        ("K3 bell_spmm_fused", lambda x: cuda_bell.bell_spmm_fused(a, x), bs,
         cuda_bell, "K3_LAUNCHES"),
        ("K3 over BELL values", lambda x: cuda_bell.bell_spmm_fused(
            dataclasses.replace(a, blocks=x), b),
         torch.stack([a.blocks, 2 * a.blocks]), cuda_bell, "K3_LAUNCHES"),
        ("K4-kit bell_spmm(plan=kit)", lambda x: pt.bell_spmm(
            a, x, plan=m["kit"]), bs, cuda_bell, "K4_KIT_LAUNCHES"),
        ("K4 bell_spmm_banded(tiles=kit.tiles)", lambda x:
            cuda_bell.bell_spmm_banded(a, x, m["kit"].plan,
                                       tiles=m["kit"].tiles), bs, cuda_bell,
         "K4_LAUNCHES"),
        ("K5 bell_spmm(plan=kit_t)", lambda x: pt.bell_spmm(
            a, x, plan=m["kit_t"]), torch.stack([b32, 2 * b32]), cuda_bell,
         "K5_LAUNCHES"),
        ("K6 bell_spmm_block", lambda x: cuda_bell.bell_spmm_block(a, x), bs,
         cuda_bell, "K6_LAUNCHES"),
        ("K7 bsr_smsmm_apply_slab", lambda x: pt.bsr_smsmm_apply_slab(
            pp, dataclasses.replace(ka, blocks=x), kb).blocks,
         torch.stack([ka.blocks, -ka.blocks]), cuda_bsr, "K7_LAUNCHES"),
        ("K7 run_slabs_arrays", lambda x: cuda_bsr.run_slabs_arrays(
            *raw_args[:5], x, z2, **raw_kw), torch.stack([z1, 2 * z1]),
         cuda_bsr, "K7_LAUNCHES"),
        ("K8 dband_spmm", lambda x: cuda_dband.dband_spmm(
            tiles, dp["plan"].start, x, dp["nb"], dp["bsz"], dp["k"],
            dp["plan"].W, 5, torch.float32), torch.stack([b3, -b3]),
         cuda_dband, "K8_LAUNCHES"),
    ]
    vmapped = {}
    for label, fn, xs, module, counter in cases:
        vmapped[label] = _transforms_hold(label, fn, xs, module, counter)
        print(f"   {label}: vmap over {xs.shape[0]} launched "
              f"{counter[:-9]} {vmapped[label]} times, bitwise equal to "
              f"single calls; {', '.join(DERIVATIVE_MODES)} each raise "
              "NotImplementedError", flush=True)
    slab_ad = _slab_ad_holds("bsr_smsmm_apply_slab_ad", ka, kb)
    print(f"   bsr_smsmm_apply_slab_ad: dA through K7 within "
          f"{slab_ad['grad_err']:.3e} of the plain autograd (2e-5 |dC||B| "
          f"each); vmap launched K7 "
          f"{slab_ad['vmap_launches']} times; jvp raises", flush=True)
    cost = _function_cost(card, lambda: plan.apply(v))
    return dict(main_vmap_launches=launches["K1"], vmap_launches=vmapped,
                slab_ad=slab_ad, function_cost=cost, card=card)


# -- phase 20: the five examples at size -------------------------------------

#: the examples' sizes on the card (ROADMAP / PERF.md §4)
POISSON_K, POISSON_SHARDS = 1024, 4
FAST_CG_N, FAST_CG_SHARDS = 500_000, 4
GALERKIN_N, GALERKIN_STEPS = 1 << 20, 20
LU_EXAMPLE_BSZ, LU_EXAMPLE_NB = 4, 4096
#: float32 iterates against float64 NumPy running the same iterations
#: (phase 18's solver gate): relative residuals within this relative share,
#: or both at float32's attainable accuracy (``_float32_floor``)
ITER_AGREE = 1e-3
FLOAT32_ROUNDOFF = 2.0 ** -24


def _float32_floor(s, x, b, iters):
    """The relative residual below which ``iters`` float32 CG steps cannot
    resolve it: the gap between the true and the updated residual grows by
    about u (||A|| ||x|| + ||b||) a step (Greenbaum, SIAM J. Matrix Anal.
    Appl. 18, 1997), u = 2^-24, ||A|| bounded by its largest row sum."""
    norm_a = float(abs(s).sum(axis=1).max())
    return iters * FLOAT32_ROUNDOFF * (
        norm_a * np.linalg.norm(x) / np.linalg.norm(b) + 1.0)


def _np_chebyshev(s, lmax, degree):
    """``parallel.chebyshev_preconditioner``'s polynomial in float64."""
    lmin = lmax / 30.0
    d, c = (lmax + lmin) / 2.0, (lmax - lmin) / 2.0

    def apply(v):
        z, r, p, alpha = np.zeros_like(v), v, v, 1.0 / d
        for i in range(degree):
            if i > 0:
                beta = (c * alpha / 2.0) ** 2 if i > 1 else \
                    0.5 * (c * alpha) ** 2
                alpha = 1.0 / (d - beta / alpha)
                p = r + beta * p
            z = z + alpha * p
            r = r - alpha * (s @ p)
        return z

    return apply


def _agree(label, got, want, floor):
    """Phase 18's rule: within ``ITER_AGREE`` relative, or both at the
    floor."""
    if want > floor:
        ok = abs(got - want) <= ITER_AGREE * want
    else:
        ok = got <= floor
    if not ok:
        raise AssertionError(f"{label}: {got:.6e}, float64 NumPy's same "
                             f"iterations {want:.6e} (floor {floor:.3e})")


def _example_pagerank(card, graph, device):
    import torch_pagerank as ex

    p_mat = ex.transition(graph)
    out = {}
    for route in ("fast", "auto"):
        r = ex.pagerank(p_mat, device=device, route=route)
        ranks, oracle = r["ranks"], r["oracle"]
        rel = float(np.max(np.abs(ranks - oracle) / np.abs(oracle)))
        # the reference's gate holds at a million pages
        np.testing.assert_allclose(ranks, oracle, rtol=1e-5)
        top = np.argsort(ranks)[::-1][:5]
        if not np.array_equal(top, np.argsort(oracle)[::-1][:5]):
            raise AssertionError(f"pagerank {route}: top-5 differs")
        label = "build_spmv_plan + csr_smvm_fast" if route == "fast" else \
            f"smvm_prepare -> plan.apply (rung {r['rung']})"
        print(f"   pagerank n={p_mat.shape[0]} nnz={p_mat.nnz}, {label}: "
              f"top-5 pages {top.tolist()} ranks "
              f"{np.round(ranks[top], 7).tolist()}; max rel err vs float64 "
              f"{rel:.3e} (rtol 1e-5); {r['ms_per_step']:.4f} ms per step, "
              f"{r['build_s']:.2f} s host set-up [{card}]", flush=True)
        out[route] = dict(ms_per_step=r["ms_per_step"], build_s=r["build_s"],
                          max_rel_err=rel, rung=r["rung"])
    return out


def _example_poisson(card, device):
    import torch_poisson_cg as ex

    t0 = time.perf_counter()
    r = ex.poisson(POISSON_K, device=device, shards=POISSON_SHARDS)
    t_all = time.perf_counter() - t0
    s = r["s"].astype(np.float64)
    b = r["b"].astype(np.float64)
    x_true = r["x_true"].astype(np.float64)
    n, nb = s.shape[0], s.shape[0] // 4
    inv_d = 1.0 / s.diagonal()
    blk = np.zeros((nb, 4, 4))
    for i in range(4):
        for j in range(4):
            blk[:, i, j] = s[np.arange(nb) * 4 + i, np.arange(nb) * 4 + j].A1
    inv_blk = np.linalg.inv(blk)
    precs = {"jacobi": lambda x: inv_d * x,
             "block-jacobi(4)": lambda x: np.einsum(
                 "bij,bj->bi", inv_blk, x.reshape(nb, 4)).reshape(-1),
             "chebyshev(6)": _np_chebyshev(s, r["lmax"], 6)}
    out = {}
    for name, x in r["x"].items():
        iters = r["final_iters"] if " x" in name else r["iters"]
        x64 = _np_pcg(s, b, precs[name.split(" x")[0]], iters)
        err64 = np.linalg.norm(x64 - x_true) / np.linalg.norm(x_true)
        res = np.linalg.norm(b - s @ x) / np.linalg.norm(b)
        res64 = np.linalg.norm(b - s @ x64) / np.linalg.norm(b)
        floor = _float32_floor(s, x, b, iters)
        _agree(f"poisson {name} residual", res, res64, floor)
        sec = r["seconds"][name]
        print(f"   poisson grid {POISSON_K}x{POISSON_K} ({n} unknowns, "
              f"{s.nnz} entries) on {POISSON_SHARDS} shards, {iters} iters, "
              f"{name}: relative residual {res:.4e} (float64 NumPy "
              f"{res64:.4e}; float32 floor {floor:.2e}), relative error "
              f"{r['err'][name]:.4e} ({err64:.4e}); "
              f"{sec / iters * 1e3:.3f} ms per iteration [{card}]",
              flush=True)
        out[name] = dict(err=r["err"][name], err_float64=err64,
                         residual=res, residual_float64=res64,
                         float32_floor=floor, ms_per_iter=sec / iters * 1e3)
    print(f"   poisson: the reference's gate (error < 1e-4 after "
          f"{r['final_iters']} Chebyshev iterations) is for a 32 x 32 grid; "
          f"at {POISSON_K}^2 each run's residual is held to float64's same "
          f"iterations (within {ITER_AGREE}, or both below float32's "
          f"attainable accuracy), the error printed beside; {t_all:.1f} s "
          f"in all, lmax {r['lmax']:.4f}", flush=True)
    return out


def _example_fast_cg(card, device):
    import torch_fast_distributed_cg as ex

    from sparse_tpu_torch.ops import cuda_csr

    before = cuda_csr.K1_LAUNCHES
    r = ex.fast_cg(FAST_CG_N, device=device, shards=FAST_CG_SHARDS)
    k1 = cuda_csr.K1_LAUNCHES - before
    if device == "cuda" and (k1 <= 0 or k1 % FAST_CG_SHARDS):
        raise AssertionError(f"fast_distributed_cg: K1 rose by {k1}")
    if not r["rel"] < 1e-5:  # the reference's gate
        raise AssertionError(f"fast_distributed_cg: rel residual "
                             f"{r['rel']:.3e}")
    np.testing.assert_allclose(r["pcsr"], r["segtile"], rtol=2e-4,
                               atol=2e-4)
    print(f"   fast_distributed_cg n={FAST_CG_N} ({r['spd'].nnz} entries) "
          f"on {FAST_CG_SHARDS} shards: halo/shard {r['halo']}, worst tile "
          f"fill {r['fill']:.3f}; CG({r['iters']}) through HaloSegtile rel "
          f"residual {r['rel']:.3e} (< 1e-5), PCSR within 2e-4; ms per "
          f"iteration HaloSegtile "
          f"{r['seconds']['segtile'] / r['iters'] * 1e3:.3f}, PCSR "
          f"{r['seconds']['pcsr'] / r['iters'] * 1e3:.3f}; K1 launches "
          f"{k1}; {r['build_s']:.1f} s host set-up [{card}]", flush=True)
    return dict(rel=r["rel"], k1_launches=k1, build_s=r["build_s"],
                ms_per_iter={k: t / r["iters"] * 1e3
                             for k, t in r["seconds"].items()})


def _example_galerkin(card, device):
    import torch_galerkin_reuse as ex

    r = ex.galerkin(GALERKIN_N, device=device, steps=GALERKIN_STEPS)
    if not r["first_ok"]:  # the reference's np.allclose gate
        raise AssertionError(f"galerkin: first update off by "
                             f"{r['first_max_err']:.3e}")
    print(f"   galerkin_reuse n={GALERKIN_N} (A_c {r['nc']}x{r['nc']}, "
          f"{r['stored']} stored): {r['ms_per_step']:.3f} ms per update over "
          f"{GALERKIN_STEPS} updates (host clock, the CSR upload included), "
          f"plans {r['plan_s']:.2f} s; first update within np.allclose of "
          f"SciPy's R A P (max err {r['first_max_err']:.3e}) [{card}]",
          flush=True)
    return dict(ms_per_step=r["ms_per_step"], plan_s=r["plan_s"],
                stored=r["stored"], first_max_err=r["first_max_err"])


def _example_block_lu(card, device):
    import torch_block_lu_solve as ex

    r = ex.block_lu(LU_EXAMPLE_BSZ, LU_EXAMPLE_NB, device=device)
    if not r["resid"] < 1e-8:  # the reference's gate
        raise AssertionError(f"block_lu_solve: residual {r['resid']:.3e}")
    if not r["lu_err"] < 1e-10:
        raise AssertionError(f"block_lu_solve: |P.A - L.U| "
                             f"{r['lu_err']:.3e}")
    print(f"   block_lu_solve {LU_EXAMPLE_NB}x{LU_EXAMPLE_NB} blocks (bsz "
          f"{LU_EXAMPLE_BSZ}, n {r['n']}), fill-in blocks {r['fills']}; max "
          f"|P.A - L.U| {r['lu_err']:.3e}; ols residual {r['resid']:.3e}; "
          f"bsr_lup {r['seconds']['bsr_lup']:.3f} s, bsr_ols "
          f"{r['seconds']['bsr_ols']:.3f} s (host clock) [{card}]",
          flush=True)
    return dict(fills=r["fills"], lu_err=r["lu_err"], resid=r["resid"],
                host_s=r["seconds"])


def phase20_examples(card, graph, device="cuda"):
    """The five port examples (``examples/torch_*.py``) at size, through
    the functions their scripts call: PageRank on powerlaw-1M (phase 18's
    graph), 60 steps through the reference's plain route and through the
    main path; the 1024 x 1024 Poisson problem on 4 shards; the fast
    distributed CG at n = 500,000 on 4 shards; the Galerkin update at n =
    1,048,576; the block LU at nb 4096.  Each holds the reference's gate
    where it applies at size, else float64 NumPy's same iterations."""
    sys.path.insert(0, str(ROOT / "examples"))
    out = {}
    for name, run in (("pagerank", lambda: _example_pagerank(card, graph,
                                                             device)),
                      ("poisson_cg", lambda: _example_poisson(card, device)),
                      ("fast_distributed_cg", lambda: _example_fast_cg(
                          card, device)),
                      ("galerkin_reuse", lambda: _example_galerkin(card,
                                                                   device)),
                      ("block_lu_solve", lambda: _example_block_lu(card,
                                                                   device))):
        t0 = time.perf_counter()
        out[name] = run()
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"   {name}: {out[name]['seconds']:.1f} s", flush=True)
    return out


# -- phase 21: the rest of the public surface at size ------------------------

#: bf16x3's gate: three bf16 products leave out lo*lo and round each part,
#: at most 2^-15 of |A||B| beside float32's summation tolerance.
BF16X3_TOL = 2.0 ** -15 + 1e-5
#: The ESC core's cut: the full fixture's A @ A expands to 5.9e9 scalar
#: products (~95 GB of keys, values and order); the leading block
#: principal submatrix with at most this many products stands in for it.
ESC_MAX_PRODUCTS = 1 << 27
#: The dense SpGEMM core's operand: the leading 4096 x 4096 block of the
#: fixture, 3 * 4096^2 dense elements within ``_MXU_DENSE_ELEMS``.
MXU_N = 4096
TRI_INT_N = 2048


def _b2b(fn):
    """Back-to-back ms of ``fn``: the median of 5 windows of 20 calls, of
    one call for a path slower than 20 ms (its first call, on the host
    clock, is the warm-up); returns (median, fastest, calls a window)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = N_TIMED if time.perf_counter() - t0 < 0.02 else 1
    ms, fastest = pipelined_ms(fn, warmup=0, n=n, windows=5)
    return ms, fastest, n


def _gate(label, got, ref, bound, tol):
    """|got - ref| <= tol * bound elementwise, finite; returns max err."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}, or non-finite values")
    err = (got.double() - ref.double()).abs()
    over = float((err - tol * bound).max()) if err.numel() else 0.0
    if over > 0:
        raise AssertionError(f"{label}: error exceeds {tol:.3g} |A||x| by "
                             f"{over:.3e}")
    return float(err.max()) if err.numel() else 0.0


def _oracle(s, x64):
    """SciPy's float64 ``s @ x64`` and ``|s| |x64|`` on the card."""
    return (torch.from_numpy(s @ x64).cuda(),
            torch.from_numpy(abs(s) @ np.abs(x64)).cuda())


def _vs_scipy(label, y, s, x64, rows=None, tol=TOL[torch.float32],
              oracle=None):
    """``y`` (its first ``s.shape[0]`` rows, or ``rows``) against SciPy's
    float64 ``s @ x64`` (or a ready ``oracle`` of it) within ``tol``
    |A||x|."""
    ref, bound = oracle or _oracle(s, x64)
    got = y[:s.shape[0]] if rows is None else y[rows]
    return _gate(label, got, ref, bound, tol)


def _exact(label, got, want):
    """An integer result equal to NumPy's int64 answer (``want``, computed
    in float64 where every partial sum stays below 2^53)."""
    if got.dtype != torch.int32 or not got.is_cuda:
        raise AssertionError(f"{label}: {got.dtype} on {got.device}, "
                             "expected int32 on the card")
    want = np.asarray(want)
    if not np.array_equal(got.long().cpu().numpy(),
                          np.rint(want).astype(np.int64)):
        raise AssertionError(f"{label}: differs from NumPy's exact answer")
    return 0


class _Paths:
    """Phase 21's records: one line per path with its gate, back-to-back
    time, host set-up time and the card."""

    def __init__(self, card):
        self.card, self.out = card, {}

    def add(self, label, fn, err, setup_s=0.0, **extra):
        ms, fastest, n = _b2b(fn)
        self.out[label] = dict(max_abs_err=err, ms=ms, fastest_ms=fastest,
                               setup_s=setup_s, **extra)
        more = "".join(f"; {k} {v:.4f}" if isinstance(v, float)
                       else f"; {k} {v}" for k, v in extra.items())
        print(f"   {label}: gate passed (max err {err:.3e}); {ms:.4f} ms "
              f"back to back (median of 5 windows of {n}; fastest "
              f"{fastest:.4f}); set-up {setup_s:.3f} s (host){more} "
              f"[{self.card}]", flush=True)
        return ms


def _phase21_band(paths, a, s, v):
    """band-10M: the plain SpMV entry points, the ``xla`` and ``bell``
    rungs, the SpMM entry points at k 64 and the distributed SpMMs over
    ``DIST_D`` shards."""
    import sparse_tpu_torch as pt
    import sparse_tpu_torch.parallel as par

    n = a.shape[0]
    v64 = v.double().cpu().numpy()
    y = pt.csr_smvm(a, v)
    paths.add("band-10M csr_smvm", lambda: pt.csr_smvm(a, v),
              _vs_scipy("csr_smvm", y, s, v64))
    t, L = _host_s(lambda: pt.row_capacity(a))
    y = pt.csr_smvm_ell(a, v, L)
    paths.add("band-10M csr_smvm_ell", lambda: pt.csr_smvm_ell(a, v, L),
              _vs_scipy("csr_smvm_ell", y, s, v64), t, L=L)
    t, plan = _host_s(lambda: pt.build_spmv_plan(a))
    y = pt.csr_smvm_fast(a, v, plan)
    paths.add("band-10M csr_smvm_fast", lambda: pt.csr_smvm_fast(a, v, plan),
              _vs_scipy("csr_smvm_fast", y, s, v64), t,
              bins=len(plan.bin_sizes))
    _phase21_rungs(paths, "band-10M", a, s, v)
    gen = torch.Generator(device="cuda").manual_seed(21)
    b = torch.randn(n, 64, device="cuda", generator=gen)
    b64 = b.double().cpu().numpy()
    ab = _oracle(s, b64)
    y = pt.spmm(a, b)
    paths.add("band-10M spmm k 64", lambda: pt.spmm(a, b),
              _vs_scipy("spmm", y, s, b64, oracle=ab))
    y = pt.csr_spmm_fast(a, b, plan)
    paths.add("band-10M csr_spmm_fast k 64",
              lambda: pt.csr_spmm_fast(a, b, plan),
              _vs_scipy("csr_spmm_fast", y, s, b64, oracle=ab))
    t, ac = _host_s(lambda: pt.csc_from_coo(pt.csr_to_coo(a)))
    bt = b.T.contiguous()
    y = pt.dsmm(bt, ac)
    st = s.T.tocsr()
    paths.add("band-10M dsmm k 64", lambda: pt.dsmm(bt, ac),
              _vs_scipy("dsmm", y.T, st, b64), t)
    del y
    mesh = par.make_1d_mesh(DIST_D)
    t, pa = _host_s(lambda: par.pcsr_from_csr(a, mesh))
    bs = par.shard_vector(b, pa, mesh)
    y = par.pcsr_spmm(pa, bs, mesh)
    paths.add(f"band-10M pcsr_spmm k 64 D={DIST_D}",
              lambda: par.pcsr_spmm(pa, bs, mesh),
              _vs_scipy("pcsr_spmm", y, s, b64, oracle=ab), t)
    t, ho = _host_s(lambda: par.halo_partition_overlapped(a, mesh))
    bh = par.shard_vector(b, ho, mesh)
    y = par.halo_spmm_overlapped(ho, bh, mesh)
    paths.add(f"band-10M halo_spmm_overlapped k 64 D={DIST_D}",
              lambda: par.halo_spmm_overlapped(ho, bh, mesh),
              _vs_scipy("halo_spmm_overlapped", y, s, b64, oracle=ab), t)


def _phase21_rungs(paths, cell, a, s, v):
    """``smvm_prepare(prefer=...)`` -> ``plan.apply`` for the ``xla`` and
    ``bell`` rungs; the rung a plan took is printed (``bell`` needs natural
    blocks of bsz >= 8 and falls through to ``xla`` without them)."""
    import sparse_tpu_torch as pt

    v64 = v.double().cpu().numpy()
    for prefer in ("xla", "bell"):
        t, plan = _host_s(lambda: pt.smvm_prepare(a, prefer=prefer))
        y = plan.apply(v)
        paths.add(f"{cell} smvm_prepare(prefer={prefer!r}).apply",
                  lambda: plan.apply(v),
                  _vs_scipy(f"{cell} {prefer}", y, s, v64), t,
                  rung=plan.kind)


def _phase21_elasticity(paths, ab):
    """elasticity-400k (phase 5's block-RCM order, 2x2 blocks): the two
    rungs on its CSR, ``bsr_smvm_ell`` and ``bsr_spmm_ell`` at k 64."""
    import sparse_tpu_torch as pt

    a = pt.bsr_to_csr(ab)
    s = sp_csr_f64(a)
    gen = torch.Generator(device="cuda").manual_seed(22)
    v = torch.randn(a.shape[0], device="cuda", generator=gen)
    _phase21_rungs(paths, "elasticity-400k", a, s, v)
    t, lb = _host_s(lambda: pt.bsr_row_capacity(ab))
    y = pt.bsr_smvm_ell(ab, v, lb)
    paths.add("elasticity-400k bsr_smvm_ell",
              lambda: pt.bsr_smvm_ell(ab, v, lb),
              _vs_scipy("bsr_smvm_ell", y, s, v.double().cpu().numpy()), t,
              Lb=lb)
    b = torch.randn(a.shape[0], 64, device="cuda", generator=gen)
    y = pt.bsr_spmm_ell(ab, b, lb)
    paths.add("elasticity-400k bsr_spmm_ell k 64",
              lambda: pt.bsr_spmm_ell(ab, b, lb),
              _vs_scipy("bsr_spmm_ell", y, s, b.double().cpu().numpy()))
    return a, s


def _phase21_entry_spmm(paths):
    """``spmm``, ``csr_spmm_fast`` and ``dsmm`` at ``__graft_entry__``'s
    shape: 512 x 512 at density 0.05, k 64 (phase 8's draws)."""
    import scipy.sparse as sp

    import sparse_tpu_torch as pt

    rng = np.random.default_rng(0)
    dense = rng.standard_normal((512, 512)).astype(np.float32) * (
        rng.random((512, 512)) < 0.05)
    bb = rng.standard_normal((512, 64)).astype(np.float32)
    s = sp.csr_matrix(dense.astype(np.float64))
    a = pt.csr_from_dense(torch.from_numpy(dense).cuda())
    ac = pt.csc_from_dense(torch.from_numpy(dense).cuda())
    b = torch.from_numpy(bb).cuda()
    bt = b.T.contiguous()
    b64 = bb.astype(np.float64)
    for label, fn, got in (
            ("spmm", lambda: pt.spmm(a, b), lambda y: y),
            ("csr_spmm_fast", lambda: pt.csr_spmm_fast(a, b), lambda y: y),
            ("dsmm", lambda: pt.dsmm(bt, ac), lambda y: y.T)):
        err = (_vs_scipy(label, got(fn()), s, b64) if label != "dsmm" else
               _vs_scipy(label, got(fn()), s.T.tocsr(), b64))
        paths.add(f"entry 512x512 {label} k 64", fn, err)


def _phase21_kind(paths, label, kname, kern, plain, bound, tol_plain,
                  oracle_err, cost, dtype, lib, lib_call):
    """One stream kind of one of K3-K6, K4's kit route or K8 on
    bell-band-80M: twice, bitwise equal and launched each time (by
    ``kname``'s launch count, ``_launch_attr``), against its plain version
    within
    TOL[tol_plain] * ``bound`` and against SciPy (``oracle_err`` of the
    result, which applies the gate), then timed back to back beside its
    plain version, its bound (``cost`` (bytes, operations) at ``dtype``'s
    peak) and the library call; returns the record."""
    mod, attr = _launch_attr(kname)
    before = getattr(mod, attr)
    err_p, c = _twice_vs_plain(label, kern, plain, bound, tol_plain)
    launches = getattr(mod, attr) - before
    if launches != 2:
        raise AssertionError(f"{label}: {kname} launched {launches} times "
                             "for 2 calls")
    err = oracle_err(c)
    del c
    plain_ms = pipelined_ms(plain, warmup=1)[0]
    b_ms, b_by = bound_ms(*cost, dtype)
    ms = paths.add(f"bell-band-80M {label}", kern, err,
                   max_abs_err_vs_plain=err_p, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    if lib is not None:
        print(f"   {label}: {ms:.4f} ms against the library's {lib:.4f} "
              f"({lib_call}): {'faster' if ms < lib else 'SLOWER'}, "
              f"{lib / ms:.2f}x [{paths.card}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, library_call=lib_call, max_abs_err=err,
                max_abs_err_vs_plain=err_p, launches=launches)


def _phase21_bell(paths, m, dband, card):
    """bell-band-80M: ``bell_smvm`` at k 1; the bf16x3 tier of K3 and K4
    (the band body; K4 also through ``bell_spmm(plan=kit)``, its mask
    body, with the vote route and, in float64, K8 timed beside it), K6
    (the persistent body) at k 128 and of K5 at k 32
    (the chunk-mask body), each against SciPy, its plain version and ``BSR
    @ B`` in float32, with its issued work (K5's also the tile bytes it
    copied); then the float64 kinds at k 128 of K3, K4 and K8 (the band
    body on DMMA; K8 on phase 14's plan ``dband``) and K6 (the persistent
    body on DMMA), with their issued work, and of K5 at k 32 (the
    chunk-mask body, with its issued work and tile bytes) beside ``BSR @
    B`` in float64; the band body's kinds among them (K3's bf16x3 and the
    float64 kinds of K3, K4 and K8) with the SM clock and power
    ``nvidia-smi`` reads while each runs; then K6 at bsz 128 in every kind
    (``_phase21_k6_wide``).  Returns {kernel: {"bf16x3": record,
    "float64": record}}, K6's also with "bsz128": {kind: record}."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.formats.bell import BELL
    from sparse_tpu_torch.ops import cuda_bell as cb
    from sparse_tpu_torch.ops import cuda_dband

    a, b, b32, kit, kit_t = m["a"], m["b"], m["b32"], m["kit"], m["kit_t"]
    oracle, valid = m["oracle"], m["slot_valid"]
    v = b[:, 0].contiguous()
    y = pt.bell_smvm(a, v)
    vh = v.double().cpu().numpy()
    paths.add("bell-band-80M bell_smvm k 1", lambda: pt.bell_smvm(a, v),
              _vs_scipy("bell_smvm", y, oracle.s, vh, rows=oracle.rows))
    bh, bh32 = b.double().cpu().numpy(), b32.double().cpu().numpy()
    nbz, k = int(valid.sum()), b.shape[1]
    bt32 = b32.T.contiguous()
    f64 = torch.float64

    def vs_scipy(label, x, tol, transposed=False):
        return lambda c: _vs_scipy(label, c.T if transposed else c,
                                   oracle.s, x, rows=oracle.rows, tol=tol)

    def split_cost(kk):  # float32 operands and result, three bf16 products
        nbytes, flops = spmm_cost(nbz, a.bsz, a.n, kk)
        return nbytes, 3 * flops

    out = {"K3": {}, "K4": {}, "K4-kit": {}, "K5": {}, "K6": {}, "K8": {}}
    lib, call = library_spmm(m, b, card, "float32, the bf16x3 yardstick")
    bound = _abs_bound(a, b, torch.float32)
    x3 = "bf16x3"
    for kname, body, kern, plain in (
            ("K3", "band body", lambda: pt.bell_spmm(a, b, precision=x3),
             lambda: cb.bell_spmm_fused_plain(a, b, precision=x3)),
            ("K4-kit", "mask body, bell_spmm(plan=kit)",
             lambda: pt.bell_spmm(a, b, plan=kit, precision=x3),
             lambda: cb.bell_spmm_banded_plain(a, b, kit.plan,
                                               tiles=kit.tiles,
                                               precision=x3)),
            ("K4", "band body, the kit's tiles",
             lambda: cb.bell_spmm_banded(a, b, kit.plan, tiles=kit.tiles,
                                         precision=x3),
             lambda: cb.bell_spmm_banded_plain(a, b, kit.plan,
                                               tiles=kit.tiles,
                                               precision=x3)),
            ("K6", "persistent body",
             lambda: cb.bell_spmm_block(a, b, precision=x3),
             lambda: cb.bell_spmm_block_plain(a, b, precision=x3))):
        label = f"{kname} bf16x3 k {k} ({body})"
        out[kname]["bf16x3"] = _phase21_kind(
            paths, label, kname, kern, plain, bound, torch.float32,
            vs_scipy(label, bh, BF16X3_TOL), split_cost(k), torch.bfloat16,
            lib, call)
        if kname == "K3":  # K3's walk
            out[kname]["bf16x3"]["sm_clock_power"] = _clock_line(
                f"{label} kernel", kern, card)
    # the split's issued work on the band and persistent bodies: the
    # float32 stream's chunks and blocks
    useful = 2 * m["nnz"] * k
    out["K4"]["bf16x3"]["issued_gflop"] = check_issued(
        "K4 bf16x3", kit.tiles, kit.plan.start, b, a.bsz, useful,
        precision=x3) / 1e9
    out["K4-kit"]["bf16x3"]["issued_gflop"] = check_issued(
        "K4-kit bf16x3", kit.tiles, kit.plan.start, b, a.bsz, useful,
        precision=x3, mask=kit.chunk_nz) / 1e9
    kit_beside("K4-kit bf16x3", out["K4-kit"]["bf16x3"], card, **{
        "K4 (vote body, the kit's tiles)": lambda: cb.bell_spmm_banded(
            a, b, kit.plan, tiles=kit.tiles, precision=x3)})
    out["K3"]["bf16x3"]["issued_gflop"] = check_counted(
        "K3 bf16x3", cb.fused_issued_flops(a, b, precision=x3),
        cb.fused_issued_model(a, k), useful) / 1e9
    out["K6"]["bf16x3"]["issued_gflop"] = check_counted(
        "K6 bf16x3", cb.block_issued_flops(a, b, precision=x3),
        cb.block_issued_model(a, k), useful) / 1e9
    lib32, call32 = library_spmm(m, b32, card, "k 32 float32, the bf16x3 "
                                 "yardstick")
    label = "K5 bf16x3 k 32 (chunk-mask body)"
    out["K5"]["bf16x3"] = _phase21_kind(
        paths, label, "K5",
        lambda: cb.bell_spmm_banded_t(a, bt32, kit_t, precision=x3),
        lambda: cb.bell_spmm_banded_t_plain(a, bt32, kit_t, precision=x3),
        _abs_bound(a, b32, torch.float32).T, torch.float32,
        vs_scipy(label, bh32, BF16X3_TOL, True), split_cost(32),
        torch.bfloat16, lib32, call32)
    useful32 = 2 * m["nnz"] * 32
    out["K5"]["bf16x3"].update(check_k5_counts(
        "K5 bf16x3 k=32", a, bt32, kit_t, useful32, precision=x3))
    # the float64 kinds: K3 and K4 on the band body (K3's wide row, K4's
    # densified tiles), K6 on the persistent body
    a64 = BELL(cols=a.cols, blocks=a.blocks.double(), n=a.n, bsz=a.bsz)
    b64 = b.double()
    kit64 = cb.bell_banded_prepare(a64, row_tile=kit.plan.rt,
                                   slot_valid=valid)
    bound = _abs_bound(a64, b64, f64)
    lib, call = library_spmm(m, b64, card, "float64")
    cost = spmm_cost(nbz, a.bsz, a.n, k, 8, 8)
    for kname, body, kern, plain in (
            ("K3", "band body", lambda: cb.bell_spmm_fused(a64, b64),
             lambda: cb.bell_spmm_fused_plain(a64, b64)),
            ("K4-kit", "mask body, bell_spmm(plan=kit)",
             lambda: pt.bell_spmm(a64, b64, plan=kit64),
             lambda: cb.bell_spmm_banded_plain(a64, b64, kit64.plan,
                                               tiles=kit64.tiles)),
            ("K4", "band body, the kit's tiles",
             lambda: cb.bell_spmm_banded(a64, b64, kit64.plan,
                                         tiles=kit64.tiles),
             lambda: cb.bell_spmm_banded_plain(a64, b64, kit64.plan,
                                               tiles=kit64.tiles)),
            ("K6", "persistent body", lambda: cb.bell_spmm_block(a64, b64),
             lambda: cb.bell_spmm_block_plain(a64, b64))):
        label = f"{kname} float64 k {k} ({body})"
        out[kname]["float64"] = _phase21_kind(
            paths, label, kname, kern, plain, bound, f64,
            vs_scipy(label, bh, TOL[f64]), cost, f64, lib, call)
        if kname != "K6":  # the band body's float64 on m16n8k8
            out[kname]["float64"]["sm_clock_power"] = _clock_line(
                f"{label} kernel", kern, card)
    out["K4"]["float64"]["issued_gflop"] = check_issued(
        "K4 float64", kit64.tiles, kit64.plan.start, b64, a.bsz,
        useful) / 1e9
    out["K4-kit"]["float64"]["issued_gflop"] = check_issued(
        "K4-kit float64", kit64.tiles, kit64.plan.start, b64, a.bsz,
        useful, mask=kit64.chunk_nz) / 1e9
    # K3's and K6's float64 votes: the float32 stream's chunks and blocks
    out["K3"]["float64"]["issued_gflop"] = check_counted(
        "K3 float64", cb.fused_issued_flops(a64, b64),
        cb.fused_issued_model(a64, k), useful) / 1e9
    out["K6"]["float64"]["issued_gflop"] = check_counted(
        "K6 float64", cb.block_issued_flops(a64, b64),
        cb.block_issued_model(a64, k), useful) / 1e9
    # K8 on phase 14's plan (measure_dband.py's flow: the operand padded
    # with W zero panels), float64 tiles and operand
    plan, nb, bsz = dband["plan"], dband["nb"], dband["bsz"]
    tiles64 = cuda_dband.densify_tiles(a, plan, f64)
    b3 = torch.cat([b64.reshape(nb, bsz, k), b64.new_zeros(plan.W, bsz, k)])
    args = (tiles64, plan.start, b3, nb, bsz, k, plan.W, plan.rt, f64)
    label = f"K8 float64 k {k} (band body)"
    out["K8"]["float64"] = _phase21_kind(
        paths, label, "K8", lambda: cuda_dband.dband_spmm(*args),
        lambda: cuda_dband.dband_spmm_plain(*args), bound, f64,
        vs_scipy(label, bh, TOL[f64]), cost, f64, lib, call)
    out["K8"]["float64"]["issued_gflop"] = check_issued(
        "K8 float64", tiles64, plan.start, b3.reshape(-1, k), bsz,
        useful) / 1e9
    out["K8"]["float64"]["sm_clock_power"] = _clock_line(
        f"{label} kernel", lambda: cuda_dband.dband_spmm(*args), card)
    kit_beside("K4-kit float64", out["K4-kit"]["float64"], card, **{
        "K4 (vote body, the kit's tiles)": lambda: cb.bell_spmm_banded(
            a64, b64, kit64.plan, tiles=kit64.tiles),
        "K8": lambda: cuda_dband.dband_spmm(*args)})
    del tiles64, b3, args, bound, kit64
    # the float32 kernels beside their bf16x3 and float64 kinds: the same
    # bits as phases 9 and 15
    tiles32, b3_32 = dband[torch.float32]
    args32 = (tiles32, plan.start, b3_32, nb, bsz, k, plan.W, plan.rt,
              torch.float32)
    for kname, fn in (
            ("K4-kit", lambda: pt.bell_spmm(a, b, plan=kit)),
            ("K4", lambda: cb.bell_spmm_banded(a, b, kit.plan,
                                               tiles=kit.tiles)),
            ("K8", lambda: cuda_dband.dband_spmm(*args32))):
        out[kname]["float32"] = f32_digest(f"{kname} float32", fn, card)
    del args32
    kit_t64 = cb.bell_banded_prepare_t(a64, slot_valid=valid)
    bt64 = bt32.double()
    lib, call = library_spmm(m, b32.double(), card, "k 32 float64")
    label = "K5 float64 k 32 (chunk-mask body)"
    out["K5"]["float64"] = _phase21_kind(
        paths, label, "K5", lambda: cb.bell_spmm_banded_t(a64, bt64, kit_t64),
        lambda: cb.bell_spmm_banded_t_plain(a64, bt64, kit_t64),
        _abs_bound(a64, b32.double(), f64).T, f64,
        vs_scipy(label, bh32, TOL[f64], True),
        spmm_cost(nbz, a.bsz, a.n, 32, 8, 8), f64, lib, call)
    out["K5"]["float64"].update(check_k5_counts(
        "K5 float64 k=32", a64, bt64, kit_t64, useful32))
    del kit_t64, a64, b64, bt64
    out["K6"]["bsz128"] = _phase21_k6_wide(card)
    return out


#: K6 past its persistent body's stages: ``bench.py``'s block band at bsz
#: 128 (``build_block_band(nb=3_907, bsz=128)``: n 500,096), k 128.
K6_WIDE_NB, K6_WIDE_BSZ = 3_907, 128
#: The source of each body K6 runs past bsz 64 (``cuda_bell._k6_body``).
K6_BODY_SOURCE = {"wide": "sparse_tpu_torch/csrc/wide_body.cuh",
                  "band": "sparse_tpu_torch/csrc/band_body.cuh"}


def _phase21_k6_wide(card):
    """K6 at bsz 128 in every kind on ``bench.py``'s block band at
    ``K6_WIDE_BSZ``, on the body ``cuda_bell._k6_body`` names: the
    wide-block body (``csrc/wide_body.cuh``) in float32, bf16, bf16x3 and
    float64, K3's band body on the wide row in int32.  Its main path
    ``bell_spmm_block`` once with K6's launch count set to 0 just before
    and read just after; then twice, bitwise equal, against its plain
    version (int32: equal) and SciPy on every 64th block row (within TOL,
    bf16x3's gate; int32: exact), its issued work against its body's host
    model; timed back to back beside its plain version, its bound and
    ``BSR @ B`` in the stream's dtype (float32 for bf16x3), with the SM
    clock and power draw ``nvidia-smi`` reads while it runs; in float32 and
    bf16 a ``torch.profiler`` trace names the kernels K6 and ``BSR @ B``
    run.  Returns {kind: record}, each naming its body."""
    from sparse_tpu_torch.formats.bell import BELL
    from sparse_tpu_torch.ops import cuda_bell as cb

    f32, f64, bf16, i32 = (torch.float32, torch.float64, torch.bfloat16,
                           torch.int32)
    a, cols_np, valid, gen = _bench_bell(K6_WIDE_NB, K6_WIDE_BSZ)
    k, bsz = 128, a.bsz
    b = torch.randn(a.n, k, device="cuda", generator=gen) * 0.01
    nbz = int(valid.sum())
    useful = 2 * nbz * bsz * bsz * k
    m = dict(a=a, cols_np=cols_np, slot_valid=valid)
    print(f"   bsz {bsz} band: n {a.n}, {nbz} stored blocks of Lb {a.Lb}, "
          f"{useful / 1e9:.3f} useful GFLOP at k {k}", flush=True)

    def with_blocks(blocks):
        return BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=bsz)

    ai = with_blocks((a.blocks * 400).round().to(i32))
    bi = torch.randint(-8, 9, (a.n, k), device="cuda", generator=gen,
                       dtype=i32)
    # kind: (A, B, precision, tolerance against the plain version and
    # against SciPy, bytes per element of A and B and of C, bound dtype)
    kinds = {
        "float32": (a, b, None, TOL[f32], TOL[f32], 4, 4, f32),
        "bf16": (with_blocks(a.blocks.to(bf16)), b.to(bf16), None,
                 TOL[bf16], TOL[bf16], 2, 2, bf16),
        "bf16x3": (a, b, "bf16x3", TOL[f32], BF16X3_TOL, 4, 4, bf16),
        "int32": (ai, bi, None, 0, 0, 4, 4, i32),
        "float64": (with_blocks(a.blocks.double()), b.double(), None,
                    TOL[f64], TOL[f64], 8, 8, f64)}
    out = {}
    for kind, (x, y, prec, tol_p, tol_s, isz, osz, bdt) in kinds.items():
        body = cb._k6_body(bsz, k, y.dtype)
        label = (f"K6 {kind} bsz {bsz} k {k} ({body} body, "
                 "bell_spmm_block)")

        def kern():
            return cb.bell_spmm_block(x, y, precision=prec)

        def plain():
            return cb.bell_spmm_block_plain(x, y, precision=prec)

        oracle = _ScipyRows(x, cols_np, valid, step=64)
        yh = y.double().cpu().numpy()
        want = oracle.s @ yh
        cb.K6_LAUNCHES = 0
        c = kern()  # the main path
        torch.cuda.synchronize()
        launches = cb.K6_LAUNCHES
        if launches != 1:
            raise AssertionError(f"{label}: the main path launched K6 "
                                 f"{launches} times")
        if kind == "int32":
            err = _int_check(label, want)(c, oracle.rows)
        else:
            err = _gate(label, c[oracle.rows],
                        torch.from_numpy(want).cuda(),
                        torch.from_numpy(oracle.abs @ np.abs(yh)).cuda(),
                        tol_s)
        c2 = kern()
        torch.cuda.synchronize()
        if c.dtype != y.dtype or not torch.equal(_bits(c), _bits(c2)):
            raise AssertionError(f"{label}: {c.dtype} result, or two runs "
                                 "differ bitwise")
        del c2
        yp = plain()
        if kind == "int32":
            if not torch.equal(c, yp):
                raise AssertionError(f"{label}: differs from its plain "
                                     "version")
            err_p = 0.0
        else:
            err_p = _gate(label, c, yp, _abs_bound(x, y, y.dtype), tol_p)
        del c, yp
        issued = check_counted(
            f"K6 {kind} bsz {bsz} ({body} body)",
            cb.block_issued_flops(x, y, precision=prec),
            cb.block_issued_model(x, k, precision=prec), useful)
        ms, fastest, n = _b2b(kern)
        clock = _clock_under(kern)
        plain_ms = _b2b(plain)[0]
        nbytes, ops = spmm_cost(nbz, bsz, a.n, k, isz, osz)
        b_ms, b_by = bound_ms(nbytes, 3 * ops if prec else ops, bdt)
        if kind == "int32":
            bsr = torch_bsr(dict(m, a=ai), i32)
            lib, call = _library(f"BSR @ B int32 (bsz {bsz}, k {k})",
                                 lambda: bsr @ bi, card)
            del bsr
        else:
            lib, call = library_spmm(m, y.float() if prec else y, card,
                                     f"bsz {bsz} k {k} {str(y.dtype)[6:]}")
        if kind in ("float32", "bf16"):  # the kernels each side runs
            bsr = m[("bsr", y.dtype)]  # library_spmm's
            _apply_kernels(f"K6 {kind} bsz {bsz}", kern, forbid=())
            _apply_kernels(f"BSR @ B {kind} bsz {bsz}", lambda: bsr @ y,
                           forbid=())
            del bsr
        print(f"   {label}: main path launched K6 {launches} time(s); gate "
              f"passed (max err {err:.3e}, vs plain {err_p:.3e}); {ms:.4f} "
              f"ms back to back (median of 5 windows of {n}; fastest "
              f"{fastest:.4f}); plain {plain_ms:.4f} ms; bound {b_ms:.4f} "
              f"ms ({b_by}), {b_ms / ms:.1%} of it; library "
              f"{'refused' if lib is None else f'{lib:.4f} ms'} ({call}); "
              f"SM clock, power under load {clock} [{card}]", flush=True)
        out[kind] = dict(body=body, source=K6_BODY_SOURCE[body],
                         ms=ms, fastest_ms=fastest, plain_ms=plain_ms,
                         sm_clock_power=clock,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                         library_call=call, max_abs_err=err,
                         max_abs_err_vs_plain=err_p, launches=launches,
                         issued_gflop=issued / 1e9)
        if lib is None:
            out[kind]["library_error"] = LIBRARY_REFUSALS.get(call,
                                                              "refused")
    del m, kinds, a, ai, b, bi
    return out


def _clock_line(label, fn, card):
    """``_clock_under(fn)``, printed under ``label``; returns it."""
    clock = _clock_under(fn)
    print(f"   {label}: SM clock, power under load {clock} [{card}]",
          flush=True)
    return clock


def _clock_under(fn):
    """``nvidia-smi``'s SM clock and power draw, read 1.5 s into 3 s of
    ``fn`` back to back (its power reading is an average that lags a
    change of load); "not read" if it gives none."""
    got = []

    def read():
        time.sleep(1.5)
        try:
            got.extend(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().splitlines())
        except (OSError, subprocess.SubprocessError):
            pass

    reader = threading.Thread(target=read)
    reader.start()
    t_end = time.perf_counter() + 3.0
    while time.perf_counter() < t_end:
        fn()
    reader.join()
    torch.cuda.synchronize()
    return got[0] if got else "not read"


def _esc_cut(rows, cols, nb):
    """The largest leading block count ``nbp`` whose principal submatrix's
    A @ A needs at most ``ESC_MAX_PRODUCTS`` scalar products."""
    def products(nbp):
        keep = (rows < nbp) & (cols < nbp)
        per_row = np.bincount(rows[keep], minlength=nbp)
        return int(per_row[cols[keep]].sum()) * 32 ** 3

    lo, hi = 1, nb
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if products(mid) <= ESC_MAX_PRODUCTS else (
            lo, mid - 1)
    return lo, products(lo)


def _csr_cuda(s, dtype=np.float32):
    """A SciPy CSR's arrays as the port's CSR on the card in ``dtype``."""
    from sparse_tpu_torch import interop

    return interop.csr_from_arrays(s.data.astype(dtype), s.indices,
                                   s.indptr, s.shape, device="cuda")


def _phase21_spgemm(paths):
    """The ESC core on the leading block principal submatrix of
    spgemm-block-181k's scalar CSR within ``ESC_MAX_PRODUCTS``, and the
    dense core on its leading ``MXU_N`` rows and columns, each A @ A
    against SciPy; returns the ESC cut's SciPy matrix for the int32
    pass."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import spgemm as sg

    t0 = time.perf_counter()
    sb, rows, cols, _ = _spgemm_fixture()
    nbp, prods = _esc_cut(rows, cols, 2_000)
    sc = sb.tocsr()
    sub = sc[:nbp * 32, :nbp * 32].tocsr()
    t_host = time.perf_counter() - t0
    a = _csr_cuda(sub)
    t, f = _host_s(lambda: int(pt.spgemm_flops(a, a)))
    if f != prods:
        raise AssertionError(f"spgemm_flops {f} != the host's {prods}")
    c = pt.spgemm_csr_csr(a, a, f)
    want = sub @ sub
    err = _sparse_vs("ESC spgemm_csr_csr", sp_csr_f64(c), want,
                     abs(sub) @ abs(sub))
    paths.add(f"spgemm-block-181k cut ESC spgemm_csr_csr (n {nbp * 32}, "
              f"{f} products)", lambda: pt.spgemm_csr_csr(a, a, f), err,
              t_host + t, nnz=want.nnz, products=f)
    sm = sc[:MXU_N, :MXU_N].tocsr()
    am = _csr_cuda(sm)
    if not sg._mxu_eligible(am, am):
        raise AssertionError("the dense core's operand exceeds its budget")
    t, nse = _host_s(lambda: int(pt.spgemm_mxu_nse(am, am)))
    c = pt.spgemm_mxu_csr_csr(am, am, nse)
    err = _sparse_vs("dense spgemm_mxu_csr_csr", sp_csr_f64(c), sm @ sm,
                     abs(sm) @ abs(sm))
    paths.add(f"spgemm-block-181k {MXU_N} x {MXU_N} spgemm_mxu_csr_csr",
              lambda: pt.spgemm_mxu_csr_csr(am, am, nse), err, t, nse=nse)
    return sub


def _phase21_pspgemm(paths, a, s):
    """``pcsr_spgemm`` (the one-shot A @ A, host pass included) on
    elasticity-400k over ``DIST_D`` shards against SciPy."""
    import sparse_tpu_torch.parallel as par

    mesh = par.make_1d_mesh(DIST_D)
    t, pa = _host_s(lambda: par.pcsr_from_csr(a, mesh))
    c = par.pcsr_spgemm(pa, pa, mesh)
    err = _sparse_vs("pcsr_spgemm", _csr_of_pcsr(c), s @ s, abs(s) @ abs(s))
    paths.add(f"elasticity-400k pcsr_spgemm D={DIST_D}",
              lambda: par.pcsr_spgemm(pa, pa, mesh), err, t)


def _phase21_int32(paths, band, ab, m, sub):
    """int32 through ``csr_smvm`` (band-10M's pattern), ``bsr_smvm``
    (elasticity-400k's), ``bell_smvm`` (bell-band-80M's), ``spgemm`` (the
    ESC cut's) and ``tri_smm`` (n ``TRI_INT_N``), each exactly NumPy's
    int64 answer on the card, timed beside the same call in float32."""
    import dataclasses

    import scipy.sparse as sp

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.formats.bell import BELL

    rng = np.random.default_rng(23)
    i32 = torch.int32
    a = band["a"]
    ai = dataclasses.replace(a, data=(a.data * 400).round().to(i32))
    si = sp_csr_f64(ai)
    vi = torch.from_numpy(rng.integers(-8, 9, a.shape[0])).to(i32).cuda()
    vf = vi.float()
    paths.add("int32 band-10M csr_smvm", lambda: pt.csr_smvm(ai, vi),
              _exact("csr_smvm", pt.csr_smvm(ai, vi),
                     si @ vi.double().cpu().numpy()),
              float32_ms=_b2b(lambda: pt.csr_smvm(a, vf))[0])
    bi = dataclasses.replace(ab, blocks=(ab.blocks * 100).round().to(i32))
    idx = ab.indices.long().cpu().numpy()
    ok = idx < ab.nb * ab.nb
    r, c = idx[ok] // ab.nb, idx[ok] % ab.nb
    k, shape = np.arange(ab.bsz), (r.size, ab.bsz, ab.bsz)
    sbi = sp.coo_matrix((bi.blocks.double().cpu().numpy()[ok].reshape(-1), (
        np.broadcast_to(r[:, None, None] * ab.bsz + k[:, None], shape)
        .reshape(-1),
        np.broadcast_to(c[:, None, None] * ab.bsz + k, shape).reshape(-1))),
        shape=(ab.n, ab.n)).tocsr()
    wi = torch.from_numpy(rng.integers(-8, 9, ab.n)).to(i32).cuda()
    paths.add("int32 elasticity-400k bsr_smvm", lambda: pt.bsr_smvm(bi, wi),
              _exact("bsr_smvm", pt.bsr_smvm(bi, wi),
                     sbi @ wi.double().cpu().numpy()),
              float32_ms=_b2b(lambda: pt.bsr_smvm(ab, wi.float()))[0])
    e = m["a"]
    ei = BELL(cols=e.cols, blocks=(e.blocks * 400).round().to(i32), n=e.n,
              bsz=e.bsz)
    oracle = _ScipyRows(ei, m["cols_np"], m["slot_valid"])
    ui = torch.from_numpy(rng.integers(-8, 9, e.n)).to(i32).cuda()
    paths.add("int32 bell-band-80M bell_smvm", lambda: pt.bell_smvm(ei, ui),
              _exact("bell_smvm", pt.bell_smvm(ei, ui)[oracle.rows],
                     oracle.s @ ui.double().cpu().numpy()),
              float32_ms=_b2b(lambda: pt.bell_smvm(e, ui.float()))[0])
    qi = sp.csr_matrix((np.rint(sub.data * 400), sub.indices, sub.indptr),
                       shape=sub.shape)
    gi = _csr_cuda(qi, np.int32)
    gf = _csr_cuda(qi, np.float32)
    want = (qi @ qi).toarray()
    paths.add(f"int32 spgemm-block-181k cut spgemm (n {sub.shape[0]})",
              lambda: pt.spgemm(gi, gi),
              _exact("spgemm", pt.csr_todense(pt.spgemm(gi, gi)), want),
              float32_ms=_b2b(lambda: pt.spgemm(gf, gf))[0])
    x = np.tril(rng.integers(-8, 9, (TRI_INT_N, TRI_INT_N)))
    ti = pt.tri_from_dense(torch.from_numpy(x).to(i32).cuda())
    tf = pt.tri_from_dense(torch.from_numpy(x).float().cuda())
    x64 = x.astype(np.float64)
    paths.add(f"int32 tri_smm n {TRI_INT_N}", lambda: pt.tri_smm(ti, ti),
              _exact("tri_smm", pt.tri_todense(pt.tri_smm(ti, ti)),
                     x64 @ x64),
              float32_ms=_b2b(lambda: pt.tri_smm(tf, tf))[0])


def phase21_surface(card, slice_run, ela_bsr, spmm_run):
    """The public paths no earlier phase runs or times at size, each held
    to its gate against SciPy / NumPy in float64 (PERF.md section 2),
    timed back to back (the median of 5 windows), with its host set-up
    time and the card: the plain SpMV and SpMM entry points and the
    ``xla`` / ``bell`` rungs on band-10M and elasticity-400k, the SpMMs at
    ``__graft_entry__``'s shape, ``bell_smvm``, the bf16x3 kinds of K3-K6
    and the float64 kinds of K3-K6 and K8 on bell-band-80M, K6 at bsz 128
    in every kind, the ESC and dense SpGEMM cores on cuts of
    spgemm-block-181k, three distributed paths over ``DIST_D`` shards, and
    an int32 pass exact to NumPy.  Returns (paths, {kernel: {kind:
    record}})."""
    paths = _Paths(card)
    _phase21_band(paths, slice_run["a"], slice_run["s"], slice_run["v"])
    ae, se = _phase21_elasticity(paths, ela_bsr)
    _phase21_entry_spmm(paths)
    kinds = _phase21_bell(paths, spmm_run, slice_run["dband"], card)
    sub = _phase21_spgemm(paths)
    _phase21_pspgemm(paths, ae, se)
    _phase21_int32(paths, slice_run, ela_bsr, spmm_run, sub)
    return paths.out, kinds


#: The bf16 SpMV kinds' gate against SciPy's float64 product of the bf16
#: inputs: one rounding of a float32 sum to bf16, times (|A||v|)_i; against
#: the plain version (which rounds its own float32 sum once): two.
BF16_SPMV_GATE = 2.0 ** -8


def _launch_attr(kname):
    """The launch counter of kernel ``kname`` ("K1-mxu" -> K1_MXU_LAUNCHES)
    and its module."""
    from sparse_tpu_torch.ops import (cuda_bell, cuda_bsr, cuda_csr,
                                      cuda_csr_block, cuda_dband)

    mod = {"K1": cuda_csr, "K1-r32": cuda_csr, "K1-mxu": cuda_csr,
           "K2": cuda_csr_block, "K7": cuda_bsr, "K8": cuda_dband}.get(
               kname, cuda_bell)
    return mod, kname.replace("-", "_").upper() + "_LAUNCHES"


def _int_check(label, want):
    """``check(y)`` for an int32 result: equal to NumPy's int64 answer
    ``want`` taken modulo 2^32 (rows ``rows`` of y when given); 0."""
    w = ((np.asarray(want, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31)

    def check(y, rows=None):
        got = y if rows is None else y[rows]
        if got.dtype != torch.int32:
            raise AssertionError(f"{label}: {got.dtype}, expected int32")
        if not np.array_equal(got.long().cpu().numpy(), w):
            raise AssertionError(f"{label}: differs from NumPy's int64 "
                                 "answer modulo 2^32")
        return 0

    return check


def _bf16_check(label, exact, mag, tol=BF16_SPMV_GATE,
                dtype=torch.bfloat16):
    """``check(y)`` for a bf16 (or ``dtype``) SpMV result: within ``tol``
    (|A||v|)_i of SciPy's float64 ``exact``; returns the max abs error."""
    exact, mag = torch.from_numpy(exact), torch.from_numpy(mag)

    def check(y):
        nonlocal exact, mag
        exact, mag = exact.to(y.device), mag.to(y.device)
        if y.dtype != dtype:
            raise AssertionError(f"{label}: {y.dtype}, expected {dtype}")
        return _gate(label, y, exact, mag, tol)

    return check


def _vs_plain(label, y, yp, mag):
    """The kernel against its plain version: equal for int32; for bf16
    within two roundings, 2 * 2^-8 (|A||v|)_i; for float64 within two
    float64 gates, 2e-12 (|A||v|)_i; returns the max abs error."""
    if y.dtype == torch.int32:
        if not torch.equal(y, yp):
            raise AssertionError(f"{label}: differs from its plain version")
        return 0
    tol = (2 * TOL[torch.float64] if y.dtype == torch.float64
           else 2 * BF16_SPMV_GATE)
    return _gate(label, y, yp, torch.from_numpy(mag).to(y.device), tol)


def _new_kind(card, label, kname, main, kern, plain, check, mag, cost, dtype,
              sibling, lib, lib_call, view=None, apply=None, clock=False):
    """One int32, bf16 or float64 kind of kernel ``kname``: its main path
    ``main`` (an entry point a user calls) once, the kernel's launch count
    set to 0 just before and read just after, checked by ``check``; the
    kernel ``kern`` twice, bitwise equal, against its plain version and
    ``check`` (both through ``view`` when given: the main path's numbering
    of a kernel that runs in the plan's); then back to back (``_b2b``) the
    kernel, its plain version, its float32 sibling and, when given,
    ``apply`` (the main path's call), beside the bound of ``cost`` (bytes,
    operations) at ``dtype``'s peak and the library call's ``lib`` ms
    (None: refused, the reason in ``LIBRARY_REFUSALS[lib_call]``); with
    ``clock``, the SM clock and power under the kernel and under its
    sibling (``_clock_under``).  Returns the record."""
    if view is None:
        def view(y):
            return y

    mod, attr = _launch_attr(kname)
    setattr(mod, attr, 0)
    y = main()
    torch.cuda.synchronize()
    launches = getattr(mod, attr)
    if launches <= 0:
        raise AssertionError(f"{label}: the main path launched no {kname}")
    err = check(y)
    del y
    y1, y2 = kern(), kern()
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        raise AssertionError(f"{label}: two runs differ bitwise")
    del y2
    err_p = _vs_plain(label, view(y1), view(plain()), mag)
    if check(view(y1)) != err:
        raise AssertionError(f"{label}: the kernel's result is not the "
                             "main path's")
    del y1
    ms, fastest, n = _b2b(kern)
    plain_ms = _b2b(plain)[0]
    sib_ms = _b2b(sibling)[0]
    apply_ms = None if apply is None else _b2b(apply)[0]
    main_ms = "" if apply is None else f"main-path call {apply_ms:.4f} ms; "
    b_ms, b_by = bound_ms(*cost, dtype)
    print(f"   {label}: main path launched {kname} {launches} time(s); "
          f"gate passed (max err {err:.3e}, vs plain {err_p:.3e}); "
          f"{ms:.4f} ms back to back (median of 5 windows of {n}; fastest "
          f"{fastest:.4f}); float32 sibling {sib_ms:.4f} ms; {main_ms}plain "
          f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
          f"{cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.3f} Gop), "
          f"{b_ms / ms:.1%} of it; library "
          f"{'refused' if lib is None else f'{lib:.4f} ms'} ({lib_call}) "
          f"[{card}]", flush=True)
    rec = dict(ms=ms, fastest_ms=fastest, plain_ms=plain_ms,
               float32_ms=sib_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib, library_call=lib_call, max_abs_err=err,
               max_abs_err_vs_plain=err_p, launches=launches)
    if apply is not None:
        rec["apply_ms"] = apply_ms
    if lib is None:
        rec["library_error"] = LIBRARY_REFUSALS.get(lib_call, "refused")
    if clock:
        rec["sm_clock_power"] = _clock_line(f"{label}, kernel", kern, card)
        rec["float32_sm_clock_power"] = _clock_line(
            f"{label}, float32 sibling", sibling, card)
    return rec


def _library(label, fn, card):
    """``library_ms`` of one call, keyed in ``LIBRARY_REFUSALS`` by the
    label the records name; returns (ms or None, label)."""
    return library_ms(label, fn, card), label


def _library_csr(cell, kind, a, v, card):
    """``library_csr_ms`` for a kind's record: (ms or None, the call's
    name), a refusal kept under that name."""
    label = f"CSR @ v {kind} ({cell})"
    ms, _ = library_csr_ms(label, a, v, card)
    call = f"{LIBRARY_CSR} ({kind}, {cell})"
    if ms is None:
        LIBRARY_REFUSALS[call] = LIBRARY_REFUSALS[f"{label}, int32 indices"]
    return ms, call


def _k1_geometry_line(group, card, kinds=("float64", "float32"), n_rows=0):
    """Print and return the geometry of K1's row kernel in ``kinds`` at
    lane group ``group`` and its split of a launch over ``n_rows`` rows
    (``cuda_csr.k1_geometry``; bf16's is ``narrow_rows``)."""
    from sparse_tpu_torch.ops import cuda_csr

    dts = {"float64": torch.float64, "float32": torch.float32,
           "bf16": torch.bfloat16}
    geo = {}
    for kind in kinds:
        g = geo[kind] = cuda_csr.k1_geometry(dts[kind], group, n_rows)
        split = (f"; {g['row_blocks']} row blocks of {g['chunks_per_block']}"
                 f" chunks over {n_rows} rows" if n_rows else "")
        print(f"   K1 {kind} row kernel at lane group {group}: "
              f"{g['registers']} registers and {g['local_bytes']} local "
              f"bytes a thread, {g['shared_bytes']} static shared bytes, "
              f"{g['blocks_per_sm']} blocks of 256 threads an SM, "
              f"{g['rows_per_group']} rows a lane group{split} [{card}]",
              flush=True)
    return geo


def _phase22_spmv(card, band, sl, ela, out):
    """K1, K1-r32, K1-mxu on band-10M and K2 on elasticity-400k in int32,
    bf16 and float64, each main path ``smvm_prepare(a) -> plan.apply(v)``
    (and ``csr_smvm_segtile`` for the variants).  K2 is timed as its
    float32 sibling is, alone on the plan's stream and the permuted
    operand, and the main path's apply (its folded view) beside it."""
    import dataclasses

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_csr, cuda_csr_block
    from sparse_tpu_torch.utils.stats import blocked_bound_bytes

    rng = np.random.default_rng(220)
    a32 = sl["a"]
    n = a32.shape[0]
    p32, v32 = band["plan"], band["v"]
    ap32, st32 = p32.state
    vp32 = v32 if p32.perm is None else v32[p32.perm]
    ab32 = ela["plan"].state[0]
    ae32 = pt.bsr_to_csr(ab32)
    ep32, ev32 = ela["plan"], ela["v"]
    eb32, est32 = ep32.state
    evp32 = ev32.reshape(-1, 2)[ep32.perm].reshape(-1)
    for kind, dt in (("int32", torch.int32), ("bf16", torch.bfloat16),
                     ("float64", torch.float64)):
        if dt == torch.int32:
            a = dataclasses.replace(a32, data=(a32.data * 400).round().to(dt))
            v = torch.from_numpy(rng.integers(-8, 9, n)).to(dt).to(
                v32.device)
        else:
            a = dataclasses.replace(a32, data=a32.data.to(dt))
            v = v32.to(dt)
        s, vh = sp_csr_f64(a), v.double().cpu().numpy()
        mag = abs(s) @ np.abs(vh)
        gates = {"bf16": (BF16_SPMV_GATE, dt),
                 "float64": (TOL[torch.float64], dt)}
        t0 = time.perf_counter()
        plan = pt.smvm_prepare(a)
        t_prep = time.perf_counter() - t0
        if plan.kind != p32.kind:
            raise AssertionError(f"band-10M {kind}: rung {plan.kind}, the "
                                 f"float32 plan's {p32.kind}")
        ap, st = plan.state
        perm = plan.perm
        vp = v if perm is None else v[perm]
        inv = plan.inv_perm
        unperm = (lambda y: y) if inv is None else (lambda y: y[inv])
        check = (_int_check(f"band-10M {kind}", s @ vh) if kind == "int32"
                 else _bf16_check(f"band-10M {kind}", s @ vh, mag,
                                  *gates[kind]))
        lib, call = _library_csr("band-10M", kind, a, v, card)
        cost = (csr_spmv_cost(a)[0], 2 * int(a.indptr[-1]))
        print(f"   band-10M {kind}: smvm_prepare {t_prep:.2f} s (host), rung "
              f"{plan.kind}, stream {st.stream.bytes_per_entry:.2f} B per "
              "entry", flush=True)
        out["K1"][kind] = _new_kind(
            card, f"band-10M K1 {kind} (smvm_prepare -> plan.apply)", "K1",
            lambda: plan.apply(v),
            lambda: unperm(pt.csr_smvm_segtile(ap, vp, st)),
            lambda: unperm(cuda_csr.segtile_stream_plain(st.stream, vp)),
            check, mag, cost, dt,
            lambda: pt.csr_smvm_segtile(ap32, vp32, st32), lib, call)
        out["K1"][kind]["setup_s"] = t_prep
        if dt == torch.float64:
            out["K1"][kind]["geometry"] = _k1_geometry_line(st.stream.group,
                                                            card)
        if dt == torch.bfloat16:
            geo = out["K1"][kind]["geometry"] = _k1_geometry_line(
                st.stream.group, card, ("bf16", "float32"),
                st.stream.n_rows)["bf16"]
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            if geo["row_blocks"] > geo["blocks_per_sm"] * sms:
                raise AssertionError(f"band-10M K1 bf16: {geo['row_blocks']}"
                                     " row blocks, more than one wave")
        out["K1-mxu"][kind] = _new_kind(
            card, f"band-10M K1-mxu {kind} (csr_smvm_segtile reduce='mxu')",
            "K1-mxu",
            lambda: unperm(pt.csr_smvm_segtile(ap, vp, st, reduce="mxu")),
            lambda: unperm(pt.csr_smvm_segtile(ap, vp, st, reduce="mxu")),
            lambda: unperm(cuda_csr.segtile_stream_plain(st.stream, vp)),
            check, mag, cost, dt,
            lambda: pt.csr_smvm_segtile(ap32, vp32, st32, reduce="mxu"),
            lib, call)
        if kind == "int32":
            out["K1-mxu"][kind]["kernel"] = "segtile_csr_i32 (K1's)"
        t0 = time.perf_counter()
        p_r32 = cuda_csr.build_seg_tiles(ap, wsub=st.wsub, rows=32)
        t_r32 = time.perf_counter() - t0
        if kind == "int32":
            r32_f32 = cuda_csr.build_seg_tiles(ap32, wsub=st32.wsub, rows=32)
        out["K1-r32"][kind] = _new_kind(
            card, f"band-10M K1-r32 {kind} (csr_smvm_segtile, 32-row plan)",
            "K1-r32", lambda: unperm(pt.csr_smvm_segtile(ap, vp, p_r32)),
            lambda: unperm(pt.csr_smvm_segtile(ap, vp, p_r32)),
            lambda: unperm(cuda_csr.segtile_stream_plain(p_r32.stream, vp)),
            check, mag, cost, dt,
            lambda: pt.csr_smvm_segtile(ap32, vp32, r32_f32), lib, call)
        out["K1-r32"][kind]["setup_s"] = t_r32
        del plan, p_r32, ap, st, a
        # K2: elasticity-400k (phase 5's block-RCM order) as a scalar CSR
        if dt == torch.int32:
            ae = dataclasses.replace(ae32,
                                     data=(ae32.data * 100).round().to(dt))
            w = torch.from_numpy(rng.integers(-8, 9, ae.shape[0])).to(
                dt).to(ev32.device)
        else:
            ae = dataclasses.replace(ae32, data=ae32.data.to(dt))
            w = ev32.to(dt)
        se, wh = sp_csr_f64(ae), w.double().cpu().numpy()
        emag = abs(se) @ np.abs(wh)
        t0 = time.perf_counter()
        eplan = pt.smvm_prepare(ae)
        t_prep = time.perf_counter() - t0
        if eplan.kind != "blockseg":
            raise AssertionError(f"elasticity-400k {kind}: rung "
                                 f"{eplan.kind}, expected blockseg")
        eb, est = eplan.state
        wp = w.reshape(-1, 2)[eplan.perm].reshape(-1)
        einv = eplan.inv_perm

        def eunperm(y):
            return y.reshape(-1, 2)[einv].reshape(-1)

        echeck = (_int_check(f"elasticity-400k {kind}", se @ wh)
                  if kind == "int32" else
                  _bf16_check(f"elasticity-400k {kind}", se @ wh, emag,
                              *gates[kind]))
        lib2, call2 = _library_csr("elasticity-400k", kind, ae, w, card)
        nb = eb.nb
        nbz = int((eb.indices.long() < nb * nb).sum())
        size = torch.empty(0, dtype=dt).element_size()
        cost2 = (blocked_bound_bytes(nbz, 2, eb.n, value_bytes=size,
                                     out_bytes=size, row_pointers=True),
                 2 * 4 * nbz)
        print(f"   elasticity-400k {kind}: smvm_prepare {t_prep:.2f} s "
              f"(host), rung {eplan.kind}", flush=True)
        out["K2"][kind] = _new_kind(
            card, f"elasticity-400k K2 {kind} (smvm_prepare -> plan.apply)",
            "K2", lambda: eplan.apply(w),
            lambda: cuda_csr_block.bsr_smvm_segtile_block(eb, wp, est),
            lambda: cuda_csr_block.block_stream_plain(est.stream, wp),
            echeck, emag, cost2, dt,
            lambda: cuda_csr_block.bsr_smvm_segtile_block(eb32, evp32, est32),
            lib2, call2, view=eunperm, apply=lambda: eplan.apply(w))
        out["K2"][kind]["setup_s"] = t_prep
        del eplan, eb, est, ae


def _phase22_bell(card, m, dband, out):
    """K3 (no plan), K4 (a BandedKit: its mask body, K4-kit; a BandedPlan:
    its vote body), K5 (a BandedKitT, k 32), K6 and K8 on bell-band-80M in
    int32 through ``bell_spmm`` / ``bell_spmm_block`` / ``dband_spmm``,
    exact on phase 8's subset of block rows; the vote route and K8 timed
    beside the kit route."""
    import sparse_tpu_torch as pt
    from sparse_tpu_torch.formats.bell import BELL
    from sparse_tpu_torch.ops import cuda_bell as cb
    from sparse_tpu_torch.ops import cuda_dband

    i32 = torch.int32
    a, b, kit, valid = m["a"], m["b"], m["kit"], m["slot_valid"]
    k = b.shape[1]
    ai = BELL(cols=a.cols, blocks=(a.blocks * 400).round().to(i32), n=a.n,
              bsz=a.bsz)
    oracle = _ScipyRows(ai, m["cols_np"], valid)
    dev = a.blocks.device
    rng = torch.Generator(device=dev).manual_seed(221)
    bi = torch.randint(-8, 9, (a.n, k), device=dev, generator=rng,
                       dtype=i32)
    bi32 = bi[:, :32].contiguous()
    bti = bi32.T.contiguous()
    want = oracle.s @ bi.double().cpu().numpy()
    want32 = oracle.s @ bi32.double().cpu().numpy()
    check, check32 = _int_check("int32 k 128", want), _int_check(
        "int32 k 32", want32)
    mag = np.zeros(1)  # unused: int32 equals its plain version exactly

    def rows(c):
        return check(c, oracle.rows)

    def rows32(c):
        return check32(c, oracle.rows)

    nbz = int(valid.sum())
    cost = spmm_cost(nbz, a.bsz, a.n, k)
    cost32 = spmm_cost(nbz, a.bsz, a.n, 32)
    bsr = torch_bsr(dict(m, a=ai), torch.int32)
    lib, call = _library("BSR @ B int32 (bell-band-80M, k 128)",
                         lambda: bsr @ bi, card)
    lib32, call32 = _library("BSR @ B int32 (bell-band-80M, k 32)",
                             lambda: bsr @ bi32, card)
    t0 = time.perf_counter()
    kit_i = cb.bell_banded_prepare(ai, row_tile=kit.plan.rt, slot_valid=valid)
    kit_ti = cb.bell_banded_prepare_t(ai, slot_valid=valid)
    t_kits = time.perf_counter() - t0
    print(f"   int32 kits: bell_banded_prepare + _t {t_kits:.2f} s (host "
          "plan, densify on the card)", flush=True)
    b32, kit_t = m["b32"], m["kit_t"]
    bt32 = b32.T.contiguous()
    out["K3"]["int32"] = _new_kind(
        card, f"bell-band-80M K3 int32 k {k} (bell_spmm, no plan)", "K3",
        lambda: pt.bell_spmm(ai, bi), lambda: cb.bell_spmm_fused(ai, bi),
        lambda: cb.bell_spmm_fused_plain(ai, bi), rows, mag, cost, i32,
        lambda: cb.bell_spmm_fused(a, b), lib, call, clock=True)
    out["K4-kit"]["int32"] = _new_kind(
        card, f"bell-band-80M K4-kit int32 k {k} (bell_spmm, BandedKit: the "
        "mask body)", "K4-kit",
        lambda: pt.bell_spmm(ai, bi, plan=kit_i),
        lambda: pt.bell_spmm(ai, bi, plan=kit_i),
        lambda: cb.bell_spmm_banded_plain(ai, bi, kit_i.plan,
                                          tiles=kit_i.tiles),
        rows, mag, cost, i32, lambda: pt.bell_spmm(a, b, plan=kit), lib,
        call, clock=True)
    out["K4"]["int32"] = _new_kind(
        card, f"bell-band-80M K4 int32 k {k} (bell_spmm, BandedPlan: the "
        "vote body)", "K4",
        lambda: pt.bell_spmm(ai, bi, plan=kit_i.plan),
        lambda: cb.bell_spmm_banded(ai, bi, kit_i.plan, tiles=kit_i.tiles),
        lambda: cb.bell_spmm_banded_plain(ai, bi, kit_i.plan,
                                          tiles=kit_i.tiles),
        rows, mag, cost, i32,
        lambda: cb.bell_spmm_banded(a, b, kit.plan, tiles=kit.tiles), lib,
        call, clock=True)
    out["K5"]["int32"] = _new_kind(
        card, "bell-band-80M K5 int32 k 32 (bell_spmm, BandedKitT)", "K5",
        lambda: pt.bell_spmm(ai, bi32, plan=kit_ti),
        lambda: cb.bell_spmm_banded_t(ai, bti, kit_ti).T,
        lambda: cb.bell_spmm_banded_t_plain(ai, bti, kit_ti).T, rows32, mag,
        cost32, i32, lambda: cb.bell_spmm_banded_t(a, bt32, kit_t), lib32,
        call32)
    out["K6"]["int32"] = _new_kind(
        card, f"bell-band-80M K6 int32 k {k} (bell_spmm_block)", "K6",
        lambda: cb.bell_spmm_block(ai, bi), lambda: cb.bell_spmm_block(ai, bi),
        lambda: cb.bell_spmm_block_plain(ai, bi), rows, mag, cost, i32,
        lambda: cb.bell_spmm_block(a, b), lib, call)
    # the counters read the float32 kind's chunk and block models
    useful = 2 * m["nnz"] * k
    out["K3"]["int32"]["issued_gflop"] = check_counted(
        "K3 int32", cb.fused_issued_flops(ai, bi), cb.fused_issued_model(
            ai, k), useful) / 1e9
    out["K6"]["int32"]["issued_gflop"] = check_counted(
        "K6 int32", cb.block_issued_flops(ai, bi), cb.block_issued_model(
            ai, k), useful) / 1e9
    out["K4"]["int32"]["issued_gflop"] = check_issued(
        "K4 int32", kit_i.tiles, kit_i.plan.start, bi, a.bsz, useful) / 1e9
    out["K4-kit"]["int32"]["issued_gflop"] = check_issued(
        "K4-kit int32", kit_i.tiles, kit_i.plan.start, bi, a.bsz, useful,
        mask=kit_i.chunk_nz) / 1e9
    out["K5"]["int32"].update(check_k5_counts(
        "K5 int32 k=32", ai, bti, kit_ti, 2 * m["nnz"] * 32))
    del kit_ti
    # K8 on phase 14's plan (the operand padded with W zero panels)
    plan, nb, bsz = dband["plan"], dband["nb"], dband["bsz"]
    tiles_i = cuda_dband.densify_tiles(ai, plan, i32)
    tiles_f = cuda_dband.densify_tiles(a, plan, torch.float32)
    b3 = torch.cat([bi.reshape(nb, bsz, k), bi.new_zeros(plan.W, bsz, k)])
    b3f = torch.cat([b.reshape(nb, bsz, k), b.new_zeros(plan.W, bsz, k)])
    args = (tiles_i, plan.start, b3, nb, bsz, k, plan.W, plan.rt, i32)
    argsf = (tiles_f, plan.start, b3f, nb, bsz, k, plan.W, plan.rt,
             torch.float32)
    out["K8"]["int32"] = _new_kind(
        card, f"bell-band-80M K8 int32 k {k} (dband_spmm)", "K8",
        lambda: cuda_dband.dband_spmm(*args),
        lambda: cuda_dband.dband_spmm(*args),
        lambda: cuda_dband.dband_spmm_plain(*args), rows, mag, cost, i32,
        lambda: cuda_dband.dband_spmm(*argsf), lib, call, clock=True)
    kit_beside("K4-kit int32", out["K4-kit"]["int32"], card, **{
        "K4 (vote body, the kit's tiles)": lambda: cb.bell_spmm_banded(
            ai, bi, kit_i.plan, tiles=kit_i.tiles),
        "K8": lambda: cuda_dband.dband_spmm(*args)})
    # the float32 siblings: the same bits as phases 9, 15 and 21
    for kname, fn in (
            ("K4-kit", lambda: pt.bell_spmm(a, b, plan=kit)),
            ("K4", lambda: cb.bell_spmm_banded(a, b, kit.plan,
                                               tiles=kit.tiles)),
            ("K8", lambda: cuda_dband.dband_spmm(*argsf))):
        out[kname]["int32"]["float32_sha256"] = f32_digest(
            f"{kname} float32", fn, card)["sha256"]
    del tiles_i, tiles_f, b3, b3f, bsr, kit_i


def _phase22_slab(card, out):
    """K7 in int32 on spgemm-block-181k's plan: ``bsr_smsmm_apply_slab``
    (the prepared route), exact on every 8th output block row against
    SciPy's int64 A @ A."""
    import scipy.sparse as sp

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_bsr

    _, rows, cols, bvals = _spgemm_fixture()
    nb, bsz = SPGEMM_NB, 32
    bi = np.rint(bvals * 1000).astype(np.int32)
    idx = torch.from_numpy((rows * nb + cols).astype(np.int32)).cuda()
    ai = pt.BSR(indices=idx, blocks=torch.from_numpy(bi).cuda(), n=nb * bsz,
                bsz=bsz)
    af = pt.BSR(indices=idx, blocks=torch.from_numpy(bvals).cuda(),
                n=nb * bsz, bsz=bsz)
    dev = idx.device
    t0 = time.perf_counter()
    plan = pt.bsr_smsmm_prepare(ai, ai)
    pp = pt.bsr_smsmm_slab_prepare(plan, ai.nbz, ai.nbz)
    t_prep = time.perf_counter() - t0
    # SciPy's int64 A @ A on every 8th block row and the last
    s = sp.bsr_matrix((bi.astype(np.int64), cols,
                       np.searchsorted(rows, np.arange(nb + 1))),
                      shape=(nb * bsz, nb * bsz))
    sub = np.unique(np.r_[np.arange(0, nb, 8), nb - 1])
    srows = (sub[:, None] * bsz + np.arange(bsz)).reshape(-1)
    ref = (s.tocsr()[srows] @ s).tobsr(blocksize=(bsz, bsz))
    ref.sort_indices()
    oidx = pp.indices.long().cpu().numpy()
    orow = oidx // nb
    sel = np.flatnonzero(np.isin(orow, sub))
    if not np.array_equal(oidx[sel] % nb, ref.indices) or not np.array_equal(
            np.searchsorted(orow[sel], sub), ref.indptr[:-1]):
        raise AssertionError("K7 int32: the output blocks of the subset "
                             "differ from SciPy's")
    check = _int_check("K7 int32", ref.data.reshape(-1))
    selt = torch.from_numpy(sel).to(dev)

    def blocks_check(c):
        return check(c[selt].reshape(-1))

    F = plan.n_products
    flops = 2 * F * bsz ** 3
    cost = ((ai.nbz + plan.nbz_out) * bsz * bsz * 4, flops)
    a_pos, b_pos, seg = plan.a_pos.long(), plan.b_pos.long(), plan.seg.long()

    def yardstick():
        o = ai.blocks.new_zeros(plan.nbz_out, bsz, bsz)
        return o.index_add_(0, seg, torch.bmm(ai.blocks[a_pos],
                                              ai.blocks[b_pos]))

    lib, call = _library("torch.bmm + index_add_ in int32 (K7's yardstick)",
                         yardstick, card)
    print(f"   spgemm-block-181k int32: host prepare {t_prep:.2f} s, {F} "
          f"block products, {plan.nbz_out} output blocks; SciPy's int64 "
          f"product on {sub.size} block rows", flush=True)
    lst = (pp.prod_ptr, pp.prod_ab)
    out["K7"]["int32"] = _new_kind(
        card, "spgemm-block-181k K7 int32 (bsr_smsmm_apply_slab)", "K7",
        lambda: pt.bsr_smsmm_apply_slab(pp, ai, ai).blocks,
        lambda: pt.bsr_smsmm_apply_slab(pp, ai, ai).blocks,
        lambda: cuda_bsr.slab_list_plain(*lst, ai.blocks, ai.blocks,
                                         out_dtype=torch.int32),
        blocks_check, np.zeros(1), cost, torch.int32,
        lambda: pt.bsr_smsmm_apply_slab(pp, af, af).blocks, lib, call)
    out["K7"]["int32"]["setup_s"] = t_prep
    issued = cuda_bsr.bsr_slab_issued(*lst, ai.blocks, ai.blocks,
                                      out_dtype=torch.int32)
    if issued != F:
        raise AssertionError(f"K7 int32: {issued} products multiplied, "
                             f"{F} in the product")
    out["K7"]["int32"]["products_issued"] = issued


def phase22_int_bf16(card, band, sl, ela, m):
    """The int32 kinds of K1 (and K1-r32, K1-mxu), K2, K3-K8 and the bf16
    and float64 kinds of K1 (and its variants) and K2 at the suite's
    sizes: band-10M, elasticity-400k, bell-band-80M (k 128, K5 at k 32)
    and spgemm-block-181k's plan.  Each kind's main path runs with the
    kernel's launch count set to 0 just before and read just after; its
    record holds the kernel against its plain version (int32: equal) and
    NumPy (int32: exact on the oracle's rows; bf16: within 2^-8 |A||v|;
    float64: within 1e-12 |A||v|), bitwise repeatable, its back-to-back
    ms beside its float32 sibling's, its plain version's, its bound and
    the library call's.  Returns {kernel: {kind: record}}."""
    out = {k: {} for k in ("K1", "K1-r32", "K1-mxu", "K2", "K3", "K4",
                           "K4-kit", "K5", "K6", "K7", "K8")}
    _phase22_spmv(card, band, sl, ela, out)
    _phase22_bell(card, m, sl["dband"], out)
    _phase22_slab(card, out)
    launches = {k: {kind: r["launches"] for kind, r in kinds.items()}
                for k, kinds in out.items()}
    print(f"   int32 / bf16 main-path launches: {launches}", flush=True)
    return out


def main():
    with Phase("phase 0: device", 60):
        card = phase0_device()
    with Phase("phase 1: build the CUDA kernels", 240):
        phase1_build()
    with Phase("phase 2: kernels vs plain versions on the card", 180):
        phase2_kernels_vs_plain()
    from sparse_tpu_torch.ops import cuda_csr, cuda_csr_block

    # the main path's run: launch counts start at 0 here
    cuda_csr.K1_LAUNCHES = 0
    cuda_csr_block.K2_LAUNCHES = 0
    with Phase("phase 3: README fixture on the card", 60):
        phase3_readme()
    with Phase("phase 4: 10M-nnz band (segtile rung)", 300):
        band = phase4_band()
    with Phase("phase 5: elasticity-400k (blockseg rung)", 300):
        ela = phase5_elasticity()
    launches = {"K1": cuda_csr.K1_LAUNCHES, "K2": cuda_csr_block.K2_LAUNCHES}
    print(f"   main-path launches: {launches}", flush=True)
    for k, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{k} was not launched by the main path")
    with Phase("phase 6: kernel vs plain at main-path shapes, timing", 180):
        kernels = phase6_timing(card, band, ela, launches)
    with Phase("phase 7: K3-K6 vs plain versions on the card", 180):
        phase7_bell_kernels_vs_plain()
    from sparse_tpu_torch.ops import cuda_bell

    # the SpMM main path's run: launch counts start at 0 here
    for kname in ("K3", "K4", "K4_KIT", "K5", "K6"):
        setattr(cuda_bell, f"{kname}_LAUNCHES", 0)
    with Phase("phase 8: bell_spmm at bench.py's shape, spmm", 240):
        spmm_run = phase8_spmm_main_path()
    spmm_launches = {k: getattr(cuda_bell, k.replace("-", "_").upper()
                                + "_LAUNCHES")
                     for k in ("K3", "K4", "K4-kit", "K5", "K6")}
    print(f"   SpMM main-path launches: {spmm_launches}", flush=True)
    for k, count in spmm_launches.items():
        if count <= 0:
            raise AssertionError(f"{k} was not launched by the main path")
    spmm_run["counts"] = spmm_launches
    with Phase("phase 9: K3-K6 vs plain at the bench shape, timing", 300):
        kernels += phase9_bell_timing(card, spmm_run)
    with Phase("phase 10: K7 vs plain versions on the card", 120):
        phase10_slab_kernel_vs_plain()
    from sparse_tpu_torch.ops import cuda_bsr

    # the SpGEMM main path's run: K7's launch count starts at 0 here
    cuda_bsr.K7_LAUNCHES = 0
    with Phase("phase 11: spgemm(a, a) at the SpGEMM fixture", 300):
        spgemm_run = phase11_spgemm_main_path()
    k7 = cuda_bsr.K7_LAUNCHES
    print(f"   SpGEMM main-path launches: {{'K7': {k7}}}", flush=True)
    if k7 <= 0:
        raise AssertionError("K7 was not launched by the main path")
    with Phase("phase 12: K7 vs plain at the fixture, timing", 240):
        kernels.append(phase12_slab_timing(card, spgemm_run, k7))
    del spgemm_run
    with Phase("phase 13: K1 variants and K8 vs plain versions", 180):
        phase13_variants_vs_plain()
    from sparse_tpu_torch.ops import cuda_dband

    # the slice's own run: the variant and K8 launch counts start at 0 here
    cuda_csr.K1_R32_LAUNCHES = 0
    cuda_csr.K1_MXU_LAUNCHES = 0
    cuda_dband.K8_LAUNCHES = 0
    with Phase("phase 14: the variants, K8 and mm_read at full width", 420):
        slice_run = phase14_slice(band["plan"].state[1].wsub, spmm_run)
    slice_launches = {"K1-r32": cuda_csr.K1_R32_LAUNCHES,
                      "K1-mxu": cuda_csr.K1_MXU_LAUNCHES,
                      "K8": cuda_dband.K8_LAUNCHES}
    print(f"   slice-4 main-path launches: {slice_launches}", flush=True)
    for k, count in slice_launches.items():
        if count <= 0:
            raise AssertionError(f"{k} was not launched by the main path")
    with Phase("phase 15: variants and K8 vs plain at full width, timing",
               300):
        kernels += phase15_timing(card, slice_run, spmm_run,
                                  band["library_ms"], slice_launches)
    bands, spd = _suite_bands()
    # the solve's residual runs the SpMV main path: counts start at 0 here
    cuda_csr.K1_LAUNCHES = 0
    cuda_csr_block.K2_LAUNCHES = 0
    with Phase("phase 16: the direct solver at the suite's block band", 600):
        solver = phase16_direct_solver(card, bands)
    solver_launches = {"K1": cuda_csr.K1_LAUNCHES,
                       "K2": cuda_csr_block.K2_LAUNCHES}
    print(f"   solver-residual launches: {solver_launches}", flush=True)
    rung_kernel = {"segtile": "K1", "blockseg": "K2"}
    for nb, rec in solver.items():
        kname = rung_kernel.get(rec["rung"])
        if kname is None or solver_launches[kname] <= 0:
            raise AssertionError(f"nb {nb}: the residual's rung "
                                 f"{rec['rung']} launched no SpMV kernel")
    with Phase("phase 17: preconditioners, algebra, packed formats", 400):
        slice5 = phase17_precond_algebra_packed(
            card, spd, (slice_run["a"], slice_run["s"]),
            ela["plan"].state[0])
    print(json.dumps({"solver": {str(k): v for k, v in solver.items()},
                      "slice5": slice5, "card": card}), flush=True)
    # the distributed layer's run: K1 and K7 counts start at 0 here
    cuda_csr.K1_LAUNCHES = 0
    cuda_bsr.K7_LAUNCHES = 0
    dist_launches = {}
    with Phase("phase 18: the distributed layer", 480):
        dist, graph = phase18_distributed(card, slice_run, spmm_run, spd,
                                          ela["plan"].state[0],
                                          dist_launches)
    print(f"   distributed-layer launches: {dist_launches}", flush=True)
    for k, count in dist_launches.items():
        if count <= 0:
            raise AssertionError(f"{k} was not launched by the distributed "
                                 "layer")
    for entry in kernels:
        key = entry["name"].split()[0]
        if key in dist_launches:
            entry["dist_launches"] = dist_launches[key]
    dist["dist"]["launches"] = dist_launches
    print(json.dumps(dist), flush=True)
    # the transforms' run: phase 19 sets K1's count to 0 before its vmap
    transform_launches = {}
    with Phase("phase 19: kernel routes under vmap and autodiff", 180):
        transforms = phase19_transforms(card, band, ela, spmm_run,
                                        slice_run, transform_launches)
    print(f"   transforms main-path launches: {transform_launches}",
          flush=True)
    # the examples' run: the kernel counts start at 0 here
    cuda_csr.K1_LAUNCHES = 0
    with Phase("phase 20: the five examples at size", 300):
        examples = phase20_examples(card, graph)
    del graph
    examples_launches = {"K1": cuda_csr.K1_LAUNCHES}
    print(f"   examples' launches: {examples_launches}", flush=True)
    if examples_launches["K1"] <= 0:
        raise AssertionError("K1 was not launched by the examples")
    for entry in kernels:
        key = entry["name"].split()[0]
        if key in transform_launches:
            entry["vmap_launches"] = transform_launches[key]
        if key in examples_launches:
            entry["example_launches"] = examples_launches[key]
    print(json.dumps({"transforms": transforms, "examples": examples,
                      "card": card}, default=float), flush=True)
    with Phase("phase 21: the rest of the surface at size", 360):
        surface, kinds = phase21_surface(card, slice_run,
                                         ela["plan"].state[0], spmm_run)
    print(json.dumps({"surface": surface, "card": card}, default=float),
          flush=True)
    # the int32 / bf16 kinds' run: each kind's launch count starts at 0
    # just before its main path (phase 22)
    with Phase("phase 22: the int32, bf16 and SpMV float64 kinds at size",
               300):
        new_kinds = phase22_int_bf16(card, band, slice_run, ela, spmm_run)
    for kname, recs in new_kinds.items():
        kinds.setdefault(kname, {}).update(recs)
    # the bf16x3, float64, int32 and bf16 kinds of the kernels join their
    # kernels' records
    for entry in kernels:
        entry.update(kinds.get(entry["name"].split()[0], {}))
    missing = sorted(k for k in new_kinds if not any(
        e["name"].split()[0] == k for e in kernels))
    if missing:
        raise AssertionError(f"no kernel record for {missing}")
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

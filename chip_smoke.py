"""End-to-end smoke run of sparse_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``sparse_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version, then drives the user's main
path — CSR from triples or COO, ``smvm_prepare``, ``plan.apply(v)`` — on the
README fixture and on two matrices at realistic size: a 500k-row, ~10M-nnz
band (the ``segtile`` rung, kernel K1) and the 400k-row vector-FEM
elasticity matrix of ``benchmarks/gen_fixtures.py`` (the ``blockseg`` rung,
kernel K2).  Results are checked against SciPy in float64, then the kernels,
their plain versions and ``apply`` are timed with CUDA events.

Every phase has a deadline; any failure exits non-zero before the result
line.  The last two lines of standard output are one JSON object per kernel
run, then ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository, the script fails.
"""

from __future__ import annotations

import faulthandler
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
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


def pipelined_ms(fn, warmup=3, n=N_TIMED):
    """Per-call time in ms of ``n`` calls issued back to back between two
    CUDA events: the device-bound rate, with the host's enqueue time
    overlapped (``median_ms`` times each call alone, host included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _report(cell, label, fn, nnz, slot_bytes, card):
    """Median alone and back-to-back per-call times of ``fn``, with the
    rates they give; returns the median."""
    ms, ms_b2b = median_ms(fn), pipelined_ms(fn)
    print(f"   {cell} {label:9s}: {ms:.4f} ms alone (median of {N_TIMED}), "
          f"{ms_b2b:.4f} ms back to back; {nnz / ms / 1e6:.3f} / "
          f"{nnz / ms_b2b / 1e6:.3f} Gnnz/s; {slot_bytes / ms / 1e6:.1f} / "
          f"{slot_bytes / ms_b2b / 1e6:.1f} GB/s slot stream [{card}]",
          flush=True)
    return ms


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


def phase2_kernels_vs_plain():
    """K1 at wsub 8/16/32 in f32 and f64 (empty rows, lane-conflict spill
    tiles, a padded shuffled raw-array call) and K2, each against its plain
    version on the card, twice for bitwise repeatability; then the README
    fixtures straight through K1."""
    import scipy.sparse as sp

    import sparse_tpu_torch as pt
    from sparse_tpu_torch.ops import cuda_csr, cuda_csr_block

    rng = np.random.default_rng(0)
    n = 20_000
    rows, cols = _band_triples(n, 24, 1500, rng)
    keep = rows % 7 != 3  # every 7th row empty
    rows, cols = rows[keep], cols[keep]
    # row 0: 16 entries on lane 5 within 2048 columns -> spill tiles
    rows = np.concatenate([np.zeros(16, np.int64), rows])
    cols = np.concatenate([5 + 128 * np.arange(16), cols])
    vals = rng.standard_normal(rows.size)
    s = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
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
            raw = dict(n=n, wsub=wsub, rows=8, kstep=plan.kstep,
                       chunks=plan.chunks)
            arrs = (plan.vals, plan.q, plan.seg_of, plan.rb)
            y1 = cuda_csr.segtile_apply(*arrs, v, **raw)
            torch.cuda.synchronize()
            y2 = cuda_csr.segtile_apply(*arrs, v, **raw)
            torch.cuda.synchronize()
            if not torch.equal(y1, y2):
                raise AssertionError(f"K1 wsub={wsub} {dtype}: two runs "
                                     "differ bitwise")
            yp = cuda_csr.segtile_apply_plain(*arrs, v, **raw)
            err = check_close(f"K1 wsub={wsub} {dtype}", y1[:n], yp[:n],
                              bound, dtype)
            empty = y1[3:n:7]
            if not torch.all(empty == 0):
                raise AssertionError("K1: an empty row is not exactly 0")
            # padded raw-array call: 37 inert tiles (rb 0 and last block),
            # whole tile order shuffled
            pad = 37
            t = plan.n_tiles
            p = torch.randperm(t + pad, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(1))
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
                               yp[:n], bound, dtype)
            print(f"   K1 wsub={wsub:2d} {str(dtype):13s} tiles "
                  f"{plan.n_tiles:6d} ({spill} spill tiles on one slot) "
                  f"max|kernel-plain| {err:.3e}, padded+shuffled "
                  f"{err3:.3e}; bitwise repeatable", flush=True)
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
        plan = pt.build_seg_tiles_block(ab, wsub=16)
        v = torch.from_numpy(v_np).to(dtype).cuda()
        y1 = cuda_csr_block.bsr_smvm_segtile_block(ab, v, plan)
        torch.cuda.synchronize()
        y2 = cuda_csr_block.bsr_smvm_segtile_block(ab, v, plan)
        torch.cuda.synchronize()
        if not torch.equal(y1, y2):
            raise AssertionError(f"K2 {dtype}: two runs differ bitwise")
        yp = cuda_csr_block.bsr_smvm_segtile_block_plain(ab, v, plan)
        err = check_close(f"K2 {dtype}", y1, yp, bound, dtype)
        print(f"   K2 wsub=16 {str(dtype):13s} tiles {plan.n_tiles:6d} "
              f"max|kernel-plain| {err:.3e}; bitwise repeatable", flush=True)
    for a, v, want in _readme_cases():
        y = pt.csr_smvm_segtile(a, v, pt.build_seg_tiles(a))
        if not torch.equal(y, want):
            raise AssertionError(f"README fixture {a.shape} through K1: got "
                                 f"{y.tolist()}")
        print(f"   README fixture {a.shape[0]}x{a.shape[1]} through K1: "
              f"{y.tolist()}", flush=True)


def _readme_cases():
    """README fixture (BASELINE config 1) and the 5x5 golden in f64 on the
    card: ``(csr, v, want)``."""
    import sparse_tpu_torch as pt

    cases = [
        (2, 3, [(0, 0, 2), (1, 2, 3)], [10, 20, 30], [20, 90]),
        (5, 5, list(zip([0, 0, 0, 1, 1, 2, 2, 2, 3, 4, 4],
                        [0, 1, 3, 1, 2, 1, 2, 3, 3, 3, 4],
                        [1, 2, 11, 3, 4, 5, 6, 7, 8, 9, 10])),
         [3, 1, 2, 6, 5], [71, 11, 59, 48, 104]),
    ]
    for n, m, triples, vec, want in cases:
        yield (pt.csr_from_triples(n, m, triples, dtype=torch.float64,
                                   device="cuda"),
               torch.tensor(vec, dtype=torch.float64, device="cuda"),
               torch.tensor(want, dtype=torch.float64, device="cuda"))


def phase3_readme():
    """The README fixtures through the main path on the card, with the
    default ladder and with prefer="segtile" (whose fill gate sends these
    tiny matrices to the row-binned rung, as in the reference)."""
    import sparse_tpu_torch as pt

    for a, v, want in _readme_cases():
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
    return dict(plan=plan, v=v, nnz=s.nnz, bound=bound)


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
    return dict(plan=plan, v=v, nnz=s.nnz)


def _time_in_turns(cell, kname, kernel, plain, apply, nnz, slot_bytes,
                   card):
    """Plain, kernel, kernel, plain (so each pair shows its own spread),
    then ``apply``; returns the first kernel and first plain medians."""
    ms_p = _report(cell, "plain", plain, nnz, slot_bytes, card)
    ms_k = _report(cell, f"{kname} kernel", kernel, nnz, slot_bytes, card)
    _report(cell, f"{kname} kernel", kernel, nnz, slot_bytes, card)
    _report(cell, "plain", plain, nnz, slot_bytes, card)
    _report(cell, "apply", apply, nnz, slot_bytes, card)
    return ms_k, ms_p


def phase6_timing(card, band, ela, launches):
    """Kernel vs plain at the main path's shapes (tolerance, bitwise
    repeat), and median times of the kernel and its plain version in turns,
    then of apply."""
    from sparse_tpu_torch.ops import cuda_csr, cuda_csr_block

    out = []
    # K1 on the band plan
    plan, v = band["plan"], band["v"]
    st = plan.state[1]
    a = plan.state[0]
    raw = dict(n=a.shape[0], wsub=st.wsub, rows=8, kstep=st.kstep,
               chunks=st.chunks)
    arrs = (st.vals, st.q, st.seg_of, st.rb)

    def k1():
        return cuda_csr.segtile_apply(*arrs, v, **raw)

    def p1():
        return cuda_csr.segtile_apply_plain(*arrs, v, **raw)

    y, y2, yp = k1(), k1(), p1()
    torch.cuda.synchronize()
    if not torch.equal(y, y2):
        raise AssertionError("K1 at the band's shape: runs differ bitwise")
    n = a.shape[0]
    err1 = check_close("K1 vs plain (band)", y[:n], yp[:n], band["bound"],
                       torch.float32)
    ms_k, ms_p = _time_in_turns("band", "K1", k1, p1, lambda: plan.apply(v),
                                band["nnz"], cuda_csr.segtile_hbm_bytes(st),
                                card)
    out.append({"name": "K1 segtile_csr", "route": "cuda",
                "source": "sparse_tpu_torch/csrc/segtile_csr.cu",
                "replaces": "sparse_tpu/ops/pallas_csr.py:492",
                "launches": launches["K1"], "max_abs_err": err1,
                "ms": ms_k, "plain_ms": ms_p})
    # K2 on the elasticity plan
    plan, v = ela["plan"], ela["v"]
    ab, st = plan.state
    vp = v.reshape(-1, 2)[plan.perm].reshape(-1)

    def k2():
        return cuda_csr_block.bsr_smvm_segtile_block(ab, vp, st)

    def p2():
        return cuda_csr_block.bsr_smvm_segtile_block_plain(ab, vp, st)

    y, y2, yp = k2(), k2(), p2()
    torch.cuda.synchronize()
    if not torch.equal(y, y2):
        raise AssertionError("K2 at the elasticity shape: runs differ "
                             "bitwise")
    bound = _block_bound(ab, vp.abs().double())
    err2 = check_close("K2 vs plain (elasticity)", y, yp, bound,
                       torch.float32)
    ms_k, ms_p = _time_in_turns(
        "elasticity", "K2", k2, p2, lambda: plan.apply(v), ela["nnz"],
        cuda_csr_block.block_segtile_hbm_bytes(st), card)
    out.append({"name": "K2 segtile_block", "route": "cuda",
                "source": "sparse_tpu_torch/csrc/segtile_block.cu",
                "replaces": "sparse_tpu/ops/pallas_csr_block.py:229",
                "launches": launches["K2"], "max_abs_err": err2,
                "ms": ms_k, "plain_ms": ms_p})
    return out


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
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

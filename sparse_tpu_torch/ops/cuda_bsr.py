"""Block-SpGEMM slab apply: kernel K7, its host planners and its gradient.

Port of ``sparse_tpu/ops/pallas_bsr.py``.  The reference's Pallas kernel is
a hand-written CUDA kernel for Hopper here (``csrc/bsr_slab.cu``), and the
names lose their ``_pallas`` infix:

=================================  ==================================
reference                          port
=================================  ==================================
``BsrPallasPlan``                  :class:`BsrSlabPlan`
``BsrPallasPlanAD``                :class:`BsrSlabPlanAD`
``bsr_smsmm_pallas_prepare``       :func:`bsr_smsmm_slab_prepare`
``bsr_smsmm_pallas_prepare_ad``    :func:`bsr_smsmm_slab_prepare_ad`
``bsr_smsmm_apply_pallas``         :func:`bsr_smsmm_apply_slab`
``bsr_smsmm_apply_pallas_ad``      :func:`bsr_smsmm_apply_slab_ad`
``run_slabs_arrays``               :func:`run_slabs_arrays` (K7)
=================================  ==================================

The host planners (``_schedule``, ``_schedule_paired``, ``_chunk_slabs``)
are the reference's NumPy passes to the letter, constants and errors
included, so both packages build the same tables: for each product slot,
the A slot (``a_idx``; a two-block window when ``paired``), the B slot
(``b_idx``) and the output row within its slab (``oloc``); per step, its
slab and whether it opens one (``first``).  The TPU's split into
``pallas_call`` chunks (``chunks``, ``slab`` relative to a chunk) is kept
for parity; K7 ignores it and launches once per apply.

K7 does not walk the slot tables: it walks a product list, ``prod_ptr``
(each output block's first product) and ``prod_ab`` (each product's A slot
and B slot, in slot order within its output block, pads left out), which
the planners build once per plan (:func:`_product_list`), and
``interop.slab_plan_from_arrays`` once per carried plan
(:func:`slot_list`).  On CUDA tensors
the prepared applies launch K7 on the plan's list and on the factors'
blocks as they are (no appended zero block), and :func:`run_slabs_arrays`
derives the list from its slot tables on the device per call, pads kept
(:func:`slot_list`); each launch is counted (``K7_LAUNCHES``).  On CPU
tensors the applies run :func:`run_slabs_arrays_plain`, the reference's
slot-order sums in plain PyTorch (gather the slots' blocks, one batched
matmul in full precision, ``segment_sum`` by output block); the list walk
has its own plain version, :func:`slab_list_plain`.  There is no other
route: tensors on two devices raise ``ValueError``.  Types:
float32 summed in full float32 (no TF32), float64 in float64, bfloat16
summed in float32 and rounded once; any other dtype, a ``precision`` other
than None or ``"highest"``, or (on a CUDA tensor) a block size above 64
raise ``ValueError``.  The gradient (:func:`bsr_smsmm_apply_slab_ad`) is a
``torch.autograd.Function`` whose backward is K7 twice, on the permuted
schedules of :func:`bsr_smsmm_slab_prepare_ad`.  The interpret flag of the
reference is dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from ..formats.bsr import BSR, BsrSmsmmPlan
from ..utils.precision import full_precision
from ._transforms import kernel_call, not_differentiable, vmap_loop
from .segmented import INDEX_DTYPE, segment_sum

__all__ = [
    "BsrSlabPlan",
    "BsrSlabPlanAD",
    "bsr_smsmm_slab_prepare",
    "bsr_smsmm_slab_prepare_ad",
    "schedule_stacked",
    "bsr_smsmm_apply_slab",
    "bsr_smsmm_apply_slab_ad",
    "run_slabs_arrays",
    "run_slabs_arrays_plain",
    "slot_list",
    "slab_list_plain",
    "bsr_slab_issued",
    "bsr_slab_issued_model",
]

#: Launches of K7, counted where :func:`_launch_list` launches it and
#: nowhere else.
K7_LAUNCHES = 0

# Plan parameters calibrated on the TPU (products per grid step, the
# output-slab footprint that sets the default p, and the scalar-prefetch
# budget that caps steps per pallas_call).  Kept so both packages build the
# same plan; they are not tuned for this card.
_G = 24
_SLAB_BYTES = 512 * 1024
_SMEM_BUDGET = 700_000

_MAX_BSZ = 64  # two blocks stay in shared memory
_KIND = {torch.float32: 0, torch.bfloat16: 2, torch.float64: 3}
_PRECISIONS = (None, "highest")


@dataclasses.dataclass(frozen=True)
class BsrSlabPlan:
    """Slab schedule for :func:`bsr_smsmm_apply_slab`.

    ``a_idx``/``b_idx``: (S*g,) int32 factor-block slots (the slot one past
    the stored capacity is the appended zero block); ``oloc``: (S*g,) int32
    output row within the step's slab; ``slab``: (S,) int32 slab id relative
    to the chunk's slab range; ``first``: (S,) int32 1 at each slab's first
    step; ``chunks``: (step0, step1, slab0, slab1) per reference
    ``pallas_call``; ``indices``: the output BSR's sorted block coordinates;
    ``slab_start``: (nslabs+1,) int32 first step of each slab, then S.

    ``paired=True``: ``a_idx`` has (S*g/2,) two-block windows and ``oloc``
    is ``row_in_slab * 2 + a_row_bit`` (the product reads slot
    ``2*window + bit``); the A stream then needs two trailing zero slots.

    ``prod_ptr`` (nbz_out+1,) int32 and ``prod_ab`` (F, 2) int32: the
    product list K7 walks (first product of each output block; each
    product's A slot and B slot, a paired window resolved to its slot, in
    slot order within its output block, pad slots left out), built once
    with the plan: by the planners, or by :func:`slot_list` where a plan is
    carried in from the reference's tables
    (``interop.slab_plan_from_arrays``)."""

    a_idx: torch.Tensor
    b_idx: torch.Tensor
    oloc: torch.Tensor
    slab: torch.Tensor
    first: torch.Tensor
    indices: torch.Tensor
    chunks: tuple
    n: int
    bsz: int
    g: int
    p: int
    nbz_out: int
    slab_start: torch.Tensor
    prod_ptr: torch.Tensor
    prod_ab: torch.Tensor
    paired: bool = False


def _default_gp(bsz: int, g: int | None, p: int | None) -> tuple[int, int]:
    if g is None:
        g = _G
    if p is None:
        p = min(max(_SLAB_BYTES // (bsz * bsz * 4), 8), 128)
    return g, p


def _device_of(indices):
    return indices.device if isinstance(indices, torch.Tensor) else None


def _tables(indices, **arrays):
    dev = _device_of(indices)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def _product_list(out_s, s1_s, s2_s, n_out, slot=None):
    """(prod_ptr, prod_ab) of products sorted by output (``out_s``
    non-decreasing), stream-1 slots ``s1_s`` and stream-2 slots ``s2_s``;
    ``slot``: each product's slot position, where the slot order within an
    output differs from the given one (the paired schedule)."""
    if slot is not None:
        order = np.argsort(slot, kind="stable")
        order = order[np.argsort(out_s[order], kind="stable")]
        out_s, s1_s, s2_s = out_s[order], s1_s[order], s2_s[order]
    ptr = np.zeros(n_out + 1, np.int64)
    np.cumsum(np.bincount(out_s, minlength=n_out), out=ptr[1:])
    return ptr.astype(np.int32), np.stack([s1_s, s2_s], 1).astype(np.int32)


def _schedule(out_pos, s1_pos, s2_pos, pad1, pad2, n_out, indices,
              g, p, n, bsz) -> BsrSlabPlan:
    """Generic slab schedule: for product f, read stream-1 slot
    ``s1_pos[f]`` and stream-2 slot ``s2_pos[f]`` and accumulate their
    block product into output slot ``out_pos[f]`` (capacity ``n_out``).
    ``pad1``/``pad2`` are the streams' appended-zero slots.  Products are
    stably sorted by output slot; empty slabs still get one zeroing step."""
    out_pos = np.asarray(out_pos, np.int64)
    order = np.argsort(out_pos, kind="stable")
    out_s = out_pos[order]
    s1_s = np.asarray(s1_pos, np.int64)[order]
    s2_s = np.asarray(s2_pos, np.int64)[order]
    F = out_s.size
    step_cap = max(_SMEM_BUDGET // ((3 * g + 2) * 4), 256)
    while True:
        nslabs = max(-(-n_out // p), 1)
        slab_of_prod = out_s // p if F else np.zeros(0, np.int64)
        counts = np.bincount(slab_of_prod, minlength=nslabs) if F else \
            np.zeros(nslabs, np.int64)
        steps_per = -(-np.maximum(counts, 1) // g)
        # chunks split only on slab boundaries, so no single slab may
        # exceed the steps-per-call cap: shrink the slab size until it fits
        if int(steps_per.max(initial=1)) <= step_cap:
            break
        if p == 1:
            raise ValueError(
                f"bsr_smsmm_slab_prepare: one output block has "
                f"{int(counts.max())} products — more than the "
                f"{step_cap * g} a single pallas_call's scalar-prefetch "
                f"SMEM budget covers even at p=1; use bsr_smsmm_apply "
                f"for this pattern"
            )
        p = max(p // 2, 1)
    sstarts = np.zeros(nslabs + 1, np.int64)
    np.cumsum(steps_per, out=sstarts[1:])
    S = int(sstarts[-1])
    a_idx = np.full(S * g, pad1, np.int32)  # zero-block slot (pad)
    b_idx = np.full(S * g, pad2, np.int32)
    oloc = np.zeros(S * g, np.int32)  # pads aim at slab row 0 (add 0)
    if F:
        pstart = np.zeros(nslabs + 1, np.int64)
        np.cumsum(counts, out=pstart[1:])
        rank = np.arange(F) - pstart[slab_of_prod]
        pos = sstarts[slab_of_prod] * g + rank
        a_idx[pos] = s1_s
        b_idx[pos] = s2_s
        oloc[pos] = (out_s - slab_of_prod * p).astype(np.int32)
    slab_of_step = np.repeat(np.arange(nslabs, dtype=np.int64), steps_per)
    first = np.zeros(S, np.int32)
    first[sstarts[:-1]] = 1
    chunks, slab_rel = _chunk_slabs(sstarts, slab_of_step, S, step_cap)
    prod_ptr, prod_ab = _product_list(out_s, s1_s, s2_s, n_out)
    return BsrSlabPlan(
        **_tables(indices, a_idx=a_idx, b_idx=b_idx, oloc=oloc,
                  slab=slab_rel, first=first,
                  slab_start=sstarts.astype(np.int32), prod_ptr=prod_ptr,
                  prod_ab=prod_ab),
        indices=indices,
        chunks=tuple(chunks),
        n=n,
        bsz=bsz,
        g=g,
        p=p,
        nbz_out=n_out,
    )


def _schedule_paired(out_pos, s1_pos, s2_pos, pad1, pad2, n_out, indices,
                     g, p, n, bsz) -> BsrSlabPlan:
    """:func:`_schedule` with the A stream read in two-block windows.

    Products within each slab are grouped by even-aligned A-slot window
    (slots {2w, 2w+1}); any two products of one window share one entry, and
    a row bit packed into ``oloc`` selects which half each product reads.
    Table encoding: ``a_idx`` is (S*g/2,) window indices; ``oloc`` is
    (S*g,) ``row_in_slab * 2 + a_row_bit``.  ``pad1`` must be an even slot
    whose pair is zero blocks (callers append 2-3 zero blocks to reach even
    alignment)."""
    assert g % 2 == 0, "paired schedule needs an even g"
    assert pad1 % 2 == 0, "paired schedule needs an even-aligned zero pair"
    gp = g // 2
    out_pos = np.asarray(out_pos, np.int64)
    order = np.argsort(out_pos, kind="stable")
    out_s = out_pos[order]
    s1_s = np.asarray(s1_pos, np.int64)[order]
    s2_s = np.asarray(s2_pos, np.int64)[order]
    F = out_s.size
    step_cap = max(_SMEM_BUDGET // ((3 * g + gp + 2) * 4), 256)
    while True:
        nslabs = max(-(-n_out // p), 1)
        slab_of_prod = out_s // p if F else np.zeros(0, np.int64)
        counts = np.bincount(slab_of_prod, minlength=nslabs) if F else \
            np.zeros(nslabs, np.int64)
        # worst-case pair-slot need per slab (every product unpaired)
        if int((-(-np.maximum(counts, 1) // gp)).max(initial=1)) <= step_cap:
            break
        if p == 1:
            raise ValueError(
                "bsr_smsmm_slab_prepare(paired): one output block "
                "exceeds the SMEM budget even at p=1; use the unpaired "
                "schedule"
            )
        p = max(p // 2, 1)

    pstart = np.zeros(nslabs + 1, np.int64)
    np.cumsum(counts, out=pstart[1:])
    # per slab: order products by window, then pair equal windows
    slab_pairs = []  # (win, f1, f2) with f2 = -1 for singles
    steps_per = np.zeros(nslabs, np.int64)
    for sl in range(nslabs):
        lo, hi = int(pstart[sl]), int(pstart[sl + 1])
        if lo == hi:
            slab_pairs.append([])
            steps_per[sl] = 1
            continue
        win = s1_s[lo:hi] >> 1
        ordw = np.argsort(win, kind="stable")
        entries = []
        k = 0
        while k < ordw.size:
            f1 = lo + int(ordw[k])
            w = int(win[ordw[k]])
            if k + 1 < ordw.size and int(win[ordw[k + 1]]) == w:
                entries.append((w, f1, lo + int(ordw[k + 1])))
                k += 2
            else:
                entries.append((w, f1, -1))
                k += 1
        slab_pairs.append(entries)
        steps_per[sl] = -(-len(entries) // gp)

    sstarts = np.zeros(nslabs + 1, np.int64)
    np.cumsum(steps_per, out=sstarts[1:])
    S = int(sstarts[-1])
    a_idx = np.full(S * gp, pad1 >> 1, np.int32)  # pad window: zero pair
    b_idx = np.full(S * g, pad2, np.int32)
    oloc = np.zeros(S * g, np.int32)
    slot_of = np.zeros(F, np.int64)  # each product's slot position

    def put(ps, half, f):
        slot_of[f] = 2 * ps + half
        b_idx[2 * ps + half] = s2_s[f]
        sl = int(out_s[f]) // p
        oloc[2 * ps + half] = ((int(out_s[f]) - sl * p) << 1) | (
            int(s1_s[f]) & 1)

    for sl in range(nslabs):
        base = int(sstarts[sl])
        for k, (w, f1, f2) in enumerate(slab_pairs[sl]):
            ps = base * gp + k
            a_idx[ps] = w
            put(ps, 0, f1)
            if f2 >= 0:
                put(ps, 1, f2)
    slab_of_step = np.repeat(np.arange(nslabs, dtype=np.int64), steps_per)
    first_step = np.zeros(S, np.int32)
    first_step[sstarts[:-1]] = 1
    chunks, slab_rel = _chunk_slabs(sstarts, slab_of_step, S, step_cap)
    prod_ptr, prod_ab = _product_list(out_s, s1_s, s2_s, n_out, slot_of)
    return BsrSlabPlan(
        **_tables(indices, a_idx=a_idx, b_idx=b_idx, oloc=oloc,
                  slab=slab_rel, first=first_step,
                  slab_start=sstarts.astype(np.int32), prod_ptr=prod_ptr,
                  prod_ab=prod_ab),
        indices=indices,
        chunks=chunks,
        n=n,
        bsz=bsz,
        g=g,
        p=p,
        nbz_out=n_out,
        paired=True,
    )


def _chunk_slabs(sstarts, slab_of_step, S, step_cap):
    """Chunk the step range on slab boundaries (each reference
    ``pallas_call`` owns a contiguous output range) under the per-call step
    cap.  Returns (chunks, slab_rel) as in :class:`BsrSlabPlan`."""
    chunks = []
    s0 = 0
    while s0 < S:
        s1 = min(s0 + step_cap, S)
        if s1 < S:
            sl = slab_of_step[s1]
            s1 = int(sstarts[sl])
            if s1 <= s0:
                s1 = int(sstarts[sl + 1])
        sl0 = int(slab_of_step[s0])
        sl1 = int(slab_of_step[s1 - 1]) + 1
        chunks.append((s0, s1, sl0, sl1))
        s0 = s1
    slab_rel = (slab_of_step - np.repeat(
        np.asarray([c[2] for c in chunks], np.int64),
        np.asarray([c[1] - c[0] for c in chunks], np.int64),
    )).astype(np.int32) if S else np.zeros(0, np.int32)
    return tuple(chunks), slab_rel


def schedule_stacked(out_pos_list, s1_list, s2_list, pad1, pad2,
                     n_out: int, g: int | None, p: int | None, bsz: int):
    """Multi-shard slab schedule with one step / slab layout for all
    shards (the reference's, for its one ``shard_map`` trace): the
    per-slab step count is the max over shards, and ``first`` / ``slab`` /
    ``chunks`` are shared; only ``a_idx`` / ``b_idx`` / ``oloc`` differ.
    Returns ``(a_idx, b_idx, oloc, first, slab, chunks, g, p)``, the first
    three ``(D, S*g)`` and ``first`` / ``slab`` ``(S,)``.  Empty shards
    still have one inert step per slab (pad slots)."""
    g, p = _default_gp(bsz, g, p)
    D = len(out_pos_list)
    step_cap = max(_SMEM_BUDGET // ((3 * g + 2) * 4), 256)
    srt = []
    for t in range(D):
        op = np.asarray(out_pos_list[t], np.int64)
        order = np.argsort(op, kind="stable")
        srt.append((op[order], np.asarray(s1_list[t], np.int64)[order],
                    np.asarray(s2_list[t], np.int64)[order]))
    while True:
        nslabs = max(-(-n_out // p), 1)
        counts = np.zeros((D, nslabs), np.int64)
        for t in range(D):
            if srt[t][0].size:
                counts[t] = np.bincount(srt[t][0] // p, minlength=nslabs)
        steps_per = -(-np.maximum(counts.max(axis=0), 1) // g)
        if int(steps_per.max(initial=1)) <= step_cap:
            break
        if p == 1:
            raise ValueError(
                "schedule_stacked: one output block exceeds a single "
                "pallas_call's scalar-prefetch SMEM budget even at p=1; "
                "use the XLA apply for this pattern"
            )
        p = max(p // 2, 1)
    sstarts = np.zeros(nslabs + 1, np.int64)
    np.cumsum(steps_per, out=sstarts[1:])
    S = int(sstarts[-1])
    a_idx = np.full((D, S * g), pad1, np.int32)
    b_idx = np.full((D, S * g), pad2, np.int32)
    oloc = np.zeros((D, S * g), np.int32)
    for t in range(D):
        out_s, s1_s, s2_s = srt[t]
        F = out_s.size
        if not F:
            continue
        slab_of_prod = out_s // p
        pstart = np.zeros(nslabs + 1, np.int64)
        np.cumsum(counts[t], out=pstart[1:])
        rank = np.arange(F) - pstart[slab_of_prod]
        pos = sstarts[slab_of_prod] * g + rank
        a_idx[t, pos] = s1_s
        b_idx[t, pos] = s2_s
        oloc[t, pos] = (out_s - slab_of_prod * p).astype(np.int32)
    slab_of_step = np.repeat(np.arange(nslabs, dtype=np.int64), steps_per)
    first = np.zeros(S, np.int32)
    first[sstarts[:-1]] = 1
    chunks, slab_rel = _chunk_slabs(sstarts, slab_of_step, S, step_cap)
    return a_idx, b_idx, oloc, first, slab_rel, chunks, g, p


def bsr_smsmm_slab_prepare(plan: BsrSmsmmPlan, nbz_a: int, nbz_b: int,
                           g: int | None = None, p: int | None = None,
                           paired: bool = False) -> BsrSlabPlan:
    """Host-side slab schedule from a block-product plan (once per pattern
    pair).  ``nbz_a``/``nbz_b``: the factors' stored block capacities (the
    appended zero block lands at that slot).  Defaults: ``g=24`` products
    per step, slab size ``p`` from a 512 KB footprint (TPU-calibrated,
    kept for parity).  ``paired=True`` reads the A stream in two-block
    windows (:func:`_schedule_paired`)."""
    g, p = _default_gp(plan.bsz, g, p)
    sched = _schedule_paired if paired else _schedule
    # paired: the zero PAIR must start even-aligned — an odd capacity gets
    # one extra zero block (apply appends 2 + (nbz & 1) zeros to match)
    pad_a = nbz_a + (nbz_a & 1) if paired else nbz_a
    return sched(
        plan.seg.cpu().numpy(), plan.a_pos.cpu().numpy(),
        plan.b_pos.cpu().numpy(), pad_a, nbz_b, plan.nbz_out, plan.indices,
        g, p, plan.n, plan.bsz,
    )


@dataclasses.dataclass(frozen=True)
class BsrSlabPlanAD:
    """Forward + two backward slab schedules for the differentiable apply.

    ``da`` accumulates dC[seg] @ B[b_pos]^T into A's block slots; ``db``
    accumulates A[a_pos]^T @ dC[seg] into B's block slots (both K7 with
    permuted schedules)."""

    fwd: BsrSlabPlan
    da: BsrSlabPlan
    db: BsrSlabPlan


def bsr_smsmm_slab_prepare_ad(plan: BsrSmsmmPlan, nbz_a: int, nbz_b: int,
                              g: int | None = None,
                              p: int | None = None) -> BsrSlabPlanAD:
    """Like :func:`bsr_smsmm_slab_prepare`, plus the two gradient schedules
    consumed by :func:`bsr_smsmm_apply_slab_ad`."""
    g, p = _default_gp(plan.bsz, g, p)
    seg = plan.seg.cpu().numpy()
    a_pos = plan.a_pos.cpu().numpy()
    b_pos = plan.b_pos.cpu().numpy()
    dev = plan.indices.device
    fwd = _schedule(seg, a_pos, b_pos, nbz_a, nbz_b, plan.nbz_out,
                    plan.indices, g, p, plan.n, plan.bsz)
    da = _schedule(a_pos, seg, b_pos, plan.nbz_out, nbz_b, nbz_a,
                   torch.arange(nbz_a, dtype=INDEX_DTYPE, device=dev),
                   g, p, plan.n, plan.bsz)
    db = _schedule(b_pos, a_pos, seg, nbz_a, plan.nbz_out, nbz_b,
                   torch.arange(nbz_b, dtype=INDEX_DTYPE, device=dev),
                   g, p, plan.n, plan.bsz)
    return BsrSlabPlanAD(fwd=fwd, da=da, db=db)


# -- the slab apply -----------------------------------------------------------


def _append_zero(blocks: torch.Tensor, dtype, k: int = 1) -> torch.Tensor:
    bsz = blocks.shape[-1]
    return torch.cat([blocks.to(dtype),
                      blocks.new_zeros((k, bsz, bsz), dtype=dtype)])


def _check_call(out_dtype, precision) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"run_slabs_arrays: precision must be one of "
                         f"{_PRECISIONS}, got {precision!r}")
    if out_dtype not in _KIND:
        raise ValueError(f"run_slabs_arrays: dtype {out_dtype} is not one "
                         "of float32, float64, bfloat16")


def _on_cuda(name: str, *tensors) -> bool:
    """False for all-CPU tensors, True for tensors on one CUDA device;
    anything else raises ``ValueError``."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    raise ValueError(f"{name}: tensors must share one CPU or CUDA device, "
                     f"got {sorted(str(d) for d in devices)}")


def _slab_starts(first: torch.Tensor, nslabs: int) -> torch.Tensor:
    """(nslabs+1,) first step of each slab, then the end of the last one,
    from ``first`` on its device (no host sync): every slab has exactly one
    step with ``first == 1``, in slab order."""
    S = first.shape[0]
    slab_of_step = torch.cumsum(first.long(), 0) - 1
    starts = torch.full((nslabs + 1,), S, dtype=torch.long,
                        device=first.device)
    starts.scatter_reduce_(0, slab_of_step.clamp(0, nslabs),
                           torch.arange(S, device=first.device),
                           reduce="amin")
    return starts.to(torch.int32)


def slot_list(a_idx, b_idx, oloc, slab_start, *, g: int, p: int,
              nbz_out: int, paired: bool = False, caps=None):
    """The product list (``prod_ptr``, ``prod_ab``) of a slot schedule, on
    its device (without a host sync unless ``caps`` is given): each slot's
    global output block
    (slab * p + row, the slab read off ``slab_start``) and its A and B
    slots (a paired window resolved by the row bit), stably sorted by
    output, so each output's products stay in slot order.  Pad slots are
    kept (they read the appended zero blocks) unless ``caps`` = (stored A
    blocks, stored B blocks) is given: then every slot that reads past
    either is left out, which is exactly the pads."""
    dev = b_idx.device
    nslots = b_idx.shape[0]
    step = torch.arange(nslots, device=dev) // g
    slab = torch.searchsorted(slab_start[1:].long(), step, right=True)
    oloc = oloc.long()
    out = slab * p + (oloc >> 1 if paired else oloc)
    if paired:
        a = 2 * a_idx.long().repeat_interleave(2) + (oloc & 1)
    else:
        a = a_idx.long()
    b = b_idx.long()
    if caps is not None:
        keep = (a < caps[0]) & (b < caps[1])
        out, a, b = out[keep], a[keep], b[keep]
    out, order = torch.sort(out, stable=True)
    ptr = torch.searchsorted(out, torch.arange(nbz_out + 1, device=dev))
    ab = torch.stack([a[order], b[order]], 1)
    return ptr.to(torch.int32), ab.to(torch.int32).contiguous()


def _launch_list(name, prod_ptr, prod_ab, z1, z2, bsz, out_dtype,
                 count=None) -> torch.Tensor:
    """K7 on the product list: ``(nbz_out, bsz, bsz)`` blocks in
    ``out_dtype``.  The factors are passed as they are (cast only where
    their dtype differs).  ``count``: an int64 counter on the card that
    gets the products multiplied; such a launch is not a launch of the
    main path and is not counted in ``K7_LAUNCHES``.  The factors go
    through :func:`~sparse_tpu_torch.ops._transforms.kernel_call`
    (``vmap`` launches once per slice; derivatives raise)."""
    if bsz > _MAX_BSZ:
        raise ValueError(f"{name}: block size {bsz} > {_MAX_BSZ} (two "
                         "blocks must fit in shared memory)")
    nbz_out = prod_ptr.shape[0] - 1

    def launch(z1, z2):
        # the lists are prepared here, where no transform wraps them
        global K7_LAUNCHES
        ptr = prod_ptr.to(torch.int32).contiguous()
        ab = prod_ab.to(torch.int32).contiguous()
        dev = z1.device
        z1c = z1.to(out_dtype).contiguous()
        z2c = z2.to(out_dtype).contiguous()
        out = torch.empty((nbz_out, bsz, bsz), dtype=out_dtype, device=dev)
        with torch.cuda.device(dev):
            rc = _kernels.load().bsr_slab(
                _KIND[out_dtype], z1c.data_ptr(), z2c.data_ptr(),
                ptr.data_ptr(), ab.data_ptr(), out.data_ptr(), nbz_out, bsz,
                None if count is None else count.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check(rc, name)
        if count is None:
            K7_LAUNCHES += 1
        return out

    if count is not None:
        return launch(z1, z2)
    return kernel_call(name, launch, z1, z2)


def run_slabs_arrays(p_a_idx, p_b_idx, p_oloc, p_first, p_slab,
                     z1: torch.Tensor, z2: torch.Tensor, *, chunks,
                     bsz: int, g: int, p: int, nbz_out: int, out_dtype,
                     precision=None, paired: bool = False,
                     slab_start: torch.Tensor | None = None) -> torch.Tensor:
    """Raw-array slab apply (K7 on CUDA tensors, :func:`run_slabs_arrays_plain`
    on CPU tensors): ``(nbz_out, bsz, bsz)`` blocks, block ``o`` the sum, in
    slot order, of ``z1[a] @ z2[b]`` over the slots aimed at it.  ``z1`` and
    ``z2`` carry the appended zero block(s) at the plan's pad slots.  On the
    card the slot tables become a product list per call
    (:func:`slot_list`, one device sort; pads kept).  ``slab_start`` (from
    the plan) saves deriving the slab step ranges from ``p_first``;
    ``chunks`` and ``p_slab`` are the reference's and only the plain
    version reads them."""
    name = "run_slabs_arrays"
    _check_call(out_dtype, precision)
    tensors = (p_a_idx, p_b_idx, p_oloc, p_first, z1, z2)
    if nbz_out == 0:
        return torch.zeros((0, bsz, bsz), dtype=out_dtype, device=z1.device)
    if not _on_cuda(name, *tensors):
        return run_slabs_arrays_plain(
            p_a_idx, p_b_idx, p_oloc, p_first, p_slab, z1, z2, chunks=chunks,
            bsz=bsz, g=g, p=p, nbz_out=nbz_out, out_dtype=out_dtype,
            precision=precision, paired=paired)
    if bsz > _MAX_BSZ:
        raise ValueError(f"{name}: block size {bsz} > {_MAX_BSZ} (two "
                         "blocks must fit in shared memory)")

    def apply(z1, z2):
        starts = slab_start if slab_start is not None else \
            _slab_starts(p_first, -(-nbz_out // p))
        ptr, ab = slot_list(p_a_idx, p_b_idx, p_oloc, starts, g=g, p=p,
                            nbz_out=nbz_out, paired=paired)
        return _launch_list(name, ptr, ab, z1, z2, bsz, out_dtype)

    # the per-call product list goes to the kernel: a transform sees the
    # whole route as one launch
    return kernel_call(name, apply, z1, z2)


def run_slabs_arrays_plain(p_a_idx, p_b_idx, p_oloc, p_first, p_slab,
                           z1: torch.Tensor, z2: torch.Tensor, *, chunks,
                           bsz: int, g: int, p: int, nbz_out: int, out_dtype,
                           precision=None,
                           paired: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the slot-table apply (any device): gather
    every slot's two blocks, one batched matmul in full precision (float32
    sums for bf16), and ``segment_sum`` by global output block in slot
    order.  The global block of a slot is ``(chunk slab0 + slab[t]) * p +
    row``, as in the reference's ``pallas_call`` chunks."""
    _check_call(out_dtype, precision)
    dev = z1.device
    if nbz_out == 0:
        return torch.zeros((0, bsz, bsz), dtype=out_dtype, device=dev)
    sl0 = torch.from_numpy(np.repeat(
        np.asarray([c[2] for c in chunks], np.int64),
        np.asarray([c[1] - c[0] for c in chunks], np.int64))).to(dev)
    step_slab = (sl0 + p_slab.long()).repeat_interleave(g)  # (S*g,)
    oloc = p_oloc.long()
    rows = oloc >> 1 if paired else oloc
    out_id = step_slab * p + rows
    if paired:
        a_slot = 2 * p_a_idx.long().repeat_interleave(2) + (oloc & 1)
    else:
        a_slot = p_a_idx.long()
    acc = torch.float64 if out_dtype == torch.float64 else torch.float32
    with full_precision(acc):
        prods = torch.bmm(z1.to(acc)[a_slot], z2.to(acc)[p_b_idx.long()])
    blocks = segment_sum(prods, out_id, nbz_out)
    return blocks.to(out_dtype)


def slab_list_plain(prod_ptr, prod_ab, z1: torch.Tensor, z2: torch.Tensor,
                    *, out_dtype, precision=None) -> torch.Tensor:
    """Plain PyTorch version of K7's list walk (any device): gather the
    product pairs, one batched matmul in full precision (float32 sums for
    bf16), then ``segment_sum`` by output block in list order; an output
    with no product is zero."""
    _check_call(out_dtype, precision)
    nbz_out = prod_ptr.shape[0] - 1
    bsz = z1.shape[-1]
    dev = z1.device
    ab = prod_ab.long()
    out_id = torch.repeat_interleave(
        torch.arange(nbz_out, device=dev), torch.diff(prod_ptr.long()),
        output_size=ab.shape[0])
    acc = torch.float64 if out_dtype == torch.float64 else torch.float32
    if ab.shape[0] == 0:
        return torch.zeros((nbz_out, bsz, bsz), dtype=out_dtype, device=dev)
    with full_precision(acc):
        prods = torch.bmm(z1.to(acc)[ab[:, 0]], z2.to(acc)[ab[:, 1]])
    return segment_sum(prods, out_id, nbz_out).to(out_dtype)


def bsr_slab_issued(prod_ptr, prod_ab, z1: torch.Tensor, z2: torch.Tensor,
                    *, out_dtype) -> int:
    """Products K7 multiplies on the list, as the kernel counts them on the
    card (each team adds the products it walked).  One launch into a
    scratch output, outside ``K7_LAUNCHES``; CUDA tensors only, so there is
    no plain version (:func:`bsr_slab_issued_model` is what it should
    read)."""
    name = "bsr_slab_issued"
    _check_call(out_dtype, None)
    if not _on_cuda(name, prod_ptr, prod_ab, z1, z2):
        raise ValueError(f"{name}: counts on the card only, got CPU tensors")
    if prod_ptr.shape[0] <= 1:
        return 0
    count = torch.zeros(1, dtype=torch.int64, device=z1.device)
    _launch_list(name, prod_ptr, prod_ab, z1, z2, z1.shape[-1], out_dtype,
                 count)
    return int(count.item())


def bsr_slab_issued_model(prod_ptr) -> int:
    """Host model of :func:`bsr_slab_issued`: every product of the list
    once, ``prod_ptr[-1]``."""
    return int(prod_ptr[-1]) if prod_ptr.shape[0] else 0


def _run_slabs(pplan: BsrSlabPlan, z1, z2, out_dtype, precision):
    return run_slabs_arrays(
        pplan.a_idx, pplan.b_idx, pplan.oloc, pplan.first, pplan.slab,
        z1, z2, chunks=pplan.chunks, bsz=pplan.bsz, g=pplan.g, p=pplan.p,
        nbz_out=pplan.nbz_out, out_dtype=out_dtype, precision=precision,
        paired=pplan.paired, slab_start=pplan.slab_start)


def _apply(name, pplan: BsrSlabPlan, x, y, out_dtype, precision, ka=1):
    """One prepared apply, C[o] = sum of x[a] @ y[b] over the plan: on the
    card K7 on the plan's list and the blocks as they are; on the CPU the
    slot-table plain version, over the blocks with their zero pads (``ka``
    of them on x)."""
    _check_call(out_dtype, precision)
    tensors = (pplan.b_idx, x, y)
    if pplan.nbz_out == 0 or not _on_cuda(name, *tensors):
        return _run_slabs(pplan, _append_zero(x, out_dtype, ka),
                          _append_zero(y, out_dtype), out_dtype, precision)
    return _launch_list(name, pplan.prod_ptr, pplan.prod_ab, x, y, pplan.bsz,
                        out_dtype)


def bsr_smsmm_apply_slab(pplan: BsrSlabPlan, a: BSR, b: BSR, *,
                         precision=None) -> BSR:
    """Numeric block SpGEMM through the slab apply (values may change, the
    block structure must not).  Deterministic: products accumulate in plan
    order within each output block.  Not differentiable — use
    :func:`bsr_smsmm_apply_slab_ad` for autograd."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    ka = 2 + (a.blocks.shape[0] & 1) if pplan.paired else 1
    blocks = _apply("bsr_smsmm_apply_slab", pplan, a.blocks, b.blocks,
                    out_dtype, precision, ka)
    return BSR(indices=pplan.indices, blocks=blocks, n=pplan.n,
               bsz=pplan.bsz)


class _SlabApplyAD(torch.autograd.Function):
    """C = A @ B on the forward schedule; dA and dB on the permuted
    schedules, each one more slab apply.  ``vmap`` runs one apply per
    slice; forward mode raises, as JAX's ``custom_vjp`` refuses it."""

    @staticmethod
    def forward(plans, precision, a_blocks, b_blocks):
        out_dtype = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
        return _apply("bsr_smsmm_apply_slab_ad", plans.fwd, a_blocks,
                      b_blocks, out_dtype, precision)

    @staticmethod
    def setup_context(ctx, inputs, output):
        plans, precision, a_blocks, b_blocks = inputs
        ctx.plans, ctx.precision = plans, precision
        ctx.save_for_backward(a_blocks, b_blocks)

    @staticmethod
    def backward(ctx, ct):
        a_blocks, b_blocks = ctx.saved_tensors
        plans, precision = ctx.plans, ctx.precision
        out_dtype = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
        name = "bsr_smsmm_apply_slab_ad"
        da = db = None
        if ctx.needs_input_grad[2]:
            # dA[a_pos] += dC[seg] @ B[b_pos]^T
            da = _apply(name, plans.da, ct, b_blocks.transpose(1, 2),
                        out_dtype, precision).to(a_blocks.dtype)
        if ctx.needs_input_grad[3]:
            # dB[b_pos] += A[a_pos]^T @ dC[seg]
            db = _apply(name, plans.db, a_blocks.transpose(1, 2), ct,
                        out_dtype, precision).to(b_blocks.dtype)
        return None, None, da, db

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(not_differentiable(
            "bsr_smsmm_apply_slab_ad", "forward"))

    @staticmethod
    def vmap(info, in_dims, plans, precision, a_blocks, b_blocks):
        return vmap_loop(
            info, in_dims[2:],
            lambda x, y: _SlabApplyAD.apply(plans, precision, x, y),
            (a_blocks, b_blocks))


def bsr_smsmm_apply_slab_ad(plans: BsrSlabPlanAD, a: BSR, b: BSR, *,
                            precision=None) -> BSR:
    """Differentiable :func:`bsr_smsmm_apply_slab`: autograd runs both
    gradient products through the same slab apply (K7 on CUDA tensors) on
    the permuted schedules of :func:`bsr_smsmm_slab_prepare_ad`."""
    blocks = _SlabApplyAD.apply(plans, precision, a.blocks, b.blocks)
    return BSR(indices=plans.fwd.indices, blocks=blocks, n=plans.fwd.n,
               bsz=plans.fwd.bsz)

"""Blocked-ELL SpMM: kernels K3-K6, the banded planner and its kits.

Port of ``sparse_tpu/ops/pallas_bell.py``.  The reference's four Pallas
kernels are hand-written CUDA kernels for Hopper here, one wrapper each,
with the ``_pallas`` infix dropped:

==============================  ===========================  ================
reference                       port                         CUDA source
==============================  ===========================  ================
``bell_spmm_pallas``            :func:`bell_spmm_block` (K6)  ``bell_spmm.cu``
``bell_spmm_pallas_fused``      :func:`bell_spmm_fused` (K3)  ``bell_spmm.cu``
``bell_spmm_pallas_banded``     :func:`bell_spmm_banded` (K4) ``bell_banded.cu``
``bell_spmm_pallas_banded_t``   :func:`bell_spmm_banded_t`    ``bell_banded.cu``
                                (K5)
==============================  ===========================  ================

On CUDA tensors a wrapper launches its kernel (``csrc/``, built at first
use) and counts the launch (``K3_LAUNCHES`` ... ``K6_LAUNCHES``); on CPU
tensors it runs its ``_plain`` sibling, the same product in plain PyTorch.
There is no other route: tensors on a CUDA device never reach the plain
version, and tensors on two devices raise ``ValueError``.

The planner (:func:`build_banded_plan`) is the reference's host numpy pass,
copied to the letter, TPU lane alignment included, so both packages build
the same :class:`BandedPlan` — its fields decide the padded-operand contract
of K5.  The super-tile fields (``S``, ``SW``, ``rel``, ``sup``) only shared a
DMA window on the TPU; ``start == sup.repeat(S) + rel`` by construction, so
K4 and K5 read ``start`` and ignore them.

Every stream of K3, K4 (and K8) and K5 skips the band's all-zero 32 x 32
chunks: K3, K8 and K4 on raw tiles by a vote inside the kernel on what they
read; K5 and K4 on a kit (``bell_spmm(plan=kit)``) by the kit's chunk mask
(:attr:`BandedKitT.chunk_nz`, :attr:`BandedKit.chunk_nz`, built once with
the kit), so they do not read them.  K6 runs one of three bodies
(:func:`_k6_body`, mirroring ``csrc/bell_spmm.cu``'s ``k6_body``): every
stream at bsz <= 64
(float64: 32) its persistent body, which skips a padding slot's zero block
by a vote per stored block; past bsz 64 its float32, bf16, bf16x3 and
float64 streams the wide-block body (``csrc/wide_body.cuh``: 128-row tiles
fed by a TMA ring, float32 on 8 x 8 FFMA register tiles, bf16 on
``wgmma``), which votes per 64 rows and 32-index slice of a stored block,
where bsz and k times the element size are multiples of 16 bytes; int32
and the other shapes K3's kernel on the wide row, which skips its
all-zero 32 x 32 chunks, so where bsz is not a multiple of 32 a chunk that
straddles a stored block and a padding block is multiplied whole.
A skipped chunk or block never meets the operand: an Inf or NaN in B
opposite it gives the sparse answer (as SciPy and ``BSR @ B`` do), where
the reference's dense product gives NaN.  Each has an issued-work counter
(:func:`fused_issued_flops`, :func:`banded_issued_flops`,
:func:`banded_t_issued`, :func:`block_issued_flops`) beside a host model
of what it should count.

Precision, as the reference's ``_resolve_precision``: float32 streams are
full float32 (no TF32); ``precision="bf16x3"`` splits each float32 operand
into a bf16 high part and a bf16 residual and sums hi*hi + hi*lo + lo*hi in
float32 (``_dot_bf16x3``); ``compute_dtype=torch.bfloat16`` streams bf16 and
accumulates in float32.  Streams are float32, bfloat16, float64 (float64
accumulates in float64) or int32 (multiply-adds modulo 2^32, the
reference's wrapping int32 result, in any order; ``precision="bf16x3"``
raises for it, as it does for float64: the reference's K3, K6 and XLA
route refuse it there, and its K4 and K5 round an int32 stream through
bf16); anything else raises ``ValueError``.  An int32 BELL with
``compute_dtype=torch.bfloat16`` streams bf16 with float32 sums and
returns int32, as the reference computes it (its result rounds each
partial product to bf16, so the two agree within the bf16 gate).  K3, K4,
K5 and K6 run bf16x3 on the tensor cores (three bf16 ``mma.sync`` products
a float32 pair, one float32 accumulator), int32 on the CUDA cores (the
float32 tiling, integer multiply-adds) and float64 on DMMA (``mma.sync``
m8n8k4).  The interpret flag of the reference is dropped.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from .. import _kernels
from ..formats.bell import BELL
from ..utils.precision import contract
from ._transforms import kernel_call

__all__ = [
    "BandedPlan",
    "BandedKit",
    "BandedKitT",
    "build_banded_plan",
    "bell_banded_prepare",
    "bell_banded_prepare_t",
    "bell_banded_refresh",
    "banded_spmm_hbm_bytes",
    "banded_spmm_t_hbm_bytes",
    "banded_issued_flops",
    "banded_issued_model",
    "chunk_mask",
    "fused_issued_flops",
    "fused_issued_model",
    "block_issued_flops",
    "block_issued_model",
    "banded_t_issued",
    "banded_t_issued_model",
    "bell_spmm_block",
    "bell_spmm_block_plain",
    "bell_spmm_fused",
    "bell_spmm_fused_plain",
    "bell_spmm_banded",
    "bell_spmm_banded_plain",
    "bell_spmm_banded_t",
    "bell_spmm_banded_t_plain",
]

#: Launches of each CUDA kernel, counted where its wrapper launches it and
#: nowhere else.
K3_LAUNCHES = 0
K4_LAUNCHES = 0  # K4's vote body: raw tiles, a BandedPlan
K4_KIT_LAUNCHES = 0  # K4's mask body: bell_spmm(plan=kit)
K5_LAUNCHES = 0
K6_LAUNCHES = 0

_STREAMS = (torch.float32, torch.bfloat16, torch.float64, torch.int32)
_PRECISIONS = (None, "highest", "bf16x3")
# stream kinds of the C entry points (csrc/bell_kinds.cuh, enum Kind)
_KIND = {torch.float32: 0, torch.bfloat16: 2, torch.float64: 3,
         torch.int32: 4}
_KIND_F32_SPLIT = 1
# the float32 / bf16 bodies' tiling, as the kernels set it: K3/K4/K8's
# output rows and columns per thread block and contraction chunk
# (csrc/band_body.cuh: band::kBM, kBN, Cfg<T>::kBK); K5's C^T rows per
# thread block, panel rows and columns per warp (csrc/bell_banded.cu:
# band_t::kBN, kBK, kSlice)
_BAND_BM, _BAND_BN, _BAND_BK = 32, 128, 32
_BT_BN, _BT_BK, _BT_SLICE = 32, 32, 32


# -- precision ----------------------------------------------------------------


def _resolve_precision(precision, stream_dtype):
    """Correct-by-default precision: ``"highest"`` (full float32, no TF32)
    for float32 streams when none is asked for; ``"bf16x3"`` opts into the
    three-product split.  Other values raise ``ValueError``."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got "
                         f"{precision!r}")
    if precision is not None:
        return precision
    if stream_dtype == torch.float32:
        return "highest"
    return None


def _stream_mode(name: str, stream_dtype, precision) -> bool:
    """Check the stream dtype and precision; True for the bf16x3 split (a
    bf16 stream has no residual to split, so it needs none)."""
    if stream_dtype not in _STREAMS:
        raise ValueError(f"{name}: stream dtype {stream_dtype} is not one of "
                         "float32, bfloat16, float64, int32")
    prec = _resolve_precision(precision, stream_dtype)
    if prec == "bf16x3" and stream_dtype in (torch.float64, torch.int32):
        raise ValueError(f"{name}: precision='bf16x3' needs a float32 or "
                         f"bfloat16 stream, got {stream_dtype}")
    return prec == "bf16x3" and stream_dtype == torch.float32


def _acc_dtype(stream_dtype):
    if stream_dtype in (torch.float64, torch.int32):
        return stream_dtype
    return torch.float32


def _bf16_parts(x: torch.Tensor):
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def _contract(spec: str, x, y, stream_dtype, split: bool):
    """``einsum(spec, x, y)`` at the kernels' precision: operands in the
    stream dtype, products and sums in the accumulator dtype
    (``utils.precision.contract``: full float32, and int32 exactly on any
    device, wrapping as the kernels do)."""
    acc = _acc_dtype(stream_dtype)
    x, y = x.to(stream_dtype).to(acc), y.to(stream_dtype).to(acc)
    if not split:
        return contract(spec, x, y)
    xh, xl = _bf16_parts(x)
    yh, yl = _bf16_parts(y)
    return (contract(spec, xh, yh) + contract(spec, xh, yl)
            + contract(spec, xl, yh))


# -- operands and devices -----------------------------------------------------


def _operand(name: str, a: BELL, b):
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    if b.dim() != 2 or b.shape[0] != a.n:
        raise ValueError(f"{name}: operand shape {tuple(b.shape)} != "
                         f"({a.n}, k)")
    return b, torch.promote_types(a.dtype, b.dtype)


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


# element bytes of the streams K6's wide-block body takes
_WIDE_ELEM = {torch.float32: 4, torch.bfloat16: 2, torch.float64: 8}


def _k6_body(bsz: int, k: int, stream_dtype) -> str:
    """The body K6 runs (``csrc/bell_spmm.cu``'s ``k6_body``): at bsz <= 64
    (float64: 32, its ring's stages) ``"persistent"``; past bsz 64 the
    float32 (with or without the bf16x3 split), bf16 and float64 streams
    ``"wide"`` where a TMA map can describe the arrays (bsz and k times the
    element size multiples of 16 bytes); int32 and every other shape
    ``"band"``, K3's band body.  Reads the shapes and the stream only."""
    if bsz <= (32 if stream_dtype == torch.float64 else 64):
        return "persistent"
    elem = _WIDE_ELEM.get(stream_dtype, 0)
    if elem and bsz > 64 and bsz * elem % 16 == 0 and k * elem % 16 == 0:
        return "wide"
    return "band"


def _kind(stream_dtype, split: bool) -> int:
    return _KIND_F32_SPLIT if split else _KIND[stream_dtype]


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start 16-byte
    aligned (a contiguous view into a larger tensor)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, fn, *args, device) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _kernels.check(rc, name)


# -- K6 / K3: one block row per thread-block row ------------------------------


def _gather_einsum(a: BELL, b, stream_dtype, split: bool):
    """C = A @ B by gathering every slot's operand panel into an (nb, Lb,
    bsz, k) tensor and one batched contraction: the plain version of K3 and
    K6, and ``bell_spmm(prefer_pallas=False)``."""
    k = b.shape[1]
    panels = b.to(stream_dtype).reshape(a.nb, a.bsz, k)[
        a.cols.reshape(-1).long()].reshape(a.nb, a.Lb, a.bsz, k)
    out = _contract("rlij,rljk->rik", a.blocks, panels, stream_dtype, split)
    return out.reshape(a.n, k)


def _rowwise(name: str, which: str, a: BELL, b, compute_dtype, precision,
             plain: bool, count: torch.Tensor | None = None):
    """K3 (``which="fused"``) or K6 (``"block"``) on CUDA tensors, the
    gather-einsum on CPU tensors or with ``plain``.  With ``count`` (an
    int64 scalar on the card) the launch goes to the kernel's issued-work
    entry instead, which adds the multiply-adds its vote kept to ``count``
    and is left out of the launch counters."""
    b, out_dtype = _operand(name, a, b)
    k = b.shape[1]
    stream = compute_dtype or out_dtype
    split = _stream_mode(name, stream, precision)
    if count is not None and not _on_cuda(name, a.blocks, a.cols, b):
        raise ValueError(f"{name}: counts every stream at every bsz, on the "
                         "card only; got CPU tensors")
    if a.n == 0 or a.Lb == 0 or k == 0:
        return torch.zeros(a.n, k, dtype=out_dtype, device=b.device)
    if plain or not _on_cuda(name, a.blocks, a.cols, b):
        return _gather_einsum(a, b, stream, split).to(out_dtype)
    body = _k6_body(a.bsz, k, stream) if which == "block" else "band"
    # K6's persistent and wide-block bodies round their bf16 sums as they
    # store them; the band body writes them in float32
    direct = stream == torch.bfloat16 and body != "band"

    def launch(blocks, b):
        # index tensors are prepared here, where no transform wraps them
        global K3_LAUNCHES, K6_LAUNCHES
        cols = a.cols.to(torch.int32).contiguous()
        blocks = blocks.to(stream).contiguous()
        bs = b.to(stream).contiguous()
        if body == "wide":  # its tensor maps take 16-byte aligned bases
            blocks, bs = _aligned16(blocks), _aligned16(bs)
        out = torch.empty(a.n, k, dtype=stream if direct
                          else _acc_dtype(stream), device=b.device)
        lib = _kernels.load()
        args = (_kind(stream, split), blocks.data_ptr(), cols.data_ptr(),
                bs.data_ptr(), out.data_ptr(), a.nb, a.Lb, a.bsz, k)
        if count is not None:
            fn = (lib.bell_fused_issued if which == "fused"
                  else lib.bell_block_issued)
            _launch(name, fn, *args, count.data_ptr(), device=b.device)
        else:
            fn = lib.bell_fused if which == "fused" else lib.bell_block
            _launch(name, fn, *args, device=b.device)
            if which == "fused":
                K3_LAUNCHES += 1
            else:
                K6_LAUNCHES += 1
        return out.to(out_dtype)

    if count is not None:
        return launch(a.blocks, b)
    return kernel_call(name, launch, a.blocks, b)


def bell_spmm_block(a: BELL, b, *, precision=None) -> torch.Tensor:
    """C[n, k] = A @ B, one stored block at a time (K6 on CUDA tensors, its
    plain version on CPU tensors).  Streams at the result dtype."""
    return _rowwise("bell_spmm_block", "block", a, b, None, precision, False)


def bell_spmm_block_plain(a: BELL, b, *, precision=None) -> torch.Tensor:
    """Plain PyTorch version of K6 (any device): the gather-einsum."""
    return _rowwise("bell_spmm_block", "block", a, b, None, precision, True)


def bell_spmm_fused(a: BELL, b, *, compute_dtype=None,
                    precision=None) -> torch.Tensor:
    """C[n, k] = A @ B, one wide (bsz, Lb*bsz) @ (Lb*bsz, k) contraction per
    block row (K3 on CUDA tensors, its plain version on CPU tensors).
    ``compute_dtype=torch.bfloat16`` streams bf16 with float32 sums."""
    return _rowwise("bell_spmm_fused", "fused", a, b, compute_dtype,
                    precision, False)


def bell_spmm_fused_plain(a: BELL, b, *, compute_dtype=None,
                          precision=None) -> torch.Tensor:
    """Plain PyTorch version of K3 (any device): the gather-einsum."""
    return _rowwise("bell_spmm_fused", "fused", a, b, compute_dtype,
                    precision, True)


def _nonzero_chunks(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(n, ceil(R/rows), ceil(C/cols)) bool of ``x`` (n, R, C): whether each
    rows x cols chunk holds a non-zero element (NaN does, -0 does not, as
    the kernels read magnitude bits)."""
    n, r, c = x.shape
    nz = x != 0
    if r % rows or c % cols:
        nz = torch.nn.functional.pad(nz, (0, -c % cols, 0, -r % rows))
    return nz.reshape(n, nz.shape[1] // rows, rows, nz.shape[2] // cols,
                      cols).any(4).any(2)


def _band_body_model(a: torch.Tensor, k: int) -> int:
    """Operations (2 per multiply-add) that the body of
    ``csrc/band_body.cuh`` issues on A's (n, M, K) at width ``k``, in every
    kind: one 32 x 32 x (k rounded up to 128) product for each 32 x 32
    chunk of A that is not zero throughout, where its vote keeps it (bf16x3
    splits each into three bf16 products and counts it once)."""
    kept = int(_nonzero_chunks(a, _BAND_BM, _BAND_BK).sum())
    return kept * 2 * _BAND_BM * _BAND_BK * (-(-k // _BAND_BN) * _BAND_BN)


def fused_issued_model(a: BELL, k: int, *, compute_dtype=None) -> int:
    """Host model of what K3's body issues on ``a`` at width ``k``, in every
    kind (what :func:`fused_issued_flops` should read; the bf16x3 split
    keeps exactly the float32 stream's chunks): the band body's count over
    each block row's wide row [A_r0 | ... | A_r,Lb-1]."""
    wide = a.blocks.to(compute_dtype or a.dtype).transpose(1, 2).reshape(
        a.nb, a.bsz, a.Lb * a.bsz)
    return _band_body_model(wide, k)


def banded_issued_model(tiles: torch.Tensor, k: int) -> int:
    """Host model of what K4's and K8's body issues on the densified
    ``tiles`` (ntiles, M, K) at width ``k`` (what
    :func:`banded_issued_flops` should read): the same for every kind, a
    float64 kit's and a bf16x3 call's those of the float32 kind."""
    return _band_body_model(tiles, k)


def _issued(name: str, which: str, a: BELL, b, compute_dtype,
            precision=None) -> int:
    count = torch.zeros(1, dtype=torch.int64, device=a.device)
    _rowwise(name, which, a, b, compute_dtype, precision, False, count)
    return 2 * int(count.item())


def fused_issued_flops(a: BELL, b, *, compute_dtype=None,
                       precision=None) -> int:
    """Operations (two per multiply-add) that K3's body issues on ``a``
    against ``b``, as the kernel counts them: each thread block adds the
    chunks its zero-chunk vote kept, at their full size, to a counter on
    the card (a bf16x3 chunk once, though it issues three bf16 products).
    One launch into a scratch output, outside ``K3_LAUNCHES``.  Every
    stream (float32, bf16, bf16x3, float64, int32), on CUDA tensors only;
    the count is the kernel's, so there is no plain version
    (:func:`fused_issued_model` is what it should read)."""
    return _issued("fused_issued_flops", "fused", a, b, compute_dtype,
                   precision)


_GEOMETRY_K3 = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm",
                "tiles", "grid", "chunks_per_tile", "walks")


def fused_geometry(nb: int, Lb: int, bsz: int, k: int,
                   stream_dtype=torch.float32, precision=None) -> dict:
    """K3's launched geometry for blocks (nb, Lb, bsz, bsz) at width ``k``
    in the stream ``stream_dtype`` (float32 with ``precision="bf16x3"``: the
    split), 16-byte aligned, from the CUDA runtime on the current card:
    registers and local (spilled) bytes a thread, dynamic shared bytes and
    resident 128-thread blocks an SM, the tiles (32 rows x 128 columns of a
    block row's output), the thread blocks a launch takes, the 32-index
    chunks a tile, and ``walks``: whether the kind walks its tiles on at
    most the resident blocks with one ring each (bf16, bf16x3, float64) or
    takes a thread block a tile (float32, int32).  Card only: raises where
    the kernels cannot be built."""
    out = (ctypes.c_int * len(_GEOMETRY_K3))()
    kind = _kind(stream_dtype, precision == "bf16x3")
    _kernels.check(_kernels.load().bell_fused_geometry(kind, nb, Lb, bsz, k,
                                                       out),
                   "fused_geometry")
    geo = dict(zip(_GEOMETRY_K3, out))
    geo["walks"] = bool(geo["walks"])
    return geo


_GEOMETRY_BAND = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm",
                  "rows_per_block")


def banded_geometry(M: int, K: int, k: int, stream_dtype=torch.float32, *,
                    masked: bool = False) -> dict:
    """K4's and K8's launched geometry for tiles (., M, K) at width ``k`` in
    the stream ``stream_dtype``, 16-byte aligned: the vote body's kernel,
    or with ``masked`` the mask body's (K4's kit route), from the CUDA
    runtime on the current card: registers and local (spilled) bytes a
    thread, shared bytes and resident 128-thread blocks an SM, and the
    output rows a thread block takes.  Card only: raises where the kernels
    cannot be built."""
    out = (ctypes.c_int * len(_GEOMETRY_BAND))()
    _kernels.check(_kernels.load().bell_banded_geometry(
        _kind(stream_dtype, False), int(masked), M, K, k, out),
        "banded_geometry")
    return dict(zip(_GEOMETRY_BAND, out))


def _wide_body_model(blocks: torch.Tensor, k: int) -> int:
    """Operations (2 per multiply-add) that K6's wide-block body issues on
    the stored blocks (n, bsz, bsz) at width ``k``: for each 64-row group
    and 32-index slice of a block that is not zero throughout (NaN is not,
    -0 is), its rows x indices x k multiply-adds, so bsz * bsz * k per
    non-zero stored block."""
    bsz = blocks.shape[-1]
    kept = _nonzero_chunks(blocks, 64, _BAND_BK).cpu()
    rows = (bsz - 64 * torch.arange(kept.shape[1])).clamp(max=64)
    idx = (bsz - _BAND_BK * torch.arange(kept.shape[2])).clamp(max=_BAND_BK)
    return 2 * int((kept * rows[:, None] * idx[None, :]).sum()) * k


def block_issued_model(a: BELL, k: int, *, stream_dtype=None,
                       precision=None) -> int:
    """Host model of what K6's body issues on ``a`` at width ``k``, in every
    kind (what :func:`block_issued_flops` should read), in operations (2
    per multiply-add), on the body :func:`_k6_body` names for the stream
    (``precision="bf16x3"`` with a float32 one is the split kind).  On the
    persistent body (bsz <= 64, float64 32): for each stored block, and
    each 32-row group of it that is not zero throughout in the stream dtype
    (NaN is not, -0 is), its rows x bsz x k multiply-adds, so bsz * bsz * k
    per non-zero stored block at bsz <= 32.  On the wide-block body: the
    same for each 64-row group and 32-index slice (:func:`_wide_body_model`).
    On K3's band body: :func:`fused_issued_model`.  bf16x3 (a float32
    stream) counts each once, as float32 does: its three products split the
    same multiply-adds."""
    bsz = a.bsz
    stream = stream_dtype or a.dtype
    _stream_mode("block_issued_model", stream, precision)
    body = _k6_body(bsz, k, stream)
    if body == "band":
        return fused_issued_model(a, k, compute_dtype=stream_dtype)
    blocks = a.blocks.to(stream).reshape(-1, bsz, bsz)
    if body == "wide":
        return _wide_body_model(blocks, k)
    kept = _nonzero_chunks(blocks, _BAND_BM, bsz)[:, :, 0]  # (blocks, groups)
    rows = (bsz - _BAND_BM * torch.arange(kept.shape[1])).clamp(max=_BAND_BM)
    return 2 * int((kept.cpu() * rows).sum()) * bsz * k


def block_issued_flops(a: BELL, b, *, precision=None) -> int:
    """Operations (two per multiply-add) that K6's body issues on ``a``
    against ``b``, as the kernel counts them: on the persistent body (bsz
    <= 64, float64 32) each thread block adds, for every stored block its
    vote kept, the multiply-adds of its tile's rows and columns, to a
    counter on the card (a bf16x3 block once); on the wide-block body each
    warpgroup, for every 32-index slice its vote kept, its useful rows x
    the slice's useful indices x the tile's useful columns; on K3's band
    body, that body's count (:func:`fused_issued_flops`).
    One launch into a scratch output, outside ``K6_LAUNCHES``.  Every stream
    (float32, bf16, float64, int32; ``precision="bf16x3"`` splits a float32
    one) at every bsz, on CUDA tensors only; the count is the kernel's, so
    there is no plain version (:func:`block_issued_model` is what it should
    read)."""
    return _issued("block_issued_flops", "block", a, b, None, precision)


# -- the banded plan ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandedPlan:
    """Static plan of the banded kernels (K4/K5).

    ``offs`` (nb_pad,) int32: each block row's window offset (first column -
    tile start); ``start`` (ntiles,) int32: first operand panel of each row
    tile; ``W``: window width in panels; ``rt``: block rows per tile.  The
    super-tile fields — ``S`` row tiles sharing one ``SW``-panel window that
    starts at ``sup``, each tile ``rel`` panels into it — are the reference's
    TPU grouping, kept for parity (``start == sup.repeat(S) + rel``)."""

    offs: torch.Tensor
    start: torch.Tensor
    rel: torch.Tensor
    sup: torch.Tensor
    W: int
    rt: int
    S: int
    SW: int


def build_banded_plan(a: BELL, row_tile: int = 8, max_window: int = 64,
                      max_super_window: int = 128, slot_valid=None,
                      align_start: bool = False) -> BandedPlan | None:
    """Plan for matrices whose rows store *consecutive* block columns
    (bands / FEM meshes in BELL layout, slots column-sorted with padding at
    the end).  Returns None when some row's valid slots are not a
    consecutive ascending run, or the window would exceed ``max_window``
    panels — callers then use the fused kernel.

    ``slot_valid`` (optional host ``(nb, Lb)`` bool) marks the stored slots;
    without it validity is ``blocks != 0``, reduced on the BELL's device and
    copied to the host as (nb, Lb) bools.  ``align_start`` is the transposed
    kernel's plan (the reference's TPU lane alignment, kept for parity: it
    fixes K5's padded operand length)."""
    nb, Lb, bsz = a.nb, a.Lb, a.bsz
    rt = max(1, row_tile)
    if nb == 0 or Lb == 0:
        return None
    # aligned plans pad the tile count to a multiple of 8 so the super-tile
    # grouping always has a dividing candidate; pad tiles are empty rows
    nb_pad = (-(-nb // (rt * 8)) * (rt * 8) if align_start
              else -(-nb // rt) * rt)
    ntiles = nb_pad // rt
    cols_h = np.zeros((nb_pad, Lb), np.int64)
    cols_h[:nb] = a.cols.cpu().numpy()
    if slot_valid is None:
        slot_valid_in = (a.blocks != 0).any(-1).any(-1).cpu().numpy()
    else:
        slot_valid_in = np.asarray(slot_valid, bool)
        if slot_valid_in.shape != (nb, Lb):
            raise ValueError(
                f"build_banded_plan: slot_valid shape {slot_valid_in.shape}"
                f" != ({nb}, {Lb})")
    slot_valid = np.zeros((nb_pad, Lb), bool)
    slot_valid[:nb] = slot_valid_in
    # valid slots must be a prefix (padding at the end) with cols c0, c0+1, ..
    nvalid = slot_valid.sum(axis=1)
    idx = np.arange(Lb)[None, :]
    if np.any(slot_valid & (idx >= nvalid[:, None])):
        return None  # valid slots are not a prefix
    first = cols_h[:, 0].copy()
    first[nvalid == 0] = 0
    expect = first[:, None] + idx
    if np.any(slot_valid & (cols_h != expect)):
        return None  # not consecutive ascending
    # tile start = min first over rows that store anything (empty rows,
    # the nb_pad tail included, follow their tile's start with offset 0)
    big = np.where(nvalid > 0, first, np.iinfo(np.int64).max).reshape(
        ntiles, rt)
    start = big.min(axis=1)
    empty = start == np.iinfo(np.int64).max
    if empty.any():
        if empty.all():
            start[:] = 0
        else:
            # empty tiles follow their nearest non-empty neighbour instead
            # of 0, which would blow the super-tile span up to ~nb
            nz = np.flatnonzero(~empty)
            idx = np.searchsorted(nz, np.arange(ntiles), side="right") - 1
            start = start[nz[np.clip(idx, 0, nz.size - 1)]]
    lane_q = 128 // math.gcd(bsz, 128)
    if align_start:
        start = (start // lane_q) * lane_q
    first[nvalid == 0] = start.repeat(rt)[nvalid == 0]
    W = int((first.reshape(ntiles, rt) - start[:, None]).max()) + Lb
    W = -(-W // lane_q) * lane_q
    if align_start:
        # aligned starts cannot always keep start + W <= nb, so K5 reads an
        # operand padded to nb_pad panels (= its padded output length, so
        # chained calls feed C^T straight back); clamping into nb_pad - W
        # keeps coverage exact
        if W > nb_pad:
            W = nb_pad  # tiny matrix: one whole-operand window
        if W > max_window:
            return None
        start = np.minimum(start, nb_pad - W)
    else:
        if W > max_window or W > nb:
            return None
        # clamp each window into [0, nb - W]: the operand is read unpadded;
        # every valid block's column c <= nb - 1 stays inside its window
        start = np.minimum(start, nb - W)
    offs = (first - start.repeat(rt)).astype(np.int32)
    # super-tile grouping: the largest S whose group window fits the budget
    S, SW = 1, W
    sup = start.copy()
    rel = np.zeros(ntiles, np.int64)
    limit = nb_pad if align_start else nb
    for cand in (8, 5, 4, 3, 2):
        if ntiles % cand:
            continue
        g = start.reshape(ntiles // cand, cand)
        sup_c = g.min(axis=1)
        span = int((g - sup_c[:, None]).max()) + W
        SW_c = -(-span // lane_q) * lane_q
        if SW_c > max_super_window or SW_c > limit:
            continue
        S, SW = cand, SW_c
        sup = np.minimum(sup_c, limit - SW)
        rel = start - sup.repeat(cand)
        break
    dev = a.device
    return BandedPlan(
        offs=torch.from_numpy(offs).to(dev),
        start=torch.from_numpy(start.astype(np.int32)).to(dev),
        rel=torch.from_numpy(rel.astype(np.int32)).to(dev),
        sup=torch.from_numpy(sup.astype(np.int32)).to(dev),
        W=W,
        rt=rt,
        S=S,
        SW=SW,
    )


def _densify_band_tiles(a: BELL, plan: BandedPlan, stream_dtype):
    """(ntiles, rt*bsz, W*bsz) dense banded tiles from the BELL blocks, on
    the BELL's device: each block row's wide panel [A_0 | A_1 | ...] lands
    at column offset ``offs[r]*bsz`` of its tile (a gather and a mask)."""
    nb, bsz, Lb = a.nb, a.bsz, a.Lb
    W, rt = plan.W, plan.rt
    nb_pad = plan.offs.shape[0]
    wide = a.blocks.to(stream_dtype).transpose(1, 2).reshape(nb, bsz,
                                                             Lb * bsz)
    if nb_pad != nb:
        wide = torch.cat([wide, wide.new_zeros(nb_pad - nb, bsz, Lb * bsz)])
    c = torch.arange(W * bsz, device=wide.device)[None, :]
    src = c - plan.offs.long()[:, None] * bsz
    ok = (src >= 0) & (src < Lb * bsz)
    srcc = src.clamp(0, Lb * bsz - 1)
    dense = torch.gather(wide, 2, srcc[:, None, :].expand(nb_pad, bsz,
                                                          W * bsz))
    dense = torch.where(ok[:, None, :], dense, dense.new_zeros(()))
    return dense.reshape(nb_pad // rt, rt * bsz, W * bsz)


@dataclasses.dataclass(frozen=True)
class BandedKit:
    """Plan + densified tiles of :func:`bell_banded_prepare`, passed to
    ``bell_spmm(..., plan=kit)``.  The tiles are bound to the matrix VALUES:
    re-prepare, or :func:`bell_banded_refresh`, after updating the blocks.

    ``chunk_nz`` (ntiles, ceil(M/32), ceil(K/32)) uint8 is built with the
    kit, whoever builds it, on the tiles' device: 1 where a 32 x 32 chunk
    of the tiles (ntiles, M, K) holds a non-zero element (NaN does, -0 does
    not; an int32 tile any set bit), the chunks K4's vote would keep.  K4
    on the kit reads only the chunks it marks.  It is plan data; the
    reference's kit has no such field (187,500 bytes at ``bench.py``'s
    band).  Tiles edited in place keep a stale mask: the kit is
    value-bound, and :func:`bell_banded_refresh` builds a new one."""

    plan: BandedPlan
    tiles: torch.Tensor
    chunk_nz: torch.Tensor = dataclasses.field(init=False, repr=False,
                                               compare=False)

    def __post_init__(self):
        object.__setattr__(self, "chunk_nz", _nonzero_chunks(
            self.tiles, _BAND_BM, _BAND_BK).to(torch.uint8))


def chunk_mask(tiles_t: torch.Tensor) -> torch.Tensor:
    """(ntiles, ceil(K/32), ceil(M/32)) uint8 of ``tiles_t`` (ntiles, K, M),
    on its device: 1 where a 32 x 32 chunk (32 contraction rows of one
    32-column slice) holds a non-zero element (NaN does, -0 does not)."""
    return _nonzero_chunks(tiles_t, _BT_BK, _BT_SLICE).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class BandedKitT:
    """Plan + TRANSPOSED densified tiles (ntiles, W*bsz, rt*bsz) for
    :func:`bell_spmm_banded_t`, from :func:`bell_banded_prepare_t`.
    Value-bound like :class:`BandedKit`.

    ``chunk_nz`` is built with the kit (:func:`chunk_mask` of the tiles, on
    their device), whoever builds it: K5 reads only the chunks it marks.
    It is plan data; the reference's kit has no such field."""

    plan: BandedPlan
    tiles_t: torch.Tensor
    chunk_nz: torch.Tensor = dataclasses.field(init=False, repr=False,
                                               compare=False)

    def __post_init__(self):
        object.__setattr__(self, "chunk_nz", chunk_mask(self.tiles_t))


def bell_banded_prepare(a: BELL, row_tile: int | None = None,
                        max_window: int = 64, compute_dtype=None,
                        slot_valid=None) -> BandedKit | None:
    """Build the banded plan and densified tiles of ``a`` once.

    Returns None when the pattern is not consecutive-column (use the fused
    kernel).  ``row_tile=None`` picks the largest rt <= 8 dividing nb.
    ``compute_dtype=torch.bfloat16`` stores the tiles as bf16 (the kernel
    then streams the operand as bf16 too, summing in float32).
    ``slot_valid``: see :func:`build_banded_plan`."""
    if row_tile is None:
        nb = a.nb
        row_tile = next((rt for rt in (8, 7, 6, 5, 4, 3, 2)
                         if nb % rt == 0), 1) if nb else 8
    plan = build_banded_plan(a, row_tile=row_tile, max_window=max_window,
                             slot_valid=slot_valid)
    if plan is None:
        return None
    tiles = _densify_band_tiles(a, plan, compute_dtype or a.dtype)
    return BandedKit(plan=plan, tiles=tiles)


def bell_banded_prepare_t(a: BELL, row_tile: int | None = None,
                          max_window: int = 64, compute_dtype=None,
                          slot_valid=None) -> BandedKitT | None:
    """Build the plan and transposed tiles of the small-k kernel (K5).

    ``row_tile=None`` picks the smallest rt with ``rt*bsz`` a multiple of
    128 (the reference's TPU output width, kept so both packages pad alike;
    W and with it the tile bytes grow with rt).  Returns None when an
    explicit rt is misaligned or the pattern is not banded."""
    if row_tile is None:
        row_tile = 128 // math.gcd(a.bsz, 128)
    if (row_tile * a.bsz) % 128:
        return None
    plan = build_banded_plan(a, row_tile=row_tile, max_window=max_window,
                             slot_valid=slot_valid, align_start=True)
    if plan is None:
        return None
    tiles = _densify_band_tiles(a, plan, compute_dtype or a.dtype)
    return BandedKitT(plan=plan, tiles_t=tiles.transpose(1, 2).contiguous())


def bell_banded_refresh(kit: BandedKit, a: BELL) -> BandedKit:
    """Re-densify a kit's tiles from NEW block values of the SAME pattern
    (the host plan is reused).  ``ValueError`` when ``a``'s block rows or
    block size do not fit the kit."""
    plan = kit.plan
    if (a.nb > plan.offs.shape[0] or a.bsz * plan.W != kit.tiles.shape[2]
            or a.bsz * plan.rt != kit.tiles.shape[1]):
        raise ValueError(
            f"bell_banded_refresh: a BELL of {a.nb} block rows of size "
            f"{a.bsz} does not fit a kit of tiles {tuple(kit.tiles.shape)}")
    return BandedKit(plan=plan, tiles=_densify_band_tiles(a, plan,
                                                          kit.tiles.dtype))


def banded_spmm_hbm_bytes(kit: BandedKit, bsz: int, n: int, k: int,
                          out_itemsize: int = 4) -> int:
    """Device-memory bytes of one banded SpMM by the reference's model: the
    densified tiles once, one ``SW``-panel operand window per super-step,
    and the output once.  (K4 on the card reads its windows through L2 per
    tile; the model is kept so both packages report the same bytes.)"""
    plan = kit.plan
    esz = kit.tiles.element_size()
    ntiles = kit.tiles.shape[0]
    window_bytes = (ntiles // plan.S) * plan.SW * bsz * k * esz
    return kit.tiles.numel() * esz + window_bytes + n * k * out_itemsize


def banded_spmm_t_hbm_bytes(kit: BandedKitT, bsz: int, n: int, k: int,
                            out_itemsize: int = 4) -> int:
    """Bytes of one transposed banded SpMM, the same model: tiles once, one
    (k, SW*bsz) window per super-step, C^T once."""
    plan = kit.plan
    esz = kit.tiles_t.element_size()
    ntiles = kit.tiles_t.shape[0]
    window_bytes = (ntiles // plan.S) * k * plan.SW * bsz * esz
    return kit.tiles_t.numel() * esz + window_bytes + n * k * out_itemsize


def _check_mask(name: str, mask: torch.Tensor, tiles: torch.Tensor):
    """``ValueError`` unless ``mask`` is a uint8 chunk mask of ``tiles``
    (ntiles, M, K) on their device: (ntiles, ceil(M/32), ceil(K/32))."""
    nt, m, kk = tiles.shape
    want = (nt, -(-m // _BAND_BM), -(-kk // _BAND_BK))
    if (not isinstance(mask, torch.Tensor) or mask.dtype != torch.uint8
            or mask.device != tiles.device or tuple(mask.shape) != want
            or not mask.is_contiguous()):
        got = ((tuple(mask.shape), mask.dtype, str(mask.device))
               if isinstance(mask, torch.Tensor) else type(mask).__name__)
        raise ValueError(f"{name}: chunk mask {got} does not fit tiles "
                         f"{tuple(tiles.shape)} on {tiles.device}: needs a "
                         f"contiguous uint8 {want} on the tiles' device")


def banded_issued_flops(tiles: torch.Tensor, start: torch.Tensor,
                        b: torch.Tensor, bsz: int, *, precision=None,
                        mask: torch.Tensor | None = None) -> int:
    """Operations (two per multiply-add) that the body of K4 and K8 issues
    on ``tiles`` (ntiles, M, K) against the operand ``b`` (rows, k), as the
    kernel counts them: each thread block adds the chunks its zero-chunk
    vote kept, at their full padded size, to a counter on the card (a
    bf16x3 chunk once).  With ``mask`` (a kit's :attr:`BandedKit.chunk_nz`)
    it counts K4's kit route instead, the mask body, which multiplies the
    chunks the mask marks: the same count where the mask is the tiles'
    own.  One launch into a scratch output, outside ``K4_LAUNCHES``,
    ``K4_KIT_LAUNCHES`` and ``K8_LAUNCHES``: it measures the skip and
    computes nothing.  CUDA tensors with float32, bf16, float64 or int32
    tiles (``precision="bf16x3"`` splits float32 tiles); the count is the
    kernel's, so there is no plain version
    (:func:`banded_issued_model` is what it should read)."""
    name = "banded_issued_flops"
    if (tiles.dim() != 3 or b.dim() != 2
            or tiles.dtype not in _STREAMS):
        raise ValueError(f"{name}: tiles {tuple(tiles.shape)} {tiles.dtype}"
                         f" and operand {tuple(b.shape)}: needs 3-d float32, "
                         "bf16 or float64 tiles (or int32 ones) and a 2-d "
                         "operand")
    split = _stream_mode(name, tiles.dtype, precision)
    if mask is not None:
        _check_mask(name, mask, tiles)
    if not _on_cuda(name, tiles, start, b):
        raise ValueError(f"{name}: counts on the card only, got CPU tensors")
    ntiles, M, K = tiles.shape
    ts = tiles.contiguous()
    st = start.to(torch.int32).contiguous()
    bs = b.to(tiles.dtype).contiguous()
    out = torch.empty(ntiles * M, b.shape[1], dtype=_acc_dtype(tiles.dtype),
                      device=b.device)
    count = torch.zeros(1, dtype=torch.int64, device=b.device)
    lib = _kernels.load()
    ptrs = (ts.data_ptr(), st.data_ptr(), bs.data_ptr(), out.data_ptr())
    if mask is not None:
        fn, ptrs = lib.bell_banded_masked_issued, (
            ptrs[0], ptrs[1], mask.data_ptr(), *ptrs[2:])
    else:
        fn = lib.bell_banded_issued
    _launch(name, fn, _kind(tiles.dtype, split), *ptrs,
            ntiles, M, K, b.shape[1], bsz, b.shape[0], count.data_ptr(),
            device=b.device)
    return 2 * int(count.item())


def banded_t_issued_model(kit: BandedKitT, k: int) -> tuple[int, int]:
    """Host model of what K5's body counts at width ``k``, for every kind:
    (operations, 2 per multiply-add: one 32 x 32 x 32 product per set bit
    of ``chunk_nz`` and 32-row block of k, once for bf16x3, whose three
    products split the same multiply-adds; tile bytes copied: each set
    chunk's elements inside the tile at the kit's element width, once per
    32-row block of k)."""
    nt, K, M = kit.tiles_t.shape
    nz = kit.chunk_nz.bool()
    blocks_k = -(-k // _BT_BN)
    rows = (K - _BT_BK * torch.arange(nz.shape[1])).clamp(max=_BT_BK)
    cols = (M - _BT_SLICE * torch.arange(nz.shape[2])).clamp(max=_BT_SLICE)
    inside = (rows[:, None] * cols[None, :]).to(nz.device)
    flops = int(nz.sum()) * 2 * _BT_BN * _BT_BK * _BT_SLICE * blocks_k
    nbytes = int((inside * nz).sum()) * kit.tiles_t.element_size() * blocks_k
    return flops, nbytes


def banded_t_issued(a: BELL, bt, kit: BandedKitT, *,
                    precision=None) -> tuple[int, int]:
    """(operations, tile bytes) that K5's body issues on ``kit`` against
    ``bt``, as the kernel counts them on the card: each warp adds the
    chunks it multiplied, at their full 32 x 32 x 32 (once for bf16x3), and
    the bytes of the tile chunks it copied.  One launch into a scratch
    output, outside ``K5_LAUNCHES``; CUDA tensors only, any kit
    (``precision="bf16x3"`` splits a float32 one;
    :func:`banded_t_issued_model` is what it should read)."""
    name = "banded_t_issued"
    plan, tiles_t = kit.plan, kit.tiles_t
    split = _stream_mode(name, tiles_t.dtype, precision)
    if not isinstance(bt, torch.Tensor):
        bt = torch.as_tensor(bt, device=a.device)
    if not _on_cuda(name, tiles_t, kit.chunk_nz, plan.start, bt):
        raise ValueError(f"{name}: counts on the card only, got CPU tensors")
    ntiles, K, M = tiles_t.shape
    counts = torch.zeros(2, dtype=torch.int64, device=bt.device)
    bs = bt.to(tiles_t.dtype).contiguous()
    out = torch.empty(bt.shape[0], ntiles * M,
                      dtype=_acc_dtype(tiles_t.dtype), device=bt.device)
    _launch(name, _kernels.load().bell_banded_t_issued,
            _kind(tiles_t.dtype, split),
            tiles_t.contiguous().data_ptr(),
            plan.start.to(torch.int32).contiguous().data_ptr(),
            kit.chunk_nz.data_ptr(), bs.data_ptr(), out.data_ptr(), ntiles,
            M, K, bt.shape[0], a.bsz, bt.shape[1], counts.data_ptr(),
            device=bt.device)
    flops, nbytes = counts.tolist()
    return 2 * flops, nbytes


# -- K4: banded ---------------------------------------------------------------


def _window_index(plan: BandedPlan, bsz: int, extent: int):
    """(ntiles, W*bsz) operand rows of every tile's window, clamped into
    ``[0, extent)``, and the mask of the rows inside it (rows past the end
    read 0, as in the kernels)."""
    idx = plan.start.long()[:, None] * bsz + torch.arange(
        plan.W * bsz, device=plan.start.device)
    return idx.clamp(max=max(extent - 1, 0)), idx < extent


def _same_tensor(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether ``x`` is ``y``'s data seen the same way (a transform may
    hand a launch another tensor object over the same memory)."""
    return (x.data_ptr() == y.data_ptr() and x.dtype == y.dtype
            and x.shape == y.shape and x.stride() == y.stride()
            and x.device == y.device)


def _banded(a: BELL, b, plan: BandedPlan, compute_dtype, tiles, precision,
            plain: bool, kit: BandedKit | None = None):
    """K4 (its plain version on CPU tensors or with ``plain``).  With
    ``kit`` (``tiles`` its tiles) a launch on the kit's own tiles runs the
    mask body on ``kit.chunk_nz``; any other launch, the vote body."""
    name = "bell_spmm_banded"
    b, out_dtype = _operand(name, a, b)
    k = b.shape[1]
    if a.n == 0 or a.Lb == 0 or k == 0:
        return torch.zeros(a.n, k, dtype=out_dtype, device=b.device)
    W, rt, bsz = plan.W, plan.rt, a.bsz
    nb_pad = plan.offs.shape[0]
    ntiles = nb_pad // rt
    stream = compute_dtype or out_dtype
    split = _stream_mode(name, stream, precision)
    if tiles is None:
        tiles = _densify_band_tiles(a, plan, stream)
    if tuple(tiles.shape) != (ntiles, rt * bsz, W * bsz):
        raise ValueError(f"{name}: tiles {tuple(tiles.shape)} != "
                         f"({ntiles}, {rt * bsz}, {W * bsz})")
    if kit is not None:
        _check_mask(name, kit.chunk_nz, tiles)
    if plain or not _on_cuda(name, tiles, plan.start, b):
        rows, inside = _window_index(plan, bsz, a.n)
        bs = b.to(stream)
        win = torch.where(inside[:, :, None], bs[rows], bs.new_zeros(()))
        out = _contract("tij,tjk->tik", tiles, win, stream, split)
        return out.reshape(nb_pad * bsz, k)[:a.n].to(out_dtype)
    def launch(tiles, b):
        global K4_LAUNCHES, K4_KIT_LAUNCHES
        masked = kit is not None and _same_tensor(tiles, kit.tiles)
        start = plan.start.to(torch.int32).contiguous()
        ts = tiles.to(stream).contiguous()
        bs = b.to(stream).contiguous()
        out = torch.empty(nb_pad * bsz, k, dtype=_acc_dtype(stream),
                          device=b.device)
        lib = _kernels.load()
        ptrs = (ts.data_ptr(), start.data_ptr(), bs.data_ptr(),
                out.data_ptr())
        if masked:
            fn, ptrs = lib.bell_banded_masked, (
                ptrs[0], ptrs[1], kit.chunk_nz.data_ptr(), *ptrs[2:])
        else:
            fn = lib.bell_banded
        _launch(name, fn, _kind(stream, split), *ptrs, ntiles, rt * bsz,
                W * bsz, k, bsz, a.n, device=b.device)
        if masked:
            K4_KIT_LAUNCHES += 1
        else:
            K4_LAUNCHES += 1
        return out[:a.n].to(out_dtype)

    return kernel_call(name, launch, tiles, b)


def bell_spmm_banded(a: BELL, b, plan: BandedPlan, *, compute_dtype=None,
                     tiles: torch.Tensor | None = None,
                     precision=None) -> torch.Tensor:
    """Banded SpMM, one (rt*bsz, W*bsz) @ (W*bsz, k) product per row tile
    (K4 on CUDA tensors, its plain version on CPU tensors).

    ``plan`` from :func:`build_banded_plan`; ``tiles`` (from
    :func:`bell_banded_prepare`) skips the in-call densify.
    ``compute_dtype=torch.bfloat16`` streams tiles and operand as bf16 with
    float32 sums."""
    return _banded(a, b, plan, compute_dtype, tiles, precision, False)


def bell_spmm_banded_plain(a: BELL, b, plan: BandedPlan, *,
                           compute_dtype=None, tiles=None,
                           precision=None) -> torch.Tensor:
    """Plain PyTorch version of K4 (any device): gather every tile's operand
    window, then one batched matmul."""
    return _banded(a, b, plan, compute_dtype, tiles, precision, True)


def _bell_spmm_kit(a: BELL, b, kit: BandedKit, *,
                   precision=None) -> torch.Tensor:
    """``bell_spmm(a, b, plan=kit)``: K4 on the kit's tiles, streaming at
    their dtype, through the kit's chunk mask (``bell_banded_masked``:
    only the marked chunks are read and multiplied; bitwise the vote
    body's C) on CUDA tensors, ``bell_spmm_banded_plain``'s product on CPU
    tensors.  A mask that does not fit the tiles raises ``ValueError``."""
    return _banded(a, b, kit.plan, kit.tiles.dtype, kit.tiles, precision,
                   False, kit)


# -- K5: banded, transposed (small k) -----------------------------------------


def _banded_t(a: BELL, bt, kit: BandedKitT, precision, plain: bool):
    name = "bell_spmm_banded_t"
    if not isinstance(bt, torch.Tensor):
        bt = torch.as_tensor(bt, device=a.device)
    plan, tiles_t = kit.plan, kit.tiles_t
    W, rt, bsz = plan.W, plan.rt, a.bsz
    nb_pad = plan.offs.shape[0]
    n_pad = nb_pad * bsz
    if bt.dim() != 2 or bt.shape[1] not in (a.n, n_pad):
        raise ValueError(f"{name}: operand shape {tuple(bt.shape)} != "
                         f"(k, {a.n}) or (k, {n_pad})")
    k = bt.shape[0]
    out_dtype = torch.promote_types(a.dtype, bt.dtype)
    if a.n == 0 or a.Lb == 0 or k == 0:
        return torch.zeros(k, n_pad, dtype=out_dtype, device=bt.device)
    stream = tiles_t.dtype
    split = _stream_mode(name, stream, precision)
    ntiles = nb_pad // rt
    if tuple(tiles_t.shape) != (ntiles, W * bsz, rt * bsz):
        raise ValueError(f"{name}: tiles_t {tuple(tiles_t.shape)} != "
                         f"({ntiles}, {W * bsz}, {rt * bsz})")
    # a padded operand gets the padded output back (the chain idiom); an
    # unpadded one gets (k, n)
    width = bt.shape[1]
    if plain or not _on_cuda(name, tiles_t, kit.chunk_nz, plan.start, bt):
        cols, inside = _window_index(plan, bsz, width)
        bs = bt.to(stream)
        win = torch.where(inside[None], bs[:, cols], bs.new_zeros(()))
        out = _contract("tij,tjk->tik", win.permute(1, 0, 2), tiles_t,
                        stream, split)  # (ntiles, k, rt*bsz)
        out = out.permute(1, 0, 2).reshape(k, n_pad)
        return out[:, :width].to(out_dtype)
    def launch(tiles_t, bt):
        global K5_LAUNCHES
        start = plan.start.to(torch.int32).contiguous()
        ts = tiles_t.contiguous()
        bs = bt.to(stream).contiguous()
        out = torch.empty(k, n_pad, dtype=_acc_dtype(stream),
                          device=bt.device)
        _launch(name, _kernels.load().bell_banded_t, _kind(stream, split),
                ts.data_ptr(), start.data_ptr(), kit.chunk_nz.data_ptr(),
                bs.data_ptr(), out.data_ptr(), ntiles, rt * bsz, W * bsz, k,
                bsz, width, device=bt.device)
        K5_LAUNCHES += 1
        return out[:, :width].to(out_dtype)

    return kernel_call(name, launch, tiles_t, bt)


def bell_spmm_banded_t(a: BELL, bt, kit: BandedKitT, *,
                       precision=None) -> torch.Tensor:
    """C^T = (A @ B)^T with B passed TRANSPOSED as ``bt`` (k, n) or padded
    (k, n_pad); returns (k, n), or (k, n_pad) for a padded operand, so
    chained calls feed C^T straight back (K5 on CUDA tensors, its plain
    version on CPU tensors).  Streams at the kit's tile dtype."""
    return _banded_t(a, bt, kit, precision, False)


def bell_spmm_banded_t_plain(a: BELL, bt, kit: BandedKitT, *,
                             precision=None) -> torch.Tensor:
    """Plain PyTorch version of K5 (any device): gather every tile's
    operand window from B^T, then one batched matmul."""
    return _banded_t(a, bt, kit, precision, True)

"""Dense-band SpMM: kernel K8.

Port of ``benchmarks/measure_dband.py`` (``densify_tiles`` :31,
``dband_spmm`` :57 / ``pallas_call`` :82): per tile of ``rt`` block rows the
band's blocks are densified once into an ``(rt*bsz, W*bsz)`` tile, and one
wide product per tile multiplies it with the ``W``-panel window of the
operand that starts at the tile's first panel::

    C[t] (rt*bsz, k) = tiles[t] @ b3[start[t] : start[t] + W] (W*bsz, k)

with ``b3`` the operand as ``(panels, bsz, k)`` — the reference pads it with
``W`` zero panels — and the output cut to ``nb*bsz`` rows.

That is K4's per-tile body (``pallas_bell.py:520-523``), and the port's
``bell_banded`` C entry (``csrc/bell_banded.cu``) computes exactly it,
reading operand rows at or past ``b3``'s end as 0.  So on CUDA tensors
:func:`dband_spmm` launches that entry (counted in ``K8_LAUNCHES``); on CPU
tensors it runs :func:`dband_spmm_plain`, the same product in plain
PyTorch.  There is no other route: a CUDA tensor never reaches the plain
version.

Precision: a float32 stream is full float32 (the reference's TPU default is
a single bf16 pass; the port keeps its float32 contract); a bfloat16 stream
is bf16 operands with float32 sums; float64 sums in float64.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ._transforms import kernel_call
from .cuda_bell import (
    _KIND,
    _acc_dtype,
    _contract,
    _densify_band_tiles,
    _launch,
    _on_cuda,
)

__all__ = ["densify_tiles", "dband_spmm", "dband_spmm_plain"]

#: Launches of K8, counted where :func:`dband_spmm` launches it and nowhere
#: else.
K8_LAUNCHES = 0

#: ``(ntiles, rt*bsz, W*bsz)`` banded tiles of a BELL in ``stream_dtype``,
#: on the BELL's device (``measure_dband.densify_tiles`` is the same
#: function as the banded kit's densify).
densify_tiles = _densify_band_tiles


def _check(tiles, start, b3, bsz, k, W, rt):
    name = "dband_spmm"
    ntiles = tiles.shape[0] if tiles.dim() == 3 else -1
    if (tuple(tiles.shape) != (ntiles, rt * bsz, W * bsz)
            or tuple(start.shape) != (ntiles,) or b3.dim() != 3
            or tuple(b3.shape[1:]) != (bsz, k)):
        raise ValueError(
            f"{name}: tiles {tuple(tiles.shape)}, start {tuple(start.shape)}, "
            f"b3 {tuple(b3.shape)} do not fit rt={rt} bsz={bsz} W={W} k={k}")
    if tiles.dtype not in _KIND:
        raise ValueError(f"{name}: stream dtype {tiles.dtype} is not one of "
                         "float32, bfloat16, float64")
    return ntiles


def dband_spmm(tiles, start, b3, nb, bsz, k, W, rt, out_dtype):
    """C (nb*bsz, k) = A @ B by dense banded tiles (K8 on CUDA tensors, its
    plain version on CPU tensors); the reference's signature.

    ``tiles`` (ntiles, rt*bsz, W*bsz) from :func:`densify_tiles` set the
    stream dtype; ``start`` (ntiles,) is each tile's first operand panel;
    ``b3`` (panels, bsz, k) the operand, read in the stream dtype."""
    ntiles = _check(tiles, start, b3, bsz, k, W, rt)
    if not _on_cuda("dband_spmm", tiles, start, b3):
        return dband_spmm_plain(tiles, start, b3, nb, bsz, k, W, rt,
                                out_dtype)
    stream = tiles.dtype

    def launch(tiles, b3):
        global K8_LAUNCHES
        st = start.to(torch.int32).contiguous()
        ts = tiles.contiguous()
        bs = b3.to(stream).contiguous()
        out = torch.empty(ntiles * rt * bsz, k, dtype=_acc_dtype(stream),
                          device=tiles.device)
        _launch("dband_spmm", _kernels.load().bell_banded, _KIND[stream],
                ts.data_ptr(), st.data_ptr(), bs.data_ptr(), out.data_ptr(),
                ntiles, rt * bsz, W * bsz, k, bsz, b3.shape[0] * bsz,
                device=tiles.device)
        K8_LAUNCHES += 1
        return out[:nb * bsz].to(out_dtype)

    return kernel_call("dband_spmm", launch, tiles, b3)


def dband_spmm_plain(tiles, start, b3, nb, bsz, k, W, rt, out_dtype):
    """Plain PyTorch version of K8 (any device): gather every tile's
    ``W``-panel operand window (panels past ``b3``'s end read 0), then one
    batched product in the stream dtype's accumulator."""
    ntiles = _check(tiles, start, b3, bsz, k, W, rt)
    stream = tiles.dtype
    panel = start.long()[:, None] + torch.arange(W, device=start.device)
    inside = panel < b3.shape[0]
    bs = b3.to(stream)
    win = torch.where(inside[:, :, None, None],
                      bs[panel.clamp(max=max(b3.shape[0] - 1, 0))],
                      bs.new_zeros(()))
    out = _contract(torch.bmm, tiles, win.reshape(ntiles, W * bsz, k),
                    stream, False)
    return out.reshape(ntiles * rt * bsz, k)[:nb * bsz].to(out_dtype)

"""K6's route past bsz 64 and its wide-block body's issued-work model.

K6 (``bell_spmm_block``) runs one of three bodies on the card, by
``ops/cuda_bell._k6_body`` (the host's copy of ``csrc/bell_spmm.cu``'s
``k6_body``): the persistent body up to bsz 64 (float64: 32); past bsz 64
the wide-block body (``csrc/wide_body.cuh``) for the float32, bf16, bf16x3
and float64 streams where bsz and k times the element size (4, 2, 4, 8
bytes) are multiples of 16 bytes, so a TMA map can describe the arrays;
K3's band body otherwise (int32 always).  The rule is held here against a
table written out by hand, and the wide body's host model (what its
counter must read on the card, ``tests/test_torch_cuda.py``) against a
count taken element by element in NumPy.  The kernels themselves run only
on the card.
"""

import numpy as np
import pytest
import torch

from sparse_tpu_torch.formats.bell import BELL
from sparse_tpu_torch.ops import cuda_bell as tcb

# kind -> (stream dtype, bf16x3 split, element bytes on the wide body or
# None where it never runs it)
KINDS = {"f32": (torch.float32, False, 4),
         "bf16": (torch.bfloat16, False, 2),
         "bf16x3": (torch.float32, True, 4),
         "f64": (torch.float64, False, 8),
         "int32": (torch.int32, False, None)}

# (bsz, k) -> the body of each kind, by hand: f32, bf16, bf16x3, f64, int32
BODIES = {
    (32, 33): ("persistent",) * 5,
    (32, 128): ("persistent",) * 5,
    (64, 33): ("persistent", "persistent", "persistent", "band",
               "persistent"),
    (64, 128): ("persistent", "persistent", "persistent", "band",
                "persistent"),
    (65, 33): ("band",) * 5,     # bsz 65: no whole 16 bytes a row
    (65, 128): ("band",) * 5,
    (66, 128): ("band", "band", "band", "wide", "band"),  # 264 bytes a row
    (80, 33): ("band",) * 5,     # k 33: no whole 16 bytes a row
    (80, 70): ("band", "band", "band", "wide", "band"),   # k 70: 280 bytes
    (80, 128): ("wide", "wide", "wide", "wide", "band"),
    (128, 33): ("band",) * 5,
    (128, 128): ("wide", "wide", "wide", "wide", "band"),
    (192, 33): ("band",) * 5,
    (192, 128): ("wide", "wide", "wide", "wide", "band"),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("bsz,k", list(BODIES))
def test_k6_body_rule(bsz, k, kind):
    stream, _, elem = KINDS[kind]
    want = BODIES[bsz, k][list(KINDS).index(kind)]
    assert tcb._k6_body(bsz, k, stream) == want
    # the rule as stated: persistent to 64 (float64 32), wide past 64 for
    # the kinds it takes where both rows are whole 16-byte units
    if bsz <= (32 if stream == torch.float64 else 64):
        assert want == "persistent"
    elif elem and bsz > 64 and bsz * elem % 16 == 0 and k * elem % 16 == 0:
        assert want == "wide"
    else:
        assert want == "band"


def _wide_count(blocks, k):
    """Operations of the wide body by hand: for each stored block, each
    64-row group and each 32-index slice holding an element that is not
    zero (NaN is, -0 is not), 2 x rows x indices x k."""
    n, bsz, _ = blocks.shape
    total = 0
    for blk in blocks:
        for r0 in range(0, bsz, 64):
            for c0 in range(0, bsz, 32):
                part = blk[r0:r0 + 64, c0:c0 + 32]
                if np.any((part != 0) | np.isnan(part)):
                    total += part.shape[0] * part.shape[1]
    return 2 * total * k


def _hand_blocks(bsz):
    """Three block rows of two slots: a lone element, a full block, a NaN
    alone in the last row group, a block of -0 only, a lone element in the
    last index slice and a padding slot (zero)."""
    blocks = np.zeros((3, 2, bsz, bsz), np.float64)
    blocks[0, 0, 0, 0] = 1.0
    blocks[0, 1] = 2.0
    blocks[1, 0, bsz - 1, 1] = np.nan
    blocks[1, 1] = -0.0
    blocks[2, 0, 1, bsz - 1] = 3.0
    return blocks


@pytest.mark.parametrize("kind", ["f32", "bf16", "bf16x3", "f64"])
@pytest.mark.parametrize("bsz,k", [(80, 72), (128, 128), (192, 136),
                                   (256, 8)])
def test_wide_issued_model_by_hand(bsz, k, kind):
    stream, split, _ = KINDS[kind]
    blocks = _hand_blocks(bsz)
    a = BELL(cols=torch.tensor([[0, 1], [1, 0], [2, 0]], dtype=torch.int32),
             blocks=torch.from_numpy(blocks).to(stream), n=3 * bsz, bsz=bsz)
    prec = "bf16x3" if split else None
    assert tcb._k6_body(bsz, k, stream) == "wide"
    got = tcb.block_issued_model(a, k, stream_dtype=stream, precision=prec)
    assert got == _wide_count(blocks.reshape(-1, bsz, bsz), k)
    # by the blocks: the lone element's 64 rows x 32 indices, the full
    # block's bsz * bsz (whatever its row tiles), the NaN's last row group
    # x 32 indices, the last slice's indices x 64 rows for element (1, -1)
    nan_group = (bsz - 64 * ((bsz - 1) // 64)) * 32
    lone_last_slice = 64 * (bsz - 32 * ((bsz - 1) // 32))
    assert got == 2 * k * (64 * 32 + bsz * bsz + nan_group
                           + lone_last_slice)


def test_wide_issued_model_counts_no_zero_block():
    """All-zero blocks (padding slots, a block row of padding only) and -0
    count nothing; a NaN counts its slice; float32 and its bf16x3 split
    count the float32 stream's slices once."""
    bsz, k = 128, 64
    rng = np.random.default_rng(3)
    blocks = rng.standard_normal((4, 3, bsz, bsz)).astype(np.float32)
    blocks[1] = 0.0                     # an empty block row
    blocks[2, 2] = -0.0
    blocks[3, 1] = 0.0
    blocks[3, 1, 100, 70] = np.nan      # row group 1, slice 2
    cols = torch.tensor([[0, 1, 2], [0, 0, 0], [1, 2, 3], [2, 3, 0]],
                        dtype=torch.int32)
    a = BELL(cols=cols, blocks=torch.from_numpy(blocks), n=4 * bsz, bsz=bsz)
    want = 2 * k * (7 * bsz * bsz + 64 * 32)
    assert tcb.block_issued_model(a, k, precision="bf16x3") == want
    # float32 without the split runs the same body and counts the same
    assert tcb._k6_body(bsz, k, torch.float32) == "wide"
    assert tcb.block_issued_model(a, k) == want
    a64 = BELL(cols=cols, blocks=torch.from_numpy(blocks).double(),
               n=4 * bsz, bsz=bsz)
    assert tcb.block_issued_model(a64, k) == want


@pytest.mark.parametrize("bsz,k", [(66, 128), (80, 70), (128, 70)])
def test_float32_shapes_tma_cannot_take_keep_the_band_model(bsz, k):
    """float32 past bsz 64 whose rows are not whole 16-byte units (bsz 66:
    264 bytes a block row, k 70: 280 bytes an operand row) stays on K3's
    band body, and its model is K3's chunk model, also with the split."""
    rng = np.random.default_rng(bsz + k)
    blocks = rng.standard_normal((3, 2, bsz, bsz)).astype(np.float32)
    blocks[1, 1] = 0.0
    blocks[2] = 0.0
    blocks[2, 0, bsz - 1, 0] = 1.0
    a = BELL(cols=torch.tensor([[0, 1], [1, 0], [2, 0]], dtype=torch.int32),
             blocks=torch.from_numpy(blocks), n=3 * bsz, bsz=bsz)
    assert tcb._k6_body(bsz, k, torch.float32) == "band"
    band = tcb.fused_issued_model(a, k)
    assert band > 0
    assert tcb.block_issued_model(a, k) == band
    assert tcb.block_issued_model(a, k, precision="bf16x3") == band
    assert band != tcb._wide_body_model(a.blocks.reshape(-1, bsz, bsz), k)

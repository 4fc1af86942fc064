"""``precision="bf16x3"`` on the blocked-ELL paths the reference refuses.

The reference's ``_resolve_precision`` (``sparse_tpu/ops/pallas_bell.py``)
documents ``"bf16x3"`` as the kernels' three-pass split (``_dot_bf16x3``),
but only the banded kernels (K4, K5) route it through ``_tile_dot``: the
per-block kernel ``bell_spmm_pallas`` (K6), the fused kernel
``bell_spmm_pallas_fused`` (K3) and the XLA gather-einsum of
``formats.bell.bell_spmm`` hand the string to ``jax.lax.dot_general``'s
``precision=``, which raises ``ValueError``.  The port computes the split
on every path (ROADMAP Queue 3, "Reference defects not kept").  This file
pins both sides: the reference raises there, and the port's K3 / K6 plain
versions and ``bell_spmm`` meet the bf16x3 gate, ``2^-15 + 1e-5`` of
``|A||B|`` per element, against the reference's own ``_dot_bf16x3``
applied to each block row's gathered panels and against float64 NumPy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu_torch as pt
from sparse_tpu.formats import bell as jbell
from sparse_tpu.ops import pallas_bell as jpb
from sparse_tpu_torch import interop
from sparse_tpu_torch.ops import cuda_bell as tcb

BF16X3_TOL = 2.0 ** -15 + 1e-5


def _operands(nb, bsz, lb, k, seed):
    """Scattered block rows (edge padding slots at column 0, one empty row)
    with N(0, 1) values scaled by 2^u, u uniform in [-8, 8], and B (n, k)
    alike: (cols, blocks, B), float32."""
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(nb, size=(nb, lb)), axis=1).astype(np.int32)
    ok = np.ones((nb, lb), bool)
    ok[nb // 2] = False
    ok[:, -1] &= rng.random(nb) < 0.5
    cols = np.where(ok, cols, 0)
    blocks = rng.standard_normal((nb, lb, bsz, bsz)) * 2.0 ** rng.uniform(
        -8, 8, (nb, lb, bsz, bsz))
    blocks *= ok[:, :, None, None]
    b = rng.standard_normal((nb * bsz, k)) * 2.0 ** rng.uniform(
        -8, 8, (nb * bsz, k))
    return cols, blocks.astype(np.float32), b.astype(np.float32)


def _reference_split(cols, blocks, b):
    """The reference's ``_dot_bf16x3`` of each block row's wide row
    [A_0 | ... | A_Lb-1] (bsz, Lb*bsz) against its gathered panels (Lb*bsz,
    k), in float32: (n, k)."""
    nb, lb, bsz, _ = blocks.shape
    wide = blocks.transpose(0, 2, 1, 3).reshape(nb, bsz, lb * bsz)
    panels = b.reshape(nb, bsz, -1)[cols].reshape(nb, lb * bsz, -1)
    out = jax.vmap(lambda x, w: jpb._dot_bf16x3(x, w, jnp.float32))(
        jnp.asarray(wide), jnp.asarray(panels))
    return np.asarray(out).reshape(nb * bsz, -1)


def _dense(cols, blocks):
    nb, lb, bsz, _ = blocks.shape
    d = np.zeros((nb * bsz, nb * bsz))
    for r in range(nb):
        for l in range(lb):
            c0 = cols[r, l] * bsz
            d[r * bsz:(r + 1) * bsz, c0:c0 + bsz] += blocks[r, l]
    return d


@pytest.mark.parametrize("entry", ["block", "fused", "xla"])
def test_reference_refuses_bf16x3_outside_the_banded_kernels(entry):
    cols, blocks, b = _operands(6, 8, 3, 16, seed=1)
    ja = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=48, bsz=8)
    jb = jnp.asarray(b)
    with pytest.raises(ValueError, match="[Pp]recision"):
        if entry == "block":
            jpb.bell_spmm_pallas(ja, jb, precision="bf16x3", interpret=True)
        elif entry == "fused":
            jpb.bell_spmm_pallas_fused(ja, jb, precision="bf16x3",
                                       interpret=True)
        else:
            jbell.bell_spmm(ja, jb, precision="bf16x3", prefer_pallas=False)


@pytest.mark.parametrize("nb,bsz,lb,k", [(20, 8, 3, 24), (12, 24, 4, 40),
                                         (9, 32, 2, 33)])
@pytest.mark.parametrize("entry", ["block_plain", "fused_plain", "bell_spmm",
                                   "bell_spmm_xla"])
def test_port_bf16x3_meets_the_gate_against_the_reference_split(
        entry, nb, bsz, lb, k):
    cols, blocks, b = _operands(nb, bsz, lb, k, seed=nb * bsz + k)
    ta = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    tb = torch.from_numpy(b)
    x3 = "bf16x3"
    got = {"block_plain": lambda: tcb.bell_spmm_block_plain(
               ta, tb, precision=x3),
           "fused_plain": lambda: tcb.bell_spmm_fused_plain(
               ta, tb, precision=x3),
           "bell_spmm": lambda: pt.bell_spmm(ta, tb, precision=x3),
           "bell_spmm_xla": lambda: pt.bell_spmm(
               ta, tb, precision=x3, prefer_pallas=False)}[entry]()
    assert got.dtype == torch.float32 and got.shape == (nb * bsz, k)
    got = got.double().numpy()
    d = _dense(cols, blocks)
    bound = BF16X3_TOL * (np.abs(d) @ np.abs(b.astype(np.float64)))
    for ref in (_reference_split(cols, blocks, b), d @ b.astype(np.float64)):
        err = np.abs(got - ref)
        assert np.isfinite(got).all()
        assert np.all(err <= bound), float((err - bound).max())

"""K8 — the dense-band SpMM of ``benchmarks/measure_dband.py`` — in the
PyTorch port against the reference's Pallas kernel in interpret mode.

Both packages densify the same BELL with their own banded planner; the
tiles must be equal, and the products agree within the tolerance times
``|A||B|`` per element (the two sum in different orders): float32 1e-5,
float64 1e-12, and for a bf16 stream the float32 bound on the bf16-rounded
inputs (both sum bf16 products in float32).  The kernel itself is tested
on the card by ``tests/test_torch_cuda.py``.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparse_tpu.formats import bell as jbell
from sparse_tpu.ops import pallas_bell as jpb
from sparse_tpu_torch import interop
from sparse_tpu_torch.ops import cuda_bell as tcb
from sparse_tpu_torch.ops import cuda_dband as tdb

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "benchmarks"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import measure_dband as jdb  # noqa: E402  (imports bench from the root)

TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 1e-5}
STREAMS = {"float32": (torch.float32, jnp.float32),
           "float64": (torch.float64, jnp.float64),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _banded(nb, bsz, hb, seed, dtype):
    """A block band of half-width ``hb`` in both packages (each block row's
    blocks in column order, short rows padded at column 0)."""
    rng = np.random.default_rng(seed)
    c = np.arange(nb)[:, None] + np.arange(-hb, hb + 1)[None, :]
    ok = (c >= 0) & (c < nb)
    order = np.argsort(~ok, axis=1, kind="stable")
    rows = np.arange(nb)[:, None]
    cols = np.where(ok, c, 0)[rows, order].astype(np.int32)
    ok = ok[rows, order]
    blocks = (rng.standard_normal((nb, 2 * hb + 1, bsz, bsz))
              * ok[:, :, None, None]).astype(dtype)
    x = np.zeros((nb * bsz, nb * bsz), np.float64)
    for r in range(nb):
        for j in np.flatnonzero(ok[r]):
            x[r * bsz:(r + 1) * bsz,
              cols[r, j] * bsz:(cols[r, j] + 1) * bsz] = blocks[r, j]
    ja = jbell.BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
                    n=nb * bsz, bsz=bsz)
    ta = interop.bell_from_arrays(cols, blocks, nb * bsz, bsz, device="cpu")
    return x, ja, ta


def _b3(b, nb, bsz, k, W):
    """The reference's operand: (nb, bsz, k) panels and W zero panels."""
    return np.concatenate([b.reshape(nb, bsz, k),
                           np.zeros((W, bsz, k), b.dtype)])


@pytest.mark.parametrize("nb,bsz,hb,rt,k,stream", [
    (40, 8, 2, 5, 16, "float32"),
    (37, 8, 1, 4, 8, "float32"),     # nb % rt != 0
    (40, 8, 2, 5, 16, "bfloat16"),
    (24, 16, 1, 3, 32, "float64"),
])
def test_dband_matches_reference(nb, bsz, hb, rt, k, stream):
    tdt, jdt = STREAMS[stream]
    dtype = np.float64 if stream == "float64" else np.float32
    x, ja, ta = _banded(nb, bsz, hb, seed=nb + k, dtype=dtype)
    jplan = jpb.build_banded_plan(ja, row_tile=rt, max_window=96)
    tplan = tcb.build_banded_plan(ta, row_tile=rt, max_window=96)
    assert (tplan.W, tplan.rt) == (jplan.W, jplan.rt)
    np.testing.assert_array_equal(tplan.start.numpy(),
                                  np.asarray(jplan.start))
    jt = jdb.densify_tiles(ja, jplan, jdt)
    tt = tdb.densify_tiles(ta, tplan, tdt)
    np.testing.assert_array_equal(_np(tt), _np(jt))
    W = tplan.W
    b = np.random.default_rng(k).standard_normal((nb * bsz, k)).astype(dtype)
    b3 = _b3(b, nb, bsz, k, W)
    out = np.float64 if stream == "float64" else np.float32
    with pltpu.force_tpu_interpret_mode():
        ref = jdb.dband_spmm(jt, jplan.start, jnp.asarray(b3).astype(jdt),
                             nb, bsz, k, W, rt, out)
    got = tdb.dband_spmm(tt, tplan.start, torch.from_numpy(b3), nb, bsz, k,
                         W, rt, torch.float64 if out is np.float64
                         else torch.float32)
    assert got.shape == (nb * bsz, k) == tuple(ref.shape)
    xs, bs = (x, b) if stream != "bfloat16" else (
        _np(torch.from_numpy(x).to(torch.bfloat16)),
        _np(torch.from_numpy(b).to(torch.bfloat16)))
    bound = TOL[stream] * (np.abs(xs) @ np.abs(bs).astype(np.float64))
    for want in (_np(ref), xs @ bs.astype(np.float64)):
        err = np.abs(_np(got).astype(np.float64) - want)
        assert np.all(err <= bound), (err - bound).max()


def test_dband_equals_k4_plain_and_checks_shapes():
    """K8 and K4 compute one function: the dense-band product on the padded
    operand equals ``bell_spmm_banded``'s plain version on the operand."""
    nb, bsz, rt, k = 30, 8, 5, 12
    x, _, ta = _banded(nb, bsz, 2, seed=5, dtype=np.float32)
    kit = tcb.bell_banded_prepare(ta, row_tile=rt, max_window=96)
    W = kit.plan.W
    b = np.random.default_rng(6).standard_normal((nb * bsz, k)).astype(
        np.float32)
    b3 = torch.from_numpy(_b3(b, nb, bsz, k, W))
    got = tdb.dband_spmm(kit.tiles, kit.plan.start, b3, nb, bsz, k, W, rt,
                         torch.float32)
    want = tcb.bell_spmm_banded_plain(ta, torch.from_numpy(b), kit.plan,
                                      tiles=kit.tiles)
    bound = 1e-5 * (np.abs(x) @ np.abs(b).astype(np.float64))
    assert np.all(np.abs(got.numpy() - want.numpy()) <= bound)
    # an operand of nb panels only: the window's panels past its end read 0
    short = tdb.dband_spmm(kit.tiles, kit.plan.start, b3[:nb], nb, bsz, k, W,
                           rt, torch.float32)
    assert np.all(np.abs(short.numpy() - want.numpy()) <= bound)
    with pytest.raises(ValueError, match="do not fit"):
        tdb.dband_spmm(kit.tiles, kit.plan.start, b3, nb, bsz, k + 1, W, rt,
                       torch.float32)
    with pytest.raises(ValueError, match="stream dtype"):
        tdb.dband_spmm(kit.tiles.half(), kit.plan.start, b3, nb, bsz, k, W,
                       rt, torch.float32)


def test_issued_count_is_the_kernels_only():
    """K4/K8's issued-work count comes from the kernel on the card, in
    every stream kind (float64 too, since it runs the vote body): CPU
    tensors and a dtype with no kind are refused, never modelled on the
    host."""
    _, _, ta = _banded(30, 8, 2, seed=5, dtype=np.float32)
    kit = tcb.bell_banded_prepare(ta, row_tile=5, max_window=96)
    b = torch.zeros(ta.n, 4)
    with pytest.raises(ValueError, match="on the card only"):
        tcb.banded_issued_flops(kit.tiles, kit.plan.start, b, 8)
    with pytest.raises(ValueError, match="on the card only"):
        tcb.banded_issued_flops(kit.tiles.double(), kit.plan.start, b, 8)
    with pytest.raises(ValueError, match="float32, bf16 or float64"):
        tcb.banded_issued_flops(kit.tiles.half(), kit.plan.start, b, 8)

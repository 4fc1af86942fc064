"""The invariant validators of the PyTorch port (``utils/validate.py``),
mirroring ``tests/test_validate.py``: every constructor's output
validates, corrupted structures are rejected with
``SparseInvariantError``, and on the same corrupted inputs the port
rejects exactly where the reference rejects.  Every port call runs on the
CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_tpu as jst
import sparse_tpu_torch as tst
from sparse_tpu.utils import validate as jval
from sparse_tpu_torch import interop
from sparse_tpu_torch.utils.validate import (
    SparseInvariantError,
    validate_bell,
    validate_bsr,
    validate_coo,
    validate_csc,
    validate_csr,
    validate_msr,
)

CPU = "cpu"


def _rand_dense(n, m, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, m)) * (rng.random((n, m)) < d)


def test_constructors_validate():
    x = torch.from_numpy(_rand_dense(8, 6, 0.4, 0))
    a = tst.csr_from_dense(x)
    validate_csr(a)
    validate_csc(tst.csr_transpose(a))
    validate_coo(tst.coo_from_triples(3, 3, [(0, 0, 1.0), (2, 1, 2.0)],
                                      device=CPU))
    validate_csr(tst.csr_add(a, tst.csr_eye(8, 6, a.dtype, device=CPU)))
    validate_csr(tst.csr_sub(a, a))
    b = tst.bsr_from_dense(torch.from_numpy(_rand_dense(8, 8, 0.3, 1)), 2)
    validate_bsr(b)
    validate_bsr(tst.bsr_add(b, tst.bsr_eye(8, 2, torch.float64,
                                            device=CPU)))
    validate_bsr(tst.bsr_mul(b, b))
    validate_bsr(tst.bsr_lup(tst.bsr_add(b, tst.bsr_eye(
        8, 2, torch.float64, device=CPU)))[0])
    validate_msr(tst.msr_from_triples(4, 5, [(0, 2, 1.0), (3, 1, 2.0)],
                                      device=CPU))
    validate_msr(tst.msr_eye(5, 3, device=CPU))
    validate_bell(tst.bell_from_bsr(b))
    validate_coo(tst.bsr_to_coo(b))


def test_corrupt_csr_rejected():
    a = tst.csr_from_dense(torch.from_numpy(_rand_dense(5, 5, 0.5, 2)))
    indptr = a.indptr.clone()
    indptr[2] = a.indptr[3] + 1
    with pytest.raises(SparseInvariantError, match="monotone"):
        validate_csr(dataclasses.replace(a, indptr=indptr))
    indices = a.indices.clone()
    indices[0] = 99
    with pytest.raises(SparseInvariantError, match="column ids"):
        validate_csr(dataclasses.replace(a, indices=indices))
    with pytest.raises(SparseInvariantError, match="indptr shape"):
        validate_csc(dataclasses.replace(tst.csr_transpose(a),
                                         indptr=a.indptr[:-1]))


@pytest.mark.parametrize("case", ["unsorted_row", "duplicate", "pad_value",
                                  "pad_index", "over_capacity", "ok"])
def test_csr_cases_as_reference(case):
    """The same arrays through both validators: the port rejects exactly
    where the reference rejects (its per-row loop, the port's one pass)."""
    x = _rand_dense(6, 7, 0.5, 3)
    j = jst.csr_from_dense(jnp.asarray(x), nse=30)
    data, indices, indptr = (np.array(j.data), np.array(j.indices),
                             np.array(j.indptr))
    k = int(indptr[-1])
    r = int(np.argmax(np.diff(indptr) >= 2))
    s = indptr[r]
    if case == "unsorted_row":
        indices[s], indices[s + 1] = indices[s + 1], indices[s]
    elif case == "duplicate":
        indices[s + 1] = indices[s]
    elif case == "pad_value":
        data[k] = 1.0
    elif case == "pad_index":
        indices[k + 1] = 2
    elif case == "over_capacity":
        indptr[-1] = 31
    t = interop.csr_from_arrays(data, indices, indptr, (6, 7), device=CPU)
    jc = jst.CSR(jnp.asarray(data), jnp.asarray(indices),
                 jnp.asarray(indptr), (6, 7))
    try:
        jval.validate_csr(jc)
    except jval.SparseInvariantError as e:
        msg = str(e).split(":")[0]
        with pytest.raises(SparseInvariantError) as err:
            validate_csr(t)
        assert str(err.value).split(":")[0] == msg
    else:
        assert case == "ok"
        validate_csr(t)


def test_corrupt_coo_rejected():
    a = tst.coo_from_triples(3, 3, [(0, 0, 1.0)], device=CPU)
    with pytest.raises(SparseInvariantError, match="column ids"):
        validate_coo(dataclasses.replace(a, col=torch.tensor(
            [7], dtype=torch.int32)))
    p = tst.coo_pad_to(a, 3)
    validate_coo(p)
    with pytest.raises(SparseInvariantError, match="column sentinel"):
        validate_coo(dataclasses.replace(p, col=torch.tensor(
            [0, 3, 1], dtype=torch.int32)))
    with pytest.raises(SparseInvariantError, match="zero data"):
        validate_coo(dataclasses.replace(p, data=torch.tensor(
            [1.0, 0.0, 2.0])))


def test_corrupt_bsr_rejected():
    a = tst.bsr_from_dense(torch.from_numpy(_rand_dense(8, 8, 0.5, 3)), 2)
    with pytest.raises(SparseInvariantError, match="sorted"):
        validate_bsr(dataclasses.replace(
            a, indices=torch.sort(a.indices, descending=True).values))
    idx = a.indices.clone()
    idx[1] = idx[0]
    with pytest.raises(SparseInvariantError, match="unique"):
        validate_bsr(dataclasses.replace(a, indices=idx))
    p = tst.bsr_from_dense(torch.from_numpy(_rand_dense(8, 8, 0.5, 3)), 2,
                           nbz=a.nbz + 2)
    validate_bsr(p)
    blocks = p.blocks.clone()
    blocks[-1, 0, 0] = 1.0
    with pytest.raises(SparseInvariantError, match="padding blocks"):
        validate_bsr(dataclasses.replace(p, blocks=blocks))


def test_corrupt_msr_rejected():
    a = tst.msr_from_triples(3, 4, [(0, 1, 1.0)], device=CPU)
    with pytest.raises(SparseInvariantError, match="column ids"):
        validate_msr(dataclasses.replace(a, col_idx=torch.tensor(
            [9, 0, 0], dtype=torch.int32)))
    with pytest.raises(SparseInvariantError, match="one slot per row"):
        validate_msr(dataclasses.replace(a, vals=a.vals[:2]))


def test_validate_bell_and_corruption():
    a = tst.bell_from_bsr(tst.bsr_from_dense(
        torch.from_numpy(_rand_dense(8, 8, 0.5, 5)), 2))
    validate_bell(a)
    cols = a.cols.clone()
    cols[0, 0] = 99
    with pytest.raises(SparseInvariantError, match="block-column ids"):
        validate_bell(dataclasses.replace(a, cols=cols))
    zero_slot = np.argwhere(~np.any(a.blocks.numpy() != 0, axis=(2, 3)))
    if zero_slot.size:
        r, lane = zero_slot[0]
        cols = a.cols.clone()
        cols[int(r), int(lane)] = 1
        with pytest.raises(SparseInvariantError, match="padding slots"):
            validate_bell(dataclasses.replace(a, cols=cols))
    with pytest.raises(SparseInvariantError, match="expected BELL"):
        validate_bell(tst.csr_eye(2, 2, device=CPU))


def test_bf16_validates():
    """bf16 values are checked for zero on the host as bf16."""
    x = torch.from_numpy(_rand_dense(8, 8, 0.4, 6)).to(torch.bfloat16)
    validate_csr(tst.csr_from_dense(x))
    validate_bsr(tst.bsr_from_dense(x, 2, nbz=20))

"""Dense within-block linear algebra: LU with partial pivoting, triangular
solves, and permutation vectors.

Port of ``sparse_tpu/linalg/dense.py`` (the reference's ``linalg``/``lup``/
``perm`` roles, blocked_square_regular.fut:9-11, 169-172).  The
factorizations take one matrix ``(n, n)`` or a stack ``(..., n, n)``: the
column loop runs once for the whole stack, as whole-matrix masked tensor
ops, so one code path serves one block or many.

Permutation convention (blocked_square_regular_test.fut:239-258): a
permutation is an index vector ``p`` with *gather* semantics,
``permute(p, x) = x[p]``, and ``lup_dense(a)`` returns ``(LU, p)`` with
``a[p] == L @ U``, ``L`` unit-lower (strict lower of LU) and ``U`` the upper
part of LU.  Pivoting follows the reference to the letter: the pivot is the
first arg-max of ``|column|`` over rows >= k, and a zero pivot does not
raise (``torch.linalg.lu_factor`` reports LAPACK swap sequences and flags
a zero pivot in ``info`` instead, so it is not used).
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..ops.segmented import INDEX_DTYPE
from ..utils.precision import full_precision

__all__ = [
    "lup_dense",
    "lu_dense",
    "forsolve_dense",
    "backsolve_dense",
    "rowsolve_upper",
    "perm_id",
    "permute",
    "perm_compose",
    "perm_inverse",
    "perm_to_matrix",
]


# -- permutations --------------------------------------------------------------


def perm_id(n: int, *, device=None) -> torch.Tensor:
    """Identity permutation (the ``perm.id`` role), on ``device`` (default
    CUDA)."""
    return torch.arange(n, dtype=INDEX_DTYPE, device=resolve_device(device))


def permute(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply a permutation to the leading axis: ``permute(p, x)[i] =
    x[p[i]]`` (the ``perm.permute`` role, blocked_square_regular.fut:437)."""
    return x[p.long()]


def perm_compose(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Concatenate permutations acting on consecutive disjoint ranges:
    ``p0`` on ``[0, len(p0))`` and ``p1`` on the next ``len(p1)`` slots
    (the ``perm.add`` accumulation, blocked_square_regular.fut:460)."""
    return torch.cat([p0, p1 + p0.shape[0]]).to(INDEX_DTYPE)


def perm_inverse(p: torch.Tensor) -> torch.Tensor:
    n = p.shape[0]
    out = torch.zeros(n, dtype=INDEX_DTYPE, device=p.device)
    out[p.long()] = torch.arange(n, dtype=INDEX_DTYPE, device=p.device)
    return out


def perm_to_matrix(p: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Dense permutation matrix P with ``P @ x == permute(p, x)``."""
    n = p.shape[0]
    out = torch.zeros((n, n), dtype=dtype, device=p.device)
    out[torch.arange(n, device=p.device), p.long()] = 1
    return out


# -- LU factorization ----------------------------------------------------------


def _masks(n: int, device):
    """``below[k]``: rows > k; ``trailing[k]``: columns >= k."""
    idx = torch.arange(n, device=device)
    return idx[None, :] > idx[:, None], idx[None, :] >= idx[:, None]


def _eliminate(lu, k, below, trailing, factors, zero):
    """Rank-1 update of the rows below k over the trailing columns, then
    the multipliers into column k (the reference's masked update: columns
    < k of the pivot row hold L multipliers, not U values).  In place;
    ``zero`` is a 0-d zero of ``lu``'s dtype."""
    factors = torch.where(below[k], factors, zero)
    urow = torch.where(trailing[k], lu[:, k, :], zero)
    lu.addcmul_(factors[:, :, None], urow[:, None, :], value=-1)
    lu[:, k + 1:, k] = factors[:, k + 1:]
    return lu


def lup_dense(a) -> tuple[torch.Tensor, torch.Tensor]:
    """LU with partial (row) pivoting: ``(LU, p)`` with ``a[p] = L @ U``
    (``lup_mod.lup``, blocked_square_regular.fut:429-430).  ``a`` is
    ``(n, n)`` or a stack ``(..., n, n)``; ``p`` is int32 of shape
    ``(..., n)``.

    A zero pivot does not raise.  It is the largest ``|column|`` over rows
    >= k, so those rows hold zeros in column k and their multipliers are
    0, as in the reference (which divides by 1 there; its ``±inf`` branch
    for a zero pivot over a non-zero entry cannot be reached)."""
    a = torch.as_tensor(a)
    n = a.shape[-1]
    lead = a.shape[:-2]
    lu = a.reshape(-1, n, n).clone()
    batch = lu.shape[0]
    below, trailing = _masks(n, lu.device)
    ident = torch.arange(n, device=lu.device).expand(batch, n)
    p = ident.clone()
    zero = lu.new_zeros(())
    for k in range(n):
        # first arg-max of |column| over rows >= k, then swap rows k, piv
        piv = lu[:, k:, k].abs().argmax(dim=1) + k
        swap = ident.clone()
        swap[:, k] = piv
        swap.scatter_(1, piv[:, None], k)
        lu = lu.gather(1, swap[:, :, None].expand(batch, n, n))
        p = p.gather(1, swap)
        pivval = lu[:, k, k, None]
        factors = lu[:, :, k] / pivval.masked_fill(pivval == 0, 1)
        lu = _eliminate(lu, k, below, trailing, factors, zero)
    return lu.reshape(a.shape), p.to(INDEX_DTYPE).reshape(*lead, n)


def lu_dense(a) -> torch.Tensor:
    """LU without pivoting (``lup_mod.lu``, blocked_square_regular.fut:
    516); ``a`` is ``(n, n)`` or a stack ``(..., n, n)``.  A zero pivot
    gives inf/nan multipliers, as in the reference."""
    a = torch.as_tensor(a)
    n = a.shape[-1]
    lu = a.reshape(-1, n, n).clone()
    below, trailing = _masks(n, lu.device)
    zero = lu.new_zeros(())
    for k in range(n):
        lu = _eliminate(lu, k, below, trailing,
                        lu[:, :, k] / lu[:, k, k, None], zero)
    return lu.reshape(a.shape)


# -- triangular solves ---------------------------------------------------------


def _solve(t, b, **kw):
    with full_precision(t.dtype):
        return torch.linalg.solve_triangular(t, b, **kw)


def forsolve_dense(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L x = b`` reading only the *strict* lower part of ``L`` with
    an implicit unit diagonal (the ``lup_mod.forsolve`` contract,
    blocked_square_regular.fut:436-439).  ``b`` is a vector or a matrix of
    columns; stacks broadcast."""
    if b.dim() == 1:
        return _solve(L, b[:, None], upper=False, unitriangular=True)[:, 0]
    return _solve(L, b, upper=False, unitriangular=True)


def backsolve_dense(U: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve ``U x = y`` reading the upper part incl. diagonal (the
    ``lup_mod.backsolve`` contract)."""
    if y.dim() == 1:
        return _solve(U, y[:, None], upper=True)[:, 0]
    return _solve(U, y, upper=True)


def rowsolve_upper(U: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve ``x U = y`` for a row-system (``backsolve'``,
    blocked_square_regular.fut:389-394): ``x = y U^-1``, reading the upper
    part of ``U`` incl. diagonal; ``y`` is a vector or a matrix of rows."""
    if y.dim() == 1:
        return _solve(U, y[None, :], upper=True, left=False)[0]
    return _solve(U, y, upper=True, left=False)

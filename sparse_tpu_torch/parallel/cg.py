"""Distributed iterative solvers on partitioned sparse matrices.

Port of ``sparse_tpu/parallel/cg.py``.  Every solver's matvec goes through
:func:`~.halo.dist_spmv`, so ``a`` may be any partitioned type — ``PCSR``,
``HaloPCSR`` / ``HaloPCSROverlap`` or ``HaloSegtile`` (kernel K1 per
shard).  The vectors are padded and row-sharded; each dot product is a
local dot plus ``mesh.all_reduce``, which takes the place of the ``psum``
GSPMD inserts in the reference.  The reference's ``fori_loop`` is a Python
loop here, and every scalar stays on the device: the zero guards are
``torch.where``, nothing reads a value back inside an iteration, so a loop
on the card is enqueued without waiting on it.

GMRES follows ``jax.scipy.sparse.linalg.gmres(solve_method="batched")``,
which the reference calls: per restart, ``restart`` Arnoldi steps with one
classical Gram-Schmidt pass, then the least-squares problem through the
normal equations (Cholesky), the residual of the new iterate preconditioned
and normalised.  Its early exits (an Arnoldi breakdown, a residual at or
below the tolerance) become masks, so the result is the reference's
without a host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.precision import full_precision
from .halo import HaloSegtile, dist_spmv
from .mesh import Mesh

__all__ = ["cg_step", "cg_solve", "pcg_solve", "bicgstab_solve",
           "gmres_solve", "power_iteration_step", "estimate_lmax",
           "chebyshev_preconditioner"]


def _dot(x: torch.Tensor, y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global dot product of two row-sharded vectors."""
    with full_precision(x.dtype):
        return mesh.all_reduce(torch.dot(x.reshape(-1), y.reshape(-1)))


def _safe(den: torch.Tensor) -> torch.Tensor:
    return torch.where(den == 0, torch.ones_like(den), den)


def cg_step(a, mesh: Mesh, state):
    """One CG iteration; all vectors padded row-sharded, dots global."""
    x, r, p, rs = state
    ap = dist_spmv(a, p, mesh)
    alpha = rs / _safe(_dot(p, ap, mesh))
    x = x + alpha * p
    r = r - alpha * ap
    rs_new = _dot(r, r, mesh)
    beta = rs_new / _safe(rs)
    p = r + beta * p
    return x, r, p, rs_new


def cg_solve(a, b: torch.Tensor, mesh: Mesh, *, iters: int = 50):
    """Solve ``A x = b`` (A square SPD, row-partitioned) by ``iters`` CG
    steps.  ``b`` must already be padded and sharded (``shard_vector``).
    Returns the padded row-sharded solution."""
    state = (torch.zeros_like(b), b, b, _dot(b, b, mesh))
    for _ in range(iters):
        state = cg_step(a, mesh, state)
    return state[0]


def _precond_apply(M, v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Apply a preconditioner given as the elementwise inverse diagonal
    (1-D, sharded like ``v``: Jacobi), batched inverse diagonal blocks (3-D,
    block-Jacobi from ``solve.precond.block_jacobi_prepare``, over the
    whole padded length: this process applies the blocks of its own
    slabs), or a callable ``M(v)`` (e.g. ``chebyshev_preconditioner``)."""
    if callable(M):
        return M(v)
    if M.dim() == 1:
        return M * v
    from ..solve.precond import block_jacobi_apply

    if mesh.world > 1:
        per = M.shape[0] // mesh.n_shards
        M = M[mesh.lo * per: mesh.hi * per]
    return block_jacobi_apply(M, v)


def pcg_solve(a, b: torch.Tensor, inv_diag, mesh: Mesh, *, iters: int = 50):
    """Preconditioned CG: ``inv_diag`` is the elementwise inverse of
    ``diag(A)`` padded and sharded like ``b`` (pad slots 0, so padding
    stays inert), the ``(nbk, bs, bs)`` inverse diagonal blocks from
    ``solve.precond.block_jacobi_prepare`` (prepared with ``padded_n =
    len(b)`` and a ``bs`` dividing the shard slab), or a callable."""
    z0 = _precond_apply(inv_diag, b, mesh)
    x, r, p, rz = torch.zeros_like(b), b, z0, _dot(b, z0, mesh)
    for _ in range(iters):
        ap = dist_spmv(a, p, mesh)
        alpha = rz / _safe(_dot(p, ap, mesh))
        x = x + alpha * p
        r = r - alpha * ap
        z = _precond_apply(inv_diag, r, mesh)
        rz_new = _dot(r, z, mesh)
        beta = rz_new / _safe(rz)
        p = z + beta * p
        rz = rz_new
    return x


def bicgstab_solve(a, b: torch.Tensor, mesh: Mesh, *, iters: int = 50):
    """BiCGSTAB for general square systems, row-partitioned (the van der
    Vorst recurrence, two distributed SpMVs per iteration).  ``b`` padded
    and sharded like ``cg_solve``'s."""
    x, r, p, r_hat = torch.zeros_like(b), b, b, b
    rho = _dot(b, b, mesh)
    for _ in range(iters):
        v = dist_spmv(a, p, mesh)
        alpha = rho / _safe(_dot(r_hat, v, mesh))
        s = r - alpha * v
        t = dist_spmv(a, s, mesh)
        omega = _dot(t, s, mesh) / _safe(_dot(t, t, mesh))
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = _dot(r_hat, r, mesh)
        beta = (rho_new / _safe(rho)) * (alpha / _safe(omega))
        p = r + beta * (p - omega * v)
        rho = rho_new
    return x


def _normalize(x, mesh: Mesh, thresh=None):
    """``jax.scipy``'s ``_safe_normalize``: (x / |x|, |x|), both zero when
    |x| is at or below ``thresh`` (default: the dtype's eps)."""
    norm = torch.sqrt(_dot(x, x, mesh))
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    unit = torch.where(use, x / torch.where(use, norm, 1), 0)
    return unit, torch.where(use, norm, 0)


def _gmres_restart(mv, M, b, x0, unit_res, res_norm, restart, mesh):
    """One batched GMRES restart (``_gmres_batched``); an Arnoldi step after
    a breakdown changes nothing."""
    dt = b.dtype
    eps = torch.finfo(dt).eps
    V = torch.zeros((b.numel(), restart + 1), dtype=dt, device=b.device)
    V[:, 0] = unit_res
    H = torch.eye(restart, restart + 1, dtype=dt, device=b.device)
    live = torch.ones((), dtype=torch.bool, device=b.device)
    with full_precision(dt):
        for k in range(restart):
            v = M(mv(V[:, k]))
            _, v_norm0 = _normalize(v, mesh)
            h = mesh.all_reduce(V.T @ v)  # one classical Gram-Schmidt pass
            v = v - V @ h
            unit_v, v_norm1 = _normalize(v, mesh, thresh=eps * v_norm0)
            h[k + 1] = v_norm1
            V[:, k + 1] = torch.where(live, unit_v, V[:, k + 1])
            H[k] = torch.where(live, h, H[k])
            live = live & (v_norm1 != 0)
        beta = torch.zeros(restart + 1, dtype=dt, device=b.device)
        beta[0] = res_norm
        A = H.T
        L, _ = torch.linalg.cholesky_ex(A.T @ A)
        y = torch.cholesky_solve((A.T @ beta)[:, None], L)[:, 0]
        x = x0 + V[:, :-1] @ y
    unit, norm = _normalize(M(b - mv(x)), mesh)
    return x, unit, norm


def gmres_solve(a, b: torch.Tensor, mesh: Mesh, *, inv_diag=None,
                restart: int = 20, iters: int = 5, tol: float = 0.0):
    """Restarted GMRES(restart) for general square systems, row-partitioned:
    at most ``iters`` restarts of ``restart`` Arnoldi steps (the batched
    formulation of ``jax.scipy.sparse.linalg.gmres``).  ``inv_diag``
    (optional) preconditions as in :func:`pcg_solve`.  A restart runs only
    while the preconditioned residual norm exceeds ``tol * |b|`` (a norm at
    or below the dtype's eps counts as zero, as in the reference); the
    check is a mask on the device, so ``tol=0`` runs the fixed budget with
    no host sync.  ``b`` padded and sharded
    like ``cg_solve``'s.  Returns the padded row-sharded solution."""
    def mv(v):
        return dist_spmv(a, v, mesh)

    def M(v):
        return v if inv_diag is None else _precond_apply(inv_diag, v, mesh)

    size = b.shape[0] * mesh.world
    restart = min(restart, size)
    x = torch.zeros_like(b)
    atol = torch.clamp(tol * torch.sqrt(_dot(b, b, mesh)), min=0.0)
    unit, norm = _normalize(M(b - mv(x)), mesh)
    for _ in range(iters):
        go = norm > atol
        x_n, unit_n, norm_n = _gmres_restart(mv, M, b, x, unit, norm,
                                             restart, mesh)
        x = torch.where(go, x_n, x)
        unit = torch.where(go, unit_n, unit)
        norm = torch.where(go, norm_n, norm)
    return x


def power_iteration_step(a, v: torch.Tensor, mesh: Mesh):
    """One normalized power-iteration step: ``v <- A v / ||A v||``; returns
    (v_next, rayleigh_quotient_estimate)."""
    av = dist_spmv(a, v, mesh)
    norm = torch.sqrt(_dot(av, av, mesh))
    lam = _dot(v, av, mesh)
    return av / _safe(norm), lam


def _stored_values(a) -> torch.Tensor:
    """Stored values of a partitioned matrix, for their dtype and device.
    The reference reads ``a.data``, ``a.vals`` or ``a.int_data``; a
    ``PHubSplit`` has none of them and raises ``AttributeError``, here as
    there."""
    if isinstance(a, HaloSegtile):
        return a.plans[0].vals
    return a.data if hasattr(a, "data") else a.int_data


def estimate_lmax(a, mesh: Mesh, *, iters: int = 30,
                  safety: float = 1.05) -> torch.Tensor:
    """Largest-eigenvalue estimate by power iteration (for
    :func:`chebyshev_preconditioner`), scaled by ``safety`` so the
    Chebyshev interval covers the spectrum."""
    L = a.rows_per_shard * a.n_shards
    vals = _stored_values(a)
    v = torch.full((a.rows_per_shard * mesh.local,), 1.0 / np.sqrt(max(L, 1)),
                   dtype=vals.dtype, device=vals.device)
    lam = torch.zeros((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        v, lam = power_iteration_step(a, v, mesh)
    return lam * safety


def chebyshev_preconditioner(a, mesh: Mesh, *, lmax, lmin=None,
                             degree: int = 8):
    """Polynomial (Chebyshev) preconditioner: a callable ``M(v)``
    approximating ``A^{-1} v`` with ``degree`` SpMVs and no solves.  ``A``
    must be SPD with spectrum inside ``[lmin, lmax]`` (``lmin`` defaults to
    ``lmax / 30``; :func:`estimate_lmax` gives the bound).  Pass it as
    ``pcg_solve``'s / ``gmres_solve``'s ``inv_diag``."""
    if lmin is None:
        lmin = lmax / 30.0
    d = (lmax + lmin) / 2.0
    c = (lmax - lmin) / 2.0

    def apply(v):
        z = torch.zeros_like(v)
        r = v
        p = r
        alpha = 1.0 / d
        for i in range(degree):
            if i > 0:
                beta = (c * alpha / 2.0) ** 2 if i > 1 else \
                    0.5 * (c * alpha) ** 2
                alpha = 1.0 / (d - beta / alpha)
                p = r + beta * p
            z = z + alpha * p
            r = r - alpha * dist_spmv(a, p, mesh)
        return z

    return apply

"""One-call production SpMV: prepare once per pattern, apply per vector.

Port of ``sparse_tpu/ops/dispatch.py``.  :func:`smvm_prepare` runs the
host-side structure analysis once and returns a :class:`SmvmAutoPlan` whose
:meth:`~SmvmAutoPlan.apply` computes ``y = A v`` through one rung:

| structure | rung | kernel |
|---|---|---|
| natural 2x2 blocks (vector FEM) | ``blockseg`` + block RCM | K2 |
| column locality (bands, scalar FEM) | ``segtile`` (+ RCM if scrambled) | K1 |
| bsz >= 8 dense blocks | ``bell`` | plain |
| heavy-tailed column degrees | ``hubsplit`` | K1 + plain |
| anything else | ``xla`` (row-binned) | plain |

Rung gates: where the reference gates a fast rung on
``jax.default_backend() == "tpu"``, the port gates it on the matrix lying on
a CUDA device, so on CPU tensors the default ladder picks what the
reference picks off-TPU.  ``prefer=`` pins a rung on both, as in the
reference.  The numeric gates are the reference's TPU-calibrated values
(see ``cuda_csr._MIN_FILL``/``_MAX_RESIDENT`` and ``_HUB_GATE``), kept so
both packages pick the same rung; they are due for re-measurement on the
H100 (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.csr import CSR
from .cuda_csr_block import block_folded_apply

__all__ = ["SmvmAutoPlan", "smvm_prepare"]

#: Hub-strip mass above which the hubsplit rung is taken.  TPU-calibrated
#: (reference dispatch.py:271), to re-measure on the H100.
_HUB_GATE = 0.08


@dataclasses.dataclass(frozen=True)
class SmvmAutoPlan:
    """Prepared SpMV dispatch (from :func:`smvm_prepare`).

    ``kind``: ``"blockseg"``, ``"segtile"``, ``"bell"``, ``"hubsplit"`` or
    ``"xla"``; ``state``: the rung's own plan tuple; ``perm``/``inv_perm``:
    the composed symmetric reorder (None = identity; BLOCK permutations for
    ``blockseg``, whose plan then carries the folded view that
    :meth:`apply` runs); ``value_src``: original storage slot of each
    reordered plan entry (:meth:`refresh`)."""

    state: tuple
    perm: torch.Tensor | None
    inv_perm: torch.Tensor | None
    kind: str
    shape: tuple[int, int]
    value_src: torch.Tensor | None = None

    def refresh(self, data) -> "SmvmAutoPlan":
        """Re-bind to NEW values of the SAME pattern (``data`` = the updated
        ORIGINAL-order CSR ``.data``).  Supported for ``segtile`` (built with
        ``smvm_prepare(refreshable=True)``) and ``xla``; the blocked rungs
        and ``hubsplit`` re-block values on the host — re-run
        :func:`smvm_prepare`.  A ``data`` of the wrong length raises
        ``ValueError``."""
        if self.kind not in ("segtile", "xla"):
            raise NotImplementedError(
                f"SmvmAutoPlan.refresh: the {self.kind!r} rung re-blocks "
                "values through host layouts — re-run smvm_prepare (or use "
                "the kernel-level refresh with re-blocked values)")
        a, plan = self.state
        data = torch.as_tensor(data, device=a.device)
        if tuple(data.shape) != (a.nse,):
            raise ValueError(
                f"SmvmAutoPlan.refresh: data has shape {tuple(data.shape)}, "
                f"the plan's matrix stores ({a.nse},)")
        if self.kind == "segtile":
            from .cuda_csr import seg_tiles_refresh

            d = data[self.value_src] if self.value_src is not None else data
            a2 = CSR(data=d, indices=a.indices, indptr=a.indptr,
                     shape=a.shape)
            return dataclasses.replace(
                self, state=(a2, seg_tiles_refresh(plan, d)))
        a2 = CSR(data=data, indices=a.indices, indptr=a.indptr,
                 shape=a.shape)
        return dataclasses.replace(self, state=(a2, plan))

    @property
    def device(self) -> torch.device:
        return self.state[0].device if self.kind != "hubsplit" \
            else self.state[0].hub_cols.device

    def apply(self, v) -> torch.Tensor:
        """y = A v in the original index space.  The ``blockseg`` rung with
        a composed reorder runs its plan's folded view
        (:func:`~.cuda_csr_block.block_seg_tiles_fold`): one K2 launch on
        ``v`` as given, with the bits of the permuted apply gathered back."""
        if self.kind == "blockseg" and self.perm is not None:
            ab, plan = self.state
            return block_folded_apply(ab, v, plan)
        v = torch.as_tensor(v, device=self.device)
        if self.perm is None:
            return self.apply_permuted(v)
        y = self.apply_permuted(v[self.perm])
        return y[self.inv_perm]

    def apply_permuted(self, v) -> torch.Tensor:
        """y' = (P A P^T) v' — the permute-free path for iterative use
        (identical to :meth:`apply` when no reorder was composed)."""
        v = torch.as_tensor(v, device=self.device)
        if self.kind == "blockseg":
            from .cuda_csr_block import bsr_smvm_segtile_block

            ab, plan = self.state
            return bsr_smvm_segtile_block(ab, v, plan)
        if self.kind == "segtile":
            from .cuda_csr import csr_smvm_segtile

            a, plan = self.state
            return csr_smvm_segtile(a, v, plan)
        if self.kind == "bell":
            from ..formats.bell import bell_smvm

            (b,) = self.state
            return bell_smvm(b, v)
        if self.kind == "hubsplit":
            from .hub_split import hub_split_smvm

            (split,) = self.state
            return hub_split_smvm(split, v)
        from .spmv import csr_smvm_fast

        a, plan = self.state
        return csr_smvm_fast(a, v, plan)


def smvm_prepare(a: CSR, *, reorder: bool = True, verbose: bool = False,
                 prefer: str | None = None,
                 refreshable: bool = False) -> SmvmAutoPlan:
    """Host-side structure analysis + plan build (once per pattern; value
    updates through :meth:`SmvmAutoPlan.refresh` where supported).

    Ladder, first match wins (the reference's order):

    1. square + fully dense natural 2x2 blocks, on CUDA -> ``blockseg`` over
       a block-RCM reorder folded into the plan (``reorder=False`` skips
       the RCM);
    2. operand + output within the residency cap and tile fill above the
       floor, on CUDA -> ``segtile`` (after scalar RCM when ``reorder`` and
       it halves the bandwidth);
    3. square + dense natural blocks at bsz >= 8 -> ``bell`` (not gated);
    4. hub strip >= 8% of entries, on CUDA -> ``hubsplit``;
    5. otherwise -> ``xla``, the row-binned path.

    ``prefer`` pins a rung by name, overriding its structure heuristic and
    device gate but not its capability requirements (squareness, residency
    cap, tile overflow)."""
    from ..utils.stats import csr_block_fill, detect_block_size
    from .cuda_csr import _MAX_RESIDENT, _MIN_FILL, build_seg_tiles
    from .reorder import csr_bandwidth

    n, m = a.shape
    log = (lambda s: print(f"smvm_prepare: {s}")) if verbose \
        else (lambda s: None)
    on_cuda = a.device.type == "cuda"
    dev = a.device

    def want(kind, cap, struct_fn):
        if prefer is not None:
            return prefer == kind and cap
        return cap and struct_fn()

    def to_dev(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(dev)

    # 1. block-granule path (int64 block coordinates: no BSR_MAX_NB cap)
    if want("blockseg", n == m and n % 2 == 0,
            lambda: on_cuda and n >= 1024 and csr_block_fill(a, 2) == 1.0):
        from ..formats.bsr import csr_to_bsr
        from .cuda_csr_block import block_seg_tiles_fold, build_seg_tiles_block
        from .reorder import block_perm_pair, csr_permute, rcm_order_blocked

        if reorder:
            perm = rcm_order_blocked(a, 2)
            ap = csr_permute(a, perm, perm)
        else:
            perm, ap = None, a
        ab = csr_to_bsr(ap, 2)
        try:
            plan = build_seg_tiles_block(ab, wsub=16)
        except ValueError:
            plan = None  # tile overflow — fall through the ladder
        if plan is not None and plan.fill * 4 >= _MIN_FILL:
            log(f"block-granule tiles (fill {plan.fill:.3f})")
            pb = inv = None
            if perm is not None:
                pbn, invn = block_perm_pair(perm, 2)
                pb, inv = to_dev(pbn), to_dev(invn)
                plan = block_seg_tiles_fold(plan, pb)
            return SmvmAutoPlan(state=(ab, plan), perm=pb, inv_perm=inv,
                                kind="blockseg", shape=(n, m))

    # 2. scalar segment tiles (with RCM only when the bandwidth needs it)
    if want("segtile", n + m <= _MAX_RESIDENT, lambda: on_cuda):
        from .reorder import permute_apply, permute_prepare, rcm_order

        perm, ap, vsrc = None, a, None
        if reorder and n == m:
            bw0 = csr_bandwidth(a)
            if bw0 > 16 * 128:
                perm2 = rcm_order(a)
                pplan = permute_prepare(a, perm2, perm2)
                ap2 = permute_apply(pplan, a)
                if csr_bandwidth(ap2) < bw0 / 2:
                    perm, ap = perm2, ap2
                    vsrc = pplan.src
        try:
            plan = build_seg_tiles(ap, wsub="auto", refreshable=refreshable)
        except ValueError:
            plan = None  # tile overflow — fall through the ladder
        if plan is not None and plan.fill >= _MIN_FILL:
            log(f"segment tiles (fill {plan.fill:.3f}, "
                f"reordered={perm is not None})")
            return SmvmAutoPlan(
                state=(ap, plan),
                perm=None if perm is None else to_dev(perm),
                inv_perm=None if perm is None else to_dev(np.argsort(perm)),
                kind="segtile", shape=(n, m), value_src=vsrc)

    # 3. BELL block storage (bsz >= 8, no column locality needed)
    if want("bell", n == m, lambda: True):
        bsz, _ = detect_block_size(a, candidates=(32, 16, 8))
        if bsz >= 8:
            from ..formats.bell import bell_from_csr

            log(f"BELL block storage (bsz {bsz})")
            return SmvmAutoPlan(state=(bell_from_csr(a, bsz),), perm=None,
                                inv_perm=None, kind="bell", shape=(n, m))

    # 4. hub/tail split for heavy-tailed degree distributions
    from .hub_split import hub_mass_fraction

    if want("hubsplit", True,
            lambda: on_cuda and n >= 4096
            and hub_mass_fraction(a) >= _HUB_GATE):
        from .hub_split import hub_split_prepare

        split = hub_split_prepare(a)
        if split.hub_fraction >= _HUB_GATE or prefer == "hubsplit":
            log(f"hub/tail split (hub fraction {split.hub_fraction:.3f})")
            return SmvmAutoPlan(state=(split,), perm=None, inv_perm=None,
                                kind="hubsplit", shape=(n, m))

    # 5. the row-binned path
    from .spmv import build_spmv_plan

    log("row-binned path")
    return SmvmAutoPlan(state=(a, build_spmv_plan(a)), perm=None,
                        inv_perm=None, kind="xla", shape=(n, m))

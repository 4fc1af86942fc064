"""A 1-D mesh of shards, in one process or across ``torch.distributed`` ranks.

The reference runs every distributed op as a ``shard_map`` body over a 1-D
JAX mesh, with three collectives: a tiled ``all_gather``, an ``all_to_all``
(split axis 0, concat axis 0) and the ``psum`` that GSPMD inserts for a dot
product of sharded vectors.  Here a :class:`Mesh` offers the same three to a
per-shard body that each op runs once for every shard this process holds.
A partitioned object keeps the reference's stacked ``[D, ...]`` fields, cut
to this process's shards ``[lo, hi)``; a row-sharded vector is this
process's ``hi - lo`` slabs laid end to end.

Two forms:

* **in-process** (``make_1d_mesh(n)``): all ``n`` shards live in this
  process, on one device (the card unless ``device="cpu"``).  The
  collectives are index operations: ``all_gather`` is the stack itself,
  ``all_to_all`` of the ``[D, D, ...]`` send buffers swaps their first two
  axes, ``all_reduce`` returns its argument.
* **process group** (``make_1d_mesh(n, group=...)`` on an initialised
  ``torch.distributed`` group of ``w`` ranks, ``n`` a multiple of ``w``):
  rank ``r`` holds shards ``[r*n/w, (r+1)*n/w)`` on its device (the
  current card on NCCL, the CPU on gloo).  The collectives are
  ``all_gather_single`` (``all_gather_into_tensor`` on a torch without
  it), ``all_to_all_single`` and ``all_reduce``.  No initialisation is
  caught or retried here: the caller owns the group.

Both give the same results for the same shards: a body sees the same
operands either way.
"""

from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["Mesh"]


class _Done:
    """A collective that has already finished (the in-process form)."""

    def __init__(self, value):
        self._value = value

    def wait(self):
        return self._value


class _Pending:
    """An issued collective: ``wait()`` returns its result once it lands."""

    def __init__(self, work, value, finish):
        self._work, self._value, self._finish = work, value, finish

    def wait(self):
        self._work.wait()
        return self._finish(self._value)


class Mesh:
    """``n_shards`` shards over one mesh axis; see the module docstring.

    ``shape`` maps ``axis`` to the shard count (the reference's
    ``mesh.shape[axis]``); this process holds shards ``[lo, hi)``
    (``local`` of them)."""

    def __init__(self, n_shards: int, axis: str = "shards", device=None,
                 group=None):
        if n_shards < 1:
            raise ValueError(f"Mesh: n_shards must be >= 1, got {n_shards}")
        self.n_shards, self.axis, self.group = int(n_shards), axis, group
        if group is None:
            self.world, self.rank = 1, 0
            self.device = resolve_device(device)
        else:
            import torch.distributed as dist

            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            if self.n_shards % self.world:
                raise ValueError(f"Mesh: {n_shards} shards do not divide "
                                 f"over {self.world} ranks")
            if device is None:
                device = ("cpu" if dist.get_backend(group) == "gloo" else
                          torch.device("cuda", torch.cuda.current_device()))
            self.device = torch.device(device)
        self.local = self.n_shards // self.world
        self.lo = self.rank * self.local
        self.hi = self.lo + self.local

    @property
    def shape(self) -> dict:
        return {self.axis: self.n_shards}

    # -- the three collectives -------------------------------------------

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[local, ...]``, one piece per shard held here; returns
        ``[n_shards, ...]``, every shard's piece in shard order (reshape
        for the reference's ``tiled=True``)."""
        if self.group is None:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        out = x.new_empty((self.n_shards,) + tuple(x.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, x, group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor, async_op: bool = False):
        """``x``: ``[local, n_shards, ...]``, row ``[s, t]`` what shard
        ``s`` sends to shard ``t``; returns ``[local, n_shards, ...]``, row
        ``[t, s]`` what shard ``t`` received from shard ``s``.  With
        ``async_op`` the result comes from ``.wait()`` on the returned
        handle, so work that does not need it can run meanwhile."""
        if self.group is None:
            y = x.transpose(0, 1)
            return _Done(y) if async_op else y
        import torch.distributed as dist

        w, L = self.world, self.local
        tail = tuple(x.shape[2:])
        # per destination rank, the [src local, dst local] pieces
        send = x.reshape((L, w, L) + tail).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)

        def finish(r):  # [src rank, src local, dst local] -> [dst, src]
            return r.permute((2, 0, 1) + tuple(range(3, r.dim()))) \
                .reshape((L, self.n_shards) + tail)

        work = dist.all_to_all_single(recv, send, group=self.group,
                                      async_op=True)
        pending = _Pending(work, recv, finish)
        return pending if async_op else pending.wait()

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (each rank's ``x`` already sums
        its own shards)."""
        if self.group is None:
            return x
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

"""A device mesh over a ``torch.distributed`` group: the port's counterpart
of a ``jax.sharding.Mesh`` with ``shard_map``.

In the JAX package a mesh lays devices out along named axes (``dp``,
``tp``, ``sp``, ``pp``, ``ep``) and a ``shard_map`` body runs once per
device.  Here one process stands at each mesh position (the ranks of
:func:`~parsec_tpu_torch.comm.run_multiproc` with ``distributed=True``),
:class:`Mesh` names the axes over the world group in row-major order, and
each axis is a set of subgroups: the ranks that differ only along it.

The collectives map one to one onto the group's:

- ``psum``/``pmean`` -> :meth:`Mesh.all_reduce` over an axis;
- ``ppermute`` -> :meth:`Mesh.shift`, paired ``isend``/``irecv`` along an
  axis;
- ``all_to_all`` -> :meth:`Mesh.all_to_all` over an axis.

The group is gloo: NCCL refuses two ranks on one card, and the ranks of a
one-card machine share it.  Gloo moves and reduces host memory only: its
point-to-point and all-to-all refuse CUDA tensors, and its all-reduce of
one copies it to the host and sums there.  So every collective stages a
CUDA tensor explicitly: one D2H before, one H2D after, counted in
``staged_bytes`` and timed in ``staged_s`` by operation
(``staged_by_op``).  The recipes' own arithmetic stays on the card; what
runs on the host is the collective itself (an all-reduce's sum included).
"""

from __future__ import annotations

import math
import time
from collections import Counter
from typing import Any, Sequence

import torch
import torch.distributed as dist

__all__ = ["Mesh"]


class Mesh:
    """Named axes over the world group.  ``shape`` maps axis name to
    size, in row-major order (the last axis varies fastest); the sizes'
    product is the world size.  Every rank must build the same mesh, in
    the same order, since subgroups are made collectively."""

    def __init__(self, shape: dict[str, int],
                 device: Any = None) -> None:
        if not dist.is_initialized():
            raise RuntimeError("Mesh: no torch.distributed group; run the "
                               "ranks with run_multiproc(distributed=True)")
        self.shape = dict(shape)
        self.axes = tuple(self.shape)
        world = dist.get_world_size()
        if math.prod(self.shape.values()) != world:
            raise ValueError(f"Mesh {self.shape}: {math.prod(self.shape.values())}"
                             f" positions for a world of {world}")
        self.rank = dist.get_rank()
        self.device = torch.device(device) if device is not None else \
            torch.device("cuda", self.rank % torch.cuda.device_count())
        # coordinates of every rank, row-major
        self._coords = [self._coords_of(r) for r in range(world)]
        self.coords = dict(zip(self.axes, self._coords[self.rank]))
        self._groups: dict[str, tuple[Any, list[int]]] = {}
        for ax in self.axes:
            mine = None
            for key in sorted({self._others(r, ax) for r in range(world)}):
                ranks = [r for r in range(world)
                         if self._others(r, ax) == key]
                # every rank creates every subgroup, in one order
                g = dist.new_group(ranks) if len(ranks) > 1 else None
                if self.rank in ranks:
                    mine = (g, ranks)
            self._groups[ax] = mine
        self.staged_bytes = 0
        self.staged_s = 0.0
        self.staged_by_op: Counter[str] = Counter()

    def _coords_of(self, r: int) -> tuple[int, ...]:
        out = []
        for ax in reversed(self.axes):
            out.append(r % self.shape[ax])
            r //= self.shape[ax]
        return tuple(reversed(out))

    def _others(self, r: int, ax: str) -> tuple:
        return tuple(c for a, c in zip(self.axes, self._coords[r]) if a != ax)

    # -- axis queries ------------------------------------------------------
    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    # -- staging -----------------------------------------------------------
    def _to_host(self, t: torch.Tensor, op: str) -> torch.Tensor:
        if t.device.type == "cpu":
            return t
        t0 = time.perf_counter()
        h = t.detach().to("cpu")
        self.staged_s += time.perf_counter() - t0
        self.staged_bytes += h.numel() * h.element_size()
        self.staged_by_op[op] += h.numel() * h.element_size()
        return h

    def _to_device(self, h: torch.Tensor, like: torch.Tensor,
                   op: str) -> torch.Tensor:
        if h.device == like.device:
            return h
        t0 = time.perf_counter()
        out = h.to(like.device)
        self.staged_s += time.perf_counter() - t0
        self.staged_bytes += h.numel() * h.element_size()
        self.staged_by_op[op] += h.numel() * h.element_size()
        return out

    # -- collectives -------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axis: str | Sequence[str],
                   mean: bool = False) -> torch.Tensor:
        """``psum`` (``pmean`` with ``mean``) of ``t`` over one axis or
        several, as a new tensor."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        out = t.detach().clone()
        for ax in axes:
            g, ranks = self._groups[ax]
            if g is None:
                continue
            h = self._to_host(out, "all_reduce")
            dist.all_reduce(h, group=g)
            out = self._to_device(h, out, "all_reduce")
            if mean:
                out = out / len(ranks)
        return out

    def shift(self, t: torch.Tensor, axis: str, offset: int = 1,
              wrap: bool = True, tag: int = 0) -> torch.Tensor | None:
        """``ppermute`` along ``axis``: send ``t`` to position ``i +
        offset`` and return what position ``i - offset`` sent.  Without
        ``wrap`` the ends neither send past nor receive from beyond the
        axis (the receiving end gets None).  ``tag`` tells apart two
        shifts of same-shaped tensors in flight at once."""
        g, ranks = self._groups[axis]
        n = len(ranks)
        i = self.index(axis)
        dst, src = i + offset, i - offset
        if wrap:
            dst, src = dst % n, src % n
        h = self._to_host(t.detach().contiguous(), "send_recv")
        buf = torch.empty_like(h)
        reqs = []
        if 0 <= src < n and src != i:
            reqs.append(dist.irecv(buf, src=ranks[src], group=g, tag=tag))
        if 0 <= dst < n and dst != i:
            reqs.append(dist.isend(h, dst=ranks[dst], group=g, tag=tag))
        for r in reqs:
            r.wait()
        if not 0 <= src < n:
            return None
        if src == i:
            return t.detach().clone()
        return self._to_device(buf, t, "send_recv")

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(..., tiled=True)`` along ``axis``: split
        ``split_dim`` into ``n`` chunks, send chunk ``j`` to position
        ``j``, and concatenate what arrives along ``concat_dim`` in
        position order."""
        g, ranks = self._groups[axis]
        n = len(ranks)
        if g is None:
            return t.detach().clone()
        chunks = torch.stack(torch.chunk(t.detach(), n, dim=split_dim))
        h = self._to_host(chunks.contiguous(), "all_to_all")
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=g)
        out = self._to_device(out, t, "all_to_all")
        return torch.cat(list(out.unbind(0)), dim=concat_dim)

    def stats(self) -> dict:
        return {"staged_bytes": self.staged_bytes,
                "staged_s": self.staged_s,
                "staged_by_op": dict(self.staged_by_op)}

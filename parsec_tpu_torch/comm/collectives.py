"""Collective-tree communication: broadcast and reduction taskpools.

Port of ``parsec_tpu/comm/collectives.py``: both collectives are plain PTG
taskpools over a tree of the activation layer's shapes (``binomial``,
``chain``, ``star``; ``comm_bcast_tree=auto`` resolves per payload through
:func:`~parsec_tpu_torch.comm.remote_dep.resolve_tree_kind`).

**Broadcast** (:func:`bcast_taskpool`): one task per tree position; the
root reads its tile, every other position receives the payload from its
:func:`tree_parent` and re-serves it to its :func:`tree_children` (an
interior rank re-registers the landed tile, and its children pull from
it), so the root sends O(children(root)) payloads, not O(n).

**Reduction** (:func:`reduce_taskpool`): leaves ship their tile up the
same tree; interior positions combine their children's partials with a
registered op (:func:`register_reduce_op`) before forwarding, so each
edge carries one tile and the root writes the final combine.

The ops combine ``torch.Tensor`` tiles (``torch.add``, ``torch.mul``,
``torch.maximum``, ``torch.minimum``).  :func:`_mp_collective_body` is the
rank body of one staged broadcast and one tree reduction across rank
processes (``run_multiproc``), returning each rank's payload digest and
the fabric's per-peer ledgers.  Nothing of the original is left out.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.params import params as _params
from ..data.data import data_create
from .remote_dep import (TREE_KINDS, resolve_tree_kind, tree_children,
                         tree_parent)

# the runtime lint's contract (analysis/runtimelint.py): empty, since
# the collectives hold no state of their own across threads
_LOCK_PROTECTED = {}
_LOCK_ORDER = ()

__all__ = ["bcast_taskpool", "reduce_taskpool", "register_reduce_op",
           "reduce_op", "tree_children", "tree_parent", "TREE_KINDS",
           "resolve_tree_kind"]


def _dtt_nbytes(V: Any) -> int | None:
    """Per-tile payload hint for ``resolve_tree_kind`` under ``auto``."""
    dtt = getattr(V, "default_dtt", None)
    return None if dtt is None else int(dtt.nbytes)


# the registry is filled at import and read when a pool is built: ops
# registered while pools run are not supported, so it carries no lock
_REDUCE_OPS: dict[str, Callable[[Any, Any], Any]] = {
    "sum": torch.add,
    "prod": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
}


def register_reduce_op(name: str, fn: Callable[[Any, Any], Any]) -> None:
    """Register a binary combine for :func:`reduce_taskpool`; it must be
    associative and commutative (the tree combines in position order)."""
    _REDUCE_OPS[name] = fn


def reduce_op(name: str) -> Callable[[Any, Any], Any]:
    fn = _REDUCE_OPS.get(name)
    if fn is None:
        raise KeyError(f"unknown reduce op {name!r}; registered: "
                       f"{sorted(_REDUCE_OPS)} (register_reduce_op)")
    return fn


def _positions(V: Any, n: int | None) -> int:
    if n is not None:
        return n
    n = getattr(V, "mt", None)
    if n is None:
        raise TypeError(f"cannot infer tree size from {type(V).__name__}; "
                        f"pass n= explicitly")
    return n


def _max_children(kind: str, n: int) -> int:
    return max((len(tree_children(kind, p, n)) for p in range(n)),
               default=0)


def bcast_taskpool(V: Any, *, root: int = 0, n: int | None = None,
                   kind: str | None = None,
                   name: str = "coll_bcast") -> Any:
    """Broadcast tile ``V(root)`` into every tile ``V(p)`` of the ``n``
    tree positions along a ``kind`` tree (default: ``comm_bcast_tree``).
    Position ``p`` maps to tile ``(root + p) % n``, so the root is
    position 0; each position runs on its tile's home rank."""
    from .. import ptg

    n = _positions(V, n)
    kind = resolve_tree_kind(kind, nbytes=_dtt_nbytes(V), n=n)
    if not 0 <= root < n:
        raise ValueError(f"root {root} outside [0, {n})")
    kids = _max_children(kind, n)

    def key(p: int) -> int:
        return (root + p) % n

    p_ = ptg.PTGBuilder(name, V=V, N=n, ROOT=root)
    t = p_.task("B", p=ptg.span(0, lambda g, l: g.N - 1))
    t.affinity("V", lambda g, l: (key(l.p),))
    f = t.flow("A", ptg.RW)
    f.input(data=("V", lambda g, l: (g.ROOT,)),
            guard=lambda g, l: l.p == 0)
    f.input(pred=("B", "A",
                  lambda g, l: {"p": tree_parent(kind, l.p, g.N)}),
            guard=lambda g, l: l.p > 0)
    for s in range(kids):
        f.output(succ=("B", "A",
                       lambda g, l, s=s:
                       {"p": tree_children(kind, l.p, g.N)[s]}),
                 guard=lambda g, l, s=s:
                 s < len(tree_children(kind, l.p, g.N)))
    f.output(data=("V", lambda g, l: (key(l.p),)))

    @t.body
    def body(es, task, g, l):
        pass        # pure movement: the landed copy IS the result

    return p_.build()


def reduce_taskpool(V: Any, OUT: Any, *, op: str = "sum", root: int = 0,
                    n: int | None = None, kind: str | None = None,
                    out_key: int = 0, name: str = "coll_reduce") -> Any:
    """Combine the ``n`` tiles of ``V`` up a ``kind`` tree with ``op``;
    the root writes the final combine into ``OUT(out_key)``.  Each
    position reads its own tile (flow ``L``), at most one partial per
    child slot (flows ``C0..Ck``), and ships its partial to its parent
    (flow ``P``)."""
    from .. import ptg

    n = _positions(V, n)
    kind = resolve_tree_kind(kind, nbytes=_dtt_nbytes(V), n=n)
    if not 0 <= root < n:
        raise ValueError(f"root {root} outside [0, {n})")
    fn = reduce_op(op)
    kids = _max_children(kind, n)

    def key(p: int) -> int:
        return (root + p) % n

    def slot(p: int, nn: int) -> int:
        """Which child slot of its parent position ``p`` occupies."""
        return tree_children(kind, tree_parent(kind, p, nn), nn).index(p)

    p_ = ptg.PTGBuilder(name, V=V, OUT=OUT, N=n, ROOT=root)
    t = p_.task("R", p=ptg.span(0, lambda g, l: g.N - 1))
    t.affinity("V", lambda g, l: (key(l.p),))
    fl = t.flow("L", ptg.READ)
    fl.input(data=("V", lambda g, l: (key(l.p),)))
    for s in range(kids):
        fc = t.flow(f"C{s}", ptg.READ)
        fc.input(pred=("R", "P",
                       lambda g, l, s=s:
                       {"p": tree_children(kind, l.p, g.N)[s]}),
                 guard=lambda g, l, s=s:
                 s < len(tree_children(kind, l.p, g.N)))
    fp = t.flow("P", ptg.WRITE)
    for s in range(kids):
        fp.output(succ=("R", f"C{s}",
                        lambda g, l: {"p": tree_parent(kind, l.p, g.N)}),
                  guard=lambda g, l, s=s:
                  l.p > 0 and slot(l.p, g.N) == s)
    fp.output(data=("OUT", lambda g, l: (out_key,)),
              guard=lambda g, l: l.p == 0)

    @t.body
    def body(es, task, g, l):
        acc = task.flow_data("L").value.clone()
        for s in range(len(tree_children(kind, l.p, n))):
            acc = fn(acc, task.flow_data(f"C{s}").value)
        task.set_flow_data(
            "P", data_create(acc, key=(name, "partial", l.p)).get_copy(0))

    return p_.build()


_params.register("comm_coll_bench_bytes", 4 << 20,
                 "payload size of the multi-process collective body's "
                 "broadcast tile")


def _mp_collective_body(ctx, rank, nranks):
    """One broadcast of a ``comm_coll_bench_bytes`` tile and one tree
    reduction, timed; returns each rank's payload digest, its times, the
    reduction (on rank 0) and the socket fabric's per-peer ledgers, so the
    caller can hold the root's egress to O(children(root))."""
    import hashlib
    import time

    import numpy as np

    from ..data_dist.matrix import VectorTwoDimCyclic

    nbytes = int(_params.get("comm_coll_bench_bytes"))
    mb = max(nbytes // 4, 1)                       # float32 elements
    V = VectorTwoDimCyclic(
        "V", lm=mb * nranks, mb=mb, P=nranks, myrank=rank,
        init_fn=lambda m, size: (
            np.arange(size, dtype=np.float32) * 0.5 + 7.0 if m == 0
            else np.zeros(size, np.float32)))
    t0 = time.perf_counter()
    ctx.add_taskpool(bcast_taskpool(V, n=nranks))
    ctx.wait(timeout=120)
    ctx.comm_barrier()
    bcast_s = time.perf_counter() - t0
    mine = V.data_of(rank).newest_copy().value.cpu().contiguous()
    digest = hashlib.sha256(mine.numpy().tobytes()).hexdigest()

    # reduction: every rank contributes rank+1 over a small tile
    R = VectorTwoDimCyclic(
        "R", lm=64 * nranks, mb=64, P=nranks, myrank=rank,
        init_fn=lambda m, size: np.full(size, float(m + 1), np.float32))
    O = VectorTwoDimCyclic("O", lm=64, mb=64, P=1, myrank=rank,
                           init_fn=lambda m, size:
                           np.zeros(size, np.float32))
    t0 = time.perf_counter()
    ctx.add_taskpool(reduce_taskpool(R, O, op="sum", n=nranks))
    ctx.wait(timeout=120)
    ctx.comm_barrier()
    reduce_s = time.perf_counter() - t0
    red = float(O.data_of(0).newest_copy().value[0]) if rank == 0 else None
    fab = ctx.comm_engine.ce.fabric
    stats = fab.peer_stats() if hasattr(fab, "peer_stats") else {}
    return {"rank": rank, "digest": digest, "bcast_s": bcast_s,
            "reduce_s": reduce_s, "reduce0": red, "peer_stats": stats,
            "tree": _params.get("comm_bcast_tree")}

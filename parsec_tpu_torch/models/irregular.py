"""Irregular and dynamic-graph apps: the reference's dynamic app tier.

Port of ``parsec_tpu/models/irregular.py`` (the shapes of the
reference's ``tests/apps/``):

- :func:`haar_project_dtd`: the adaptive Haar-tree projection
  (``haar_tree/project_dyn.jdf:38-96``).  Task PROJECT(n, l) decides in
  its body whether the approximation error warrants refining, and if so
  inserts its two children at run time: a tree whose shape no front-end
  could enumerate.
- :func:`merge_sort_dtd`: the bottom-up merge tree over sorted runs
  (``merge_sort/merge_sort.jdf``): leaf sorts, then pairwise merges, the
  DAG discovered from tile access order at insertion.  The bodies run
  where the data lies (a CUDA tensor sorts and merges on the card), and
  a merge places both runs by ``torch.searchsorted`` in one pass,
  giving the JAX two-pointer merge's order (ties from the left run
  first).
- :func:`all2all_ptg`: the NR-round all-to-all (``all2all/a2a.jdf:26-75``):
  FANOUT chains each source tile across rounds, SEND fans it to every
  destination, RECV chains the accumulation per destination.
"""

from __future__ import annotations

import math
import threading
from typing import Any

import torch

from .. import ptg
from ..dtd import DTDTaskpool, INOUT, INPUT, OUTPUT, VALUE


# ---------------------------------------------------------------------------
# adaptive Haar projection (haar_tree/project_dyn.jdf)
# ---------------------------------------------------------------------------

_L = 10.0   # domain half-width (project_dyn.jdf:7)


def _key_to_x(n: int, l: int) -> float:
    scale = (2.0 * _L) * (2.0 ** (-n))
    return -_L + scale * (0.5 + l)


def _func(alpha: float, x: float) -> float:
    return math.exp(-(x / alpha) * (x / alpha))


def _node(alpha: float, n: int, l: int) -> tuple[float, float, float]:
    """(s, d, err) of tree node (n, l) — the PROJECT body's arithmetic."""
    sl = _func(alpha, _key_to_x(n + 1, 2 * l))
    sr = _func(alpha, _key_to_x(n + 1, 2 * l + 1))
    d = 0.5 * (sl - sr)
    err = abs(d) * (2.0 ** (-0.5 * n))
    return 0.5 * (sl + sr), d, err


def haar_project_dtd(tp: DTDTaskpool, alpha: float, thresh: float,
                     min_depth: int = 8, max_depth: int = 31) -> dict:
    """Insert the adaptive projection into ``tp``; returns the (live) tree
    dict (n, l) -> (s, d) filled as the discovery runs.  Call ``tp.wait()``
    to drain.  A node refines (stores itself + inserts both children) while
    its error exceeds ``thresh`` or it is shallower than ``min_depth`` —
    exactly ``project_dyn.jdf:63-85``'s ``larger_than_thresh`` protocol.
    """
    tree: dict[tuple[int, int], tuple[float, float]] = {}
    lock = threading.Lock()

    def project(n: int, l: int) -> None:
        s, d, err = _node(alpha, n, l)
        if (n >= min_depth and err <= thresh) or n >= max_depth:
            return                      # leaf: below threshold, stop
        with lock:
            tree[(n, l)] = (s, d)
        # runtime discovery: the children exist only because THIS body
        # decided so (the recursive-refinement insert)
        tp.insert_task(project, (n + 1, VALUE), (2 * l, VALUE),
                       name="PROJECT")
        tp.insert_task(project, (n + 1, VALUE), (2 * l + 1, VALUE),
                       name="PROJECT")

    tp.insert_task(project, (0, VALUE), (0, VALUE), name="PROJECT")
    return tree


def haar_project_reference(alpha: float, thresh: float, min_depth: int = 8,
                           max_depth: int = 31) -> dict:
    """Sequential oracle for :func:`haar_project_dtd`."""
    tree: dict[tuple[int, int], tuple[float, float]] = {}

    def rec(n: int, l: int) -> None:
        s, d, err = _node(alpha, n, l)
        if (n >= min_depth and err <= thresh) or n >= max_depth:
            return
        tree[(n, l)] = (s, d)
        rec(n + 1, 2 * l)
        rec(n + 1, 2 * l + 1)

    rec(0, 0)
    return tree


# ---------------------------------------------------------------------------
# merge sort (merge_sort/merge_sort.jdf)
# ---------------------------------------------------------------------------

def merge_sort_dtd(tp: DTDTaskpool, data: torch.Tensor,
                   run: int = 64) -> torch.Tensor:
    """Sort ``data`` (a 1-D tensor, on the host or the card) through a
    DTD merge tree: leaf tasks sort runs in place, then pairwise merge
    tasks combine them up the tree, every RAW edge discovered from tile
    access order.  Returns the tensor that holds the sorted result after
    ``tp.wait()``."""
    n = len(data)
    if n == 0:
        return data.clone()
    segs = [data[i:i + run].clone() for i in range(0, n, run)]

    def sort_leaf(a: torch.Tensor) -> None:
        a.copy_(torch.sort(a, stable=True).values)

    def merge(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
        # a and b are each sorted: a[i] lands after the b elements below
        # it, b[j] after the a elements at or below it (ties: a first)
        ia = torch.arange(len(a), device=a.device)
        ib = torch.arange(len(b), device=b.device)
        out[ia + torch.searchsorted(b, a, right=False)] = a
        out[ib + torch.searchsorted(a, b, right=True)] = b

    tiles = [tp.tile_of_array(s, key=("run", i))
             for i, s in enumerate(segs)]
    for t in tiles:
        tp.insert_task(sort_leaf, (t, INOUT), name="SORT")
    level = list(zip(tiles, segs))
    h = 0
    while len(level) > 1:
        nxt = []
        h += 1
        for i in range(0, len(level) - 1, 2):
            (ta, sa), (tb, sb) = level[i], level[i + 1]
            out = torch.empty(len(sa) + len(sb), dtype=data.dtype,
                              device=data.device)
            to = tp.tile_of_array(out, key=("merge", h, i // 2))
            tp.insert_task(merge, (ta, INPUT), (tb, INPUT), (to, OUTPUT),
                           name="MERGE")
            nxt.append((to, out))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0][1]


# ---------------------------------------------------------------------------
# all-to-all (all2all/a2a.jdf)
# ---------------------------------------------------------------------------

def all2all_ptg(A: Any, B: Any, rounds: int) -> ptg.PTGTaskpool:
    """NR-round all-to-all: every source tile A(t) reaches every
    destination tile B(s) each round (``a2a.jdf:26-75``'s
    FANOUT -> SEND -> RECV wire pattern; the per-destination RECV
    accumulation is chained so writes stay ordered).

    ``A`` and ``B`` are 1-D tiled collections (``VectorTwoDimCyclic``)
    with equal tile counts/sizes.  After the pool drains (plus a comm
    barrier across ranks), ``B(s) = B0(s) + rounds * sum_t A(t)``.
    """
    NT = A.mt
    assert B.mt == NT

    p = ptg.PTGBuilder("a2a", A=A, B=B, NT=NT, NR=rounds)

    fo = p.task("FANOUT",
                r=ptg.span(0, lambda g, l: g.NR - 1),
                t=ptg.span(0, lambda g, l: g.NT - 1))
    fo.affinity("A", lambda g, l: (l.t,))
    f = fo.flow("A", ptg.READ)
    f.input(data=("A", lambda g, l: (l.t,)), guard=lambda g, l: l.r == 0)
    f.input(pred=("FANOUT", "A", lambda g, l: {"r": l.r - 1, "t": l.t}),
            guard=lambda g, l: l.r > 0)
    f.output(succ=("SEND", "A",
                   lambda g, l: tuple({"r": l.r, "t": l.t, "s": s}
                                      for s in range(g.NT))))
    f.output(succ=("FANOUT", "A", lambda g, l: {"r": l.r + 1, "t": l.t}),
             guard=lambda g, l: l.r < g.NR - 1)
    fo.body(lambda es, task, g, l: None)

    snd = p.task("SEND",
                 r=ptg.span(0, lambda g, l: g.NR - 1),
                 t=ptg.span(0, lambda g, l: g.NT - 1),
                 s=ptg.span(0, lambda g, l: g.NT - 1))
    snd.affinity("A", lambda g, l: (l.t,))
    fs = snd.flow("A", ptg.READ)
    fs.input(pred=("FANOUT", "A", lambda g, l: {"r": l.r, "t": l.t}))
    fs.output(succ=("RECV", "X",
                    lambda g, l: {"r": l.r, "s": l.s, "t": l.t}))
    snd.body(lambda es, task, g, l: None)

    rcv = p.task("RECV",
                 r=ptg.span(0, lambda g, l: g.NR - 1),
                 s=ptg.span(0, lambda g, l: g.NT - 1),
                 t=ptg.span(0, lambda g, l: g.NT - 1))
    rcv.affinity("B", lambda g, l: (l.s,))
    fx = rcv.flow("X", ptg.READ)
    fx.input(pred=("SEND", "A", lambda g, l: {"r": l.r, "t": l.t, "s": l.s}))
    fb = rcv.flow("B", ptg.RW)
    fb.input(data=("B", lambda g, l: (l.s,)),
             guard=lambda g, l: l.r == 0 and l.t == 0)
    fb.input(pred=("RECV", "B",
                   lambda g, l: {"r": l.r, "s": l.s, "t": l.t - 1}),
             guard=lambda g, l: l.t > 0)
    fb.input(pred=("RECV", "B",
                   lambda g, l: {"r": l.r - 1, "s": l.s, "t": g.NT - 1}),
             guard=lambda g, l: l.r > 0 and l.t == 0)
    fb.output(succ=("RECV", "B",
                    lambda g, l: {"r": l.r, "s": l.s, "t": l.t + 1}),
              guard=lambda g, l: l.t < g.NT - 1)
    fb.output(succ=("RECV", "B",
                    lambda g, l: {"r": l.r + 1, "s": l.s, "t": 0}),
              guard=lambda g, l: l.r < g.NR - 1 and l.t == g.NT - 1)
    fb.output(data=("B", lambda g, l: (l.s,)),
              guard=lambda g, l: l.r == g.NR - 1 and l.t == g.NT - 1)

    def accumulate(es, task, g, l):
        task.flow_data("B").value += task.flow_data("X").value

    rcv.body(accumulate)
    return p.build()

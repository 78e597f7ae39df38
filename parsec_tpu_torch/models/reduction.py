"""Generalized binomial-tree reduction: the BT_reduction app.

Port of ``parsec_tpu/models/reduction.py`` (the reference's
``tests/apps/generalized_reduction/BT_reduction.jdf``): NT tiles reduce
under a user operator through the binomial forest.  NT splits into one
complete binary tree per set bit (``count_bits``), each tree reduces
level by level (``BT_REDUC``), and the trees' results fold through a
linear chain (``LINEAR_REDUC``) whose head writes the result back to
``A(0)``.  The execution space is *dependent* (a tree's levels depend on
which tree), and the chain's terminator reads an explicit NULL dep.

The bodies apply ``op`` to the tiles' tensors wherever they lie (a
collection whose ``init_fn`` gives CUDA tensors reduces on the card).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .. import ptg


def count_bits(n: int) -> int:
    return bin(n).count("1")


def tree_bit(n: int, t: int) -> int:
    """Bit position of the t-th (1-based, lowest-first) set bit of n —
    ``log_of_tree_size`` (the tree holds 2^bit leaves)."""
    cnt = 0
    for i in range(n.bit_length()):
        if (1 << i) & n:
            cnt += 1
            if cnt == t:
                return i
    raise ValueError((n, t))


def tree_offset(n: int, t: int) -> int:
    """First leaf index of the t-th tree — ``compute_offset``."""
    off = 0
    cnt = 0
    for i in range(n.bit_length()):
        if (1 << i) & n:
            cnt += 1
            if cnt == t:
                return off
            off += 1 << i
    raise ValueError((n, t))


def index_to_tree(n: int, idx: int) -> int:
    cnt = 0
    for i in range(n.bit_length()):
        if (1 << i) & n:
            cnt += 1
            if idx < (1 << i):
                return cnt
            idx -= 1 << i
    raise ValueError((n, idx))


def local_index(n: int, idx: int) -> int:
    for i in range(n.bit_length()):
        if (1 << i) & n:
            if idx < (1 << i):
                return idx
            idx -= 1 << i
    raise ValueError((n, idx))


def bt_reduction_ptg(A: Any, op: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor] | None = None
                     ) -> ptg.PTGTaskpool:
    """Build the three-class reduction forest over the 1-D collection
    ``A`` (NT = A.mt tiles).  ``op(a, b) -> reduced`` defaults to add.
    After the pool drains, ``A(0)``'s home copy holds the fold of every
    tile (remote ranks need the usual comm barrier first).
    """
    NT = A.mt
    T = count_bits(NT)
    opf = op or (lambda a, b: a + b)

    p = ptg.PTGBuilder("bt_reduction", A=A, NT=NT, T=T)

    # -- leaves ---------------------------------------------------------
    red = p.task("REDUCTION", i=ptg.span(0, lambda g, l: g.NT - 1))
    red.affinity("A", lambda g, l: (l.i,))
    fa = red.flow("V", ptg.READ)
    fa.input(data=("A", lambda g, l: (l.i,)))
    # routes: singleton tree -> straight to the linear chain; otherwise
    # to the tree's first level, A or B side by leaf parity
    fa.output(succ=("LINEAR_REDUC", "C",
                    lambda g, l: {"i": index_to_tree(g.NT, l.i)}),
              guard=lambda g, l:
              tree_bit(g.NT, index_to_tree(g.NT, l.i)) == 0)
    fa.output(succ=("BT_REDUC", "VA",
                    lambda g, l: {"t": index_to_tree(g.NT, l.i), "s": 1,
                                  "i": local_index(g.NT, l.i) // 2}),
              guard=lambda g, l:
              tree_bit(g.NT, index_to_tree(g.NT, l.i)) > 0
              and local_index(g.NT, l.i) % 2 == 0)
    fa.output(succ=("BT_REDUC", "VB",
                    lambda g, l: {"t": index_to_tree(g.NT, l.i), "s": 1,
                                  "i": local_index(g.NT, l.i) // 2}),
              guard=lambda g, l:
              tree_bit(g.NT, index_to_tree(g.NT, l.i)) > 0
              and local_index(g.NT, l.i) % 2 == 1)
    red.body(lambda es, task, g, l: None)

    # -- the binary trees (dependent space: s, i depend on t) ------------
    bt = p.task("BT_REDUC",
                t=ptg.span(1, lambda g, l: g.T),
                s=ptg.span(1, lambda g, l: tree_bit(g.NT, l.t)),
                i=ptg.span(0, lambda g, l:
                           (1 << (tree_bit(g.NT, l.t) - l.s)) - 1))
    bt.affinity("A", lambda g, l: (tree_offset(g.NT, l.t) + l.i * 2,))
    fva = bt.flow("VA", ptg.READ)
    fva.input(pred=("REDUCTION", "V",
                    lambda g, l: {"i": tree_offset(g.NT, l.t) + 2 * l.i}),
              guard=lambda g, l: l.s == 1)
    fva.input(pred=("BT_REDUC", "VB",
                    lambda g, l: {"t": l.t, "s": l.s - 1, "i": 2 * l.i}),
              guard=lambda g, l: l.s > 1)
    fvb = bt.flow("VB", ptg.RW)
    fvb.input(pred=("REDUCTION", "V",
                    lambda g, l: {"i": tree_offset(g.NT, l.t) + 2 * l.i
                                  + 1}),
              guard=lambda g, l: l.s == 1)
    fvb.input(pred=("BT_REDUC", "VB",
                    lambda g, l: {"t": l.t, "s": l.s - 1,
                                  "i": 2 * l.i + 1}),
              guard=lambda g, l: l.s > 1)
    fvb.output(succ=("BT_REDUC", "VA",
                     lambda g, l: {"t": l.t, "s": l.s + 1, "i": l.i // 2}),
               guard=lambda g, l: l.s < tree_bit(g.NT, l.t)
               and l.i % 2 == 0)
    fvb.output(succ=("BT_REDUC", "VB",
                     lambda g, l: {"t": l.t, "s": l.s + 1, "i": l.i // 2}),
               guard=lambda g, l: l.s < tree_bit(g.NT, l.t)
               and l.i % 2 == 1)
    fvb.output(succ=("LINEAR_REDUC", "C", lambda g, l: {"i": l.t}),
               guard=lambda g, l: l.s == tree_bit(g.NT, l.t))

    def bt_body(es, task, g, l):
        a = task.flow_data("VA").value
        b = task.flow_data("VB")
        b.value = opf(a, b.value)
        b.version += 1

    bt.body(bt_body)

    # -- the linear chain over trees (T down to 1) ------------------------
    lin = p.task("LINEAR_REDUC", i=ptg.span(1, lambda g, l: g.T))
    lin.affinity("A", lambda g, l: (tree_offset(g.NT, l.i),))
    fb = lin.flow("B", ptg.READ)
    fb.input(pred=("LINEAR_REDUC", "C", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.T)
    fb.input(null=True, guard=lambda g, l: l.i == g.T)   # the terminator
    fc = lin.flow("C", ptg.RW)
    fc.input(pred=("REDUCTION", "V",
                   lambda g, l: {"i": tree_offset(g.NT, l.i)}),
             guard=lambda g, l: tree_bit(g.NT, l.i) == 0)
    fc.input(pred=("BT_REDUC", "VB",
                   lambda g, l: {"t": l.i, "s": tree_bit(g.NT, l.i),
                                 "i": 0}),
             guard=lambda g, l: tree_bit(g.NT, l.i) > 0)
    fc.output(succ=("LINEAR_REDUC", "B", lambda g, l: {"i": l.i - 1}),
              guard=lambda g, l: l.i > 1)
    fc.output(data=("A", lambda g, l: (0,)), guard=lambda g, l: l.i == 1)

    def lin_body(es, task, g, l):
        b = task.flow_data("B")
        if b is not None:                  # the terminator has no B
            c = task.flow_data("C")
            c.value = opf(b.value, c.value)
            c.version += 1

    lin.body(lin_body)
    return p.build()

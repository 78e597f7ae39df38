"""2-D 5-point stencil as a PTG taskpool.

Port of ``parsec_tpu/models/stencil2d.py``: each iteration every (mb, nb)
tile reads radius-1 ghost ROWS from its north/south neighbours and ghost
COLUMNS from its east/west neighbours of the previous iteration, then
applies

    out = wc*c + wn*north(c) + ws*south(c) + we*east(c) + ww*west(c)

with zero boundaries.  The dynamic body runs on the host in float64; the
traceable the wavefront lowering runs is plain PyTorch over a written-out
group axis (the JAX package's is plain jnp too: no kernel).  The halo
edges carry ``wire=`` views (a remote neighbour would receive only its
ghost row or column); on one rank they are stored and unused.
"""

from __future__ import annotations

from typing import Any

import torch

from .. import ptg
from ..data.data import data_create
from ..data_dist.collection import DictCollection
from ..ptg.lowering import Traceable


def _update(pad: torch.Tensor, w: tuple) -> torch.Tensor:
    """The 5-point update of the interior of ``pad [..., h+2, w+2]``."""
    wc, wn, ws, we, ww = w
    return (wc * pad[..., 1:-1, 1:-1] + wn * pad[..., :-2, 1:-1]
            + ws * pad[..., 2:, 1:-1] + ww * pad[..., 1:-1, :-2]
            + we * pad[..., 1:-1, 2:])


def stencil_2d_ptg(M: Any, weights: Any, iterations: int) -> ptg.PTGTaskpool:
    """Build ST(t, i, j) over the tiles of ``M``.

    ``weights`` = (wc, wn, ws, we, ww).  Flows: C chained over t; N/S/E/W
    read the previous iteration's neighbour tiles (halo); boundaries are
    zero-padded.  Matches :func:`stencil2d_reference`.
    """
    MT, NT = M.mt, M.nt
    w = tuple(float(x) for x in weights)
    if len(w) != 5:
        raise ValueError("stencil_2d_ptg: weights are (wc, wn, ws, we, ww)")

    # t == 0 reads snapshot M (double buffer, as in the 1-D model: a
    # T == 1 writeback must not race generation-0 reads)
    M0 = DictCollection(
        name=M.name + "_0",
        init_fn=lambda i, j: M.data_of(i, j).newest_copy().value.clone(),
        keys=[(i, j) for i in range(MT) for j in range(NT)])

    p = ptg.PTGBuilder("stencil2d", M=M, M0=M0, MT=MT, NT=NT,
                       T=iterations, W=w)
    t = p.task("ST",
               t=ptg.span(0, lambda g, l: g.T - 1),
               i=ptg.span(0, lambda g, l: g.MT - 1),
               j=ptg.span(0, lambda g, l: g.NT - 1))
    t.affinity("M", lambda g, l: (l.i, l.j))
    t.priority(lambda g, l: g.T - l.t)

    fc = t.flow("C", ptg.RW)
    fc.input(data=("M0", lambda g, l: (l.i, l.j)),
             guard=lambda g, l: l.t == 0)
    fc.input(pred=("ST", "C",
                   lambda g, l: {"t": l.t - 1, "i": l.i, "j": l.j}),
             guard=lambda g, l: l.t > 0)
    fc.output(succ=("ST", "C",
                    lambda g, l: {"t": l.t + 1, "i": l.i, "j": l.j}),
              guard=lambda g, l: l.t < g.T - 1)
    # halo fan-out: this tile is next iteration's N/S/E/W ghost source;
    # each edge names the sub-view a remote neighbour would receive
    _all = slice(None)
    fc.output(succ=("ST", "N",
                    lambda g, l: {"t": l.t + 1, "i": l.i + 1, "j": l.j}),
              guard=lambda g, l: l.t < g.T - 1 and l.i < g.MT - 1,
              wire=(slice(-1, None), _all))       # their north = my last row
    fc.output(succ=("ST", "S",
                    lambda g, l: {"t": l.t + 1, "i": l.i - 1, "j": l.j}),
              guard=lambda g, l: l.t < g.T - 1 and l.i > 0,
              wire=(slice(0, 1), _all))           # their south = my first row
    fc.output(succ=("ST", "W",
                    lambda g, l: {"t": l.t + 1, "i": l.i, "j": l.j + 1}),
              guard=lambda g, l: l.t < g.T - 1 and l.j < g.NT - 1,
              wire=(_all, slice(-1, None)))       # their west = my last col
    fc.output(succ=("ST", "E",
                    lambda g, l: {"t": l.t + 1, "i": l.i, "j": l.j - 1}),
              guard=lambda g, l: l.t < g.T - 1 and l.j > 0,
              wire=(_all, slice(0, 1)))           # their east = my first col
    fc.output(data=("M", lambda g, l: (l.i, l.j)),
              guard=lambda g, l: l.t == g.T - 1)

    def _ghost(name, di, dj):
        f = t.flow(name, ptg.READ)
        f.input(data=("M0", lambda g, l: (l.i + di, l.j + dj)),
                guard=lambda g, l: l.t == 0
                and 0 <= l.i + di < g.MT and 0 <= l.j + dj < g.NT)
        f.input(pred=("ST", "C",
                      lambda g, l: {"t": l.t - 1, "i": l.i + di,
                                    "j": l.j + dj}),
                guard=lambda g, l: l.t > 0
                and 0 <= l.i + di < g.MT and 0 <= l.j + dj < g.NT)
        return f

    _ghost("N", -1, 0)    # ghost row above comes from tile (i-1, j)
    _ghost("S", +1, 0)
    _ghost("W", 0, -1)
    _ghost("E", 0, +1)

    def body(es, task, g, l):
        cur = task.flow_data("C").value
        c = cur.double()
        h, wd = c.shape

        def edge(fname, take):
            v = task.flow_data(fname)
            return None if v is None else v.value.double()[take]

        nrow = edge("N", (slice(-1, None), slice(None)))   # their last row
        srow = edge("S", (slice(0, 1), slice(None)))
        wcol = edge("W", (slice(None), slice(-1, None)))
        ecol = edge("E", (slice(None), slice(0, 1)))
        pad = torch.zeros((h + 2, wd + 2), dtype=torch.float64)
        pad[1:-1, 1:-1] = c
        if nrow is not None:
            pad[0:1, 1:-1] = nrow
        if srow is not None:
            pad[-1:, 1:-1] = srow
        if wcol is not None:
            pad[1:-1, 0:1] = wcol
        if ecol is not None:
            pad[1:-1, -1:] = ecol
        # detach: neighbours still read this C as their ghost this round
        task.set_flow_data("C", data_create(
            _update(pad, g.W).to(cur.dtype),
            key=("st2", l.t, l.i, l.j)).get_copy(0))

    # the traceable the wavefront lowering runs, over a leading group
    # axis (None ghosts = zero boundary, exactly like the dynamic body)
    def stacked(c, n_, s_, w_, e_):
        ct = torch.promote_types(c.dtype, torch.float32)
        G, h, wd = c.shape
        pad = c.new_zeros((G, h + 2, wd + 2), dtype=ct)
        pad[:, 1:-1, 1:-1] = c
        if n_ is not None:
            pad[:, 0:1, 1:-1] = n_[:, -1:, :]
        if s_ is not None:
            pad[:, -1:, 1:-1] = s_[:, 0:1, :]
        if w_ is not None:
            pad[:, 1:-1, 0:1] = w_[:, :, -1:]
        if e_ is not None:
            pad[:, 1:-1, -1:] = e_[:, :, 0:1]
        return _update(pad, w).to(c.dtype)

    def apply(*cols):
        def stack(xs):
            return None if xs is None else torch.stack(xs)
        return list(stacked(*(stack(xs) for xs in cols)).unbind(0))

    t.body(body, dyld="stencil2d")
    tp = p.build()
    tp.local_traceables = {"stencil2d": Traceable(apply, stacked=stacked)}
    return tp


def stencil2d_reference(x: Any, weights: Any,
                        iterations: int) -> torch.Tensor:
    """Dense float64 oracle (zero boundaries), on the device of ``x`` when
    it is a tensor."""
    w = tuple(float(v) for v in weights)
    x = torch.as_tensor(x).to(torch.float64)
    for _ in range(iterations):
        pad = x.new_zeros((x.shape[0] + 2, x.shape[1] + 2))
        pad[1:-1, 1:-1] = x
        x = _update(pad, w)
    return x


def stencil2d_flops(rows: int, cols: int, iterations: int) -> float:
    return 2.0 * 5 * rows * cols * iterations

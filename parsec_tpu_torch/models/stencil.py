"""1-D radius-R stencil as a PTG taskpool: the halo-exchange app.

Port of ``parsec_tpu/models/stencil.py``: each iteration, every sequence
tile of a :class:`VectorTwoDimCyclic` reads radius-R ghost regions from
its left and right neighbours of the previous iteration and applies a
(2R+1)-point weighted update, with zero-padded boundaries.

Two incarnations of one taskpool, as in the JAX package:

- the dynamic body (a host chore through ``Context``), in float64 on the
  CPU tensors of the tiles, then cast back to the tile dtype;
- the traceable the lowering runs (``lower_taskpool(stencil_1d_ptg(...))``
  takes the wavefront pass): per level, each group's padded rows
  ``[G, mb + 2R]`` are built with zero ghosts where a neighbour is missing,
  and ONE launch of K3 (:func:`ops.stencil.stencil1d`) updates the group.
  It is scoped to the taskpool through ``local_traceables``, since its
  weights differ per build.

``flops = iterations * N * (2R+1) * 2`` (one multiply and one add per
weight).  :func:`stencil_reference` is the float64 oracle, on the device
of its input.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from .. import ptg
from ..data.data import data_create
from ..data_dist.collection import DictCollection
from ..data_dist.matrix import VectorTwoDimCyclic
from ..ops.stencil import stencil1d, stencil1d_plain
from ..ptg.lowering import Traceable


def stencil_1d_ptg(V: VectorTwoDimCyclic, weights: Any,
                   iterations: int) -> ptg.PTGTaskpool:
    """Build the ST(t, i) taskpool over the sequence tiles of ``V``.

    Flows: C is the tile state chained over t; L/R read the neighbour
    tiles of the previous iteration for the ghost regions (halo
    exchange).  Boundaries are zero-padded.
    """
    W = torch.as_tensor(weights, dtype=torch.float64).reshape(-1)
    R = (len(W) - 1) // 2
    if 2 * R + 1 != len(W):
        raise ValueError("stencil_1d_ptg: weights must have odd length")
    if R > V.mb:
        raise ValueError("stencil_1d_ptg: the radius must fit in one tile")
    NT = V.mt

    # t == 0 reads come from a lazy snapshot of V (double buffer):
    # otherwise the t == T-1 writeback to V(i) races the t == 0 ghost
    # reads of V(i) when T == 1.  The declared key space mirrors V's
    # tiling, so the lowering can lay out the snapshot's store.
    V0 = DictCollection(
        name=V.name + "_0",
        init_fn=lambda i: V.data_of(i).newest_copy().value.clone(),
        keys=[(i,) for i in range(V.mt)])

    p = ptg.PTGBuilder("stencil1d", V=V, V0=V0, NT=NT, T=iterations,
                       W=W, R=R)
    t = p.task("ST",
               t=ptg.span(0, lambda g, l: g.T - 1),
               i=ptg.span(0, lambda g, l: g.NT - 1))
    t.affinity("V", lambda g, l: (l.i,))
    t.priority(lambda g, l: g.T - l.t)

    fc = t.flow("C", ptg.RW)
    fc.input(data=("V0", lambda g, l: (l.i,)),
             guard=lambda g, l: l.t == 0)
    fc.input(pred=("ST", "C", lambda g, l: {"t": l.t - 1, "i": l.i}),
             guard=lambda g, l: l.t > 0)
    fc.output(succ=("ST", "C", lambda g, l: {"t": l.t + 1, "i": l.i}),
              guard=lambda g, l: l.t < g.T - 1)
    # halo flows to next iteration's neighbours
    fc.output(succ=("ST", "L", lambda g, l: {"t": l.t + 1, "i": l.i + 1}),
              guard=lambda g, l: l.t < g.T - 1 and l.i < g.NT - 1)
    fc.output(succ=("ST", "R", lambda g, l: {"t": l.t + 1, "i": l.i - 1}),
              guard=lambda g, l: l.t < g.T - 1 and l.i > 0)
    fc.output(data=("V", lambda g, l: (l.i,)),
              guard=lambda g, l: l.t == g.T - 1)

    fl = t.flow("L", ptg.READ)
    fl.input(data=("V0", lambda g, l: (l.i - 1,)),
             guard=lambda g, l: l.t == 0 and l.i > 0)
    fl.input(pred=("ST", "C", lambda g, l: {"t": l.t - 1, "i": l.i - 1}),
             guard=lambda g, l: l.t > 0 and l.i > 0)

    fr = t.flow("R", ptg.READ)
    fr.input(data=("V0", lambda g, l: (l.i + 1,)),
             guard=lambda g, l: l.t == 0 and l.i < g.NT - 1)
    fr.input(pred=("ST", "C", lambda g, l: {"t": l.t - 1, "i": l.i + 1}),
             guard=lambda g, l: l.t > 0 and l.i < g.NT - 1)

    def body(es, task, g, l):
        cur = task.flow_data("C").value
        c = cur.double()
        left = task.flow_data("L")
        right = task.flow_data("R")
        zeros = torch.zeros(g.R, dtype=torch.float64)
        lg = left.value.double()[-g.R:] if left is not None else zeros
        rg = right.value.double()[:g.R] if right is not None else zeros
        new = stencil1d_plain(torch.cat([lg, c, rg]), g.W).to(cur.dtype)
        # ALWAYS detach into a fresh copy: the incoming C copy is still
        # read by the neighbours' L/R flows of this same iteration (WAR
        # hazard); rebinding it in place would leak t's state into their
        # t-1 ghost reads.  (At t == 0 this also protects the home tile.)
        task.set_flow_data(
            "C", data_create(new, key=("st", l.t, l.i)).get_copy(0))

    # The traceable the wavefront lowering runs: boundary tasks arrive
    # with their L/R flow as None (no active arrow) and read zero ghosts,
    # exactly like the dynamic body.  Computes in the tile dtype promoted
    # with fp32 (bf16 tiles update in fp32), one K3 launch per group.
    wl = W.tolist()
    ghosts: dict[tuple, torch.Tensor] = {}    # zero ghosts, made once each

    def stacked(c, left, right):
        ct = torch.promote_types(c.dtype, torch.float32)
        if left is None or right is None:
            gk = (c.shape[0], ct, c.device)
            zeros = ghosts.get(gk)
            if zeros is None:
                zeros = ghosts[gk] = c.new_zeros((c.shape[0], R), dtype=ct)
        lg = zeros if left is None else left[:, -R:].to(ct)
        rg = zeros if right is None else right[:, :R].to(ct)
        padded = torch.cat([lg, c.to(ct), rg], dim=1)
        return stencil1d(padded, wl).to(c.dtype)

    def apply(cs, lefts, rights):
        def stack(xs):
            if xs is None:
                return None
            return xs[0][None] if len(xs) == 1 else torch.stack(xs)
        return list(stacked(stack(cs), stack(lefts), stack(rights))
                    .unbind(0))

    t.body(body, dyld="stencil1d")
    tp = p.build()
    tp.local_traceables = {"stencil1d": Traceable(apply, stacked=stacked)}
    return tp


def stencil_reference(x: Any, weights: Any, iterations: int) -> torch.Tensor:
    """Dense float64 oracle (zero-padded boundaries), on the device of
    ``x`` when it is a tensor."""
    x = torch.as_tensor(x).to(torch.float64)
    w = torch.as_tensor(weights, dtype=torch.float64).reshape(-1)
    R = (len(w) - 1) // 2
    zeros = x.new_zeros(R)
    for _ in range(iterations):
        x = stencil1d_plain(torch.cat([zeros, x, zeros]), w)
    return x


def stencil_flops(n: int, radius: int, iterations: int) -> float:
    return 2.0 * (2 * radius + 1) * n * iterations


def run_stencil_bench(n: int = 1 << 20, mb: int = 1 << 16, radius: int = 4,
                      iterations: int = 10, nb_cores: int = 2) -> dict:
    """GFLOPS of the dynamic runtime's host bodies
    (``testing_stencil_1D.c`` analog)."""
    from ..runtime import Context
    rng = np.random.default_rng(0)
    base = rng.standard_normal(n).astype(np.float32)
    V = VectorTwoDimCyclic("V", lm=n, mb=mb, P=1,
                           init_fn=lambda m, size:
                           base[m * mb:m * mb + size])
    weights = np.full(2 * radius + 1, 1.0 / (2 * radius + 1))
    tp = stencil_1d_ptg(V, weights, iterations)
    ctx = Context(nb_cores=nb_cores)
    t0 = time.perf_counter()
    ctx.add_taskpool(tp)
    ctx.wait(timeout=600)
    dt = time.perf_counter() - t0
    ctx.fini()
    flops = stencil_flops(n, radius, iterations)
    return {"gflops": flops / dt / 1e9, "seconds": dt, "n": n,
            "radius": radius, "iterations": iterations}

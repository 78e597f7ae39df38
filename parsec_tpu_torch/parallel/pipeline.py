"""Pipeline parallelism (PP), in both incarnations.

Port of ``parsec_tpu/parallel/pipeline.py``:

1. **On the dataflow core** (:func:`pipeline_ptg`): the Ex03 chain widened
   into a stage x microbatch grid.  Task ``P(s, m)`` runs stage ``s`` on
   microbatch ``m`` on the rank that owns stage ``s`` (a 1-D cyclic stage
   distribution), takes its activation from ``P(s-1, m)`` and feeds
   ``P(s+1, m)``, so activations hop rank to rank through the
   remote-dep protocol.  Early microbatches go first, so every stage
   keeps busy.  The stage functions take and return tensors wherever the
   tiles lie: over the device fabric with tiles on the card, each stage
   computes there and each hop is a copy on the card.
2. **On the mesh** (:func:`make_pipeline_step`): stages are the ``pp``
   axis of a :class:`~.mesh.Mesh`, each rank holds its stage's weights,
   and the GPipe rotation runs ``nmicro + nstages - 1`` ticks, each a
   local stage apply and a shift of the activation to the next stage.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from .. import ptg
from ..data_dist.matrix import VectorTwoDimCyclic
from .mesh import Mesh

__all__ = ["pipeline_ptg", "make_pipeline_step"]


def pipeline_ptg(X: Any, stage_fns: Sequence[Callable], nranks: int,
                 name: str = "pipeline") -> ptg.PTGTaskpool:
    """The stage-chain PTG: microbatch tiles ``X(m, 0)`` flow through
    every stage.  ``X`` holds the inputs and takes the final outputs back
    (home rank 0); ``stage_fns[s]`` maps a tensor to a tensor and runs on
    rank ``s % nranks``."""
    S = len(stage_fns)
    stages = VectorTwoDimCyclic(f"{name}_stages", lm=S, mb=1, P=nranks)

    p = ptg.PTGBuilder(name, X=X, STAGES=stages, S=S, M=X.mt,
                       FNS=tuple(stage_fns))
    t = p.task("P",
               s=ptg.span(0, lambda g, l: g.S - 1),
               m=ptg.span(0, lambda g, l: g.M - 1))
    t.affinity("STAGES", lambda g, l: (l.s,))
    # drain early microbatches first so the stages stay busy
    t.priority(lambda g, l: g.M - l.m)
    f = t.flow("V", ptg.RW)
    f.input(data=("X", lambda g, l: (l.m, 0)), guard=lambda g, l: l.s == 0)
    f.input(pred=("P", "V", lambda g, l: {"s": l.s - 1, "m": l.m}),
            guard=lambda g, l: l.s > 0)
    f.output(succ=("P", "V", lambda g, l: {"s": l.s + 1, "m": l.m}),
             guard=lambda g, l: l.s < g.S - 1)
    f.output(data=("X", lambda g, l: (l.m, 0)),
             guard=lambda g, l: l.s == g.S - 1)

    def body(es, task, g, l):
        v = task.flow_data("V")
        v.value = g.FNS[l.s](v.value)
        v.version += 1

    t.body(body)
    return p.build()


def make_pipeline_step(mesh: Mesh, stage_fn: Callable, nstages: int,
                       nmicro: int) -> Callable:
    """A forward pipeline over the ``pp`` axis: ``run(w, xs) -> ys`` with
    ``w`` this rank's stage weights and ``xs`` the ``[nmicro, ...]``
    microbatches (the same on every rank).  ``stage_fn(w, x) -> x``.
    Each tick applies the stage, the last stage retires microbatch
    ``t - (nstages - 1)``, and the activation shifts one stage on (no
    wrap: stage 0 always takes a fresh microbatch).  ``ys`` is shared
    along pp at the end (an all-reduce of the last stage's)."""
    if nstages != mesh.size("pp"):
        raise ValueError(f"nstages={nstages} != pp axis size "
                         f"{mesh.size('pp')}")

    def run(w: Any, xs: torch.Tensor) -> torch.Tensor:
        if xs.shape[0] != nmicro:
            raise ValueError(f"xs carries {xs.shape[0]} microbatches, "
                             f"expected nmicro={nmicro}")
        s = mesh.index("pp")
        cur = torch.zeros_like(xs[0])
        ys = torch.zeros_like(xs)
        for t in range(nmicro + nstages - 1):
            inp = xs[t if t < nmicro else 0] if s == 0 else cur
            out = stage_fn(w, inp)
            done = t - (nstages - 1)
            if s == nstages - 1 and done >= 0:
                ys[done] = out
            nxt = mesh.shift(out, "pp", 1, wrap=False, tag=t)
            cur = nxt if nxt is not None else torch.zeros_like(out)
        if s != nstages - 1:
            ys.zero_()
        return mesh.all_reduce(ys, "pp")

    return run

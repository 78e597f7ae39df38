"""Expert parallelism (EP) on the dataflow core and on the mesh.

Port of ``parsec_tpu/parallel/expert.py``: a mixture-of-experts
feed-forward whose experts are placed by an arbitrary tile -> rank table,
the :class:`~parsec_tpu_torch.data_dist.matrix.TwoDimTabular`
distribution.

Static-capacity top-1 routing as a three-class PTG (:func:`moe_ptg`):

- ``GATE(b)`` on the rank of token block ``b``: the router's argmax, and
  for every expert ``e`` a fixed-capacity buffer ``[cap, 1+d]``: column 0
  the token's row (``-1`` pads), the rest its values.  One guarded output
  dep a ``(b, e)`` pair forms the static all-to-all.
- ``EXPERT(e)`` on ``rank_table(e)``: its FFN on the value columns of
  every incoming buffer; the index column rides along.
- ``COMBINE(b)`` back on ``b``'s rank: scatters the expert outputs to
  their rows by the carried indices and writes the tile.

The routing decision is data (the index column), never graph structure.
The bodies are torch ops on the tiles wherever they lie (on the card over
the device fabric).

The mesh incarnation (:func:`make_moe_step`) is the dense one-hot
dispatch/combine over the ``ep`` axis of a :class:`~.mesh.Mesh`: each rank
applies its own experts, and an all-reduce over ep combines them (what
GSPMD makes of the JAX package's sharded einsums).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .. import ptg
from ..data.data import data_create
from ..data_dist.matrix import TwoDimTabular
from .mesh import Mesh

__all__ = ["moe_ptg", "reference_moe", "make_moe_step"]


def _gate_pack(x: torch.Tensor, wg: torch.Tensor, nexperts: int,
               cap: int) -> list[torch.Tensor]:
    """Top-1 route: one ``[cap, 1+d]`` packed buffer an expert."""
    d = x.shape[1]
    sel = torch.argmax(x @ wg, dim=1)
    out = []
    for e in range(nexperts):
        buf = torch.full((cap, 1 + d), -1.0, dtype=torch.float32,
                         device=x.device)
        rows = torch.nonzero(sel == e).flatten()[:cap]
        buf[:len(rows), 0] = rows.to(torch.float32)
        buf[:len(rows), 1:] = x[rows]
        out.append(buf)
    return out


def _expert_apply(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The FFN on the value columns; the index column rides along."""
    out = buf.to(torch.float32).clone()
    valid = out[:, 0] >= 0
    h = torch.relu(out[:, 1:] @ w)            # relu(x @ W_e)
    out[:, 1:] = torch.where(valid[:, None], h, out[:, 1:])
    return out


def reference_moe(x: torch.Tensor, wg: torch.Tensor,
                  we: torch.Tensor) -> torch.Tensor:
    """The dense reference: top-1 routed ``relu(x @ W_sel)`` a token."""
    sel = torch.argmax(x @ wg, dim=1)
    y = torch.zeros_like(x, dtype=torch.float32)
    for e in range(we.shape[0]):
        rows = torch.nonzero(sel == e).flatten()
        if len(rows):
            y[rows] = torch.relu(x[rows] @ we[e])
    return y


def moe_ptg(X: Any, W: TwoDimTabular, wg: Any, nexperts: int,
            name: str = "moe") -> ptg.PTGTaskpool:
    """Build the EP PTG.  ``X(b, 0)`` is a ``[ntok, d]`` token block
    (the outputs overwrite it); ``W`` holds one ``[d, d]`` expert a tile,
    ``W.rank_of(e, 0)`` its placement; ``wg`` the replicated ``[d,
    nexperts]`` router.  GATE's flow ``B<e>`` targets EXPERT's ``X<b>``:
    the target flow's name depends on the source's local, so each
    ``(b, e)`` pair has its own guarded dep, exactly one active."""
    B, E = X.mt, nexperts
    cap = X.mb   # full capacity: top-1, no token dropped

    p = ptg.PTGBuilder(name, X=X, W=W,
                       WG=torch.as_tensor(wg, dtype=torch.float32),
                       B=B, E=E, CAP=cap)

    ga = p.task("GATE", b=ptg.span(0, lambda g, l: g.B - 1))
    ga.affinity("X", lambda g, l: (l.b, 0))
    ga.flow("T", ptg.READ).input(data=("X", lambda g, l: (l.b, 0)))
    for e in range(E):
        fb = ga.flow(f"B{e}", ptg.WRITE)
        for b in range(B):
            fb.output(succ=("EXPERT", f"X{b}",
                            lambda g, l, e=e: {"e": e}),
                      guard=lambda g, l, b=b: l.b == b)

    def gate_body(es, task, g, l):
        x = task.flow_data("T").value.to(torch.float32)
        packed = _gate_pack(x, g.WG.to(x.device), g.E, g.CAP)
        for e in range(g.E):
            task.set_flow_data(
                f"B{e}", data_create(
                    packed[e],
                    key=(task.taskpool.name, "g", l.b, e)).get_copy(0))

    ga.body(gate_body)

    ex = p.task("EXPERT", e=ptg.span(0, lambda g, l: g.E - 1))
    ex.affinity("W", lambda g, l: (l.e, 0))
    ex.flow("WF", ptg.READ).input(data=("W", lambda g, l: (l.e, 0)))
    for b in range(B):
        fx = ex.flow(f"X{b}", ptg.RW)
        for e in range(E):
            fx.input(pred=("GATE", f"B{e}",
                           lambda g, l, b=b: {"b": b}),
                     guard=lambda g, l, e=e: l.e == e)
        for e in range(E):
            fx.output(succ=("COMBINE", f"R{e}",
                            lambda g, l, b=b: {"b": b}),
                      guard=lambda g, l, e=e: l.e == e)

    def expert_body(es, task, g, l):
        w = task.flow_data("WF").value.to(torch.float32)
        for b in range(g.B):
            buf = task.flow_data(f"X{b}")
            buf.value = _expert_apply(buf.value, w)
            buf.version += 1

    ex.body(expert_body)

    co = p.task("COMBINE", b=ptg.span(0, lambda g, l: g.B - 1))
    co.affinity("X", lambda g, l: (l.b, 0))
    cy = co.flow("Y", ptg.RW)
    cy.input(data=("X", lambda g, l: (l.b, 0)))
    cy.output(data=("X", lambda g, l: (l.b, 0)))
    for e in range(E):
        fr = co.flow(f"R{e}", ptg.READ)
        for b in range(B):
            fr.input(pred=("EXPERT", f"X{b}",
                           lambda g, l, e=e: {"e": e}),
                     guard=lambda g, l, b=b: l.b == b)

    def combine_body(es, task, g, l):
        y = task.flow_data("Y")
        out = torch.zeros_like(y.value, dtype=torch.float32)
        for e in range(g.E):
            buf = task.flow_data(f"R{e}").value
            valid = buf[:, 0] >= 0
            rows = buf[valid, 0].to(torch.int64)
            out[rows] = buf[valid, 1:]
        y.value = out
        y.version += 1

    co.body(combine_body)
    return p.build()


def make_moe_step(mesh: Mesh) -> Callable:
    """The dense-dispatch MoE step over the ``ep`` axis: ``step(x, wg,
    we)`` with tokens ``[T, d]`` and router ``[d, E]`` the same on every
    rank, and ``we`` this rank's ``[E / ep, d, d]`` experts (experts
    ``index("ep") * E/ep`` on).  Returns ``[T, d]``, the same on every
    rank."""

    def step(x: torch.Tensor, wg: torch.Tensor,
             we: torch.Tensor) -> torch.Tensor:
        e_loc = we.shape[0]
        e0 = mesh.index("ep") * e_loc
        sel = torch.argmax(x @ wg, dim=-1)                        # [T]
        onehot = torch.nn.functional.one_hot(
            sel, wg.shape[1]).to(x.dtype)[:, e0:e0 + e_loc]       # [T, e]
        xe = torch.einsum("te,td->etd", onehot, x)                # dispatch
        he = torch.relu(torch.einsum("etd,edf->etf", xe, we))
        y = torch.einsum("te,etf->tf", onehot, he)                # combine
        return mesh.all_reduce(y, "ep")

    return step

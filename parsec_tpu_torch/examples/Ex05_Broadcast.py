"""Ex05: broadcast: one writer task fans out to a reader on every rank.

Port of the JAX package's ``examples/Ex05_Broadcast.py`` (the
reference's ``Ex05_Broadcast.jdf``): rank 0's writer produces a value;
``R(r)`` on each rank receives it through one activation that the comm
engine propagates down a tree.
"""

import torch

from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.data.data import data_create
from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic

NRANKS = 4


def body_fn(ctx, rank, nranks):
    V = VectorTwoDimCyclic("V", lm=nranks, mb=1, P=nranks, myrank=rank,
                           init_fn=lambda m, size: torch.zeros(size))
    p = ptg.PTGBuilder("bcast", V=V, NR=nranks)
    w = p.task("W", z=ptg.span(0, 0))
    w.affinity("V", lambda g, l: (0,))
    fw = w.flow("A", ptg.WRITE)
    for r in range(nranks):
        fw.output(succ=("R", "X", lambda g, l, r=r: {"r": r}))

    @w.body
    def wbody(es, task, g, l):
        task.set_flow_data("A", data_create(
            torch.full((1,), 42.0), key=("w", 0)).get_copy(0))

    t = p.task("R", r=ptg.span(0, lambda g, l: g.NR - 1))
    t.affinity("V", lambda g, l: (l.r,))
    t.flow("X", ptg.READ).input(pred=("W", "A", lambda g, l: {"z": 0}))
    fy = t.flow("Y", ptg.RW)
    fy.input(data=("V", lambda g, l: (l.r,)))
    fy.output(data=("V", lambda g, l: (l.r,)))

    @t.body
    def rbody(es, task, g, l):
        y = task.flow_data("Y")
        y.value = task.flow_data("X").value.clone()

    ctx.add_taskpool(p.build())
    ctx.wait(timeout=60)
    ctx.comm_barrier()
    return float(V.data_of(rank).newest_copy().value[0])


def main() -> list:
    res = run_multirank(NRANKS, body_fn)
    assert res == [42.0] * NRANKS, res
    return res


if __name__ == "__main__":
    print(f"broadcast landed on all {NRANKS} ranks: {main()}")

"""Ex03: the chain distributed: task affinity walks the ranks.

Port of the JAX package's ``examples/Ex03_ChainMPI.py`` (the reference's
``Ex03_ChainMPI.jdf``): the Ex02 chain where ``T(i)`` lives on rank
``i % nranks``, so the tile hops rank to rank through the remote-dep
protocol.  Runs 4 in-process ranks over the comm engine.
"""

import torch

from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic

NB = 8
NRANKS = 4


def body_fn(ctx, rank, nranks):
    V = VectorTwoDimCyclic("V", lm=NB, mb=1, P=nranks, myrank=rank,
                           init_fn=lambda m, size: torch.zeros(size))
    p = ptg.PTGBuilder("chainmpi", V=V, NB=NB)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.NB - 1))
    t.affinity("V", lambda g, l: (l.i,))      # T(i) runs on rank_of(V(i))
    f = t.flow("A", ptg.RW)
    f.input(data=("V", lambda g, l: (0,)), guard=lambda g, l: l.i == 0)
    f.input(pred=("T", "A", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "A", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.NB - 1)
    f.output(data=("V", lambda g, l: (0,)),
             guard=lambda g, l: l.i == g.NB - 1)

    @t.body
    def body(es, task, g, l):
        v = task.flow_data("A")
        v.value = v.value + 1

    ctx.add_taskpool(p.build())
    ctx.wait(timeout=60)
    ctx.comm_barrier()
    if rank == 0:     # V(0) is homed on rank 0
        return float(V.data_of(0).newest_copy().value[0])
    return None


def main() -> float:
    res = run_multirank(NRANKS, body_fn)
    assert res[0] == NB, res
    return res[0]


if __name__ == "__main__":
    print(f"chain hopped {NRANKS} ranks, counted to {main():.0f}")

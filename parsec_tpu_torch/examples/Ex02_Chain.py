"""Ex02: a task chain, one RW flow threaded through ``T(i-1) -> T(i)``.

Port of the JAX package's ``examples/Ex02_Chain.py`` (the reference's
``Ex02_Chain.jdf``): NB tasks in a chain, each incrementing the value it
received from its predecessor.  Built with the programmatic DSL.
"""

import torch

from parsec_tpu_torch import ptg
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.runtime import Context

NB = 10


def main() -> float:
    coll = DictCollection("A", dtt=TileType((1,), torch.float32),
                          init_fn=lambda *k: torch.zeros(1))
    p = ptg.PTGBuilder("chain", A=coll, NB=NB)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.NB - 1))
    f = t.flow("V", ptg.RW)
    f.input(data=("A", lambda g, l: (0,)), guard=lambda g, l: l.i == 0)
    f.input(pred=("T", "V", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "V", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.NB - 1)
    f.output(data=("A", lambda g, l: (0,)),
             guard=lambda g, l: l.i == g.NB - 1)

    @t.body
    def body(es, task, g, l):
        v = task.flow_data("V")
        v.value = v.value + 1

    ctx = Context(nb_cores=0)
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=30)
    ctx.fini()
    out = float(coll.data_of(0).newest_copy().value[0])
    assert out == NB, out
    return out


if __name__ == "__main__":
    print(f"chain of {NB} tasks counted to {main():.0f}")

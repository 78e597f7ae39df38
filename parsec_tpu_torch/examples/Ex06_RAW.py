"""Ex06: the read-after-write problem: an anti-dependency left implicit.

Port of the JAX package's ``examples/Ex06_RAW.py`` (the reference's
``Ex06_RAW.jdf``): a Bcast task hands one datum to several readers AND to
an updater that overwrites it, and nothing orders the readers against
the update, so whether a reader observes 7 or 700 depends on scheduling.
Ex07 fixes it with CTL arrows.
"""

import torch

from parsec_tpu_torch import ptg
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.runtime import Context

NREADERS = 4


def main() -> tuple:
    coll = DictCollection("M", dtt=TileType((1,), torch.float32),
                          init_fn=lambda *k: torch.zeros(1))
    seen: list = []
    p = ptg.PTGBuilder("raw", M=coll, NR=NREADERS)

    w = p.task("Bcast", k=ptg.span(0, 0))
    fw = w.flow("A", ptg.RW)
    fw.input(data=("M", lambda g, l: (0,)))
    fw.output(succ=("Update", "A", lambda g, l: {"k": 0}))
    for r in range(NREADERS):
        fw.output(succ=("Recv", "A", lambda g, l, r=r: {"r": r}))

    @w.body
    def wbody(es, task, g, l):
        task.flow_data("A").value = torch.full((1,), 7.0)

    u = p.task("Update", k=ptg.span(0, 0))
    fu = u.flow("A", ptg.RW)
    fu.input(pred=("Bcast", "A", lambda g, l: {"k": 0}))
    fu.output(data=("M", lambda g, l: (0,)))

    @u.body
    def ubody(es, task, g, l):
        a = task.flow_data("A")
        a.value = a.value * 100    # the unordered update

    t = p.task("Recv", r=ptg.span(0, lambda g, l: g.NR - 1))
    t.flow("A", ptg.READ).input(pred=("Bcast", "A", lambda g, l: {"k": 0}))

    @t.body
    def rbody(es, task, g, l):
        seen.append(float(task.flow_data("A").value[0]))

    ctx = Context(nb_cores=0)
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=30)
    ctx.fini()
    assert len(seen) == NREADERS
    assert all(v in (7.0, 700.0) for v in seen), seen
    return seen, float(coll.data_of(0).newest_copy().value[0])


if __name__ == "__main__":
    seen, final = main()
    racy = [v for v in seen if v != 7.0]
    print(f"readers saw {seen} (final={final:.0f})"
          + (f" — {len(racy)} hit the RAW hazard; Ex07 shows the fix"
             if racy else " — no hazard this run, but nothing forbids it"))

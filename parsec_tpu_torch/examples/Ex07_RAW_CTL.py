"""Ex07: ordering anti-dependencies explicitly with a CTL arrow.

Port of the JAX package's ``examples/Ex07_RAW_CTL.py`` (the reference's
``Ex07_RAW_CTL.jdf``): the Ex06 shape, but the updater waits until every
reader is done; a control arrow from each ``Recv(r)`` to ``Update``
encodes the write-after-read dependency the data edges cannot express.
"""

import torch

from parsec_tpu_torch import ptg
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.runtime import Context

NREADERS = 4


def main() -> list:
    coll = DictCollection("M", dtt=TileType((1,), torch.float32),
                          init_fn=lambda *k: torch.zeros(1))
    order: list = []
    p = ptg.PTGBuilder("rawctl", M=coll, NR=NREADERS)

    w = p.task("Bcast", k=ptg.span(0, 0))
    fw = w.flow("A", ptg.RW)
    fw.input(data=("M", lambda g, l: (0,)))
    fw.output(succ=("Update", "A", lambda g, l: {"k": 0}))
    for r in range(NREADERS):
        fw.output(succ=("Recv", "A", lambda g, l, r=r: {"r": r}))

    @w.body
    def wbody(es, task, g, l):
        task.flow_data("A").value = torch.full((1,), 7.0)

    t = p.task("Recv", r=ptg.span(0, lambda g, l: g.NR - 1))
    t.flow("A", ptg.READ).input(pred=("Bcast", "A", lambda g, l: {"k": 0}))
    # the WAR edge: tell Update this reader is done
    t.flow("ctl", ptg.CTL).output(
        succ=("Update", "ctl", lambda g, l: {"k": 0}))

    @t.body
    def rbody(es, task, g, l):
        order.append(("read", l.r))

    u = p.task("Update", k=ptg.span(0, 0))
    fu = u.flow("A", ptg.RW)
    fu.input(pred=("Bcast", "A", lambda g, l: {"k": 0}))
    fu.output(data=("M", lambda g, l: (0,)))
    fc = u.flow("ctl", ptg.CTL)
    for r in range(NREADERS):
        fc.input(pred=("Recv", "ctl", lambda g, l, r=r: {"r": r}))

    @u.body
    def ubody(es, task, g, l):
        order.append(("update",))
        a = task.flow_data("A")
        a.value = a.value * 100

    ctx = Context(nb_cores=0)
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=30)
    ctx.fini()
    assert order[-1] == ("update",), order    # CTL held the update back
    assert len(order) == NREADERS + 1
    assert float(coll.data_of(0).newest_copy().value[0]) == 700.0
    return order


if __name__ == "__main__":
    print(f"update ran strictly after {NREADERS} reads: {main()[-1]}")

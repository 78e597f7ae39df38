"""Ex11: the persistent serving layer: one hot runtime, many clients.

Port of the JAX package's ``examples/Ex11_Serve.py``: two tenants share a
:class:`~parsec_tpu_torch.serve.RuntimeServer`; the ``pro`` tenant
carries a 4x fair-share weight and one of its requests a priority bump;
a deadline-bounded request queued behind a full admission window is shed
with :class:`~parsec_tpu_torch.serve.DeadlineExceeded`.
"""

import itertools
import time

import torch

from parsec_tpu_torch import ptg
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.serve import (AdmissionController, DeadlineExceeded,
                                    RuntimeServer)

NB = 6
_uniq = itertools.count()


def chain_request(body_sleep: float = 0.0):
    """One client request: the Ex02 counting chain as a private pool."""
    tag = next(_uniq)
    coll = DictCollection(f"A{tag}", dtt=TileType((1,), torch.float32),
                          init_fn=lambda *k: torch.zeros(1))
    p = ptg.PTGBuilder(f"req{tag}", A=coll, NB=NB)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.NB - 1))
    f = t.flow("V", ptg.RW)
    f.input(data=("A", lambda g, l: (0,)), guard=lambda g, l: l.i == 0)
    f.input(pred=("T", "V", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "V", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.NB - 1)
    f.output(data=("A", lambda g, l: (0,)),
             guard=lambda g, l: l.i == g.NB - 1)

    def body(es, task, g, l):
        if body_sleep:
            time.sleep(body_sleep)
        v = task.flow_data("V")
        v.value = v.value + 1

    t.body(body)
    return p.build(), coll


def main() -> dict:
    stats = {}
    with RuntimeServer(nb_cores=2,
                       tenant_weights={"free": 1.0, "pro": 4.0}) as server:
        # a burst of requests from both tenants, one with a priority bump
        tickets = []
        for i in range(6):
            tp, coll = chain_request()
            tickets.append((server.submit(
                tp, tenant="pro" if i % 2 else "free",
                priority=10 if i == 5 else 0), coll))
        for tk, coll in tickets:
            tk.result(timeout=30)       # this submission, not a full drain
            got = float(coll.data_of(0).newest_copy().value[0])
            assert got == NB, got
        stats = server.stats()
        assert stats["completed"] == 6, stats

    # deadline shedding: a 1-slot admission window held by a slow request
    # sheds the deadline-bounded one behind it
    with RuntimeServer(nb_cores=1,
                       admission=AdmissionController(max_inflight=1)
                       ) as server:
        slow, _ = chain_request(body_sleep=0.1)
        holder = server.submit(slow, tenant="free")
        quick, _ = chain_request()
        try:
            server.submit(quick, tenant="free", deadline=0.05)
            raise AssertionError("expected DeadlineExceeded")
        except DeadlineExceeded:
            pass
        holder.result(timeout=30)
        assert server.stats()["admission"]["shed_deadline"] == 1
    return stats


if __name__ == "__main__":
    s = main()
    print(f"served {s['completed']} requests across tenants "
          f"{sorted(s['per_tenant_completed'])}; "
          f"1 deadline-bounded request shed")

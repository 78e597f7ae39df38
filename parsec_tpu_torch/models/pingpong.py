"""Pingpong: the comm layer's latency and bandwidth harness.

Port of ``parsec_tpu/models/pingpong.py`` (the reference's
``tests/apps/pingpong/rtt.jdf`` and ``bandwidth.jdf``): one RW datum
threads through NT tasks whose affinity walks the ranks round-robin
(``: A(k % WS)``), so every hop is one remote activation and one payload
move.  NT hops timed end to end give the round trip a hop of whichever
fabric carries the ranks; a larger tile (``payload``, the tile's bytes)
turns the rtt shape into the bandwidth shape on the same wire path.
"""

from __future__ import annotations

import time
from typing import Any

from .. import ptg
from ..data.data import nbytes_of


def pingpong_ptg(A: Any, nt: int) -> ptg.PTGTaskpool:
    """PING(k), k = 0..nt-1: T chains rank to rank; every task also
    writes its state back to its local home tile (rtt.jdf:13-21)."""
    WS = max(A.nodes, 1)
    p = ptg.PTGBuilder("pingpong", A=A, NT=nt, WS=WS)
    t = p.task("PING", k=ptg.span(0, lambda g, l: g.NT - 1))
    t.affinity("A", lambda g, l: (l.k % g.WS,))
    t.priority(lambda g, l: 0)
    f = t.flow("T", ptg.RW)
    f.input(data=("A", lambda g, l: (0,)), guard=lambda g, l: l.k == 0)
    f.input(pred=("PING", "T", lambda g, l: {"k": l.k - 1}),
            guard=lambda g, l: l.k > 0)
    f.output(succ=("PING", "T", lambda g, l: {"k": l.k + 1}),
             guard=lambda g, l: l.k < g.NT - 1)
    f.output(data=("A", lambda g, l: (l.k % g.WS,)))

    def body(es, task, g, l):
        t_ = task.flow_data("T")
        t_.value += 1.0
        t_.version += 1     # an in-place RW write bumps the version

    t.body(body)
    return p.build()


def run_pingpong(ctx: Any, A: Any, nt: int,
                 timeout: float = 300.0) -> dict:
    """Run NT hops and report seconds a hop (the rtt harness,
    ``pingpong/main.c``).  The caller owns the barrier and the check."""
    tp = pingpong_ptg(A, nt)
    t0 = time.perf_counter()
    ctx.add_taskpool(tp)
    tp.wait(timeout=timeout)
    dt = time.perf_counter() - t0
    return {"seconds": dt, "hops": nt, "us_per_hop": dt / nt * 1e6,
            "payload_bytes": nbytes_of(A.data_of(0).newest_copy().value)}

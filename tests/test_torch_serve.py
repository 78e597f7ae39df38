"""The port's serving layer (``parsec_tpu_torch/serve``) on plain DAG
submissions: tickets, admission, weighted-fair tenants, drain and
context poison — held against ``parsec_tpu/serve`` where the behaviour
is deterministic (the fair scheduler's pick order on the same queue).
The LLM streams on top of it are in ``tests/test_torch_llm.py``.
"""

import itertools
import time

import pytest

from parsec_tpu.serve.fair import FairScheduler as JFairScheduler
from parsec_tpu_torch import ptg
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.runtime.context import ContextWaitTimeout
from parsec_tpu_torch.sched.api import SchedulerModule
from parsec_tpu_torch.serve import (AdmissionController, AdmissionRejected,
                                    DeadlineExceeded, RuntimeServer)
from parsec_tpu_torch.serve.fair import FairScheduler

_uniq = itertools.count()


def _chain_pool(nb=5, body_sleep=0.0):
    """T(0) -> ... -> T(nb-1), each adding 1 to one tile; returns
    (taskpool, check)."""
    tag = next(_uniq)
    coll = DictCollection(f"chain{tag}", dtt=TileType((1,)))
    p = ptg.PTGBuilder(f"chain{tag}", A=coll, NB=nb)
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
        v = task.data[0]                 # the one flow, V
        v.value = v.value + 1

    t.body(body)

    def check():
        assert float(coll.data_of(0).newest_copy().value[0]) == nb

    return p.build(), check


def test_two_tenants_submissions_resolve_with_their_results():
    with RuntimeServer(nb_cores=2, tenant_weights={"a": 2.0}) as server:
        pools = [_chain_pool(nb=3 + i % 3) for i in range(8)]
        tks = [server.submit(tp, tenant="ab"[i % 2], priority=i % 2)
               for i, (tp, _) in enumerate(pools)]
        for tk, (tp, check) in zip(tks, pools):
            assert tk.result(timeout=30) is tp
            check()
            assert tk.state == "done" and tk.latency_s >= 0
        s = server.stats()
    assert s["completed"] == 8 and s["failed"] == s["rejected"] == 0
    assert s["per_tenant_completed"] == {"a": 4, "b": 4}
    assert sum(s["fair_dispatched"].values()) == sum(3 + i % 3
                                                     for i in range(8))


def test_admission_sheds_deadlines_and_cancels():
    server = RuntimeServer(nb_cores=1,
                           admission=AdmissionController(max_inflight=1))
    slow, check = _chain_pool(nb=2, body_sleep=0.2)
    t_slow = server.submit(slow)
    with pytest.raises(AdmissionRejected):
        server.submit(_chain_pool(nb=2)[0], block=False)
    with pytest.raises(DeadlineExceeded):
        server.submit(_chain_pool(nb=2)[0], deadline=0.05)
    t_slow.result(timeout=30)
    check()
    assert t_slow.cancel() is False             # it already ran
    s = server.stats()
    assert s["rejected"] == 2 and s["admission"]["shed_deadline"] == 1
    server.drain(timeout=30)
    with pytest.raises(AdmissionRejected):
        server.submit(_chain_pool(nb=2)[0])


def _jax_chain_value(nb: int, compiled: bool) -> float:
    """The same chain through the JAX package's server: its tile after
    ``nb`` increments."""
    import numpy as np

    from parsec_tpu import ptg as jptg
    from parsec_tpu.data.data import TileType as JTileType
    from parsec_tpu.data_dist.collection import DictCollection as JDict
    from parsec_tpu.serve import RuntimeServer as JServer

    coll = JDict("jchain", dtt=JTileType((1,), np.float32))
    p = jptg.PTGBuilder("jchain", A=coll, NB=nb)
    t = p.task("T", i=jptg.span(0, lambda g, l: g.NB - 1))
    f = t.flow("V", jptg.RW)
    f.input(data=("A", lambda g, l: (0,)), guard=lambda g, l: l.i == 0)
    f.input(pred=("T", "V", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "V", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.NB - 1)
    f.output(data=("A", lambda g, l: (0,)),
             guard=lambda g, l: l.i == g.NB - 1)

    def body(es, task, g, l):
        v = task.data[0]
        v.value = v.value + 1

    t.body(body)
    with JServer(nb_cores=1) as server:
        server.submit(p.build(), compiled=compiled).result(timeout=30)
    return float(coll.data_of(0).newest_copy().value[0])


def _served_chain(compiled: bool, nb: int = 6):
    """Serve a chain pool whose body records whether its pool ran on the
    compiled DAG; returns (tile value, engaged flags, fair dispatches)."""
    tp, check = _chain_pool(nb=nb)
    tc = tp.task_classes[0]
    inner = tc.chores[0].hook.ptg_body
    engaged = []

    def body(es, task, g, l):
        engaged.append(getattr(task.taskpool, "_compiled_dag", None)
                       is not None)
        return inner(es, task, g, l)

    tc.chores[0].hook = ptg.dsl.TaskClassBuilder._wrap_cpu_body(
        tp._tc_builders["T"], body)
    with RuntimeServer(nb_cores=1) as server:
        assert server.submit(tp, compiled=compiled).result(timeout=30) is tp
        dispatched = sum(server.stats()["fair_dispatched"].values())
    check()
    coll = tp.globals["A"]
    return float(coll.data_of(0).newest_copy().value[0]), engaged, dispatched


def test_compiled_submission_runs_on_the_compiled_dag():
    """``compiled=True`` puts a host pool on the compiled-DAG executor:
    every body ran while the pool held its compiled DAG, no task went
    through the fair scheduler, and the tile equals the JAX server's
    (exactly: six fp32 increments of an integer)."""
    got, engaged, dispatched = _served_chain(compiled=True)
    assert engaged == [True] * 6 and dispatched == 0
    assert got == _jax_chain_value(6, compiled=True) == 6.0


def test_served_pool_stays_dynamic_by_default():
    """``compiled=False``, the default, keeps a served pool on the
    dynamic scheduler: the fair shim dispatches every task."""
    got, engaged, dispatched = _served_chain(compiled=False)
    assert engaged == [False] * 6 and dispatched == 6
    assert got == _jax_chain_value(6, compiled=False) == 6.0


class _StubInner(SchedulerModule):
    name = "stub"

    def __init__(self):
        self.items = []

    def schedule(self, es, tasks, distance=0):
        self.items.extend(tasks)

    def select(self, es):
        return (self.items.pop(0), 0) if self.items else (None, 0)

    def pending_tasks(self, context):
        return len(self.items)


class _Sub:
    def __init__(self, tenant, priority=0, deadline_at=None):
        self.tenant = tenant
        self.priority = priority
        self.deadline_at = deadline_at


class _Task:
    def __init__(self, sub, tag, priority=0):
        self.taskpool = type("_TP", (), {})()
        self.taskpool._serve_sub = sub
        self.priority = priority
        self.tag = tag


def test_fair_pick_order_matches_the_jax_scheduler():
    """The same queue (two weighted tenants, priorities, a deadline)
    drains in the same order through both fair schedulers."""
    subs = [_Sub("heavy"), _Sub("light"), _Sub("heavy", priority=3),
            _Sub("light", deadline_at=50.0)]
    orders = []
    for cls in (JFairScheduler, FairScheduler):
        fair = cls(_StubInner())
        fair.set_weight("heavy", 3.0)
        fair.set_weight("light", 1.0)
        for i in range(48):
            fair.schedule(None, [_Task(subs[i % 4], f"t{i}", i % 5)])
        orders.append([fair.select(None)[0].tag for _ in range(48)])
        assert fair.select(None) == (None, 0)
    assert orders[0] == orders[1]
    heavy = [t for t in orders[1][:24] if int(t[1:]) % 2 == 0]
    assert 16 <= len(heavy) <= 20               # a 3:1 share within rounding


def test_drain_timeout_fails_leftovers_and_reentry_returns():
    server = RuntimeServer(nb_cores=1)
    tk = server.submit(_chain_pool(nb=2, body_sleep=0.5)[0])
    time.sleep(0.05)
    with pytest.raises(ContextWaitTimeout):
        server.drain(timeout=0.1)
    with pytest.raises(ContextWaitTimeout):
        tk.result(timeout=5)
    assert server.stats()["inflight"] == 0
    t0 = time.monotonic()
    server.drain(timeout=5)
    assert time.monotonic() - t0 < 2


def test_worker_failure_fails_inflight_tickets_and_poisons_server():
    server = RuntimeServer(nb_cores=1)
    p = ptg.PTGBuilder(f"boom{next(_uniq)}")
    t = p.task("BOOM", i=ptg.span(0, lambda g, l: 0))
    t.flow("ctl", ptg.CTL)

    def body(es, task, g, l):
        raise ValueError("serving body exploded")

    t.body(body)
    tk = server.submit(p.build())
    with pytest.raises(RuntimeError):
        tk.result(timeout=30)
    assert tk.state == "failed" and server.stats()["poisoned"]
    with pytest.raises(AdmissionRejected):
        server.submit(_chain_pool(nb=2)[0])
    with pytest.raises(AdmissionRejected):
        server.submit_stream([1, 2], max_new_tokens=2)
    with pytest.raises(RuntimeError):
        server.drain(timeout=10)

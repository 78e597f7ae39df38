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


# ---------------------------------------------------------------------------
# the task budget, lowered submissions and a caller's context
# ---------------------------------------------------------------------------

def test_task_budget_charges_the_enumerated_task_count():
    """A submission costs its ``nb_local_tasks()``; the budget holds the
    sum, admits an oversized submission when nothing is in flight, and
    releases exactly what it charged (the JAX controller's rule)."""
    from parsec_tpu.serve.admission import AdmissionController as JAdm
    for cls in (AdmissionController, JAdm):
        adm = cls(max_inflight=0, max_tenant_inflight=0,
                  max_inflight_tasks=10)
        adm.admit("a", 6, block=False)
        with pytest.raises(Exception) as e:
            adm.admit("b", 5, block=False)      # 11 > 10
        assert "budget" in str(e.value)
        adm.admit("b", 4, block=False)          # 10 fits
        assert adm.stats()["inflight_tasks"] == 10
        adm.release("a", 6)
        adm.release("b", 4)
        adm.admit("c", 25, block=False)         # alone: admitted
        assert adm.stats()["inflight_tasks"] == 25
        adm.release("c", 25)
        assert adm.stats()["inflight_tasks"] == 0


def test_server_task_budget_from_the_params():
    from parsec_tpu_torch.core.params import params
    saved = params.get("serve_max_inflight_tasks")
    params.set("serve_max_inflight_tasks", 4)
    try:
        server = RuntimeServer(nb_cores=1)
    finally:
        params.set("serve_max_inflight_tasks", saved)
    assert server._adm.max_inflight_tasks == 4
    slow, check = _chain_pool(nb=3, body_sleep=0.2)   # costs 3
    tk = server.submit(slow)
    assert server.stats()["admission"]["inflight_tasks"] == 3
    with pytest.raises(AdmissionRejected):
        server.submit(_chain_pool(nb=2)[0], block=False)   # 3 + 2 > 4
    tk.result(timeout=30)
    check()
    tk2 = server.submit(_chain_pool(nb=4)[0])
    tk2.result(timeout=30)
    server.drain(timeout=30)
    assert server.stats()["admission"]["inflight_tasks"] == 0


def _lowered_gemm_pool(seed: int, n: int = 16, nb: int = 4):
    import numpy as np

    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    return a, b, tiled_gemm_ptg(
        TiledMatrix.from_dense("A", a, nb, nb),
        TiledMatrix.from_dense("B", b, nb, nb),
        TiledMatrix.from_dense("C", np.zeros((n, n), np.float32), nb, nb))


def test_repeat_lowered_submissions_hit_the_cache():
    """Two submissions of one structure: the second reuses the first's
    step; each resolves to host tensors that match the JAX server's
    ``submit_lowered`` on the same inputs (fp32 sums of 16 products,
    ``rtol=1e-5, atol=1e-4``)."""
    import numpy as np
    import torch

    from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
    from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm
    from parsec_tpu.serve import RuntimeServer as JServer
    from parsec_tpu_torch.ptg.lowering import lowering_cache

    server = RuntimeServer(nb_cores=1)
    a, b, tp1 = _lowered_gemm_pool(seed=1)
    r1 = server.submit_lowered(tp1, device="cpu").result(timeout=120)
    h0 = lowering_cache.hits
    a2, b2, tp2 = _lowered_gemm_pool(seed=2)
    r2 = server.submit_lowered(tp2, device="cpu").result(timeout=120)
    assert lowering_cache.hits - h0 == 1
    server.drain(timeout=60)
    assert set(r1) == set(r2) == {"A", "B", "C"}
    assert all(v.device.type == "cpu" and isinstance(v, torch.Tensor)
               for v in r2.values())
    for (x, y, r) in ((a, b, r1), (a2, b2, r2)):
        np.testing.assert_allclose(r["C"].numpy(), x.astype(np.float64) @ y,
                                   rtol=1e-5, atol=1e-4)
    with JServer(nb_cores=1) as js:
        jr = js.submit_lowered(j_gemm(
            JTiled.from_dense("A", a2, 4, 4), JTiled.from_dense("B", b2, 4, 4),
            JTiled.from_dense("C", np.zeros((16, 16), np.float32), 4, 4))
        ).result(timeout=120)
    np.testing.assert_allclose(r2["C"].numpy(), np.asarray(jr["C"]),
                               rtol=1e-5, atol=1e-4)


def test_a_failing_lowered_submission_fails_its_ticket_alone():
    """``device="cuda"`` with no card raises inside the lowering: that
    ticket fails, and the server keeps serving."""
    import torch

    server = RuntimeServer(nb_cores=1)
    _, _, tp = _lowered_gemm_pool(seed=3)
    tk = server.submit_lowered(tp, device="meta" if torch.cuda.is_available()
                               else "cuda")
    with pytest.raises(Exception):
        tk.result(timeout=60)
    assert tk.state == "failed" and not server.stats()["poisoned"]
    _, _, tp2 = _lowered_gemm_pool(seed=4)
    assert "C" in server.submit_lowered(tp2, device="cpu").result(timeout=60)
    server.drain(timeout=30)


def test_a_server_over_a_callers_context():
    from parsec_tpu_torch.runtime import Context
    ctx = Context(nb_cores=1)
    ctx.start()
    server = RuntimeServer(context=ctx)
    assert server.context is ctx and isinstance(ctx.scheduler,
                                                FairScheduler)
    tp, check = _chain_pool(nb=3)
    assert server.submit(tp).result(timeout=30) is tp
    check()
    again = RuntimeServer(context=ctx)      # never a second shim
    assert again._fair is server._fair
    server.drain(timeout=30)
    with pytest.raises(ValueError):
        RuntimeServer(context=Context(nb_cores=0))

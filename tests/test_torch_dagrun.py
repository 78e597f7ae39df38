"""The port's compiled-DAG executor (``parsec_tpu_torch/runtime/dagrun.py``)
against the JAX package's (``parsec_tpu/runtime/dagrun.py``).

Mirrors ``tests/test_dagrun.py``.  Every pool is built twice from the
same description, once with each package's PTG builder, and
``compile_taskpool_dag`` must engage (with the same executor class) or
decline in the port exactly where it does in the JAX package.  Then both
run it and the results compare: traces as sets and in dependency order,
tile values exactly (integer increments in fp32), hook retry counts
exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import parsec_tpu.runtime.dagrun as jdagrun
from parsec_tpu import ptg as jptg
from parsec_tpu.core.params import params as jparams
from parsec_tpu.data.data import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.runtime import Context as JContext
from parsec_tpu.runtime.task import HOOK_RETURN_AGAIN as J_AGAIN
from parsec_tpu_torch import ptg
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.models.ep import ep_pool as port_ep_pool
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.runtime import dagrun
from parsec_tpu_torch.runtime.task import HOOK_RETURN_AGAIN

JAX = SimpleNamespace(
    name="jax", ptg=jptg, Context=JContext, dagrun=jdagrun, params=jparams,
    AGAIN=J_AGAIN, device="tpu", ep=lambda *a: jax_ep_pool(*a),
    coll=lambda: JDict("A", dtt=JTileType((2,), np.float32),
                       init_fn=lambda *k: np.zeros(2, np.float32)),
    value=lambda c: float(c.data_of(0).newest_copy().value[0]))
PORT = SimpleNamespace(
    name="port", ptg=ptg, Context=Context, dagrun=dagrun, params=params,
    AGAIN=HOOK_RETURN_AGAIN, device="cuda", ep=port_ep_pool,
    coll=lambda: DictCollection("A", dtt=TileType((2,), torch.float32),
                                init_fn=lambda *k: torch.zeros(2)),
    value=lambda c: float(c.data_of(0).newest_copy().value[0]))
BOTH = (JAX, PORT)


@pytest.fixture
def dynamic_only():
    saved = [P.params.get("runtime_dag_compile") for P in BOTH]
    for P in BOTH:
        P.params.set("runtime_dag_compile", False)
    yield
    for P, v in zip(BOTH, saved):
        P.params.set("runtime_dag_compile", v)


def jax_ep_pool(nt, depth, body=None):
    """The JAX package's EP pool, built as the port's
    ``models/ep.py:ep_pool`` builds it (``microbench.py``'s shape with a
    ``body(d, n)``)."""
    p = jptg.PTGBuilder("ep", NT=nt, DEPTH=depth)
    t = p.task("EP", d=jptg.span(0, lambda g, l: g.DEPTH - 1),
               n=jptg.span(0, lambda g, l: g.NT - 1))
    f = t.flow("ctl", jptg.CTL)
    f.input(pred=("EP", "ctl", lambda g, l: {"d": l.d - 1, "n": l.n}),
            guard=lambda g, l: l.d > 0)
    f.output(succ=("EP", "ctl", lambda g, l: {"d": l.d + 1, "n": l.n}),
             guard=lambda g, l: l.d < g.DEPTH - 1)
    if body is None:
        t.body(lambda es, task, g, l: None)
    else:
        t.body(lambda es, task, g, l: body(l.d, l.n))
    return p


def ep_pool(P, NT=8, DEPTH=5, trace=None):
    body = None if trace is None else lambda d, n: trace.append((d, n))
    return P.ep(NT, DEPTH, body).build()


def chain_pool(P, coll, n=6):
    """RW chain over one tile: T(0) -> T(1) -> ... each adds 1."""
    p = P.ptg.PTGBuilder("chain", N=n, A=coll)
    t = p.task("T", i=P.ptg.span(0, lambda g, l: g.N - 1))
    f = t.flow("V", P.ptg.RW)
    f.input(data=("A", lambda g, l: (0,)), guard=lambda g, l: l.i == 0)
    f.input(pred=("T", "V", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "V", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.N - 1)
    f.output(data=("A", lambda g, l: (0,)),
             guard=lambda g, l: l.i == g.N - 1)

    @t.body
    def body(es, task, g, l):
        c = task.flow_data("V")
        c.value = c.value + 1

    return p.build()


def prio_pool(P, order=None):
    p = P.ptg.PTGBuilder("prio", N=4)
    t = p.task("T", i=P.ptg.span(0, lambda g, l: g.N - 1))
    t.flow("ctl", P.ptg.CTL).output(
        succ=("U", "ctl", lambda g, l: {"i": l.i}))
    t.priority(lambda g, l: l.i)
    t.body(lambda es, task, g, l:
           order.append(("T", l.i)) if order is not None else None)
    u = p.task("U", i=P.ptg.span(0, lambda g, l: g.N - 1))
    u.flow("ctl", P.ptg.CTL).input(
        pred=("T", "ctl", lambda g, l: {"i": l.i}))
    u.body(lambda es, task, g, l:
           order.append(("U", l.i)) if order is not None else None)
    return p.build()


def tri_pool(P, seen):
    p = P.ptg.PTGBuilder("tri", N=5)
    t = p.task("T", i=P.ptg.span(0, lambda g, l: g.N - 1),
               j=P.ptg.span(0, lambda g, l: l.i))
    t.flow("ctl", P.ptg.CTL)
    t.body(lambda es, task, g, l: seen.append((l.i, l.j)))
    return p.build()


def device_pool(P):
    p = P.ptg.PTGBuilder("dev", N=2)
    t = p.task("T", i=P.ptg.span(0, lambda g, l: g.N - 1))
    t.flow("ctl", P.ptg.CTL)
    t.body(lambda es, task, g, l: None)
    t.body(device=P.device, dyld="nonexistent_kernel")
    return p.build()


def compiled_kind(P, tp, nb_ranks=1):
    """The executor ``compile_taskpool_dag`` returns for ``tp`` (its class
    name), or ``None`` where it declines."""
    ctx = P.Context(nb_cores=0)
    try:
        ctx.nb_ranks = nb_ranks
        dag = P.dagrun.compile_taskpool_dag(tp, ctx)
    finally:
        ctx.nb_ranks = 1
        ctx.fini()
    return None if dag is None else type(dag).__name__


def same_kind(build, nb_ranks=1):
    """Build with both packages; the port engages or declines exactly
    where the JAX package does.  Returns the kind."""
    kinds = [compiled_kind(P, build(P), nb_ranks) for P in BOTH]
    assert kinds[0] == kinds[1], kinds
    return kinds[1]


def run_pool(P, tp, nb_cores=0):
    ctx = P.Context(nb_cores=nb_cores)
    ctx.add_taskpool(tp)
    engaged = getattr(tp, "_compiled_dag", None) is not None
    ctx.wait(timeout=60)
    ctx.fini()
    return engaged


class TestVectorPath:
    def test_ep_compiles_vectorized(self):
        assert same_kind(ep_pool) == "VecCompiledDag"
        ctx = Context(nb_cores=0)
        assert dagrun.compile_taskpool_dag(ep_pool(PORT), ctx).ntasks == 40
        ctx.fini()

    @pytest.mark.parametrize("nb_cores", [0, 2])
    def test_ep_runs_each_task_once_in_dependency_order(self, nb_cores):
        traces = {}
        for P in BOTH:
            trace = traces[P.name] = []
            assert run_pool(P, ep_pool(P, trace=trace), nb_cores)
        assert sorted(traces["port"]) == sorted(traces["jax"]) == [
            (d, n) for d in range(5) for n in range(8)]
        pos = {t: i for i, t in enumerate(traces["port"])}
        for d in range(1, 5):
            for n in range(8):
                assert pos[(d - 1, n)] < pos[(d, n)]

    def test_matches_dynamic(self, dynamic_only):
        assert same_kind(ep_pool) is None
        trace = []
        assert not run_pool(PORT, ep_pool(PORT, trace=trace))
        assert sorted(trace) == [(d, n) for d in range(5) for n in range(8)]


class TestScalarPath:
    def test_data_chain_compiles_scalar(self):
        assert same_kind(lambda P: chain_pool(P, P.coll())) == "CompiledDag"

    @pytest.mark.parametrize("compiled", [True, False])
    def test_data_chain_result(self, compiled, dynamic_only):
        values = []
        for P in BOTH:
            P.params.set("runtime_dag_compile", compiled)
            coll = P.coll()
            assert run_pool(P, chain_pool(P, coll)) == compiled
            values.append(P.value(coll))
        assert values == [6.0, 6.0]

    def test_priority_pool_takes_scalar_path(self):
        assert same_kind(prio_pool) == "CompiledDag"
        orders = []
        for P in BOTH:
            order = []
            assert run_pool(P, prio_pool(P, order))
            orders.append(order)
        assert orders[0] == orders[1]   # the native heap's order

    def test_triangular_space_takes_scalar_path(self):
        assert same_kind(lambda P: tri_pool(P, [])) == "CompiledDag"
        seens = []
        for P in BOTH:
            seen = []
            assert run_pool(P, tri_pool(P, seen))
            seens.append(sorted(seen))
        assert seens[0] == seens[1] == [(i, j) for i in range(5)
                                        for j in range(i + 1)]


class TestHookProtocol:
    def test_again_is_retried(self):
        results = []
        for P in BOTH:
            attempts = {}
            p = P.ptg.PTGBuilder("again", N=6)
            t = p.task("T", i=P.ptg.span(0, lambda g, l: g.N - 1))
            t.flow("ctl", P.ptg.CTL)

            def body(es, task, g, l, attempts=attempts, AGAIN=P.AGAIN):
                k = attempts.get(l.i, 0)
                attempts[l.i] = k + 1
                return AGAIN if k < 2 else None

            t.body(body)
            assert run_pool(P, p.build())
            results.append(attempts)
        assert results[0] == results[1] == {i: 3 for i in range(6)}

    def test_again_with_batch_overflow(self):
        """A >1024-wide wavefront plus a carried AGAIN task in one pass
        must not overflow the fixed completion buffer."""
        ran = []
        for P in BOTH:
            state = {"again": True, "ran": 0}
            p = P.ptg.PTGBuilder("wide", N=2200)
            t = p.task("T", i=P.ptg.span(0, lambda g, l: g.N - 1))
            t.flow("ctl", P.ptg.CTL)

            def body(es, task, g, l, state=state, AGAIN=P.AGAIN):
                state["ran"] += 1
                if l.i == 0 and state["again"]:
                    state["again"] = False
                    return AGAIN
                return None

            t.body(body)
            assert run_pool(P, p.build())
            ran.append(state["ran"])
        assert ran == [2201, 2201]   # 2200 tasks + one retry

    @pytest.mark.parametrize("nb_cores", [0, 2])
    def test_wait_timeout_leaves_pool_resumable(self, nb_cores):
        import time as _t
        p = ptg.PTGBuilder("slow", N=30)
        t = p.task("T", i=ptg.span(0, lambda g, l: g.N - 1))
        f = t.flow("ctl", ptg.CTL)   # a chain: one task a wavefront, so
        f.input(pred=("T", "ctl", lambda g, l: {"i": l.i - 1}),
                guard=lambda g, l: l.i > 0)   # the batch deadline bites
        f.output(succ=("T", "ctl", lambda g, l: {"i": l.i + 1}),
                 guard=lambda g, l: l.i < g.N - 1)
        done = []

        @t.body
        def body(es, task, g, l):
            _t.sleep(0.01)
            done.append(l.i)

        tp = p.build()
        ctx = Context(nb_cores=nb_cores)
        ctx.add_taskpool(tp)
        assert tp._compiled_dag is not None
        with pytest.raises(TimeoutError):
            ctx.wait(timeout=0.05)
        if nb_cores == 0:        # the waiter alone drives: cut mid-way
            assert len(done) < 30
        ctx.wait(timeout=30)   # resumes and finishes
        ctx.fini()
        assert done == list(range(30))

    @pytest.mark.parametrize("nb_cores", [0, 2])
    def test_body_exception_does_not_wedge_fini(self, nb_cores):
        for P in BOTH:
            p = P.ptg.PTGBuilder("boom", N=3)
            t = p.task("T", i=P.ptg.span(0, lambda g, l: g.N - 1))
            t.flow("ctl", P.ptg.CTL)

            def body(es, task, g, l):
                raise ValueError("body failure")

            t.body(body)
            ctx = P.Context(nb_cores=nb_cores)
            ctx.add_taskpool(p.build())
            with pytest.raises((ValueError, RuntimeError)) as ei:
                ctx.wait(timeout=30)
            err = ei.value
            assert isinstance(err, ValueError) \
                or isinstance(err.__cause__, ValueError)
            ctx.fini()   # must not hang on the aborted pool


class TestFallbacks:
    def test_device_chore_falls_back_to_dynamic(self):
        assert same_kind(device_pool) is None

    def test_multirank_falls_back(self):
        assert same_kind(ep_pool, nb_ranks=2) is None

    def test_param_gate(self, dynamic_only):
        assert same_kind(ep_pool) is None

    def test_served_pool_falls_back(self):
        def served(P):
            tp = ep_pool(P)
            tp._serve_no_dag = True
            return tp
        assert same_kind(served) is None

    def test_no_native_tier_falls_back(self):
        saved = [P.params.get("runtime_native") for P in BOTH]
        try:
            for P in BOTH:
                P.params.set("runtime_native", False)
            assert same_kind(ep_pool) is None
        finally:
            for P, v in zip(BOTH, saved):
                P.params.set("runtime_native", v)

    def test_models_engage_alike(self):
        """The host tiled GEMM and Cholesky compile scalar in both
        packages; their device forms decline in both."""
        from parsec_tpu.data_dist import matrix as jm
        from parsec_tpu.models import cholesky as jchol
        from parsec_tpu.models import tiled_gemm as jgemm
        from parsec_tpu_torch.data_dist import matrix as pm
        from parsec_tpu_torch.models import cholesky as pchol
        from parsec_tpu_torch.models import tiled_gemm as pgemm

        a = np.random.default_rng(0).standard_normal((16, 16)).astype(
            np.float32)
        spd = pchol.make_spd(16, seed=0)
        mods = {"jax": (jm, jgemm, jchol, "cpu", "tpu"),
                "port": (pm, pgemm, pchol, "cpu", "cuda")}

        def gemm(P, dev_i):
            m, g, _, *devs = mods[P.name]
            mats = [m.TiledMatrix.from_dense(x, a, 8, 8) for x in "ABC"]
            return g.tiled_gemm_ptg(*mats, devices=devs[dev_i])

        def chol(P, dev_i):
            m, _, c, *devs = mods[P.name]
            return c.tiled_cholesky_ptg(
                m.SymTwoDimBlockCyclic.from_dense("S", spd, 8, 8),
                devices=devs[dev_i])

        assert same_kind(lambda P: gemm(P, 0)) == "CompiledDag"
        assert same_kind(lambda P: chol(P, 0)) == "CompiledDag"
        assert same_kind(lambda P: gemm(P, 1)) is None
        assert same_kind(lambda P: chol(P, 1)) is None

"""The runtime's round-out in the port against the JAX package: virtual
processes (``runtime/vpmap.py`` and ``Context``), thread binding,
``wait_taskpool`` and ``test(tp)``, the taskpool registry and
``compose``, the paranoid write-back checks, the futures, and the
remote-dep switches ``comm_coalesce`` and ``comm_wire_datatypes``.

Each is held against the JAX package on the same inputs: the vpmap
tables, the streams' partition, the pools' results and task counts, the
paranoid verdicts with their ``show_help`` keys, the futures' values and
callback orders, and, with the switches off, the values, task counts and
staged payload bytes of multi-rank runs.  Values compare exactly (host
bodies in float64, or the same float32 operations), but for the
float32 multi-rank stencil (``rtol=atol=1e-6``, as its own file holds).
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.core import future as jfut
from parsec_tpu.core.output import show_help_flush as j_show_help_flush
from parsec_tpu.core.params import params as jparams
from parsec_tpu.data.data import data_create as j_data_create
from parsec_tpu.data.datatype import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.models import cholesky as jchol
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm
from parsec_tpu.runtime import Context as JContext
from parsec_tpu.runtime import scheduling as jsched
from parsec_tpu.runtime import taskpool as jtaskpool
from parsec_tpu.runtime.vpmap import nb_vps as j_nb_vps
from parsec_tpu.runtime.vpmap import parse_vpmap as j_parse_vpmap
from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.core import future as pfut
from parsec_tpu_torch.core.output import show_help_flush
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data.data import data_create
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                               TiledMatrix)
from parsec_tpu_torch.models import cholesky as pchol
from parsec_tpu_torch.models.ep import ep_pool
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.runtime import (CompoundTaskpool, Context, compose,
                                      taskpool_lookup)
from parsec_tpu_torch.runtime import scheduling as psched
from parsec_tpu_torch.runtime.vpmap import nb_vps, parse_vpmap


@pytest.fixture
def both_params():
    """An override of a param in both packages, each param's value and
    source restored at exit (``overrides``: a restored param reads as
    untouched, so it does not join a report's knob vector)."""
    with contextlib.ExitStack() as stack:
        def set_(name, value):
            for reg in (params, jparams):
                stack.enter_context(reg.overrides({name: value}))
        yield set_


@pytest.fixture
def port_param():
    """An override of one of the port's params, restored as
    :func:`both_params` restores."""
    with contextlib.ExitStack() as stack:
        def set_(name, value):
            stack.enter_context(params.overrides({name: value}))
        yield set_


# ---------------------------------------------------------------------------
# virtual processes
# ---------------------------------------------------------------------------

SPECS = [("", 4, 1), ("", 4, 2), ("", 5, 3), ("flat", 4, 2),
         ("rr:2", 5, 1), ("rr:3", 7, 9), ("rr:0", 3, 1),
         ("list:1,3", 4, 1), ("list:2,2,2", 4, 1), ("list:1", 3, 1),
         ("list:3,1", 6, 1), (" rr:2 ", 4, 1)]


@pytest.mark.parametrize("spec,nstreams,nvp", SPECS)
def test_parse_vpmap_equals_the_jax_one(spec, nstreams, nvp):
    got = parse_vpmap(spec, nstreams, nvp)
    assert got == j_parse_vpmap(spec, nstreams, nvp)
    assert nb_vps(got) == j_nb_vps(got)


def test_a_file_spec_equals_the_jax_one(tmp_path):
    path = tmp_path / "vpmap.txt"
    path.write_text("# two virtual processes\n2\n\n3\n")
    spec = f"file:{path}"
    for n in (3, 5, 8):
        assert parse_vpmap(spec, n, 1) == j_parse_vpmap(spec, n, 1)
    assert parse_vpmap(spec, 5, 1) == [0, 0, 1, 1, 1]


@pytest.mark.parametrize("spec", ["bad", "list:0,1", "list:", "rr:x"])
def test_a_bad_spec_raises_like_the_jax_one(spec):
    for parse in (parse_vpmap, j_parse_vpmap):
        with pytest.raises(ValueError):
            parse(spec, 4, 1)


@pytest.mark.parametrize("spec,nvp", [("list:1,3", 1), ("", 2),
                                      ("rr:3", 1), ("flat", 4)])
def test_a_context_partitions_its_streams_like_the_jax_one(both_params,
                                                          spec, nvp):
    both_params("runtime_vpmap", spec)
    both_params("runtime_nb_vp", nvp)
    shapes = []
    for cls in (Context, JContext):
        ctx = cls(nb_cores=4)
        try:
            shapes.append([[es.th_id for es in vp.execution_streams]
                           for vp in ctx.virtual_processes])
            assert ctx._submit_es.virtual_process \
                is ctx.virtual_processes[0]
        finally:
            ctx.fini()
    assert shapes[0] == shapes[1]


def test_two_virtual_processes_steal_nothing_from_each_other(port_param):
    """The EP pool on 4 workers in 2 virtual processes, on the dynamic
    scheduler: every task selected on the virtual process it was
    scheduled on, and every task ran."""
    port_param("runtime_nb_vp", 2)
    port_param("runtime_dag_compile", False)
    done = []
    ctx = Context(nb_cores=4)
    try:
        assert len(ctx.virtual_processes) == 2
        ctx.add_taskpool(ep_pool(8, 12, lambda d, n: done.append((d, n)))
                         .build())
        ctx.wait(timeout=60)
        st = ctx.vp_stats()
    finally:
        ctx.fini()
    assert st["cross_vp"] == 0 and st["nb_vp"] == 2
    assert sum(st["tasks_by_vp"]) > 0
    assert sorted(done) == [(d, n) for d in range(12) for n in range(8)]


def test_one_virtual_process_counts_nothing():
    ctx = Context(nb_cores=2)
    try:
        ctx.add_taskpool(ep_pool(2, 3).build())
        ctx.wait(timeout=60)
        assert ctx.vp_stats() == {"nb_vp": 1, "tasks_by_vp": [0],
                                  "cross_vp": 0}
    finally:
        ctx.fini()


def test_bound_workers_run(both_params, monkeypatch):
    """Under ``runtime_bind_threads`` each worker pins itself to a core
    of the process's mask, round-robin, and the pool runs."""
    import os
    both_params("runtime_bind_threads", True)
    pinned = []
    if hasattr(os, "sched_setaffinity"):
        monkeypatch.setattr(os, "sched_setaffinity",
                            lambda pid, cores: pinned.append(sorted(cores)))
    a = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    A = TiledMatrix.from_dense("A", a, 4, 4)
    B = TiledMatrix.from_dense("B", a, 4, 4)
    C = TiledMatrix("C", 8, 8, 4, 4)
    ctx = Context(nb_cores=3)
    try:
        ctx.add_taskpool(tiled_gemm_ptg(A, B, C, devices="cpu"))
        ctx.wait(timeout=60)
    finally:
        ctx.fini()
    np.testing.assert_allclose(C.to_dense(), a.astype(np.float64) @ a,
                               atol=1e-5)
    if hasattr(os, "sched_getaffinity"):
        allowed = sorted(os.sched_getaffinity(0))
        assert sorted(pinned) == sorted(
            [[allowed[i % len(allowed)]] for i in range(3)])


# ---------------------------------------------------------------------------
# wait_taskpool, test(tp), the registry and compose
# ---------------------------------------------------------------------------

def _gemm_pair(mod, tiled, gemm, devices_kw):
    rng = np.random.default_rng(9)
    a = rng.standard_normal((12, 12)).astype(np.float32)
    b = rng.standard_normal((12, 12)).astype(np.float32)
    A, B = tiled.from_dense("A", a, 4, 4), tiled.from_dense("B", b, 4, 4)
    C1, C2 = tiled("C1", 12, 12, 4, 4), tiled("C2", 12, 12, 4, 4)
    return (a, b, C1, C2, gemm(A, B, C1, **devices_kw),
            gemm(A, B, C2, **devices_kw))


def test_wait_taskpool_and_test_match_the_jax_context():
    out = []
    for cls, tiled, gemm in ((Context, TiledMatrix, tiled_gemm_ptg),
                             (JContext, JTiled, j_gemm)):
        a, b, C1, C2, tp1, tp2 = _gemm_pair(None, tiled, gemm,
                                            {"devices": "cpu"})
        ctx = cls(nb_cores=2)
        try:
            ctx.start()
            assert not ctx.test(tp1)
            ctx.add_taskpool(tp1)
            ctx.add_taskpool(tp2)
            ctx.wait_taskpool(tp1, timeout=60)
            assert ctx.test(tp1) and tp1.test()
            ctx.wait_taskpool(tp2, timeout=60)
            assert ctx.test(tp2) and ctx.test()
        finally:
            ctx.fini()
        out.append((C1.to_dense(), C2.to_dense()))
    for g, w in zip(out[0], out[1]):
        np.testing.assert_array_equal(g, w)


def test_a_wait_taskpool_deadline_raises_and_names_the_pool(port_param):
    """A pool whose one task holds its worker: ``wait_taskpool`` raises
    at its deadline, and waits it out once the task is let go."""
    from parsec_tpu_torch.runtime import ContextWaitTimeout
    port_param("runtime_dag_compile", False)    # the worker runs it
    port_param("prof_stall_dump", False)
    gate = threading.Event()
    p = ptg.PTGBuilder("stuck")
    t = p.task("T", i=ptg.span(0, 0))
    t.body(lambda es, task, g, l: (gate.wait(5), None)[1])
    tp = p.build()
    ctx = Context(nb_cores=1)
    try:
        ctx.start()
        ctx.add_taskpool(tp)
        with pytest.raises(ContextWaitTimeout):
            ctx.wait_taskpool(tp, timeout=0.2)
        gate.set()
        ctx.wait_taskpool(tp, timeout=30)
    finally:
        gate.set()
        ctx.fini()


def test_the_registry_holds_live_pools_like_the_jax_one():
    got = []
    for cls, lookup, gemm, tiled in (
            (Context, taskpool_lookup, tiled_gemm_ptg, TiledMatrix),
            (JContext, jtaskpool.taskpool_lookup, j_gemm, JTiled)):
        *_, tp, _ = _gemm_pair(None, tiled, gemm, {"devices": "cpu"})
        live = lookup(tp.taskpool_id) is tp
        ctx = cls(nb_cores=0)
        try:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
        finally:
            ctx.fini()
        got.append((live, lookup(tp.taskpool_id)))
    assert got == [(True, None), (True, None)]


@pytest.mark.parametrize("nb_cores", [0, 2])
def test_compose_runs_its_members_in_order_like_the_jax_one(nb_cores):
    """C1 = A·B, then C2 = C1·B: the second member reads the first's
    result, so order is visible in the values."""
    out = []
    for cls, tiled, gemm, comp in (
            (Context, TiledMatrix, tiled_gemm_ptg, compose),
            (JContext, JTiled, j_gemm, jtaskpool.compose)):
        rng = np.random.default_rng(4)
        a = rng.standard_normal((8, 8)).astype(np.float32)
        b = rng.standard_normal((8, 8)).astype(np.float32)
        A, B = tiled.from_dense("A", a, 4, 4), tiled.from_dense("B", b, 4, 4)
        C1, C2 = tiled("C1", 8, 8, 4, 4), tiled("C2", 8, 8, 4, 4)
        first = gemm(A, B, C1, devices="cpu")
        second = gemm(C1, B, C2, devices="cpu")
        c = comp(first, second)
        assert c.members == [first, second]
        ctx = cls(nb_cores=nb_cores)
        try:
            ctx.add_taskpool(c)
            ctx.wait_taskpool(c, timeout=60)
            assert first.test() and second.test() and c.test()
        finally:
            ctx.fini()
        out.append(C2.to_dense())
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_allclose(out[0], (a.astype(np.float64) @ b) @ b,
                               rtol=1e-4, atol=1e-4)
    assert isinstance(compose(), CompoundTaskpool)


def test_an_empty_compose_completes():
    ctx = Context(nb_cores=0)
    try:
        c = compose()
        ctx.add_taskpool(c)
        ctx.wait(timeout=10)
        assert c.test()
    finally:
        ctx.fini()


# ---------------------------------------------------------------------------
# the paranoid checks: tests/test_coverage_roundout.py's four cases
# ---------------------------------------------------------------------------

def _coll(mod_dict, tiletype, name):
    return mod_dict(name, dtt=tiletype((1,)),
                    init_fn=lambda *k: np.zeros(1, np.float32))


def _paranoid_cases():
    return (("port", psched.apply_writeback_to_home, data_create,
             lambda n: _coll(DictCollection, TileType, n), show_help_flush,
             lambda: torch.ones(1)),
            ("jax", jsched.apply_writeback_to_home, j_data_create,
             lambda n: _coll(JDict, JTileType, n), j_show_help_flush,
             lambda: np.ones(1, np.float32)))


def test_unordered_writebacks_are_caught_like_the_jax_package(both_params):
    both_params("debug_paranoid", True)
    for _, wb, mk, coll, _flush, one in _paranoid_cases():
        P = coll("P")
        c1 = mk(one(), key="a").get_copy(0)
        c2 = mk(one(), key="b").get_copy(0)
        c1.version, c2.version = 3, 2
        wb(P, (0,), c1, owner=7)
        with pytest.raises(AssertionError, match="unordered writebacks"):
            wb(P, (0,), c2, owner=7)


def test_equal_version_writebacks_warn_like_the_jax_package(both_params):
    both_params("debug_paranoid", True)
    for _, wb, mk, coll, flush, one in _paranoid_cases():
        R = coll("R")
        flush()
        wb(R, (0,), mk(one(), key="e1").get_copy(0), owner=8)
        wb(R, (0,), mk(one(), key="e2").get_copy(0), owner=8)
        counts = flush()
        assert counts.get(("paranoid", "equal-version-writeback"), 0) >= 1


def test_ordered_writebacks_pass_like_the_jax_package(both_params):
    both_params("debug_paranoid", True)
    for _, wb, mk, coll, flush, one in _paranoid_cases():
        Q = coll("Q")
        flush()
        for v in (1, 2, 3):
            c = mk(one(), key=f"v{v}").get_copy(0)
            c.version = v
            wb(Q, (0,), c, owner=9)
        assert flush() == {}
        # another pool's write-back is not held against this one's
        c = mk(one(), key="other").get_copy(0)
        c.version = 1
        wb(Q, (0,), c, owner=10)


def test_a_normal_run_is_clean_under_paranoid(both_params):
    """The dynamic Cholesky under ``debug_paranoid`` on both packages:
    no finding, the same factor."""
    both_params("debug_paranoid", True)
    both_params("runtime_dag_compile", False)
    a = pchol.make_spd(32, seed=3)
    show_help_flush()
    j_show_help_flush()
    A = SymTwoDimBlockCyclic.from_dense("A", a.copy(), 8, 8)
    ctx = Context(nb_cores=2)
    try:
        ctx.add_taskpool(pchol.tiled_cholesky_ptg(A, devices="cpu"))
        ctx.wait(timeout=60)
    finally:
        ctx.fini()
    from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
    jA = JSym.from_dense("A", a.copy(), 8, 8)
    jctx = JContext(nb_cores=2)
    try:
        jctx.add_taskpool(jchol.tiled_cholesky_ptg(jA, devices="cpu"))
        jctx.wait(timeout=60)
    finally:
        jctx.fini()
    assert show_help_flush() == {} and j_show_help_flush() == {}
    np.testing.assert_allclose(np.tril(A.to_dense()), np.tril(jA.to_dense()),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# futures
# ---------------------------------------------------------------------------

def _future_trace(f):
    log = []
    a = f.Future()
    a.on_ready(lambda x: log.append(("first", x.get())))
    a.on_ready(lambda x: log.append(("second", x.get())))
    st0 = a.status
    a.set(5)
    a.on_ready(lambda x: log.append(("late", x.get())))
    with pytest.raises(RuntimeError):
        a.set(6)
    cf = f.CountableFuture(3, combine=lambda x, y: x + y)
    cf.on_ready(lambda x: log.append(("count", x.get())))
    for v in (1, 2, 4):
        assert not cf.is_ready()
        cf.contribute(v)
    with pytest.raises(RuntimeError):
        cf.contribute(1)
    nofold = f.CountableFuture(2)
    nofold.contribute("x")
    nofold.contribute("y")
    with pytest.raises(ValueError):
        f.CountableFuture(0)
    calls = []
    root = f.DataCopyFuture(convert=lambda _: calls.append("root") or 10)
    mid = f.DataCopyFuture(parent=root,
                           convert=lambda v: calls.append("mid") or v * 2)
    leaf = f.DataCopyFuture(parent=mid,
                            convert=lambda v: calls.append("leaf") or v + 1)
    got = leaf.get(timeout=5)
    again = (leaf.get(timeout=5), mid.get(timeout=5))
    blocked = f.DataCopyFuture(parent=f.Future(), convert=lambda v: v)
    with pytest.raises(TimeoutError):
        blocked.get(timeout=0.05)
    return (log, st0, a.status, cf.get(), nofold.get(), got, again, calls,
            bool(leaf.status & f.FUTURE_STATUS_TRIGGERED))


def test_futures_behave_like_the_jax_futures():
    assert _future_trace(pfut) == _future_trace(jfut)
    log, *_ = _future_trace(pfut)
    assert log == [("first", 5), ("second", 5), ("late", 5), ("count", 7)]


# ---------------------------------------------------------------------------
# the remote-dep switches
# ---------------------------------------------------------------------------

def _chol_body(port):
    def body(ctx, rank, nranks):
        a = pchol.make_spd(64, seed=2)
        if port:
            A = SymTwoDimBlockCyclic.from_dense("A", a.copy(), 16, 16, P=2,
                                                Q=2, myrank=rank)
            tp = pchol.tiled_cholesky_ptg(A, devices="cpu")
        else:
            from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as J
            A = J.from_dense("A", a.copy(), 16, 16, P=2, Q=2, myrank=rank)
            tp = jchol.tiled_cholesky_ptg(A, devices="cpu")
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        eng = ctx.comm_engine
        return (np.asarray(A.to_dense()), tp.nb_local_tasks(),
                eng.payload_bytes_staged, eng.payload_bytes_received)
    return body


@pytest.mark.parametrize("coalesce", [True, False])
def test_coalescing_off_gives_the_jax_runs_values_and_bytes(both_params,
                                                            coalesce):
    both_params("comm_coalesce", coalesce)
    both_params("termdet", "fourcounter")
    got = run_multirank(4, _chol_body(True), timeout=180)
    want = j_run_multirank(4, _chol_body(False), timeout=180)
    np.testing.assert_allclose(sum(r[0] for r in got),
                               sum(r[0] for r in want), rtol=1e-5,
                               atol=1e-6)
    assert [r[1] for r in got] == [r[1] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    assert [r[3] for r in got] == [r[3] for r in want]


def test_wire_views_off_ship_whole_tiles_like_the_jax_run(both_params):
    """The 2-D stencil on a 2 x 2 grid with ``comm_wire_datatypes`` off
    in both packages: whole tiles cross, the staged bytes of each rank
    equal the JAX run's and exceed those with wire views on."""
    from test_torch_stencil_multirank import _assemble_2d, _body_2d
    runs = {}
    for on in (True, False):
        both_params("comm_wire_datatypes", on)
        port = run_multirank(4, _body_2d(True), timeout=180)
        jax = j_run_multirank(4, _body_2d(False), timeout=180)
        np.testing.assert_allclose(_assemble_2d(port), _assemble_2d(jax),
                                   rtol=1e-6, atol=1e-6)
        assert [r[1] for r in port] == [r[1] for r in jax]
        assert [r[2] for r in port] == [r[2] for r in jax]
        runs[on] = sum(r[2] for r in port)
    assert runs[False] > runs[True] > 0

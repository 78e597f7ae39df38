"""PINS, the counters, the binary trace and the task profiler in the port.

The same small GEMM and Cholesky pools run through both packages at
``nb_cores=0`` under the LFQ scheduler, on the dynamic scheduler and on
the compiled DAG, with one callback on every event the port fires: the
counts of (event, task class) must be equal (``TASKPOOL_FINI`` apart:
the JAX package declares it and fires it nowhere; the port fires it once
a pool).  Then: disabled slots are ``None`` and the table keeps its
identity; a recorder retargets every slot; the ``pins`` param opens a
module for every context and the last context closes it; the SDE task
counters equal the pool's; the task profiler's file, read back by the
JAX package's reader, gives the port reader's rows with one ``task_exec``
span a task; the device module's stage-in events sum to its ``bytes_in``
and every task it runs has one EXEC span; and a pool with one
inconsistent successor fails at its first executed task under the
iterators checker, in both packages.

Each test reads the PINS slots bare: the always-on flight recorder,
which every context installs, is set aside for the test
(``prof_flightrec_size`` 0) and restored after it.
"""

import collections

import numpy as np
import pytest

import parsec_tpu.prof.pins as jpins
import parsec_tpu.runtime.dagrun  # noqa: F401 — registers its params
from parsec_tpu.core.params import params as jparams
from parsec_tpu.core.mca import repository as jrepository
from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.models import cholesky as jchol
from parsec_tpu.models import tiled_gemm as jgemm
from parsec_tpu.prof.iterators_checker import \
    IteratorsCheckerError as JIterError
from parsec_tpu.prof.profiling import Profiling as JProfiling
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch import ptg
from parsec_tpu_torch.core.mca import repository
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic as PSym
from parsec_tpu_torch.data_dist.matrix import TiledMatrix as PTiled
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models import cholesky as pchol
from parsec_tpu_torch.models import tiled_gemm as pgemm
from parsec_tpu_torch.prof import (Profiling, flight_recorder, pins,
                                   release_pins_modules, sde, trace_state)
from parsec_tpu_torch.prof.counters import TASKS_ENABLED, TASKS_RETIRED
from parsec_tpu_torch.prof.iterators_checker import IteratorsCheckerError
from parsec_tpu_torch.prof.pins import PinsEvent
from parsec_tpu_torch.runtime import Context as PContext

N, NB = 32, 8
NTASKS = {"gemm": 64, "cholesky": 20}


@pytest.fixture(autouse=True)
def _no_flight_recorder():
    saved_size = params.get("prof_flightrec_size")
    saved = flight_recorder.recorder
    flight_recorder.uninstall()
    params.set("prof_flightrec_size", 0)
    yield
    params.set("prof_flightrec_size", saved_size)
    if saved is not None:
        flight_recorder.recorder = saved
        pins.recorder = saved.note


@pytest.fixture
def port_param():
    saved = {}

    def set_(name, value):
        saved.setdefault(name, params.get(name))
        params.set(name, value)

    yield set_
    for name, value in saved.items():
        params.set(name, value)


@pytest.fixture
def traced():
    """The task profiler on a fresh trace, off and cleared after."""
    trace_state.fini()
    saved = params.get("pins")
    params.set("pins", "task_profiler")
    yield trace_state
    params.set("pins", saved)
    trace_state.fini()


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


def _pool(pkg, kind, devices="cpu"):
    tiled, sym, gemm, chol = ((JTiled, JSym, jgemm, jchol) if pkg == "jax"
                              else (PTiled, PSym, pgemm, pchol))
    if kind == "gemm":
        rng = np.random.RandomState(1)
        a = rng.randn(N, N).astype(np.float32)
        b = rng.randn(N, N).astype(np.float32)
        C = tiled("C", N, N, NB, NB)
        return gemm.tiled_gemm_ptg(tiled.from_dense("A", a, NB, NB),
                                   tiled.from_dense("B", b, NB, NB), C,
                                   devices=devices), C, a @ b
    a = pchol.make_spd(N, seed=1)
    A = sym.from_dense("A", a, NB, NB)
    return chol.tiled_cholesky_ptg(A, devices=devices), A, \
        np.linalg.cholesky(a.astype(np.float64))


def _record(pins_mod):
    """Count (event, task class) over every event the port fires."""
    counts = collections.Counter()
    cbs = []
    for ev in PinsEvent:
        e = pins_mod.PinsEvent(int(ev))

        def cb(es, payload, _e=int(ev)):
            for p in payload if isinstance(payload, list) else [payload]:
                if isinstance(p, tuple) and p and hasattr(p[0], "task_class"):
                    p = p[0]            # SELECT_STEAL: (task, distance)
                # a task's class by name; a pool's or a count's: None
                tc = getattr(getattr(p, "task_class", None), "name", None)
                counts[(_e, tc)] += 1

        pins_mod.register(e, cb)
        cbs.append((e, cb))
    return counts, cbs


def _run(pkg, kind, compiled):
    pins_mod, prm, ctx_cls = ((jpins, jparams, JContext) if pkg == "jax"
                              else (pins, params, PContext))
    saved = prm.get("runtime_dag_compile")
    prm.set("runtime_dag_compile", compiled)
    tp, out, want = _pool(pkg, kind)
    counts, cbs = _record(pins_mod)
    try:
        ctx = ctx_cls(nb_cores=0)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        ctx.fini()
    finally:
        for e, cb in cbs:
            pins_mod.unregister(e, cb)
        prm.set("runtime_dag_compile", saved)
    got = out.to_dense()
    np.testing.assert_allclose(np.tril(got) if kind == "cholesky" else got,
                               want, rtol=1e-3, atol=1e-3)
    return counts


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("kind", ["gemm", "cholesky"])
def test_event_counts_match_the_jax_package(kind, compiled):
    jc = _run("jax", kind, compiled)
    pc = _run("port", kind, compiled)
    fini = int(PinsEvent.TASKPOOL_FINI)
    assert pc.pop((fini, None)) == 1 and (fini, None) not in jc
    assert pc == jc
    execs = sum(v for (e, _c), v in pc.items()
                if e == int(PinsEvent.EXEC_BEGIN))
    assert execs == NTASKS[kind]
    if compiled:     # the batch spans fire, the scheduler's events do not
        assert pc[(int(PinsEvent.DAG_FETCH_BEGIN), None)] > 0
        assert (int(PinsEvent.SCHEDULE_BEGIN), "GEMM") not in pc
    else:
        assert pc[(int(PinsEvent.COMPLETE_EXEC_END), "GEMM")] \
            == (NTASKS["gemm"] if kind == "gemm" else 4)


def test_disabled_slots_are_none_and_the_table_keeps_its_identity():
    table = pins.hooks
    assert all(h is None for h in table) and not pins.enabled
    assert len(table) == max(int(e) for e in PinsEvent) + 1

    def cb(es, payload):
        pass

    pins.register(PinsEvent.EXEC_BEGIN, cb)
    try:
        assert pins.hooks is table and pins.enabled
        assert table[int(PinsEvent.EXEC_BEGIN)] is not None
        assert sum(h is not None for h in table) == 1
    finally:
        pins.unregister(PinsEvent.EXEC_BEGIN, cb)
    assert all(h is None for h in table) and not pins.enabled


def test_a_recorder_retargets_every_slot():
    seen = []
    table = pins.hooks
    pins.recorder = lambda ev, payload: seen.append((ev, payload))
    try:
        assert pins.recorder is not None and pins.hooks is table
        fired = [i for i, h in enumerate(table) if h is not None]
        assert fired == sorted(int(e) for e in PinsEvent)
        assert not pins.enabled      # the recorder leaves the gate off
        for e in PinsEvent:
            pins.fire(e, None, int(e))
        assert seen == [(e, int(e)) for e in PinsEvent]
    finally:
        pins.recorder = None
    assert all(h is None for h in table)


def test_the_pins_param_holds_modules_for_every_context(port_param):
    port_param("pins", "sde")
    a = PContext(nb_cores=0)
    b = PContext(nb_cores=0)
    assert pins.hooks[int(PinsEvent.COMPLETE_EXEC_END)] is not None
    a.fini()
    assert pins.hooks[int(PinsEvent.COMPLETE_EXEC_END)] is not None
    b.fini()
    b.abort()                  # a second teardown releases nothing more
    assert all(h is None for h in pins.hooks)
    release_pins_modules(("sde",))          # an unheld name is a no-op
    port_param("pins", "no_such_module")
    with pytest.raises(LookupError, match="no_such_module"):
        PContext(nb_cores=0)
    assert all(h is None for h in pins.hooks)


@pytest.mark.parametrize("kind", ["gemm", "cholesky"])
def test_sde_task_counts_equal_the_pools(port_param, kind):
    port_param("pins", "sde")
    port_param("runtime_dag_compile", False)
    sde.reset()
    tp, _out, _want = _pool("port", kind)
    ctx = PContext(nb_cores=0)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    ctx.fini()
    snap = sde.snapshot()
    assert snap[TASKS_RETIRED] == snap[TASKS_ENABLED] == NTASKS[kind]
    assert repository.find("pins", "sde") is not None


def test_the_jax_reader_loads_the_ports_trace(tmp_path, traced, port_param):
    port_param("runtime_dag_compile", False)
    tp, _out, _want = _pool("port", "gemm")
    ctx = PContext(nb_cores=0)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    ctx.fini()
    assert traced.validate() == []
    path = str(tmp_path / "port.ptpb")
    traced.dump(path)
    theirs = JProfiling.load(path)
    ours = Profiling.load(path)
    assert theirs.validate() == [] and ours.validate() == []
    assert theirs.to_records() == ours.to_records() == traced.to_records()
    execs = [r for r in ours.to_records() if r["name"] == "task_exec"]
    assert len(execs) == NTASKS["gemm"]
    assert {r["info.task"] for r in execs} == {"GEMM"}
    assert len({r["event_id"] for r in execs}) == NTASKS["gemm"]
    assert all(r["duration_ns"] >= 0 for r in execs)
    names = {r["name"] for r in ours.to_records()}
    assert {"task_exec", "task_prepare_input", "task_release_deps",
            "task_complete"} <= names
    trace = ours.to_chrome_trace(str(tmp_path / "t.json"))
    assert len([e for e in trace["traceEvents"] if e["ph"] == "X"]) \
        == len(ours.to_records())


def test_the_ports_reader_loads_the_jax_packages_trace(tmp_path):
    """The other way round: the JAX task profiler's file, the port's
    reader."""
    from parsec_tpu.prof.profiling import profiling as jtrace
    jtrace.fini()
    jtrace.init()
    comp = jrepository.find("pins", "task_profiler")
    mod = comp.open()
    try:
        _run("jax", "gemm", compiled=True)
    finally:
        comp.close(mod)
    path = str(tmp_path / "jax.ptpb")
    jtrace.dump(path)
    jtrace.fini()
    assert Profiling.load(path).to_records() \
        == JProfiling.load(path).to_records()
    execs = [r for r in Profiling.load(path).to_records()
             if r["name"] == "task_exec"]
    assert len(execs) == NTASKS["gemm"]


def test_the_compiled_dag_is_traced(traced):
    tp, _out, _want = _pool("port", "gemm")
    ctx = PContext(nb_cores=0)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    ctx.fini()
    recs = traced.to_records()
    assert len([r for r in recs if r["name"] == "task_exec"]) == 64
    assert [r for r in recs if r["name"] == "dag_fetch"]
    done = [r for r in recs if r["name"] == "dag_complete"]
    assert sum(r["info.batch"] for r in done) == 64


def test_the_device_module_fires_on_the_host(cpu_cuda_device, traced,
                                             port_param):
    """The dynamic GEMM on the device module around the host, as on the
    card: every task has one EXEC span (flooded tasks too), the SDE
    counters see every task retire, the stage-in payloads sum to
    ``bytes_in``, and each batch has its begin and end."""
    port_param("pins", "task_profiler,sde")
    sde.reset()
    staged, batches, enq = [], [], []

    def on_stage(es, nb):
        staged.append(nb)

    def on_batch(es, n):
        batches.append(n)

    def on_enq(es, t):
        enq.append(t)

    regs = [(PinsEvent.DEVICE_STAGE_IN, on_stage),
            (PinsEvent.DEVICE_BATCH_END, on_batch),
            (PinsEvent.DEVICE_ENQUEUE, on_enq)]
    for e, cb in regs:
        pins.register(e, cb)
    try:
        tp, out, want = _pool("port", "gemm", devices="cuda")
        ctx = PContext(nb_cores=0)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        ctx.fini()
    finally:
        for e, cb in regs:
            pins.unregister(e, cb)
    np.testing.assert_allclose(out.to_dense(), want, rtol=1e-4, atol=1e-4)
    dev = cpu_cuda_device
    assert dev.executed_tasks == 64
    assert sum(staged) == dev.bytes_in > 0
    assert sum(batches) == 64 and 0 < len(enq) <= 64
    recs = traced.to_records()
    execs = [r for r in recs if r["name"] == "task_exec"]
    assert len(execs) == 64 and len({r["event_id"] for r in execs}) == 64
    assert len([r for r in recs if r["name"] == "task_complete"]) == 64
    assert sde.get(TASKS_RETIRED) == 64


def _inconsistent_chain(p):
    """T(i), i < 4: each T(i) sends V to T(i+1) (the last one's arrow
    leaves the space), whose input from T was dropped: every task's
    successor arrow is inconsistent."""
    b = p.PTGBuilder("chain", NB=4)
    t = b.task("T", i=p.span(0, lambda g, l: g.NB - 1))
    f = t.flow("V", p.RW)
    f.input(null=True)
    f.output(succ=("T", "V", lambda g, l: {"i": l.i + 1}))
    ran = []
    t.body(lambda es, task, g, l: ran.append(l.i))
    return b.build(), ran


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_the_iterators_checker_fails_the_first_task(pkg, port_param):
    import parsec_tpu.ptg as jptg
    if pkg == "jax":
        mod, prm, ctx_cls, err = jptg, jparams, JContext, JIterError
        comp = jrepository.find("pins", "iterators_checker")
    else:
        mod, prm, ctx_cls, err = ptg, params, PContext, IteratorsCheckerError
        comp = repository.find("pins", "iterators_checker")
    saved = prm.get("runtime_dag_compile")
    prm.set("runtime_dag_compile", False)
    tp, ran = _inconsistent_chain(mod)
    handle = comp.open()
    ctx = ctx_cls(nb_cores=0)
    try:
        ctx.add_taskpool(tp)
        with pytest.raises((err, RuntimeError)) as ei:
            ctx.wait(timeout=30)
        cause = ei.value if isinstance(ei.value, err) \
            else ei.value.__cause__
        assert isinstance(cause, err), ei.value
        assert "no matching active input dep" in str(cause)
        assert len(ran) == 1          # the first executed task failed
    finally:
        comp.close(handle)
        prm.set("runtime_dag_compile", saved)
        ctx.abort()

"""The port's always-on flight recorder, stall dump and run reports.

The cases of the JAX package's ``tests/test_flight_recorder.py`` on the
port's copy: ring wrap-around, per-event counts and payload sums past
it, empty selects and fetches as liveness ticks, a recycled thread name
keeping its counts, the allocation-free disabled slots, a typed
``ContextWaitTimeout`` after exactly one stall dump (stderr and the
``flightrec-<rank>.json`` artifact in a temporary directory), the
bounded ``fini``, the switch that turns the dump off, the metrics
snapshotter, the unified Chrome export read back, and a JSON-compact
``runtime_report``.  Then the port's own: ``runtime_report()``'s keys
equal the JAX package's on the same served run, after each package's
commcheck analysed the same four-rank broadcast (so both carry the
``comm_pattern`` block, whose entry for it is equal); four rank threads of one
process count each event once; the device module's ``debug_state`` and
the schedulers' ``queue_depths`` answer while their locks are held.
"""

import json
import threading
import time
import tracemalloc

import pytest

import parsec_tpu.prof.pins as jpins
import parsec_tpu.runtime.dagrun  # noqa: F401 — registers its params
from parsec_tpu.prof import flight_recorder as jflight
from parsec_tpu.prof import runtime_report as jruntime_report
from parsec_tpu.prof import spans as jspans
from parsec_tpu.serve import RuntimeServer as JRuntimeServer
from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.core.mca import repository
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.prof import (export_run_report, flight_recorder, pins,
                                   runtime_report, spans, trace_state)
from parsec_tpu_torch.prof.pins import PinsEvent
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.runtime.context import ContextWaitTimeout
from parsec_tpu_torch.serve import RuntimeServer

@pytest.fixture
def param():
    saved = {}

    def set_(name, value):
        saved.setdefault(name, params.get(name))
        params.set(name, value)

    yield set_
    for name, value in saved.items():
        params.set(name, value)


@pytest.fixture
def fresh_recorder():
    """A private size-8 recorder for the test, the process's one back
    after."""
    old_rec, old_hook = flight_recorder.recorder, pins.recorder
    rec = flight_recorder.install(8)
    yield rec
    flight_recorder.recorder, pins.recorder = old_rec, old_hook


# ---------------------------------------------------------------------------
# ring mechanics
# ---------------------------------------------------------------------------

def test_ring_wraparound_keeps_last_n(fresh_recorder):
    for i in range(20):
        pins.fire(PinsEvent.EXEC_END, None, i)
    ring = fresh_recorder.snapshot()[threading.current_thread().name]
    assert ring["total"] == 20
    assert [e["info"] for e in ring["events"]] == list(range(12, 20))
    assert all(e["event"] == "EXEC_END" for e in ring["events"])
    assert [e["info"] for e in fresh_recorder.snapshot(last=3)[
        threading.current_thread().name]["events"]] == [17, 18, 19]


def test_counts_survive_wraparound_and_sum_payloads(fresh_recorder):
    for _ in range(30):
        pins.fire(PinsEvent.COMPLETE_EXEC_END, None, None)
    pins.fire(PinsEvent.DAG_COMPLETE_END, None, 1000)
    pins.fire(PinsEvent.DAG_COMPLETE_END, None, 24)
    pins.fire(PinsEvent.DEVICE_STAGE_IN, None, 4096)
    counts, vsums = fresh_recorder.aggregate()
    assert counts[PinsEvent.COMPLETE_EXEC_END] == 30
    assert vsums[PinsEvent.DAG_COMPLETE_END] == 1024
    rep = runtime_report()
    assert rep["dynamic_tasks_retired"] == 30
    assert rep["dag_tasks_completed"] == 1024
    assert rep["tasks_retired"] == 1054
    assert rep["h2d_bytes"] == 4096


def test_idle_selects_become_liveness_ticks(fresh_recorder):
    pins.fire(PinsEvent.EXEC_BEGIN, None, 7)
    for _ in range(500):
        pins.fire(PinsEvent.SELECT_BEGIN, None, None)
        pins.fire(PinsEvent.SELECT_END, None, None)
    for _ in range(100):
        pins.fire(PinsEvent.DAG_FETCH_BEGIN, None, None)
        pins.fire(PinsEvent.DAG_FETCH_END, None, 0)
    ring = fresh_recorder.snapshot()[threading.current_thread().name]
    assert ring["total"] == 1
    assert ring["events"][0]["event"] == "EXEC_BEGIN"
    assert ring["idle_selects"] == 600
    assert ring["idle_age_ms"] is not None


def test_busy_selects_do_not_count_as_idle(fresh_recorder):
    task = object()
    for _ in range(10):
        pins.fire(PinsEvent.SELECT_BEGIN, None, None)
        pins.fire(PinsEvent.SELECT_END, None, task)
    ring = fresh_recorder.snapshot()[threading.current_thread().name]
    assert ring["idle_selects"] == 0 and ring["total"] == 10


def test_recycled_thread_name_keeps_cumulative_counts(fresh_recorder):
    def worker():
        for _ in range(5):
            pins.fire(PinsEvent.COMPLETE_EXEC_END, None, None)
    for _ in range(2):
        t = threading.Thread(target=worker, name="recycled-es")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    counts, _ = fresh_recorder.aggregate()
    assert counts[PinsEvent.COMPLETE_EXEC_END] == 10
    assert list(fresh_recorder.rings).count("recycled-es") == 1


def test_payload_summaries_name_tasks_and_tuples(fresh_recorder):
    class _TC:
        name = "GEMM"

    class _Task:
        task_class = _TC()
        uid = 77

    pins.fire(PinsEvent.EXEC_BEGIN, None, _Task())
    pins.fire(PinsEvent.SERVE_SUBMIT, None, ("tenantA", "pool"))
    pins.fire(PinsEvent.DEVICE_BATCH_BEGIN, None, [1, 2, 3])
    evs = fresh_recorder.snapshot()[threading.current_thread().name]["events"]
    assert (evs[0]["task"], evs[0]["info"]) == (77, "GEMM")
    assert evs[1]["info"] == "('tenantA', 'pool')"
    assert evs[2]["info"] == "list[3]"


def _bare_slots():
    """The recorder's hook off the slots (put back by the caller)."""
    saved = pins.recorder
    pins.recorder = None
    return saved


def test_disabled_slots_are_none_and_allocation_free():
    saved = _bare_slots()
    try:
        assert not pins.enabled, "a test left a PINS chain registered"
        hooks = pins.hooks
        ev = int(PinsEvent.EXEC_BEGIN)
        assert hooks[ev] is None
        payload = object()
        pins.fire(PinsEvent.EXEC_BEGIN, None, payload)
        it = range(1000)
        tracemalloc.start()
        before, _ = tracemalloc.get_traced_memory()
        for _ in it:
            h = hooks[ev]
            if h is not None:
                h(None, payload)
            pins.fire(PinsEvent.EXEC_BEGIN, None, payload)
        after, _ = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        assert after - before < 512, (before, after)
    finally:
        pins.recorder = saved


def test_recorder_assignment_retargets_the_slots():
    table = pins.hooks
    seen = []
    saved = pins.recorder
    pins.recorder = lambda ev, payload: seen.append((ev, payload))
    try:
        pins.hooks[int(PinsEvent.EXEC_BEGIN)](None, 42)
        pins.fire(PinsEvent.DAG_COMPLETE_END, None, 7)
        assert seen == [(PinsEvent.EXEC_BEGIN, 42),
                        (PinsEvent.DAG_COMPLETE_END, 7)]
    finally:
        pins.recorder = saved
    assert pins.hooks is table and pins.recorder is saved


def test_prof_flightrec_size_zero_installs_no_recorder(param):
    old_rec, old_hook = flight_recorder.recorder, pins.recorder
    flight_recorder.uninstall()
    param("prof_flightrec_size", 0)
    try:
        Context(nb_cores=0).fini()
        assert flight_recorder.recorder is None and pins.recorder is None
        assert runtime_report()["flightrec"] == "disabled"
        param("prof_flightrec_size", 256)
        Context(nb_cores=0).fini()
        assert flight_recorder.recorder.size == 256
        assert pins.recorder == flight_recorder.recorder.note
    finally:
        flight_recorder.recorder, pins.recorder = old_rec, old_hook


# ---------------------------------------------------------------------------
# the stall dump
# ---------------------------------------------------------------------------

def _hung_pool(ev, n=4):
    p = ptg.PTGBuilder("hangpool", N=n)
    t = p.task("HANG", i=ptg.span(0, lambda g, l: g.N - 1))
    t.body(lambda es, task, g, l: (ev.wait(20), None)[1])
    return p.build()


def test_wait_timeout_raises_typed_after_one_dump(tmp_path, param, capsys):
    param("runtime_dag_compile", False)
    param("prof_flightrec_dir", str(tmp_path))
    ev = threading.Event()
    ctx = Context(nb_cores=2)
    ctx.add_taskpool(_hung_pool(ev))
    try:
        t0 = time.monotonic()
        with pytest.raises(ContextWaitTimeout) as ei:
            ctx.wait(timeout=1.0)
        assert time.monotonic() - t0 < 10
        assert isinstance(ei.value, TimeoutError)
        report = ctx.last_stall_report
        workers = report["workers"]
        for es_name in ("parsec-es0", "parsec-es1"):
            evs = workers[es_name]["events"]
            assert evs[-1]["event"] == "EXEC_BEGIN"
            assert evs[-1]["info"] == "HANG"
        assert report["queue_depths"] and \
            set(report["queue_depths"]) >= {"vp0.system", "es0", "es1"}
        assert report["sched_pending"] == 2
        assert report["active_taskpools"][0]["name"] == "hangpool"
        loaded = json.loads((tmp_path / "flightrec-0.json").read_text())
        assert loaded["workers"].keys() == workers.keys()
        err = capsys.readouterr().err
        assert err.count("STALL DUMP") == 1 and "parsec-es0" in err
    finally:
        ev.set()
        ctx.wait(timeout=30)
        ctx.fini()


def test_fini_bounded_drain_tears_down_instead_of_hanging(tmp_path, param):
    param("runtime_dag_compile", False)
    param("prof_flightrec_dir", str(tmp_path))
    ev = threading.Event()
    ctx = Context(nb_cores=1)
    ctx.add_taskpool(_hung_pool(ev, n=1))
    ctx.start()
    time.sleep(0.2)
    threading.Timer(0.3, ev.set).start()
    t0 = time.monotonic()
    ctx.fini(timeout=0.2)
    assert time.monotonic() - t0 < 10
    assert ctx.last_stall_report is not None
    assert (tmp_path / "flightrec-0.json").exists()
    assert not any(t.is_alive() for t in ctx._threads)


def test_fini_after_a_timed_out_wait_dumps_only_once(tmp_path, param,
                                                     capsys):
    param("runtime_dag_compile", False)
    param("prof_flightrec_dir", str(tmp_path))
    ev = threading.Event()
    ctx = Context(nb_cores=1)
    ctx.add_taskpool(_hung_pool(ev, n=1))
    with pytest.raises(ContextWaitTimeout):
        ctx.wait(timeout=0.3)
    threading.Timer(0.3, ev.set).start()
    ctx.fini(timeout=0.0)
    assert capsys.readouterr().err.count("STALL DUMP") == 1


def test_the_stall_dump_can_be_turned_off(param):
    param("runtime_dag_compile", False)
    param("prof_stall_dump", False)
    ev = threading.Event()
    ctx = Context(nb_cores=1)
    ctx.add_taskpool(_hung_pool(ev, n=1))
    try:
        with pytest.raises(ContextWaitTimeout):
            ctx.wait(timeout=0.3)
        assert ctx.last_stall_report is None
    finally:
        ev.set()
        ctx.wait(timeout=30)
        ctx.fini()


def test_debug_state_and_queue_depths_answer_under_held_locks():
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    try:
        state = dev.debug_state()
        assert state["name"] == "cuda(cpu)"
        assert {"lru_tiles", "pending_tasks", "inflight_dispatches"} <= \
            set(state)
        with dev._mutex_lock, dev._lru_lock:
            held = [None]
            t = threading.Thread(
                target=lambda: held.__setitem__(0, dev.debug_state()))
            t.start()
            t.join(timeout=5)
            assert not t.is_alive()
        assert held[0]["pending_tasks"] == "<manager lock held>"
        assert held[0]["lru_tiles"] == "<lru lock held>"
    finally:
        registry.devices = snapshot
        for i, d in enumerate(registry.devices):
            d.device_index = i
    from parsec_tpu_torch.serve.fair import FairScheduler
    ctx = Context(nb_cores=0)
    try:
        fair = FairScheduler(ctx.scheduler)
        with fair._lock:
            assert fair.queue_depths(ctx)["fair"] == -1
        assert fair.queue_depths(ctx) == ctx.scheduler.queue_depths(ctx)
    finally:
        ctx.fini()
    for name in ("lfq", "ap", "ll", "pbq", "ltq", "lhq"):
        c = Context(nb_cores=2, scheduler=name)
        try:
            depths = c.scheduler.queue_depths(c)
        finally:
            c.fini()
        want = {"shared"} if name in ("ap", "ll") else {"es0", "es1"}
        assert want <= set(depths), (name, depths)


# ---------------------------------------------------------------------------
# the snapshotter and the reports
# ---------------------------------------------------------------------------

def test_snapshotter_samples_counters_and_props(param):
    param("runtime_dag_compile", False)
    param("prof_snapshot_interval", 0.03)
    snap = flight_recorder.snapshotter
    before = len(snap.series)
    p = ptg.PTGBuilder("sleepy", N=60)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.N - 1))
    t.body(lambda es, task, g, l: time.sleep(0.005))
    with Context(nb_cores=2) as ctx:
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=60)
    assert len(snap.series) > before
    s = snap.series[-1]
    assert "sde" in s and "props" in s and "tasks_retired" in s
    time.sleep(0.1)
    n = len(snap.series)
    time.sleep(0.12)
    assert len(snap.series) == n


def test_export_run_report_round_trips_through_chrome(tmp_path, param):
    param("runtime_dag_compile", False)
    trace_state.init()
    comp = repository.find("pins", "task_profiler")
    mod = comp.open()
    try:
        p = ptg.PTGBuilder("exp", N=12)
        t = p.task("T", i=ptg.span(0, lambda g, l: g.N - 1))
        t.body(lambda es, task, g, l: None)
        with Context(nb_cores=0) as ctx:
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=30)
        flight_recorder.snapshotter.sample()
        flight_recorder.snapshotter.sample()
        path = tmp_path / "report.json"
        out = export_run_report(chrome_path=str(path))
        evs = json.loads(path.read_text())["traceEvents"]
        assert {"flightrec", "parsec"} <= {e.get("cat") for e in evs}
        assert "C" in {e.get("ph") for e in evs}
        assert any(e.get("name") == "task_exec" for e in evs)
        summary = out["summary"]
        assert summary["tasks_retired"] >= 12
        assert summary["trace_events"] == len(evs)
        assert summary["workers"]
    finally:
        comp.close(mod)
        trace_state.fini()


def test_runtime_report_is_json_serializable_and_compact():
    flight_recorder.ensure_installed()
    rep = runtime_report()
    assert len(json.dumps(rep)) < 4096
    assert "tasks_retired" in rep and "workers" in rep and "knobs" in rep


def test_knobs_name_the_params_set_away_from_their_defaults(param):
    param("comm_get_window", 7)
    assert runtime_report()["knobs"]["comm_get_window"] == 7


def _served_report(server_cls, build, report_fn, spans_mod, rec_mod,
                   pins_mod):
    """A fresh recorder and span recorder, a served CTL backlog of two
    tenants, and the report.  The SLO planes of servers an earlier test
    of the process dropped are collected first: the report merges every
    live plane."""
    import gc
    gc.collect()
    old = rec_mod.recorder, spans_mod.recorder
    rec_mod.install(256)
    spans_mod.uninstall()
    spans_mod.install()
    try:
        with server_cls(nb_cores=2) as server:
            tks = []
            for i in range(4):
                p = build.PTGBuilder("rep", N=4)
                t = p.task("T", i=build.span(0, lambda g, l: g.N - 1))
                t.body(lambda es, task, g, l: None)
                tks.append(server.submit(p.build(), tenant=f"t{i % 2}"))
            for tk in tks:
                tk.result(timeout=60)
        return report_fn()
    finally:
        spans_mod.uninstall()
        if old[1] is not None:
            spans_mod.install(recorder_obj=old[1])
        rec_mod.recorder = old[0]
        pins_mod.recorder = old[0].note if old[0] is not None else None


def _bcast_analysed(pkg: str) -> str:
    """Run each package's commcheck over a four-rank broadcast (the
    ``comm_pattern`` block then appears in its reports); the pool's name."""
    if pkg == "jax":
        from parsec_tpu.analysis.commcheck import check_comm
        from parsec_tpu.comm.collectives import bcast_taskpool
        from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic
    else:
        from parsec_tpu_torch.analysis.commcheck import check_comm
        from parsec_tpu_torch.comm.collectives import bcast_taskpool
        from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic
    tp = bcast_taskpool(VectorTwoDimCyclic("FRV", lm=4096, mb=1024, P=4),
                        n=4)
    check_comm(tp, nb_ranks=4)
    return tp.name


def test_runtime_report_keys_equal_the_jax_packages_on_a_served_run():
    from parsec_tpu import ptg as jptg
    name = _bcast_analysed("port")
    assert _bcast_analysed("jax") == name
    rep = _served_report(RuntimeServer, ptg, runtime_report, spans,
                         flight_recorder, pins)
    jrep = _served_report(JRuntimeServer, jptg, jruntime_report, jspans,
                          jflight, jpins)
    assert rep["comm_pattern"][name] == jrep["comm_pattern"][name]
    keys, jkeys = set(rep), set(jrep)
    # ``llm`` follows whether a batcher ever ran in the process, in each
    # package: compare it only when both have it
    if ("llm" in keys) != ("llm" in jkeys):
        keys.discard("llm")
        jkeys.discard("llm")
    assert keys == jkeys
    assert {"serve", "slo", "critpath", "knobs"} <= keys
    for block in ("serve", "critpath"):
        assert set(rep[block]) == set(jrep[block]), block
    assert rep["serve"] == jrep["serve"] == {
        "submitted": 4, "admitted": 4, "rejected": 0, "started": 4,
        "completed": 4, "drains": 1}
    assert set(rep["slo"]["t0"]) == set(jrep["slo"]["t0"])
    assert len(json.dumps(rep)) < 4096


def test_four_rank_threads_count_each_event_once(fresh_recorder):
    """Four rank contexts in one process share the one recorder: an
    event a rank fires lands in that rank's thread ring, once."""
    old_sz = params.get("runtime_dag_compile")
    params.set("runtime_dag_compile", False)
    try:
        def body(ctx, rank, nranks):
            p = ptg.PTGBuilder(f"r{rank}", N=5)
            t = p.task("T", i=ptg.span(0, lambda g, l: g.N - 1))
            t.body(lambda es, task, g, l: None)
            ctx.add_taskpool(p.build(), local_only=True)
            ctx.wait(timeout=60)
            return True
        assert run_multirank(4, body, nb_cores=0) == [True] * 4
    finally:
        params.set("runtime_dag_compile", old_sz)
    counts, _ = fresh_recorder.aggregate()
    assert counts[PinsEvent.COMPLETE_EXEC_END] == 20
    assert counts[PinsEvent.TASKPOOL_INIT] == 4

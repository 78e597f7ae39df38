"""Request spans and trace ids on the wire, in the port, against the JAX
package's.

- trace contexts, the bounded recorder and the allocation-free disabled
  path (the ``r = spans.recorder; if r is not None`` site pattern,
  pinned under ``tracemalloc``);
- a traced tiled GEMM through its host chores on the dynamic scheduler,
  in both packages: the span-name counts must be equal; an untraced pool
  records nothing; on the device module around the host, one EXEC span
  a task run;
- the wire: a traced CTRL frame packed by the port parses with the JAX
  package's header layout into its trace word, and a JAX fabric's
  receive thread records it under that trace; the activation tuple and
  the first fragment's meta carry the trace in the JAX codec's bytes;
- a two-rank ``run_multiproc`` of the port with spans on: the port's
  tracemerge stitches at least one activation and one GET flow across
  the ranks, and the JAX package's tracemerge reads the same files to
  the same statistics.
"""

import os
import time
import tracemalloc

import numpy as np
import pytest

import parsec_tpu.runtime.dagrun  # noqa: F401 — registers its params
from parsec_tpu.comm import codec as jcodec
from parsec_tpu.comm.remote_dep import pack_activation as jpack
from parsec_tpu.comm.socket_fabric import _HDR as J_HDR
from parsec_tpu.comm.socket_fabric import SocketFabric as JSocketFabric
from parsec_tpu.core.params import params as jparams
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.models import tiled_gemm as jgemm
from parsec_tpu.prof import spans as jspans
from parsec_tpu.prof import tracemerge as jtracemerge
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch.comm import codec, run_multiproc
from parsec_tpu_torch.comm.multiproc import _free_port_base
from parsec_tpu_torch.comm.remote_dep import (pack_activation,
                                              unpack_activation)
from parsec_tpu_torch.comm.socket_fabric import K_CTRL, SocketFabric
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.matrix import TiledMatrix as PTiled
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models import tiled_gemm as pgemm
from parsec_tpu_torch.prof import spans, tracemerge
from parsec_tpu_torch.runtime import Context

N, NB = 32, 8
TRACE = 0xBEEF01


@pytest.fixture
def installed():
    """The port's recorder on for the test, off (and the process's
    earlier one, if any, back) after."""
    prev = spans.recorder
    spans.uninstall()
    rec = spans.install()
    yield rec
    spans.uninstall()
    if prev is not None:
        spans.install(recorder_obj=prev)


@pytest.fixture
def jinstalled():
    prev = jspans.recorder
    jspans.uninstall()
    rec = jspans.install()
    yield rec
    jspans.uninstall()
    if prev is not None:
        jspans.install(recorder_obj=prev)


@pytest.fixture
def dynamic():
    saved = params.get("runtime_dag_compile"), \
        jparams.get("runtime_dag_compile")
    params.set("runtime_dag_compile", False)
    jparams.set("runtime_dag_compile", False)
    yield
    params.set("runtime_dag_compile", saved[0])
    jparams.set("runtime_dag_compile", saved[1])


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def _operands(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, N), np.float32),
            rng.standard_normal((N, N), np.float32))


def _names(raw):
    out = {}
    for s in raw:
        out[s[0]] = out.get(s[0], 0) + 1
    return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_trace_ids_are_unique_and_64bit():
    seen = {spans.new_trace().trace_id for _ in range(1000)}
    assert len(seen) == 1000 and all(0 < t < 2 ** 64 for t in seen)
    assert spans.TraceContext(2 ** 64 + 5).trace_id == 5
    assert repr(spans.TraceContext(TRACE)) == "TraceContext(0xbeef01)"


def test_the_disabled_span_path_is_allocation_free():
    prev = spans.recorder
    spans.uninstall()
    try:
        r = spans.recorder
        if r is not None:
            r.record("x", 0, 0, 0)
        it = range(1000)
        tracemalloc.start()
        before, _ = tracemalloc.get_traced_memory()
        for _ in it:
            r = spans.recorder
            if r is not None:
                r.record("x", 0, 0, 0)
        after, _ = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        assert after - before < 512, (before, after)
    finally:
        if prev is not None:
            spans.install(recorder_obj=prev)


def test_the_recorder_stays_within_its_bound():
    rec = spans.SpanRecorder(max_spans=100)
    for i in range(500):
        rec.record("x", 1, i, i + 1)
    assert len(rec.spans) <= 100 and rec.dropped >= 400
    # the newest spans are the ones kept
    assert rec.spans[-1][2] == 499
    assert rec.by_trace(1) == rec.spans


def test_prof_spans_installs_the_recorder_at_context_construction():
    prev = spans.recorder
    spans.uninstall()
    saved = params.get("prof_spans")
    params.set("prof_spans", True)
    try:
        Context(nb_cores=0).fini()
        assert spans.recorder is not None
    finally:
        params.set("prof_spans", saved)
        spans.uninstall()
        if prev is not None:
            spans.install(recorder_obj=prev)


# ---------------------------------------------------------------------------
# task-grain spans against the JAX package's
# ---------------------------------------------------------------------------

def _port_gemm_spans(rec, traced: bool = True):
    a, b = _operands()
    A, B = PTiled.from_dense("A", a, NB, NB), PTiled.from_dense("B", b, NB,
                                                                  NB)
    C = PTiled("C", N, N, NB, NB)
    tp = pgemm.tiled_gemm_ptg(A, B, C, devices="cpu")
    if traced:
        tp._trace = spans.TraceContext(TRACE)
        tp._trace_enq_ns = time.perf_counter_ns()
    ctx = Context(nb_cores=0)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    ctx.fini()
    np.testing.assert_allclose(C.to_dense(), a @ b, rtol=1e-5, atol=1e-4)
    return [s for s in rec.spans if s[1] == TRACE]


def test_span_names_of_a_traced_gemm_equal_the_jax_packages(
        installed, jinstalled, dynamic):
    got = _names(_port_gemm_spans(installed))
    a, b = _operands()
    A, B = JTiled.from_dense("A", a, NB, NB), JTiled.from_dense("B", b, NB,
                                                                  NB)
    C = JTiled("C", N, N, NB, NB)
    tp = jgemm.tiled_gemm_ptg(A, B, C, devices="cpu")
    tp._trace = jspans.TraceContext(TRACE)
    tp._trace_enq_ns = time.perf_counter_ns()
    ctx = JContext(nb_cores=0)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    ctx.fini()
    want = _names(jinstalled.by_trace(TRACE))
    assert got == want
    assert got["exec"] == got["release"] == (N // NB) ** 3
    assert got["queue_wait"] == 1
    # exec spans carry the task-class name, in the Chrome export too
    ev = [e for e in spans.to_chrome_events(pid=0) if e["name"] == "exec"]
    assert ev and ev[0]["args"] == {"trace": "beef01", "task": "GEMM"}


def test_an_untraced_pool_records_nothing(installed, dynamic):
    _port_gemm_spans(installed, traced=False)
    assert installed.spans == []


def test_one_exec_span_a_task_on_the_device_module(installed, dynamic,
                                                   cpu_cuda_device):
    a, b = _operands(4)
    A, B = PTiled.from_dense("A", a, NB, NB), PTiled.from_dense("B", b, NB,
                                                                  NB)
    C = PTiled("C", N, N, NB, NB)
    before = cpu_cuda_device.executed_tasks
    tp = pgemm.tiled_gemm_ptg(A, B, C)
    tp._trace = spans.TraceContext(TRACE)
    ctx = Context(nb_cores=2)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    ctx.fini()
    ran = cpu_cuda_device.executed_tasks - before
    assert ran == (N // NB) ** 3
    names = _names(installed.by_trace(TRACE))
    assert names["exec"] == ran
    np.testing.assert_allclose(C.to_dense(), a @ b, rtol=1e-5, atol=1e-4)


def test_chrome_and_raw_exports_round_trip(installed, dynamic, tmp_path):
    from parsec_tpu_torch.prof.critpath import attribute, load, normalize
    _port_gemm_spans(installed)
    raw = spans.export_spans(str(tmp_path / "spans.json"), rank=0)
    chrome = spans.export_chrome(str(tmp_path / "trace-rank0.json"), rank=0)
    assert raw["spans"] == len(installed.spans)
    assert chrome["events"] == len(installed.spans) + 2 + len(
        {s[6] for s in installed.spans})
    rep_raw = attribute(load(str(tmp_path / "spans.json")))
    rep_live = attribute(normalize(list(installed.spans)))
    assert rep_raw["buckets_ms"] == rep_live["buckets_ms"]
    rep_chrome = attribute(load(str(tmp_path / "trace-rank0.json")))
    # the Chrome form rounds to µs: within 1 µs a span
    for k, v in rep_live["buckets_ms"].items():
        assert abs(rep_chrome["buckets_ms"][k] - v) <= \
            1e-3 * (rep_live["spans"] + 1), k


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def test_a_traced_ctrl_header_parses_with_the_jax_layout():
    fab = SocketFabric.__new__(SocketFabric)
    fab.rank = 0
    frames = []
    fab._send_frame = lambda dst, frame, nbytes, frag, snapshot=False: \
        frames.append(frame(7))
    fab.deliver(1, 42, 0, {"x": 1}, trace_id=TRACE)
    fab.deliver(1, 42, 0, {"x": 1})
    (kind, flags, tag, src, seq, u0, u1, u2) = J_HDR.unpack(frames[0][0])
    assert (kind, tag, src, seq, u2) == (K_CTRL, 42, 0, 7, TRACE)
    assert J_HDR.unpack(frames[1][0])[7] == 0
    assert frames[0][1:] == frames[1][1:]    # the payload is untouched


def test_a_jax_fabric_records_the_port_frames_trace(jinstalled):
    for _attempt in range(5):
        base = _free_port_base(2)
        try:
            pf = SocketFabric(2, 0, base_port=base)
        except OSError:
            continue
        try:
            jf = JSocketFabric(2, 1, base_port=base)
        except OSError:
            pf.close()
            continue
        break
    try:
        pf.deliver(1, 5, 0, {"a": np.arange(3, dtype=np.int64)},
                   trace_id=TRACE)
        deadline = time.monotonic() + 30
        got = []
        while not got and time.monotonic() < deadline:
            got = jf.drain(1)
            time.sleep(0.001)
        assert got and got[0][0] == 5
        wire = [s for s in jinstalled.spans if s[0] == "wire.ctrl"]
        assert [s[1] for s in wire] == [TRACE]
        assert wire[0][5]["src"] == 0
    finally:
        pf.close()
        jf.close()


def test_activation_and_fragment_meta_carry_the_trace_in_the_jax_bytes():
    msg = {"tp": 3, "tc": 1, "locals": {"m": 2}, "ranks": [0, 2],
           "tree": "chain", "priority": 4, "seq": 9, "pos": 1,
           "trace": TRACE,
           "outputs": [{"flow_index": 0, "writeback": False, "version": 2,
                        "wire": (0, 17), "shape": (8, 8)}]}
    t, jt = pack_activation(msg), jpack(msg)
    assert t == jt and t[-1] == TRACE
    assert codec.encode(t) == jcodec.encode(jt)
    assert unpack_activation(t)["trace"] == TRACE
    # a 10-element tuple (no trace) still unpacks, as untraced
    assert unpack_activation(t[:10])["trace"] == 0
    meta = {"shape": (64, 64), "dtype": "float32", "nbytes": 16384,
            "nfrags": 2, "tier": "host", "trace": TRACE}
    assert codec.encode(meta) == jcodec.encode(meta)


def _traced_two_ranks(tmp_path, kind="cholesky"):
    env = {"PARSEC_MP_KINDS": kind, "PARSEC_MP_N": "256",
           "PARSEC_MP_NB": "64", "PARSEC_MP_CHORES": "cpu",
           "PARSEC_MP_WARMUP": "1", "PARSEC_MP_TRACE_DIR": str(tmp_path)}
    saved_env = {k: os.environ.get(k) for k in env}
    saved = params.get("prof_spans")
    os.environ.update(env)
    params.set("prof_spans", True)
    try:
        return run_multiproc(2, "parsec_tpu_torch.comm.mp_bodies:pool_body",
                             timeout=180)
    finally:
        params.set("prof_spans", saved)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_two_rank_spans_stitch_across_processes(tmp_path):
    res = _traced_two_ranks(tmp_path)
    recs = [r["kinds"]["cholesky"] for r in res]
    for r in recs:
        assert {"exec", "comm.activate", "comm.get"} <= set(r["spans"])
        assert r["spans_dropped"] == 0
    paths = [str(tmp_path / f"trace-cholesky-rank{r}.json") for r in (0, 1)]
    stats = tracemerge.merge_traces(paths, str(tmp_path / "merged.json"))
    assert stats["flows_by_kind"].get("act", 0) >= 1, stats
    assert stats["flows_by_kind"].get("get", 0) == sum(r["gets"]
                                                       for r in recs) >= 1
    assert stats["cross_rank_flows"] == stats["flows_matched"]
    # every activation hop's two spans were matched
    assert stats["flows_by_kind"]["act"] == sum(
        r["spans"]["comm.activate"] for r in recs) // 2
    cp = stats["critpath"]
    assert cp["traces"] == 1 and cp["buckets_ms"]["exec"] > 0
    # the JAX package's tracemerge reads the port's files the same way
    jstats = jtracemerge.merge_traces(paths, str(tmp_path / "jmerged.json"))
    for key in ("events", "flows_matched", "cross_rank_flows",
                "resumed_flows", "flows_by_kind", "trees"):
        assert jstats[key] == stats[key], key
    assert jstats["critpath"]["buckets_ms"] == cp["buckets_ms"]

"""The port's trace tools against the JAX package's on the same inputs.

A two-process ``run_multiproc`` of the port's chain with the task
profiler and the grapher on writes each rank's binary trace and DOT
fragment; then ``prof.info`` (its CLI with ``--validate`` and
``--chrome``, and ``summarize`` equal to the JAX package's on the same
files), ``prof.dotmerge`` (its CLI, and ``merge`` equal to the JAX
package's; the parser and the rank tag from the file name), the grapher
(a GEMM's DOT equal to the JAX grapher's on the same pool), the debug
marks and the perf modules (opened through the ``pins`` param), and the
dashboard (``stream_to`` and ``read_live_snapshot``, the
``props_stream`` of a context, ``render_snapshot`` and
``render_critpath`` equal to the JAX package's, its CLI).
"""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import parsec_tpu.runtime.dagrun  # noqa: F401 — registers its params
from parsec_tpu.core.mca import repository as jrepository
from parsec_tpu.core.params import params as jparams
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.models import tiled_gemm as jgemm
from parsec_tpu.prof import dashboard as jdashboard
from parsec_tpu.prof import dotmerge as jdotmerge
from parsec_tpu.prof import info as jinfo
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import run_multiproc
from parsec_tpu_torch.core.mca import repository
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.matrix import TiledMatrix as PTiled
from parsec_tpu_torch.models import tiled_gemm as pgemm
from parsec_tpu_torch.prof import (counters, dashboard, debug_marks,
                                   dotmerge, info, properties)
from parsec_tpu_torch.prof.critpath import attribute, normalize
from parsec_tpu_torch.runtime import Context

BODY = "parsec_tpu_torch.comm.mp_bodies:traced_chain_body"


@pytest.fixture(scope="module")
def trace_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    saved = os.environ.get("PARSEC_MP_TRACE_DIR")
    os.environ["PARSEC_MP_TRACE_DIR"] = str(d)
    try:
        res = run_multiproc(2, BODY, timeout=120)
    finally:
        if saved is None:
            os.environ.pop("PARSEC_MP_TRACE_DIR", None)
        else:
            os.environ["PARSEC_MP_TRACE_DIR"] = saved
    assert res == [True, True]
    for r in range(2):
        assert (d / f"rank{r}.prof").exists() and (d / f"rank{r}.dot").exists()
    return d


@pytest.fixture
def param():
    saved = {}

    def set_(name, value):
        saved.setdefault(name, params.get(name))
        params.set(name, value)

    yield set_
    for name, value in saved.items():
        params.set(name, value)


def _run(*args):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=120)


# ---------------------------------------------------------------------------
# info
# ---------------------------------------------------------------------------

def test_info_cli_summarizes_multirank_traces(trace_dir):
    p = _run("parsec_tpu_torch.prof.info", "--validate",
             str(trace_dir / "rank0.prof"), str(trace_dir / "rank1.prof"))
    assert p.returncode == 0, p.stderr[-1500:]
    out = p.stdout
    assert "rank0.prof" in out and "rank1.prof" in out
    assert "task_exec" in out and "VALIDATION: ok" in out
    assert "count" in out and "mean" in out


def test_info_chrome_export_flag(trace_dir, tmp_path):
    out = tmp_path / "trace.json"
    p = _run("parsec_tpu_torch.prof.info", "--chrome", str(out),
             str(trace_dir / "rank0.prof"))
    assert p.returncode == 0, p.stderr[-1500:]
    assert any(e.get("ph") == "X"
               for e in json.loads(out.read_text())["traceEvents"])


@pytest.mark.parametrize("rank", [0, 1])
def test_info_summarize_equals_the_jax_packages(trace_dir, rank):
    path = str(trace_dir / f"rank{rank}.prof")
    buf, jbuf = io.StringIO(), io.StringIO()
    res = info.summarize(path, out=buf, validate=True)
    jres = jinfo.summarize(path, out=jbuf, validate=True)
    assert res == jres
    assert buf.getvalue() == jbuf.getvalue()
    st = res["classes"]["task_exec"]
    assert res["problems"] == [] and st["count"] == 2
    assert 0 < st["min_ns"] <= st["max_ns"]


# ---------------------------------------------------------------------------
# dotmerge and the grapher
# ---------------------------------------------------------------------------

def test_dotmerge_cli_unions_ranks_and_marks_cross_edges(trace_dir):
    merged = trace_dir / "merged.dot"
    p = _run("parsec_tpu_torch.prof.dotmerge", str(trace_dir / "rank0.dot"),
             str(trace_dir / "rank1.dot"), "-o", str(merged))
    assert p.returncode == 0, p.stderr[-1500:]
    nodes, edges = dotmerge.parse_dot(merged.read_text())
    assert len(nodes) == 4
    assert {a["ranks"] for a in nodes.values()} == {"0", "1"}
    cross = [k for k, a in edges.items() if a.get("style") == "dashed"]
    assert len(cross) == 3 and len(edges) == 3


def test_dotmerge_equals_the_jax_packages(trace_dir, tmp_path):
    paths = [str(trace_dir / f"rank{r}.dot") for r in (0, 1)]
    assert dotmerge.merge(paths) == jdotmerge.merge(paths)
    stats = dotmerge.write_merged(paths, str(tmp_path / "p.dot"))
    jstats = jdotmerge.write_merged(paths, str(tmp_path / "j.dot"))
    assert stats == jstats
    assert (tmp_path / "p.dot").read_text() == (tmp_path / "j.dot").read_text()


def test_dotmerge_parse_round_trip(tmp_path):
    src = tmp_path / "one.dot"
    src.write_text('digraph dag {\n'
                   '  "A_1" [label="A(1)" color="#e6194b"];\n'
                   '  "B_1" [label="B(1)" color="#3cb44b"];\n'
                   '  "A_1" -> "B_1" [label="X"];\n'
                   '  "A_1" -> "B_1" [label="Y"];\n'
                   '}\n')
    stats = dotmerge.write_merged([str(src)], str(tmp_path / "out.dot"))
    assert stats == {"nodes": 2, "edges": 2, "cross_rank_edges": 0}
    nodes, edges = dotmerge.parse_dot((tmp_path / "out.dot").read_text())
    assert nodes["A_1"]["label"] == "A(1)" and nodes["A_1"]["ranks"] == "0"
    assert ("A_1", "B_1", "X") in edges and ("A_1", "B_1", "Y") in edges


def test_dotmerge_rank_tag_from_filename(tmp_path):
    for r in (10, 2):
        (tmp_path / f"rank{r}.dot").write_text(
            f'digraph d {{\n  "T_{r}" [label="T({r})"];\n}}\n')
    nodes, _ = dotmerge.merge([str(tmp_path / "rank10.dot"),
                               str(tmp_path / "rank2.dot")])
    assert nodes["T_10"]["ranks"] == "10" and nodes["T_2"]["ranks"] == "2"


def _gemm_dot(pkg_tiled, pkg_gemm, ctx_cls, repo, path):
    a = np.ones((16, 16), np.float32)
    tp = pkg_gemm.tiled_gemm_ptg(pkg_tiled.from_dense("A", a, 8, 8),
                                 pkg_tiled.from_dense("B", a, 8, 8),
                                 pkg_tiled("C", 16, 16, 8, 8), devices="cpu")
    comp = repo.find("pins", "grapher")
    mod = comp.open()
    try:
        ctx = ctx_cls(nb_cores=0)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        ctx.fini()
    finally:
        comp.close(mod)
    mod.write_dot(str(path))
    return dotmerge.parse_dot(path.read_text())


def test_the_grapher_writes_the_jax_graphers_dag(tmp_path, param):
    param("runtime_dag_compile", False)
    saved = jparams.get("runtime_dag_compile")
    jparams.set("runtime_dag_compile", False)
    try:
        got = _gemm_dot(PTiled, pgemm, Context, repository,
                        tmp_path / "p.dot")
        want = _gemm_dot(JTiled, jgemm, JContext, jrepository,
                         tmp_path / "j.dot")
    finally:
        jparams.set("runtime_dag_compile", saved)
    assert got == want
    nodes, edges = got
    assert len(nodes) == 8 and len(edges) == 4     # 2x2 chains of 2


# ---------------------------------------------------------------------------
# debug marks and the perf modules
# ---------------------------------------------------------------------------

def _chain_pool(n=20):
    p = ptg.PTGBuilder("marks", N=n)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.N - 1))
    f = t.flow("ctl", ptg.CTL)
    f.input(pred=("T", "ctl", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "ctl", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.N - 1)
    t.body(lambda es, task, g, l: None)
    return p.build()


def test_debug_marks_ring_the_last_events(param):
    param("runtime_dag_compile", False)
    param("debug_marks_size", 16)
    param("pins", "debug_marks")
    ctx = Context(nb_cores=0)
    ctx.add_taskpool(_chain_pool())
    ctx.wait(timeout=60)
    ctx.fini()
    marks = debug_marks.ring.snapshot()
    assert len(marks) == 16
    kinds = {m[2] for m in marks}
    assert {"exec_begin", "exec_end", "complete"} <= kinds
    assert "T(i=19)" in debug_marks.ring.dump()


def test_print_steals_and_alperf_open_through_the_pins_param(param):
    param("runtime_dag_compile", False)
    param("pins_alperf_interval", 0.02)
    param("pins", "print_steals,alperf")
    p = ptg.PTGBuilder("sleepy", N=40)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.N - 1))
    t.body(lambda es, task, g, l: time.sleep(0.002))
    ctx = Context(nb_cores=2)
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=60)
    assert properties.has("alperf", "tasks_per_s")
    ctx.fini()
    assert not properties.has("alperf", "tasks_per_s")


# ---------------------------------------------------------------------------
# the dashboard
# ---------------------------------------------------------------------------

SNAP = {"ts": 1.7e9, "props": {
    "rank0": {"sched_pending": 3, "active_taskpools": 1, "nb_tasks": 12,
              "sde": {"parsec::tasks_retired": 40}},
    "slo": {"tenants": {"t0.ttft_ms_p50": 12.5}},
    "alperf": {"tasks_per_s": 1234.5}}}


def test_render_snapshot_and_critpath_equal_the_jax_dashboards():
    assert dashboard.render_snapshot(SNAP) == jdashboard.render_snapshot(SNAP)
    rep = attribute(normalize([
        ("exec", 1, 0, 4_000_000, None, "GEMM", 1),
        ("comm.get", 1, 2_000_000, 9_000_000, None, {"bytes": 1 << 20}, 2)]))
    assert dashboard.render_critpath(rep) == jdashboard.render_critpath(rep)
    snap = dict(SNAP, critpath=rep)
    assert dashboard.render_snapshot(snap) == \
        jdashboard.render_snapshot(snap)
    assert dashboard.render_snapshot({"props": {}}).endswith(
        "(no properties registered)")


def test_a_context_streams_its_properties_to_the_dashboard(tmp_path, param):
    path = tmp_path / "props.json"
    param("props_stream", str(path))
    param("props_stream_interval", 0.02)
    param("runtime_dag_compile", False)
    ctx = Context(nb_cores=0)
    ctx.add_taskpool(_chain_pool(5))
    ctx.wait(timeout=60)
    deadline = time.monotonic() + 10
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.01)
    ctx.fini()
    snap = counters.read_live_snapshot(str(path))
    ns = [k for k in snap["props"] if k.startswith("rank0")]
    assert ns and {"sched_pending", "active_taskpools", "nb_tasks",
                   "sde"} <= set(snap["props"][ns[0]])
    out = io.StringIO()
    dashboard.watch(str(path), iterations=1, out=out)
    assert "parsec-tpu live properties" in out.getvalue()
    # the context's gauges leave the dictionary with it
    assert not any(properties.has(n, "sched_pending") for n in ns)
    out = io.StringIO()
    dashboard.watch(str(tmp_path / "none.json"), iterations=1, out=out)
    assert "waiting for" in out.getvalue()


def test_stream_to_writes_and_stops(tmp_path):
    path = tmp_path / "s.json"
    properties.register("tt", "x", lambda: 7)
    try:
        stop = properties.stream_to(str(path), interval=0.01)
        deadline = time.monotonic() + 10
        while not path.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        stop()
        assert counters.read_live_snapshot(str(path))["props"]["tt"]["x"] == 7
        assert not (tmp_path / "s.json.tmp").exists()
    finally:
        properties.unregister("tt", "x")


def test_the_dashboard_cli_renders_a_critpath_panel(tmp_path):
    evs = [{"name": "exec", "cat": "span", "ph": "X", "ts": 0.0,
            "dur": 5000.0, "pid": 1, "tid": 1,
            "args": {"trace": "c0de", "task": "GEMM"}}]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    r = _run("parsec_tpu_torch.prof.dashboard", "--critpath", str(p))
    assert r.returncode == 0, r.stderr[-1500:]
    assert r.stdout.startswith("critical path") and "exec 5.0ms" in r.stdout
    r2 = _run("parsec_tpu_torch.prof.dashboard", "--help")
    assert r2.returncode == 0 and "props_stream" in r2.stdout

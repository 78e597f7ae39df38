"""Critical-path attribution in the port against the JAX package's.

Both packages' ``self_test`` pass; on the same spans (synthetic seeded
ones, and the spans of a traced Cholesky through its host chores)
``attribute`` gives the JAX package's report exactly (the same integer
nanosecond sweep), its identity ``sum(buckets) + idle == window`` holds
for every request, and ``render`` writes the same text;
``dag_critical_path`` and ``GraphReport.critical_path`` over the same
graphcheck graph (the tiled GEMM and the Cholesky, with and without
class costs) equal the JAX package's; the CLI reads a trace on disk.
The JAX package's cases that need ``perfdb`` or the sharded server are
not ported (neither module has a port).
"""

import json
import subprocess
import sys
import time

import numpy as np
import pytest

import parsec_tpu.runtime.dagrun  # noqa: F401 — registers its params
from parsec_tpu import analysis as j_analysis
from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.models import cholesky as j_chol
from parsec_tpu.models import tiled_gemm as j_gemm
from parsec_tpu.prof import critpath as jcritpath
from parsec_tpu_torch import analysis
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic as PSym
from parsec_tpu_torch.data_dist.matrix import TiledMatrix as PTiled
from parsec_tpu_torch.models import cholesky as p_chol
from parsec_tpu_torch.models import tiled_gemm as p_gemm
from parsec_tpu_torch.prof import critpath, spans
from parsec_tpu_torch.prof.critpath import (attribute, class_costs_from,
                                            dag_critical_path, from_chrome,
                                            normalize, render,
                                            summarize_recorder)
from parsec_tpu_torch.runtime import Context

MS = 1_000_000
NAMES = ("exec", "release", "queue_wait", "schedule", "comm.get",
         "comm.get_serve", "comm.activate", "wire.ctrl", "serve.request",
         "serve.admission")


def _random_spans(seed, n=400, traces=5):
    """Seeded spans over a few traces: every span name, overlapping and
    gapped, with task classes and GET sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        name = NAMES[int(rng.integers(len(NAMES)))]
        tr = int(rng.integers(0, traces))
        t0 = int(rng.integers(0, 200 * MS))
        t1 = t0 + int(rng.integers(0, 5 * MS))
        if name == "exec":
            args = ["GEMM", "POTRF", "TRSM"][int(rng.integers(3))]
        elif name.startswith("comm.get"):
            args = {"bytes": int(rng.integers(1, 1 << 24)),
                    "flow": f"get:0:{int(rng.integers(9))}",
                    "flow_side": "recv"}
        else:
            args = None
        out.append((name, tr, t0, t1, "t" if tr % 2 else None, args, 1))
    return out


def _identity(rep):
    for key, rq in rep["requests"].items():
        assert abs(sum(rq["buckets_ms"].values()) - rq["window_ms"]) < 1e-9, \
            key


def test_both_self_tests_pass():
    assert critpath.self_test() == 0
    assert jcritpath.self_test() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribute_equals_the_jax_packages_on_seeded_spans(seed):
    raw = _random_spans(seed)
    rep = attribute(normalize(raw))
    jrep = jcritpath.attribute(jcritpath.normalize(raw))
    assert rep == jrep
    _identity(rep)
    assert render(rep) == jcritpath.render(jrep)
    assert class_costs_from(rep) == jcritpath.class_costs_from(jrep)
    # the Chrome form of the same spans attributes the same way
    evs = [{"name": n, "cat": "span", "ph": "X", "ts": t0 / 1e3,
            "dur": (t1 - t0) / 1e3, "pid": 0, "tid": 0,
            "args": {"trace": format(tr, "x"), **a}}
           for n, tr, t0, t1, a in normalize(raw)]
    assert attribute(from_chrome(evs)) == \
        jcritpath.attribute(jcritpath.from_chrome(evs))


def test_decomposition_is_an_accounting_identity():
    sp = normalize([
        ("queue_wait", 0x7, 0, 3 * MS, None, None, 1),
        ("exec", 0x7, 1 * MS, 6 * MS, None, "POTRF", 1),
        ("comm.get", 0x7, 2 * MS, 9 * MS, None, {"bytes": 1 << 16}, 2),
        ("release", 0x7, 9 * MS, 10 * MS, None, None, 1),
        ("exec", 0x7, 12 * MS, 14 * MS, None, "GEMM", 1),
    ])
    rep = attribute(sp)
    rq = rep["requests"]["7"]
    _identity(rep)
    bk = rq["buckets_ms"]
    assert bk["exec"] == 7.0 and bk["queue"] == 1.0, bk
    assert bk["comm.get"] == 3.0 and bk["idle"] == 2.0, bk
    assert rep["tasks"]["POTRF"]["count"] == 1
    assert abs(rep["edges"]["comm.get:64kib"]["overlap_lost_ms"] - 3.0) < 1e-9


def test_attribute_of_a_traced_cholesky_equals_the_jax_packages():
    """The spans of one traced run, attributed by both packages."""
    saved = params.get("runtime_dag_compile")
    params.set("runtime_dag_compile", False)
    prev = spans.recorder
    spans.uninstall()
    rec = spans.install()
    try:
        A = PSym.from_dense("A", p_chol.make_spd(64, seed=2), 16, 16)
        tp = p_chol.tiled_cholesky_ptg(A, devices="cpu")
        tp._trace = spans.TraceContext(0xC0DE)
        tp._trace_enq_ns = time.perf_counter_ns()
        ctx = Context(nb_cores=2)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        ctx.fini()
        raw = list(rec.spans)
        compact = summarize_recorder()
    finally:
        params.set("runtime_dag_compile", saved)
        spans.uninstall()
        if prev is not None:
            spans.install(recorder_obj=prev)
    rep = attribute(normalize(raw))
    assert rep == jcritpath.attribute(jcritpath.normalize(raw))
    _identity(rep)
    assert rep["traces"] == 1 and rep["tasks"]["GEMM"]["count"] > 0
    assert compact == {k: rep[k] for k in ("spans", "traces", "buckets_ms",
                                          "overlap_efficiency",
                                          "overlap_lost_ms",
                                          "top_overlap_lost")}


def test_summarize_recorder_without_a_recorder_is_none():
    prev = spans.recorder
    spans.uninstall()
    try:
        assert summarize_recorder() is None
    finally:
        if prev is not None:
            spans.install(recorder_obj=prev)


def test_dag_critical_path_equals_the_jax_packages():
    g = {("A", 0): [("B", 0), ("C", 0)], ("B", 0): [("D", 0)],
         ("C", 0): [("D", 0)], ("D", 0): [],
         ("X", 1): [("Y", 2)], ("Y", 2): [("X", 1)]}
    costs = {"A": 1.0, "B": 5.0, "C": 2.0, "D": 1.0}
    dag = dag_critical_path(g, costs)
    assert dag == jcritpath.dag_critical_path(g, costs)
    assert dag["length"] == 7.0 and dag["cyclic"] == 2
    assert [n[0] for n in dag["path"]] == ["A", "B", "D"]


def _gemm(pkg_tiled, pkg_gemm, nt=3):
    a = np.ones((nt * 8, nt * 8), np.float32)
    return pkg_gemm.tiled_gemm_ptg(pkg_tiled.from_dense("A", a, 8, 8),
                                   pkg_tiled.from_dense("B", a, 8, 8),
                                   pkg_tiled("C", nt * 8, nt * 8, 8, 8),
                                   devices="cpu")


def _cholesky(pkg_sym, pkg_chol, nt=4):
    return pkg_chol.tiled_cholesky_ptg(
        pkg_sym("A", nt * 16, nt * 16, 16, 16), devices="cpu")


@pytest.mark.parametrize("model", ["gemm", "cholesky"])
def test_graph_report_critical_path_equals_the_jax_packages(model):
    if model == "gemm":
        pr = analysis.check_ptg(_gemm(PTiled, p_gemm))
        jr = j_analysis.check_ptg(_gemm(JTiled, j_gemm))
        costs = {"GEMM": 2.5}
        want_len = 3                  # the k chain of one C tile
    else:
        pr = analysis.check_ptg(_cholesky(PSym, p_chol))
        jr = j_analysis.check_ptg(_cholesky(JSym, j_chol))
        costs = {"POTRF": 4.0, "TRSM": 2.0, "SYRK": 1.5, "GEMM": 3.0}
        want_len = None
    assert pr.graph == jr.graph
    for c in (None, costs):
        got = pr.critical_path(c)
        assert got == jr.critical_path(c)
        assert got["cyclic"] == 0 and got["nodes"] == pr.ntasks
    if want_len is not None:
        assert pr.critical_path()["length"] == want_len
        assert pr.critical_path(costs)["length"] == want_len * 2.5


def test_the_cli_attributes_a_chrome_trace_on_disk(tmp_path):
    evs = [{"name": "exec", "cat": "span", "ph": "X", "ts": 0.0,
            "dur": 5000.0, "pid": 1, "tid": 1,
            "args": {"trace": "c0de", "task": "GEMM"}},
           {"name": "comm.get", "cat": "span", "ph": "X", "ts": 2000.0,
            "dur": 6000.0, "pid": 1, "tid": 2,
            "args": {"trace": "c0de", "bytes": 4 << 20,
                     "flow": "get:0:1", "flow_side": "recv"}}]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    r = subprocess.run([sys.executable, "-m", "parsec_tpu_torch.prof.critpath",
                        str(p), "--json"], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr[-1500:]
    rep = json.loads(r.stdout)
    assert rep["spans"] == 2 and "c0de" in rep["requests"]
    assert rep["requests"]["c0de"]["buckets_ms"]["exec"] == 5.0
    assert rep["edges"]["comm.get:4mib"]["overlap_lost_ms"] == 3.0
    r2 = subprocess.run([sys.executable, "-m",
                         "parsec_tpu_torch.prof.critpath", str(p)],
                        capture_output=True, text=True, timeout=60)
    assert r2.returncode == 0 and "overlap_lost" in r2.stdout
    r3 = subprocess.run([sys.executable, "-m",
                         "parsec_tpu_torch.prof.critpath", "--self-test"],
                        capture_output=True, text=True, timeout=60)
    assert r3.returncode == 0 and "self-test: ok" in r3.stdout


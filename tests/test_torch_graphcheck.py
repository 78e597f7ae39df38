"""graphcheck in the port against the JAX package's.

Every pool builder both packages have goes through both checkers on the
same inputs: the model graphs of both CLIs (``_model_graphs``: tiled GEMM,
Cholesky, LU, both stencils, prefill, the decode, spec and batched-spec
superpools, the collectives; at two sizes), the DTD GEMM, and the
Cholesky and LU on a 2 x 2 block-cyclic grid checked for 4 ranks.  Node
and edge counts, the retained graph and the findings as a set of (code,
severity, task class, flow, instance, count) must be equal.

Then one seeded mutation per finding class of graphcheck's table, sixteen
in all, built the same way in both packages (the first six mirror
``tests/test_analysis.py``): each must be caught, with the same
provenance and the same whole set of findings in both.  The enqueue gate
(``analysis_check``) must raise before any side effect, DTD's ``close()``
must validate under it, ``validate(raise_on_error=False)`` must return
the report, and the CLI must print an OK line for every graph.
"""

import types

import numpy as np
import pytest
import torch

import parsec_tpu.ptg as j_ptg
from parsec_tpu import analysis as j_analysis
from parsec_tpu.analysis.__main__ import _model_graphs as j_model_graphs
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JBC
from parsec_tpu.dtd import INOUT as J_INOUT
from parsec_tpu.dtd import INPUT as J_INPUT
from parsec_tpu.dtd import DTDTaskpool as JDTDTaskpool
from parsec_tpu.models import cholesky as j_chol
from parsec_tpu.models import lu as j_lu
from parsec_tpu.models import tiled_gemm as j_gemm
from parsec_tpu.runtime import Context as JContext
from parsec_tpu.runtime.task import Dep as JDep
from parsec_tpu_torch import analysis
from parsec_tpu_torch import ptg as p_ptg
from parsec_tpu_torch.analysis import GraphCheckError
from parsec_tpu_torch.analysis.__main__ import _model_graphs, main as cli_main
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.collection import DictCollection as PDict
from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic as PSym
from parsec_tpu_torch.data_dist.matrix import TiledMatrix as PTiled
from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic as PBC
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.dtd import INOUT as P_INOUT
from parsec_tpu_torch.dtd import INPUT as P_INPUT
from parsec_tpu_torch.dtd import DTDTaskpool as PDTDTaskpool
from parsec_tpu_torch.models import cholesky as p_chol
from parsec_tpu_torch.models import lu as p_lu
from parsec_tpu_torch.models import tiled_gemm as p_gemm
from parsec_tpu_torch.runtime import Context as PContext
from parsec_tpu_torch.runtime.task import Dep as PDep

JAX = types.SimpleNamespace(
    name="jax", an=j_analysis, ptg=j_ptg, Dict=JDict, Sym=JSym, BC=JBC,
    Tiled=JTiled, chol=j_chol, lu=j_lu, gemm=j_gemm, Dep=JDep,
    Context=JContext, DTD=JDTDTaskpool, INPUT=J_INPUT, INOUT=J_INOUT)
PORT = types.SimpleNamespace(
    name="port", an=analysis, ptg=p_ptg, Dict=PDict, Sym=PSym, BC=PBC,
    Tiled=PTiled, chol=p_chol, lu=p_lu, gemm=p_gemm, Dep=PDep,
    Context=PContext, DTD=PDTDTaskpool, INPUT=P_INPUT, INOUT=P_INOUT)


@pytest.fixture
def port_param():
    """Scoped override of the port's params, restored at test exit."""
    saved = {}

    def set_(name, value):
        saved.setdefault(name, params.get(name))
        params.set(name, value)

    yield set_
    for name, value in saved.items():
        params.set(name, value)


def _findings(report):
    return sorted((f.code, f.severity, f.task_class, f.flow,
                   tuple(sorted(f.instance.items())) if f.instance else None,
                   f.count) for f in report.findings)


def _same_reports(jr, pr):
    assert (pr.ntasks, pr.nedges, pr.truncated) \
        == (jr.ntasks, jr.nedges, jr.truncated)
    assert _findings(pr) == _findings(jr)
    assert pr.graph == jr.graph


# ---------------------------------------------------------------------------
# every pool builder: the port's findings are the JAX package's
# ---------------------------------------------------------------------------

MODELS = ["cholesky", "lu", "pingpong", "reduction", "stencil1d",
          "stencil2d", "tiled_gemm", "all2all", "llm_prefill",
          "llm_decode_k", "llm_decode_spec", "llm_decode_spec_batched",
          "comm_bcast", "comm_reduce"]


@pytest.mark.parametrize("nt", [3, 5])
@pytest.mark.parametrize("name", MODELS)
def test_model_graphs_match_the_jax_package(name, nt):
    jtp = dict(j_model_graphs(nt))[name]
    ptp = dict(_model_graphs(nt))[name]
    jr = j_analysis.check_ptg(jtp)
    pr = analysis.check_ptg(ptp)
    _same_reports(jr, pr)
    assert pr.ok and pr.ntasks > 0


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_four_rank_grids_match_the_jax_package(kind):
    """The factorizations on a 2 x 2 block-cyclic grid, rank 0's view,
    checked for 4 ranks: affinities resolve inside the grid."""
    def build(pkg):
        n, nb = 64, 16
        if kind == "cholesky":
            A = pkg.Sym.from_dense("A", p_chol.make_spd(n, seed=1), nb, nb,
                                   P=2, Q=2, myrank=0)
            return pkg.chol.tiled_cholesky_ptg(A, devices="cpu")
        A = pkg.BC.from_dense("A", p_lu.make_dd(n, seed=1), nb, nb, P=2,
                              Q=2, myrank=0)
        return pkg.lu.tiled_lu_ptg(A, devices="cpu")

    jr = j_analysis.check_ptg(build(JAX), nb_ranks=4)
    pr = analysis.check_ptg(build(PORT), nb_ranks=4)
    _same_reports(jr, pr)
    assert pr.ok


def _dtd_gemm(pkg, nt=3, nb=8, oob=False):
    """The DTD GEMM by ``nt**3`` insertions on a pool enqueued in a
    caller-driven context; with ``oob`` one more task touches a tile
    outside a declared key space.  Returns (context, pool)."""
    rng = np.random.RandomState(5)
    a = rng.randn(nt * nb, nt * nb).astype(np.float32)
    b = rng.randn(nt * nb, nt * nb).astype(np.float32)
    A = pkg.Tiled.from_dense("A", a, nb, nb)
    B = pkg.Tiled.from_dense("B", b, nb, nb)
    C = pkg.Tiled.from_dense("C", np.zeros_like(a), nb, nb)
    ctx = pkg.Context(nb_cores=0)
    tp = pkg.DTD("dtd_gemm")
    ctx.add_taskpool(tp)

    def body(x, y, c):
        c += x @ y

    for m in range(nt):
        for n in range(nt):
            for k in range(nt):
                tp.insert_task(body, (tp.tile_of(A, m, k), pkg.INPUT),
                               (tp.tile_of(B, k, n), pkg.INPUT),
                               (tp.tile_of(C, m, n), pkg.INOUT),
                               name="gemm")
    if oob:
        D = pkg.Dict("D", init_fn=lambda *k: np.zeros(4, np.float32),
                     keys=[(0,), (1,)])
        tp.insert_task(lambda x: None, (tp.tile_of(D, 5), pkg.INOUT),
                       name="oob")
    return ctx, tp


def test_dtd_gemm_matches_the_jax_package():
    reports = {}
    for pkg in (JAX, PORT):
        ctx, tp = _dtd_gemm(pkg)
        try:
            reports[pkg.name] = (pkg.an.check_dtd(tp), tp.validate())
            tp.close()
            ctx.wait(timeout=60)
            reports[pkg.name] += (pkg.an.check_dtd(tp),)
        finally:
            ctx.abort()
    for jr, pr in zip(reports["jax"], reports["port"]):
        assert (pr.ntasks, pr.nedges) == (jr.ntasks, jr.nedges)
        assert _findings(pr) == _findings(jr) == []


def test_dtd_out_of_range_tile_matches_the_jax_package():
    reports = {}
    for pkg in (JAX, PORT):
        ctx, tp = _dtd_gemm(pkg, oob=True)
        try:
            reports[pkg.name] = pkg.an.check_dtd(tp)
        finally:
            ctx.abort()
    assert _findings(reports["port"]) == _findings(reports["jax"])
    f = reports["port"].errors[0]
    assert (f.code, f.task_class, f.instance) \
        == ("tile-out-of-range", "dtd", {"tile": (5,)})


def test_a_spilled_kv_page_stays_in_range():
    """A page spilled to the host tier is still in its block table, so
    ``has_key`` (the oracle of ``tile-out-of-range``) still answers
    True, as the JAX package's does; a page past the table does not."""
    from parsec_tpu.data_dist.paged_kv import PagedKVCollection as JKV
    from parsec_tpu_torch.data_dist.kv_tiers import KVTierMap
    from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection as PKV
    answers = {}
    for name, cls in (("jax", JKV), ("port", PKV)):
        kv = cls("KV", page_size=4, num_heads=2, head_dim=4)
        kv.alloc_seq("s")
        for _ in range(3):
            kv.alloc_page("s")
        if name == "port":
            tiers = KVTierMap(kv)
            d = kv.data_of("s", 1)
            tiers.note_spill(d, 4 * 2 * 4 * 3 * 4)
            assert tiers.spills == 1
        answers[name] = [kv.has_key("s", p) for p in range(5)] \
            + [kv.has_key("t", 0), kv.has_key("s")]
    assert answers["port"] == answers["jax"] \
        == [True, True, True, False, False, False, False]


# ---------------------------------------------------------------------------
# detection power: one seeded mutation per finding class, in both packages
# ---------------------------------------------------------------------------


def _cholesky(pkg, nt=5, P=1, Q=1):
    A = pkg.Sym("A", nt * 16, nt * 16, 16, 16, P=P, Q=Q)
    return pkg.chol.tiled_cholesky_ptg(A, devices="cpu")


def _flow(tp, cls, name):
    return next(f for f in tp.task_class(cls).flows if f.name == name)


def _chain(pkg, name="chain", nb=4, access=None, seed_input=True):
    """T(i), i < NB: flow V threads T(i-1) -> T(i), T(0) reads D(0) and
    the last writes D(1) back."""
    ptg = pkg.ptg
    D = pkg.Dict("D", init_fn=lambda *k: np.zeros(4, np.float32),
                 keys=[(0,), (1,)])
    p = ptg.PTGBuilder(name, NB=nb, D=D)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.NB - 1))
    f = t.flow("V", access if access is not None else ptg.RW)
    if seed_input:
        f.input(data=("D", lambda g, l: 0), guard=lambda g, l: l.i == 0)
    f.input(pred=("T", "V", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "V", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.NB - 1)
    f.output(data=("D", lambda g, l: 1), guard=lambda g, l: l.i == g.NB - 1)
    t.body(lambda es, task, g, l: None)
    return p, t


def _fan_out(pkg, same_tile):
    """P reads D(0) and hands its one copy to W(0) and W(1), which both
    write it (RW) and write back D(1 + j), or both D(1)."""
    ptg = pkg.ptg
    D = pkg.Dict("D", init_fn=lambda *k: np.zeros(4, np.float32),
                 keys=[(0,), (1,), (2,)])
    p = ptg.PTGBuilder("fan", D=D)
    src = p.task("P", z=ptg.span(0, 0))
    f = src.flow("V", ptg.RW)
    f.input(data=("D", lambda g, l: 0))
    f.output(succ=("W", "V", lambda g, l: [{"j": 0}, {"j": 1}]))
    src.body(lambda es, task, g, l: None)
    w = p.task("W", j=ptg.span(0, 1))
    fw = w.flow("V", ptg.RW)
    fw.input(pred=("P", "V", lambda g, l: {"z": 0}))
    fw.output(data=("D", (lambda g, l: 1) if same_tile
                    else (lambda g, l: 1 + l.j)))
    w.body(lambda es, task, g, l: None)
    return p.build()


def _mut_missing_input_edge(pkg):
    tp = _cholesky(pkg)
    _flow(tp, "GEMM", "A").deps_in.clear()
    return tp, {}


def _mut_missing_output_edge(pkg):
    tp = _cholesky(pkg)
    fT = _flow(tp, "POTRF", "T")
    fT.deps_out = [d for d in fT.deps_out if d.target_class != "TRSM"]
    return tp, {}


def _mut_dangling_input(pkg):
    p, _t = _chain(pkg)
    tp = p.build()
    # T(0)'s chain input is now active: it names T(-1)
    _flow(tp, "T", "V").deps_in[1].guard = None
    return tp, {}


def _mut_dependency_cycle(pkg):
    tp = _cholesky(pkg)
    _flow(tp, "GEMM", "C").deps_out.append(pkg.Dep(
        target_class="GEMM", target_flow="C",
        target_params=lambda l: {"m": l["m"], "n": l["n"], "k": l["k"] - 1},
        guard=lambda l: l["k"] > 0))
    return tp, {}


def _mut_ctl_data_mismatch(pkg):
    ptg = pkg.ptg
    p = ptg.PTGBuilder("ctl", NB=3)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.NB - 1))
    c = t.flow("C", ptg.CTL)
    c.output(succ=("U", "V", lambda g, l: {"i": l.i}))
    t.body(lambda es, task, g, l: None)
    u = p.task("U", i=ptg.span(0, lambda g, l: g.NB - 1))
    v = u.flow("V", ptg.RW)
    v.input(pred=("T", "C", lambda g, l: {"i": l.i}))
    u.body(lambda es, task, g, l: None)
    return p.build(), {}


def _mut_write_flow_receives_input(pkg):
    p, _t = _chain(pkg, access=pkg.ptg.WRITE)
    return p.build(), {}


def _mut_no_input_source(pkg):
    p, _t = _chain(pkg, seed_input=False)
    return p.build(), {}


def _mut_read_chain_never_written(pkg):
    tp = _cholesky(pkg)
    _flow(tp, "GEMM", "C").access = pkg.ptg.READ
    return tp, {}


def _mut_unordered_shared_write(pkg):
    return _fan_out(pkg, same_tile=False), {}


def _mut_unordered_writeback(pkg):
    return _fan_out(pkg, same_tile=True), {}


def _mut_tile_out_of_range(pkg):
    tp = _cholesky(pkg)
    po = tp.task_class("POTRF")
    orig = po.affinity
    po.affinity = lambda l: (orig(l)[0], (l["k"], l["k"] + 99))
    return tp, {}


def _mut_rank_out_of_range(pkg):
    # a 2 x 2 grid's ranks 2 and 3 lie outside a 2-rank check
    return _cholesky(pkg, 4, P=2, Q=2), {"nb_ranks": 2}


def _mut_class_without_affinity(pkg):
    p, _t = _chain(pkg)
    return p.build(), {"nb_ranks": 2}


def _mut_edge_eval_error(pkg):
    ptg = pkg.ptg
    p = ptg.PTGBuilder("bad", NB=4)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.NB - 1))
    f = t.flow("V", ptg.RW)
    f.input(null=True)
    f.output(succ=("T", "V", lambda g, l: {"i": l.i + g.TYPO}),
             guard=lambda g, l: l.i < g.NB - 1)
    t.body(lambda es, task, g, l: None)
    return p.build(), {}


def _mut_no_startup_task(pkg):
    ptg = pkg.ptg
    p = ptg.PTGBuilder("stuck", NB=3)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.NB - 1))
    f = t.flow("V", ptg.RW)
    f.input(pred=("T", "V", lambda g, l: {"i": (l.i - 1) % g.NB}))
    f.output(succ=("T", "V", lambda g, l: {"i": (l.i + 1) % g.NB}))
    t.body(lambda es, task, g, l: None)
    return p.build(), {}


def _mut_dead_flow(pkg):
    p, t = _chain(pkg)
    x = t.flow("X", pkg.ptg.CTL)
    x.output(succ=("T", "X", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: False)
    return p.build(), {}


# code -> (mutation, severity, expected provenance (class, flow, instance))
MUTATIONS = {
    "missing-input-edge": (_mut_missing_input_edge, "error",
                           ("TRSM", "C", {"m": 2, "k": 0})),
    "missing-output-edge": (_mut_missing_output_edge, "error",
                            ("TRSM", "T", {"m": 1, "k": 0})),
    "dangling-input": (_mut_dangling_input, "error", ("T", "V", {"i": 0})),
    "dependency-cycle": (_mut_dependency_cycle, "error", ("GEMM", None,
                                                          None)),
    "ctl-data-mismatch": (_mut_ctl_data_mismatch, "error",
                          ("T", "C", {"i": 0})),
    "write-flow-receives-input": (_mut_write_flow_receives_input, "error",
                                  ("T", "V", {"i": 0})),
    "no-input-source": (_mut_no_input_source, "error", ("T", "V", {"i": 0})),
    "read-chain-never-written": (_mut_read_chain_never_written, "error",
                                 ("GEMM", "C", None)),
    "unordered-shared-write": (_mut_unordered_shared_write, "warning",
                               ("W", None, None)),
    "unordered-writeback": (_mut_unordered_writeback, "error",
                            ("W", None, None)),
    "tile-out-of-range": (_mut_tile_out_of_range, "error",
                          ("POTRF", None, {"k": 0})),
    "rank-out-of-range": (_mut_rank_out_of_range, "error", (None, None,
                                                            None)),
    "class-without-affinity": (_mut_class_without_affinity, "warning",
                               ("T", None, None)),
    "edge-eval-error": (_mut_edge_eval_error, "error", ("T", "V", {"i": 0})),
    "no-startup-task": (_mut_no_startup_task, "error", (None, None, None)),
    "dead-flow": (_mut_dead_flow, "warning", ("T", "X", None)),
}


def test_the_mutations_cover_every_finding_class():
    lines = analysis.graphcheck.__doc__.splitlines()
    rules = [i for i, line in enumerate(lines) if line.startswith("=====")]
    codes = {line.split()[0].strip("`")
             for line in lines[rules[0] + 1:rules[1]]
             if line.startswith("``")}
    assert codes == set(MUTATIONS) and len(MUTATIONS) == 16


@pytest.mark.parametrize("code", sorted(MUTATIONS))
def test_each_mutation_is_caught_with_the_jax_packages_provenance(code):
    mutate, severity, (cls, flow, inst) = MUTATIONS[code]
    reports = {}
    for pkg in (JAX, PORT):
        tp, kw = mutate(pkg)
        reports[pkg.name] = pkg.an.check_ptg(tp, **kw)
    jr, pr = reports["jax"], reports["port"]
    assert _findings(pr) == _findings(jr)
    hits = [f for f in pr.findings if f.code == code]
    assert hits, pr.findings
    first = hits[0]
    assert first.severity == severity
    if cls is not None:
        assert first.task_class == cls
    if flow is not None:
        assert first.flow == flow
    if inst is not None:
        assert first.instance == inst
    jfirst = next(f for f in jr.findings if f.code == code)
    assert (first.task_class, first.flow, first.instance, first.message) \
        == (jfirst.task_class, jfirst.flow, jfirst.instance, jfirst.message)
    if severity == "error":
        assert not pr.ok
        with pytest.raises(GraphCheckError, match=code):
            pr.raise_if_failed()


def test_the_cycle_and_the_dropped_edge_name_their_ends():
    tp, _ = _mut_dependency_cycle(PORT)
    f = next(f for f in analysis.check_ptg(tp).errors
             if f.code == "dependency-cycle")
    assert "GEMM" in f.message and "->" in f.message
    tp, _ = _mut_missing_input_edge(PORT)
    f = next(f for f in analysis.check_ptg(tp).errors
             if f.code == "missing-input-edge")
    assert "GEMM" in f.message       # names the consumer it lands on


def test_a_truncated_enumeration_stays_clean():
    report = analysis.check_ptg(_cholesky(PORT, 5), max_tasks=3)
    j_report = j_analysis.check_ptg(_cholesky(JAX, 5), max_tasks=3)
    assert report.truncated and report.ok, report.findings
    assert "truncated" in report.summary()
    assert _findings(report) == _findings(j_report)


# ---------------------------------------------------------------------------
# the hooks: validate(), the enqueue gate, DTD's close()
# ---------------------------------------------------------------------------


def test_validate_returns_the_report_or_raises():
    good = _cholesky(PORT)
    assert good.validate().ok
    tp, _ = _mut_missing_input_edge(PORT)
    report = tp.validate(raise_on_error=False)
    assert not report.ok
    assert {f.code for f in report.errors} >= {"missing-input-edge"}
    with pytest.raises(GraphCheckError) as ei:
        tp.validate()
    assert ei.value.report.name == tp.name
    assert _findings(ei.value.report) == _findings(report)
    with pytest.raises(GraphCheckError):
        analysis.check_taskpool(tp, raise_on_error=True)
    with pytest.raises(TypeError):
        analysis.check_taskpool(object())


def _gemm_missing_chain(nt=2, nb=8, devices="cpu"):
    """The dynamic GEMM with GEMM.C's chain input dropped: the k-chain's
    output arrow lands on no input (missing-input-edge)."""
    rng = np.random.RandomState(3)
    a = rng.randn(nt * nb, nt * nb).astype(np.float32)
    A = PTiled.from_dense("A", a, nb, nb)
    B = PTiled.from_dense("B", a.T.copy(), nb, nb)
    C = PTiled("C", nt * nb, nt * nb, nb, nb)
    tp = p_gemm.tiled_gemm_ptg(A, B, C, devices=devices)
    fC = _flow(tp, "GEMM", "C")
    fC.deps_in = [d for d in fC.deps_in if d.target_class is None]
    return tp, (a, A, B, C)


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


def test_the_gate_raises_before_any_side_effect(port_param, cpu_cuda_device):
    """Under ``analysis_check`` a malformed pool raises from
    ``add_taskpool`` with the finding's provenance, and leaves the
    context as it was: no pool, no comm id, no detector, no task run on
    the device module.  A sound pool then runs in the same context."""
    port_param("analysis_check", True)
    bad, _ = _gemm_missing_chain(devices="cuda")
    ctx = PContext(nb_cores=0)
    try:
        ids = ctx._next_comm_id
        with pytest.raises(GraphCheckError) as ei:
            ctx.add_taskpool(bad)
        hit = next(f for f in ei.value.findings
                   if f.code == "missing-input-edge")
        assert (hit.task_class, hit.flow) == ("GEMM", "C")
        assert hit.instance == {"m": 0, "n": 0, "k": 0}
        assert ctx.test() and not ctx._active_taskpools
        assert ctx._next_comm_id == ids
        assert bad.context is None and bad.tdm is None
        assert cpu_cuda_device.executed_tasks == 0
        _, (a, A, B, C) = _gemm_missing_chain(devices="cuda")
        good = p_gemm.tiled_gemm_ptg(A, B, C, devices="cuda")
        ctx.add_taskpool(good)
        ctx.wait(timeout=60)
        np.testing.assert_allclose(C.to_dense(), a @ a.T, rtol=1e-4,
                                   atol=1e-4)
        assert cpu_cuda_device.executed_tasks == 8
    finally:
        ctx.abort()


def test_the_gate_is_off_by_default():
    assert params.get("analysis_check") is False
    bad, _ = _gemm_missing_chain()
    ctx = PContext(nb_cores=0)
    try:
        ctx.add_taskpool(bad)      # enqueued: the check did not run
        assert bad.context is ctx
    finally:
        ctx.abort()


def test_dtd_close_validates_under_the_gate(port_param):
    port_param("analysis_check", True)
    ctx, tp = _dtd_gemm(PORT, nt=2, oob=True)
    try:
        with pytest.raises(GraphCheckError, match="tile-out-of-range"):
            tp.close()
    finally:
        ctx.abort()
    ctx, tp = _dtd_gemm(PORT, nt=2)
    try:
        tp.close()                 # a sound pool closes
        ctx.wait(timeout=60)
        assert tp.validate().ok
    finally:
        ctx.abort()


def test_the_iterators_checker_is_reexported():
    from parsec_tpu_torch.prof import iterators_checker
    assert analysis.check_task is iterators_checker.check_task
    assert analysis.IteratorsCheckerError \
        is iterators_checker.IteratorsCheckerError
    with pytest.raises(AttributeError):
        analysis.no_such_name   # noqa: B018


def test_the_cli_prints_an_ok_line_for_every_graph(capsys):
    assert cli_main(["--nt", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    names = [tp.name for _n, tp in _model_graphs(3)]
    # the default run is the graph sweep, then the self-lint's line
    assert len(lines) - 1 == len(names) == 16
    for line, name in zip(lines, names):
        assert line.startswith(f"graphcheck {name}: OK"), line
    assert lines[-1].startswith("runtimelint: OK"), lines[-1]
    assert cli_main(["--graph", "cholesky", "--ranks", "1", "-v"]) == 0
    assert capsys.readouterr().out.startswith("graphcheck cholesky: OK")


def test_the_cli_fails_on_an_unknown_model():
    with pytest.raises(SystemExit):
        cli_main(["--graph", "no_such_model"])


def test_check_is_read_only():
    """A check runs no body and leaves the tiles as they were."""
    calls = []
    ptg = PORT.ptg
    p = ptg.PTGBuilder("probe", NB=3)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.NB - 1))
    f = t.flow("V", ptg.RW)
    f.input(null=True)
    t.body(lambda es, task, g, l: calls.append(l.i))
    A = PTiled.from_dense("A", torch.ones(8, 8).numpy(), 4, 4)
    before = A.to_dense().copy()
    analysis.check_ptg(p.build())
    analysis.check_ptg(p_gemm.tiled_gemm_ptg(A, A, PTiled("C", 8, 8, 4, 4),
                                             devices="cpu"))
    assert calls == []
    np.testing.assert_array_equal(A.to_dense(), before)

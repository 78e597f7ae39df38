"""The port's megakernel regions (``parsec_tpu_torch/analysis/regions.py``
and ``ptg/lowering.py:lower_regions``) against the JAX package's.

Region selection is pure Python over graphcheck's retained graph, so the
port's regions, members, levels and region DAG must EQUAL the JAX
package's on every pool both CLIs build (``_model_graphs``: the tiled
GEMM, Cholesky, LU, both stencils, the prefill, k-step decode and both
speculative pools, the collective trees) at several ``max_tasks``.
``lower_regions`` must give the JAX region DAG, row-conflict
(anti-dependency) edges included.  Then the slice on the host
(``device="cpu"``): the region Cholesky and LU against the JAX region
factor, the port's dynamic path and float64; the region decode (a
one-step superpool) and k-step superpools against the JAX tokens and the
oracle; the compile budget, the lowering cache, the refusals, the region
pool under graphcheck and on worker threads, ``warm_cache`` and its CLI,
and the batcher's ``llm_lower_regions``.

Tolerances: factors against the JAX region factor and the port's dynamic
factor within 1e-5 abs (fp32 both sides, only the summation order
differs), against float64 at ``rtol=1e-3, atol=1e-4`` (the JAX test's);
attention outputs and tail pages within 1e-5 abs; tokens exactly.
"""

import json
from unittest import mock

import numpy as np
import pytest
import torch

from parsec_tpu.analysis import check_ptg as j_check
from parsec_tpu.analysis import select_regions as j_select
from parsec_tpu.analysis import task_levels as j_levels
from parsec_tpu.analysis.__main__ import _model_graphs as j_model_graphs
from parsec_tpu.analysis.regions import regions_of_report as j_of_report
from parsec_tpu.data.datatype import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.data_dist.paged_kv import PagedKVCollection as JPagedKV
from parsec_tpu.llm import ToyLM as JToyLM
from parsec_tpu.llm import decode as jdec
from parsec_tpu.models import cholesky as j_chol
from parsec_tpu.models import lu as j_lu
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm
from parsec_tpu.ptg.lowering import lower_regions as j_lower_regions
from parsec_tpu.runtime import Context as j_Context
import parsec_tpu_torch.llm as p_llm
import parsec_tpu_torch.ops.ragged_attention  # noqa: F401 — traceables
from parsec_tpu_torch import ptg
from parsec_tpu_torch.analysis import (GraphCheckError, check_ptg,
                                       select_regions, task_levels)
from parsec_tpu_torch.analysis.__main__ import _model_graphs
from parsec_tpu_torch.analysis.regions import regions_of_report
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic as PSym
from parsec_tpu_torch.data_dist.matrix import TiledMatrix as PTiled
from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.llm import ToyLM
from parsec_tpu_torch.llm import decode as pdec
from parsec_tpu_torch.models import cholesky as p_chol
from parsec_tpu_torch.models import lu as p_lu
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.ptg import lowering
from parsec_tpu_torch.ptg.lowering import (LoweringError, lower_regions,
                                           lowering_cache)
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.serve import RuntimeServer

JMODEL = JToyLM()
MODEL = ToyLM()
H, D = MODEL.num_heads, MODEL.head_dim
TOL = 1e-5


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
def cpu_cuda_device():
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def _view(regs) -> list:
    return [(r.index, r.members, r.level_lo, r.level_hi, sorted(r.preds),
             sorted(r.succs)) for r in regs]


# ---------------------------------------------------------------------------
# region selection
# ---------------------------------------------------------------------------

def _diamond():
    # a -> b, c -> d, plus an isolated 2-chain x -> y
    return {("A", (0,)): [("B", (0,)), ("C", (0,))],
            ("B", (0,)): [("D", (0,))], ("C", (0,)): [("D", (0,))],
            ("D", (0,)): [], ("X", (0,)): [("Y", (0,))], ("Y", (0,)): []}


def test_task_levels_of_the_diamond_equal_the_jax_levels():
    lv = task_levels(_diamond())
    assert lv == j_levels(_diamond())
    assert lv[("D", (0,))] == 2 and lv[("Y", (0,))] == 1


@pytest.mark.parametrize("max_tasks", [0, 1, 2, 3])
def test_diamond_regions_equal_the_jax_regions(max_tasks):
    regs = select_regions(_diamond(), max_tasks=max_tasks)
    assert _view(regs) == _view(j_select(_diamond(), max_tasks=max_tasks))
    assert sorted(n for r in regs for n in r.members) == sorted(_diamond())
    for r in regs:
        assert r.ntasks <= max_tasks or max_tasks == 0 \
            or r.level_lo == r.level_hi


def test_a_cycle_raises_in_both_packages():
    adj = {("A", (0,)): [("B", (0,))], ("B", (0,)): [("A", (0,))]}
    for levels in (task_levels, j_levels):
        with pytest.raises(ValueError, match="cycle"):
            levels(adj)


@pytest.mark.parametrize("truncated,ntasks,match", [
    (True, 0, "truncated"), (False, 7, "no concrete task graph")])
def test_reports_regions_refuse_raise_in_both_packages(truncated, ntasks,
                                                       match):
    class Fake:
        ok = True
        name = "fake"
        graph: dict = {}
    Fake.truncated, Fake.ntasks = truncated, ntasks
    for of_report in (regions_of_report, j_of_report):
        with pytest.raises(ValueError, match=match):
            of_report(Fake())


SHARED = ["cholesky", "lu", "pingpong", "reduction", "stencil1d",
          "stencil2d", "tiled_gemm", "all2all", "llm_prefill",
          "llm_decode_k", "llm_decode_spec", "llm_decode_spec_batched",
          "comm_bcast", "comm_reduce"]


@pytest.mark.parametrize("max_tasks", [0, 4, 16])
@pytest.mark.parametrize("name", SHARED)
def test_regions_of_every_pool_equal_the_jax_regions(name, max_tasks):
    jr = j_check(dict(j_model_graphs(4))[name])
    pr = check_ptg(dict(_model_graphs(4))[name])
    assert pr.ok and pr.graph == jr.graph
    assert task_levels(pr.graph) == j_levels(jr.graph)
    regs = pr.select_regions(max_tasks=max_tasks)
    assert _view(regs) == _view(jr.select_regions(max_tasks=max_tasks))
    assert sum(r.ntasks for r in regs) == pr.ntasks


# ---------------------------------------------------------------------------
# lower_regions: the region DAG, anti-dependency edges included
# ---------------------------------------------------------------------------

def _card_chores(f):
    def g(*a, **kw):
        kw["devices"] = "cuda"
        return f(*a, **kw)
    return g


def _lowerable(pkg: str, name: str, nt: int = 4, nb: int = 4):
    """Each package's pool with the chores that name its traceables: the
    dense pools with their default chores, the others from each CLI's
    builders (the port's LLM pools with the card's chores)."""
    if name in ("tiled_gemm", "cholesky", "lu"):
        n = nt * nb
        rng = np.random.default_rng(0)
        a = rng.standard_normal((n, n)).astype(np.float32)
        spd, dd = j_chol.make_spd(n), j_lu.make_dd(n)
        if pkg == "jax":
            return {"tiled_gemm": lambda: j_gemm(
                        JTiled.from_dense("A", a, nb, nb),
                        JTiled.from_dense("B", a, nb, nb),
                        JTiled.from_dense("C", a, nb, nb)),
                    "cholesky": lambda: j_chol.tiled_cholesky_ptg(
                        JSym.from_dense("A", spd, nb, nb)),
                    "lu": lambda: j_lu.tiled_lu_ptg(
                        JTiled.from_dense("A", dd, nb, nb))}[name]()
        return {"tiled_gemm": lambda: tiled_gemm_ptg(
                    PTiled.from_dense("A", a, nb, nb),
                    PTiled.from_dense("B", a, nb, nb),
                    PTiled.from_dense("C", a, nb, nb)),
                "cholesky": lambda: p_chol.tiled_cholesky_ptg(
                    PSym.from_dense("A", spd, nb, nb)),
                "lu": lambda: p_lu.tiled_lu_ptg(
                    PTiled.from_dense("A", dd, nb, nb))}[name]()
    if pkg == "jax":
        return dict(j_model_graphs(nt))[name]
    names = ("prefill_ptg", "decode_superpool_ptg", "spec_superpool_ptg",
             "spec_batched_ptg")
    with mock.patch.multiple(p_llm, **{n: _card_chores(getattr(p_llm, n))
                                       for n in names}):
        return dict(_model_graphs(nt))[name]


LOWERED = ["tiled_gemm", "cholesky", "lu", "stencil1d", "stencil2d",
           "llm_prefill", "llm_decode_k", "llm_decode_spec",
           "llm_decode_spec_batched"]


@pytest.mark.parametrize("max_tasks", [0, 6])
@pytest.mark.parametrize("name", LOWERED)
def test_lower_regions_gives_the_jax_region_dag(name, max_tasks):
    jplan = j_lower_regions(_lowerable("jax", name), max_tasks=max_tasks)
    plan = lower_regions(_lowerable("port", name), max_tasks=max_tasks,
                         device="cpu")

    def dag(p):
        return [(r.index, r.ntasks, r.level_lo, r.level_hi, sorted(r.preds),
                 sorted(r.succs), r.step_fn is None,
                 sorted((nm, len(rows)) for nm, rows in r.touched.items()))
                for r in p.regions]

    assert dag(plan) == dag(jplan)
    # the anti-dependency edges: the region DAG holds every task edge
    # between regions, and possibly more
    task_edges = {(p, r.index) for r in plan.regions for p in r.preds}
    sel = check_ptg(_lowerable("port", name)).select_regions(max_tasks)
    assert {(p, r.index) for r in sel for p in r.preds} <= task_edges
    assert plan.stats()["ntasks"] == jplan.stats()["ntasks"]


def test_the_region_dag_carries_an_anti_dependency_edge():
    """nt=5 with cap 8 splits the Cholesky into bands whose row
    conflicts add region edges beyond the task edges (as in JAX)."""
    kw = dict(max_tasks=8)
    a = j_chol.make_spd(160)
    jplan = j_lower_regions(j_chol.tiled_cholesky_ptg(
        JSym.from_dense("A", a, 32, 32)), **kw)
    plan = lower_regions(p_chol.tiled_cholesky_ptg(
        PSym.from_dense("A", a, 32, 32)), device="cpu", **kw)
    rep = check_ptg(p_chol.tiled_cholesky_ptg(PSym.from_dense("A", a, 32,
                                                              32)))
    task = {(p, r.index) for r in rep.select_regions(8) for p in r.preds}
    full = {(p, r.index) for r in plan.regions for p in r.preds}
    assert full == {(p, r.index) for r in jplan.regions for p in r.preds}
    assert full > task


# ---------------------------------------------------------------------------
# factors on the host: port region == JAX region == port dynamic
# ---------------------------------------------------------------------------

def _chol_dynamic(a, nb):
    A = PSym.from_dense("A", a.copy(), nb, nb)
    with Context(nb_cores=0) as ctx:
        ctx.add_taskpool(p_chol.tiled_cholesky_ptg(A, devices="cpu"))
        ctx.wait(timeout=120)
    return np.tril(np.asarray(A.to_dense()))


@pytest.mark.parametrize("n,nb,max_tasks", [
    (64, 16, 0), (96, 32, 0), (128, 32, 6), (160, 32, 8)])
def test_region_cholesky_matches_jax_and_the_dynamic_path(n, nb, max_tasks):
    a = j_chol.make_spd(n)
    JA = JSym.from_dense("A", a.copy(), nb, nb)
    j_lower_regions(j_chol.tiled_cholesky_ptg(JA),
                    max_tasks=max_tasks).execute()
    A = PSym.from_dense("A", a.copy(), nb, nb)
    plan = lower_regions(p_chol.tiled_cholesky_ptg(A), max_tasks=max_tasks,
                         device="cpu")
    plan.execute()
    got = np.tril(np.asarray(A.to_dense()))
    assert np.abs(got - np.tril(JA.to_dense())).max() <= TOL
    assert np.abs(got - _chol_dynamic(a, nb)).max() <= TOL
    expect = np.linalg.cholesky(a.astype(np.float64))
    np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-4)
    st = plan.stats()
    assert st["ntasks"] == (n // nb) * (n // nb + 1) * (n // nb + 2) // 6
    assert st["xla_calls"] == sum(r.step_fn is not None
                                  for r in plan.regions)


def test_region_lu_matches_the_jax_region_lu():
    n, nb = 96, 16
    dd = j_lu.make_dd(n)
    JA = JTiled.from_dense("A", dd.copy(), nb, nb)
    j_lower_regions(j_lu.tiled_lu_ptg(JA), max_tasks=12).execute()
    A = PTiled.from_dense("A", dd.copy(), nb, nb)
    plan = lower_regions(p_lu.tiled_lu_ptg(A), max_tasks=12, device="cpu")
    assert len(plan.regions) > 1
    plan.execute()
    assert np.abs(np.asarray(A.to_dense()) - JA.to_dense()).max() <= TOL


# ---------------------------------------------------------------------------
# the decode and k-step superpools, region-lowered
# ---------------------------------------------------------------------------

def _prompts(seed, n, lo=2, hi=30):
    rng = np.random.default_rng(seed)
    return {f"s{i}": [int(t) for t in rng.integers(0, MODEL.vocab,
                                                   int(rng.integers(lo, hi)))]
            for i in range(n)}


def _jax_superpool(prompts, steps):
    kv = JPagedKV("KV", page_size=4, num_heads=H, head_dim=D)
    Q = JDict("Q", dtt=JTileType((3, H, D), np.float32))
    O = JDict("O", dtt=JTileType((H, D), np.float32))
    TOK = JDict("TOK", dtt=JTileType((3,), np.float32))
    EMB = JDict("EMB", dtt=JTileType(JMODEL.q3_table().shape, np.float32))
    jdec.seed_decode_superpool(JMODEL, kv, Q, TOK, EMB, prompts, steps)
    tp = jdec.decode_superpool_ptg(kv, Q, O, TOK, EMB, list(prompts),
                                   [steps[s] for s in prompts],
                                   devices="auto")
    return kv, O, TOK, tp


def _port_superpool(prompts, steps):
    kv = PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D)
    Q = DictCollection("Q", dtt=TileType((3, H, D)))
    O = DictCollection("O", dtt=TileType((H, D)))
    TOK = DictCollection("TOK", dtt=TileType((3,)))
    EMB = DictCollection("EMB", dtt=TileType(tuple(MODEL.q3_table().shape)))
    pdec.seed_emb_table(MODEL, EMB)
    for seq, prompt in prompts.items():
        kv.alloc_seq(seq)
        for key, tile in pdec.prefill_chunks(MODEL, kv, seq,
                                             prompt[:-1]).items():
            pg = kv.data_of(*key).get_copy(0)
            pg.value = tile
            pg.version += 1
        pdec.preallocate_decode_steps(kv, seq, steps[seq])
        pdec.seed_stream_step(MODEL, Q, TOK, seq, prompt[-1])
    tp = pdec.decode_superpool_ptg(kv, Q, O, TOK, EMB, list(prompts),
                                   [steps[s] for s in prompts])
    return kv, O, TOK, tp


@pytest.mark.parametrize("kstep", [False, True])
@pytest.mark.parametrize("max_tasks", [0, 8])
def test_region_superpools_give_the_jax_tokens(kstep, max_tasks):
    """The decode step (a one-step superpool: ATTN -> OUT -> SAMPLE) and
    the k-step superpool (mixed k, page boundaries crossed mid-pool),
    region-lowered in both packages."""
    prompts = _prompts(3, 3)
    steps = (dict(zip(prompts, (5, 4, 2))) if kstep
             else {s: 1 for s in prompts})
    jkv, jO, jTOK, jtp = _jax_superpool(prompts, steps)
    j_lower_regions(jtp, max_tasks=max_tasks).execute()
    kv, O, TOK, tp = _port_superpool(prompts, steps)
    plan = lower_regions(tp, max_tasks=max_tasks, device="cpu")
    if max_tasks == 0:
        assert len(plan.regions) == len(prompts)   # parallel chains
    plan.execute()
    got = pdec.read_token_chains(TOK, steps)
    for seq, prompt in prompts.items():
        assert got[seq] == jdec.read_token_chain(jTOK, seq, steps[seq])
        assert got[seq][0] == MODEL.reference_generate(prompt, steps[seq])
        last = kv.npages(seq) - 1
        assert np.abs(kv.data_of(seq, last).newest_copy().value.numpy()
                      - np.asarray(jkv.data_of(seq, last).newest_copy()
                                   .value)).max() <= TOL
        assert np.abs(O.data_of(seq).newest_copy().value.numpy()
                      - np.asarray(jO.data_of(seq).newest_copy().value)
                      ).max() <= TOL


def test_a_region_pool_writes_back_only_the_rows_it_wrote():
    """Two region superpools over one set of collections, each built and
    its table made before either runs, as the batcher builds one pool a
    tenant: the second pool's completion must leave the first pool's
    tokens alone.  Its stores hold every key the open collections know,
    the first pool's too, as copies from before that pool ran; writing
    them back (the fault this holds) put the first pool's TOK rows back
    to zeros."""
    prompts = _prompts(11, 4)
    steps = {s: 3 for s in prompts}
    kv = PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D)
    Q = DictCollection("Q", dtt=TileType((3, H, D)))
    O = DictCollection("O", dtt=TileType((H, D)))
    TOK = DictCollection("TOK", dtt=TileType((3,)))
    EMB = DictCollection("EMB", dtt=TileType(tuple(MODEL.q3_table().shape)))
    pdec.seed_emb_table(MODEL, EMB)
    for seq, prompt in prompts.items():
        kv.alloc_seq(seq)
        for key, tile in pdec.prefill_chunks(MODEL, kv, seq,
                                             prompt[:-1]).items():
            pg = kv.data_of(*key).get_copy(0)
            pg.value = tile
            pg.version += 1
        pdec.preallocate_decode_steps(kv, seq, steps[seq])
        pdec.seed_stream_step(MODEL, Q, TOK, seq, prompt[-1])
    groups = (list(prompts)[:2], list(prompts)[2:])
    pools = []
    for i, group in enumerate(groups):
        tp = pdec.decode_superpool_ptg(kv, Q, O, TOK, EMB, group,
                                       [steps[s] for s in group],
                                       name=f"llm_decode{i}")
        plan = lower_regions(tp, device="cpu")
        plan.compile()
        pools.append(plan.taskpool(plan.materialize_table()))
    for pool in pools:                     # the first completes first
        with Context(nb_cores=1) as ctx:
            ctx.add_taskpool(pool)
            ctx.wait(timeout=60)
    got = pdec.read_token_chains(TOK, steps)
    for seq, prompt in prompts.items():
        assert got[seq][0] == MODEL.reference_generate(prompt, 3), seq


# ---------------------------------------------------------------------------
# the compile budget and the lowering cache
# ---------------------------------------------------------------------------

def _chol_plan(n=160, nb=32, max_tasks=8):
    a = j_chol.make_spd(n)
    A = PSym.from_dense("A", a.copy(), nb, nb)
    return a, A, lower_regions(p_chol.tiled_cholesky_ptg(A),
                               max_tasks=max_tasks, device="cpu")


def test_a_budget_of_epsilon_sheds_in_ascending_order_and_completes():
    lowering_cache.clear()
    a, A, plan = _chol_plan()
    notes = []
    st = plan.compile(budget_s=1e-9, note=lambda **kw: notes.append(kw))
    data = [r for r in plan.regions if r.step_fn is not None]
    assert st["regions_compiled"] == 0 and st["regions_eager"] == len(data)
    sizes = [n_["ntasks"] for n_ in notes]
    assert sizes == sorted(sizes) and all(n_["eager"] for n_ in notes)
    plan.execute()
    np.testing.assert_allclose(np.tril(np.asarray(A.to_dense())),
                               np.linalg.cholesky(a.astype(np.float64)),
                               rtol=1e-3, atol=1e-4)
    st = plan.stats()
    assert st["xla_calls"] == 0 and st["eager_runs"] == len(data)


def test_the_first_region_fits_and_the_rest_shed_monotonically():
    lowering_cache.clear()
    _a, _A, plan = _chol_plan(max_tasks=6)
    rate = []

    def note(**kw):
        rate.append(kw)
    plan.compile(budget_s=0.5, note=note)
    # the cheap regions measure the rate that guards the expensive ones:
    # once a region is shed every later (as large) region is shed
    eager = [bool(n_.get("eager")) for n_ in rate
             if not n_.get("compiling")]
    if True in eager:
        assert all(eager[eager.index(True):])
    assert plan.stats()["regions_compiled"] >= 1


def test_a_warm_second_compile_prepares_nothing():
    lowering_cache.clear()
    _a, _A, plan = _chol_plan()
    plan.compile()
    assert plan.stats()["regions_compiled"] > 0
    _a2, _A2, plan2 = _chol_plan()
    notes = []
    st = plan2.compile(budget_s=1e-9, note=lambda **kw: notes.append(kw))
    assert st["regions_eager"] == 0
    assert st["regions_compiled"] == plan.stats()["regions_compiled"]
    assert st["compile_s"] == 0.0 and st["trace_s"] == 0.0
    assert notes and all(n_.get("cached") for n_ in notes)
    assert all(r2._exec is r1._exec for r1, r2 in
               zip(plan.regions, plan2.regions) if r1.step_fn is not None)


def test_identical_parallel_regions_share_one_step():
    prompts = {f"s{i}": [3, 7, 11, 5] for i in range(4)}
    _kv, _O, _TOK, tp = _port_superpool(prompts, {s: 2 for s in prompts})
    plan = lower_regions(tp, device="cpu")
    assert len(plan.regions) == 4
    lowering_cache.clear()
    st = plan.compile()
    assert st["regions_compiled"] == 4
    assert lowering_cache.misses == 1 and lowering_cache.hits == 3
    assert len({id(r._exec) for r in plan.regions}) == 1


# ---------------------------------------------------------------------------
# refusals, graphcheck, concurrency
# ---------------------------------------------------------------------------

def test_a_truncated_report_raises_lowering_error(port_param):
    port_param("analysis_max_tasks", 5)
    a = j_chol.make_spd(160)
    with pytest.raises(LoweringError, match="truncated"):
        lower_regions(p_chol.tiled_cholesky_ptg(PSym.from_dense(
            "A", a, 32, 32)), device="cpu")


def test_a_failing_report_raises_graphcheck_error():
    p = ptg.PTGBuilder("bad", N=2)
    ta = p.task("A", i=ptg.span(0, lambda g, l: g.N - 1))
    ta.flow("ctl", ptg.CTL).output(succ=("B", "ctl",
                                         lambda g, l: {"i": l.i}))
    ta.body(lambda es, task, g, l: None)
    tb = p.task("B", i=ptg.span(0, lambda g, l: g.N - 1))
    tb.flow("ctl", ptg.CTL)             # no matching input edge
    tb.body(lambda es, task, g, l: None)
    with pytest.raises(GraphCheckError):
        lower_regions(p.build(), device="cpu")


def test_several_ranks_are_refused():
    class TwoRanks:
        nb_ranks = 2
    _a, A, _plan = _chol_plan()
    with pytest.raises(LoweringError, match="single-rank"):
        lower_regions(p_chol.tiled_cholesky_ptg(A), context=TwoRanks(),
                      device="cpu")


@pytest.mark.parametrize("kind", ["cholesky", "superpool"])
def test_the_region_pool_passes_graphcheck(kind):
    if kind == "cholesky":
        _a, _A, plan = _chol_plan(128, 32, 6)
    else:
        prompts = _prompts(5, 3)
        _kv, _O, _TOK, tp = _port_superpool(
            prompts, dict(zip(prompts, (4, 3, 2))))
        plan = lower_regions(tp, device="cpu")
    plan.compile()
    pool = plan.taskpool(plan.materialize_table())
    report = pool.validate()
    assert not report.errors, report.summary()
    assert pool.region_plan is plan
    assert pool.nb_local_tasks() == len(plan.regions)


@pytest.mark.parametrize("name,max_tasks", [("cholesky", 6), ("lu", 12)])
def test_the_region_pool_fans_in_on_one_ranged_ctl_flow(name, max_tasks):
    """The region pool is the JAX package's: one CTL flow, a ranged
    fan-in from the predecessors, and the same graph under graphcheck;
    run on worker threads it gives the JAX region pool's factor."""
    n, nb = 64, 8
    if name == "cholesky":
        a = j_chol.make_spd(n)
        JA, A = JSym.from_dense("A", a.copy(), nb, nb), \
            PSym.from_dense("A", a.copy(), nb, nb)
        jtp, tp = j_chol.tiled_cholesky_ptg(JA), p_chol.tiled_cholesky_ptg(A)
    else:
        a = j_lu.make_dd(n)
        JA, A = JTiled.from_dense("A", a.copy(), nb, nb), \
            PTiled.from_dense("A", a.copy(), nb, nb)
        jtp, tp = j_lu.tiled_lu_ptg(JA), p_lu.tiled_lu_ptg(A)
    jplan = j_lower_regions(jtp, max_tasks=max_tasks)
    plan = lower_regions(tp, max_tasks=max_tasks, device="cpu")
    jplan.compile()
    plan.compile()
    jpool = jplan.taskpool(jplan.materialize_table())
    pool = plan.taskpool(plan.materialize_table())
    tc, jtc = pool.task_class("REGION"), jpool.task_class("REGION")
    assert [(f.name, f.is_ctl) for f in tc.flows] == \
        [(f.name, f.is_ctl) for f in jtc.flows] == [("ctl", True)]
    assert [d.ranged for d in tc.flows[0].deps_in] == \
        [d.ranged for d in jtc.flows[0].deps_in] == [True]
    jr, pr = j_check(jpool), check_ptg(pool)
    assert pr.ok and pr.graph == jr.graph
    # a region with no predecessor starts at once
    assert any(not r.preds for r in plan.regions)
    with Context(nb_cores=2) as ctx:
        ctx.add_taskpool(pool)
        ctx.wait(timeout=60)
    with j_Context(nb_cores=2) as ctx:
        ctx.add_taskpool(jpool)
        ctx.wait(timeout=60)
    np.testing.assert_allclose(np.asarray(A.to_dense()),
                               np.asarray(JA.to_dense()), rtol=0, atol=TOL)


def test_regions_on_worker_threads_give_the_same_factor():
    a, A, plan = _chol_plan(160, 32, 4)
    assert len(plan.regions) > 4
    with Context(nb_cores=3) as ctx:
        plan.execute(context=ctx)
    np.testing.assert_allclose(np.tril(np.asarray(A.to_dense())),
                               _chol_dynamic(a, 32), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# warm_cache and the CLI: prepared, nothing run
# ---------------------------------------------------------------------------

def _no_step(*_a, **_k):
    raise AssertionError("warming ran a step")


def test_warm_cache_runs_no_step_and_a_second_warm_is_free(monkeypatch):
    lowering_cache.clear()
    monkeypatch.setattr(lowering, "_run_level", _no_step)
    monkeypatch.setattr(lowering, "_call_one", _no_step)
    out = lowering.warm_cache("cholesky", n=96, nb=32,
                              modes=("auto", "region"), device="cpu")
    assert out["auto"]["mode"] == "wavefront"
    assert out["region"]["regions_compiled"] >= 1
    assert out["region"]["regions_eager"] == 0
    out2 = lowering.warm_cache("cholesky", n=96, nb=32, modes=("region",),
                               device="cpu")
    assert out2["region"]["compile_s"] == 0.0


@pytest.mark.parametrize("workload,geom", [
    ("cholesky", {"n": 128, "nb": 32}),
    ("llm_decode_k", {"nseqs": 2, "steps": 2}),
    ("llm_decode", {"nseqs": 2, "npages": 2}),
    ("llm_spec_k", {"nseqs": 2, "draft": 2}),
    ("llm_prefill_tail", {"nseqs": 2, "tail_pages": 2})])
def test_the_warm_cli_prepares_every_region(workload, geom, capsys,
                                             monkeypatch):
    monkeypatch.setattr(lowering, "_run_level", _no_step)
    argv = ["--warm", workload, "--modes", "auto,region", "--device", "cpu"]
    argv += (["--n", "128", "--nb", "32"] if workload == "cholesky"
             else ["--n", "2", "--nb", "2"])
    assert lowering._main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["workload"] == workload and out["backend"][1] == "cpu"
    assert {k: out[k] for k in geom} == geom
    assert out["region"]["regions"] >= 1
    assert out["region"]["regions_eager"] == 0
    assert "error" not in out["auto"]


# ---------------------------------------------------------------------------
# the batcher: region-lowered superpools
# ---------------------------------------------------------------------------

def _serve(prompts, max_new):
    with RuntimeServer(nb_cores=2) as server:
        tks = {n: server.submit_stream(p, max_new_tokens=max_new,
                                       tenant=f"t{i % 2}")
               for i, (n, p) in enumerate(prompts.items())}
        got = {n: tk.result(timeout=120)["tokens"] for n, tk in tks.items()}
        return got, server.stats()["llm"]


def test_region_superpools_serve_the_oracle_tokens(cpu_cuda_device,
                                                   port_param):
    port_param("llm_lower_regions", True)
    port_param("llm_steps_per_pool", 4)
    prompts = _prompts(7, 5, lo=3, hi=40)
    got, stats = _serve(prompts, 9)
    for name, prompt in prompts.items():
        assert got[name] == MODEL.reference_generate(prompt, 9), name
    reg = stats["regions"]
    assert reg["pools"] == stats["decode_submits"] and reg["fallbacks"] == 0
    assert reg["regions"] >= reg["pools"]
    # the region pools' bodies run on the worker threads: no decode task
    # went through the device module, only the prefill pools
    assert set(cpu_cuda_device.stats()["tasks_by_class"]) == {"PF"}


def test_region_spec_pools_serve_the_oracle_tokens(cpu_cuda_device,
                                                   port_param):
    """Speculative pools are region-lowered too (as in JAX): the draftable
    streams' accepted prefixes and the rollbacks leave the oracle's
    tokens."""
    port_param("llm_lower_regions", True)
    port_param("llm_spec_k", 4)
    prompts = {f"s{i}": ([3, 7, 11, 5] * 6 if i % 2 else p)
               for i, p in enumerate(_prompts(9, 4, lo=3, hi=30).values())}
    got, stats = _serve(prompts, 14)
    for name, prompt in prompts.items():
        assert got[name] == MODEL.reference_generate(prompt, 14), name
    assert stats["spec_submits"] > 0
    assert stats["regions"]["pools"] == stats["decode_submits"]
    assert stats["regions"]["fallbacks"] == 0


def test_a_refused_pool_falls_back_task_by_task(cpu_cuda_device,
                                                port_param):
    port_param("llm_lower_regions", True)

    def refuse(*_a, **_k):
        raise LoweringError("refused")
    prompts = _prompts(8, 3)
    with mock.patch.object(lowering, "lower_regions", refuse):
        got, stats = _serve(prompts, 5)
    for name, prompt in prompts.items():
        assert got[name] == MODEL.reference_generate(prompt, 5), name
    assert stats["regions"]["pools"] == 0
    assert stats["regions"]["fallbacks"] == stats["decode_submits"]
    assert "ATTN" in cpu_cuda_device.stats()["tasks_by_class"]


def test_the_params_and_their_defaults():
    assert params.get("llm_lower_regions") is False
    assert params.get("lowering_region_max_tasks") == 256
    assert params.get("lowering_compile_budget_s") == 0.0
    a = j_chol.make_spd(64)
    plan = lower_regions(p_chol.tiled_cholesky_ptg(
        PSym.from_dense("A", a, 16, 16)), device="cpu")
    assert plan.device == torch.device("cpu") and plan.mode == "region"
    assert len(plan.regions) == 1       # 20 tasks under the cap of 256

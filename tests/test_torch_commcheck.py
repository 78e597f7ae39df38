"""The port's static comm-pattern derivation
(``parsec_tpu_torch/analysis/commcheck.py``) against the JAX package's.

The cases of ``tests/test_commcheck.py``, each on both packages with the
same inputs: the port's ``check_comm(...).to_dict()``, its per-rank-pair
bytes, its findings with their provenance, ``recommend_tree`` and
``predict_collective_traffic(n)`` must EQUAL the JAX package's: the
model sweep at 4 ranks, the broadcast and reduction trees at 2, 4 and 8
ranks, the factorizations and the GEMM (fp32 and bf16 operands) on a 2 x
2 grid, the classifier over synthetic rank-pair matrices, one seeded
mutation per finding class (duplicate activation, unowned remote read,
cross-rank unordered write, tree-shape mismatch) with its clean control,
the tree rule, the ``comm_pattern`` block of ``runtime_report()`` and
the CLI.  Byte counts are exact integers: no tolerance.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parsec_tpu import ptg as j_ptg
from parsec_tpu.analysis import commcheck as jcc
from parsec_tpu.analysis.__main__ import _model_graphs as j_model_graphs
from parsec_tpu.analysis.__main__ import main as j_cli
from parsec_tpu.comm import collectives as j_coll
from parsec_tpu.comm.remote_dep import resolve_tree_kind as j_resolve
from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JBC
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVec
from parsec_tpu.models import cholesky as j_chol
from parsec_tpu.models import lu as j_lu
from parsec_tpu.models import tiled_gemm as j_gemm
from parsec_tpu.prof.flight_recorder import runtime_report as j_report
from parsec_tpu_torch import ptg as p_ptg
from parsec_tpu_torch.analysis import commcheck as pcc
from parsec_tpu_torch.analysis.__main__ import _model_graphs
from parsec_tpu_torch.analysis.__main__ import main as p_cli
from parsec_tpu_torch.comm import collectives as p_coll
from parsec_tpu_torch.comm.remote_dep import TREE_KINDS, resolve_tree_kind
from parsec_tpu_torch.core.params import MCAParamValueError, params
from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic as PSym
from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic as PBC
from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic as PVec
from parsec_tpu_torch.models import cholesky as p_chol
from parsec_tpu_torch.models import lu as p_lu
from parsec_tpu_torch.models import tiled_gemm as p_gemm
from parsec_tpu_torch.prof.flight_recorder import runtime_report

JAX = types.SimpleNamespace(cc=jcc, ptg=j_ptg, coll=j_coll, Vec=JVec,
                            Sym=JSym, BC=JBC, chol=j_chol, lu=j_lu,
                            gemm=j_gemm, bf16=jnp.bfloat16, f32=np.float32)
PORT = types.SimpleNamespace(cc=pcc, ptg=p_ptg, coll=p_coll, Vec=PVec,
                             Sym=PSym, BC=PBC, chol=p_chol, lu=p_lu,
                             gemm=p_gemm, bf16=torch.bfloat16,
                             f32=torch.float32)


def _vec(pkg, name, n, mb=1024, P=1, dtype=None):
    return pkg.Vec(name, lm=mb * n, mb=mb, P=P,
                   dtype=pkg.f32 if dtype is None else dtype)


def _findings(cr):
    return sorted((f.code, f.severity, f.message, f.task_class, f.flow,
                   tuple(sorted(f.instance.items())) if f.instance else None,
                   f.count) for f in cr.findings)


def _same(pcr, jcr):
    """The whole derivation: the dict, the pairs, the counts, the
    findings with provenance, the tree recommendation."""
    assert pcr.to_dict() == jcr.to_dict()
    assert pcr.rank_bytes == jcr.rank_bytes
    assert pcr.edge_count == jcr.edge_count
    assert (pcr.fan_out, pcr.fan_in) == (jcr.fan_out, jcr.fan_in)
    assert _findings(pcr) == _findings(jcr)
    assert pcc.recommend_tree(pcr) == jcc.recommend_tree(jcr)


def _both(build, nb_ranks):
    """``build(pkg)`` analysed by each package's commcheck."""
    pcr = pcc.check_comm(build(PORT), nb_ranks=nb_ranks)
    jcr = jcc.check_comm(build(JAX), nb_ranks=nb_ranks)
    _same(pcr, jcr)
    return pcr


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

SHARED = ["cholesky", "lu", "pingpong", "reduction", "stencil1d",
          "stencil2d", "tiled_gemm", "all2all", "llm_prefill",
          "llm_decode_k", "llm_decode_spec", "llm_decode_spec_batched",
          "comm_bcast", "comm_reduce"]
WANT = {"comm_bcast": "broadcast", "comm_reduce": "reduce",
        "cholesky": "none", "stencil1d": "halo"}


@pytest.mark.parametrize("name", SHARED)
def test_the_model_sweep_equals_the_jax_sweep(name):
    pcr = pcc.check_comm(dict(_model_graphs(5, ranks=4))[name], nb_ranks=4)
    jcr = jcc.check_comm(dict(j_model_graphs(5, ranks=4))[name],
                         nb_ranks=4)
    _same(pcr, jcr)
    assert pcr.ok and pcr.pattern in pcc.PATTERNS
    assert pcr.pattern == WANT.get(name, pcr.pattern)
    blk = pcc.report_block()[pcr.name]
    assert blk == jcc.report_block()[jcr.name] == pcr.to_dict()


def test_a_single_rank_pool_is_none():
    pcr = _both(lambda k: k.coll.bcast_taskpool(_vec(k, "V", 8), n=8), 1)
    assert pcr.pattern == "none" and pcr.total_bytes == 0


@pytest.mark.parametrize("n", [2, 4, 8])
def test_bcast_and_reduce_bytes_equal_the_jax_bytes(n):
    mb = 1024
    pcr = _both(lambda k: k.coll.bcast_taskpool(
        _vec(k, "B", n, mb=mb, P=n), n=n), n)
    assert pcr.pattern == "broadcast" and not pcr.findings
    assert pcr.total_bytes == (n - 1) * mb * 4
    pcr = _both(lambda k: k.coll.reduce_taskpool(
        _vec(k, "R", n, mb=mb, P=n), _vec(k, "O", 1, mb=mb), n=n), n)
    assert pcr.pattern == "reduce"
    assert pcr.total_bytes == (n - 1) * mb * 4


def test_a_bf16_pool_sizes_its_tiles_by_the_torch_itemsize():
    """numpy has no bfloat16: the port sizes a bf16 tile from
    ``torch.bfloat16.itemsize`` (2 bytes), as the JAX package does from
    its numpy extension dtype."""
    n, mb = 4, 1000
    pcr = _both(lambda k: k.coll.bcast_taskpool(
        _vec(k, "H", n, mb=mb, P=n, dtype=k.bf16), n=n), n)
    assert pcr.total_bytes == (n - 1) * mb * 2
    assert pcc._itemsize(torch.bfloat16) == 2
    assert pcc._itemsize(np.float64) == 8


def _grid(kind: str, pkg, bf16: bool = False):
    """Rank 0's view of a 2 x 2 block-cyclic grid over 4 ranks."""
    n, nb = 64, 16
    if kind == "cholesky":
        A = pkg.Sym.from_dense("A", p_chol.make_spd(n, seed=1), nb, nb,
                               P=2, Q=2, myrank=0)
        return pkg.chol.tiled_cholesky_ptg(A, devices="cpu")
    if kind == "lu":
        A = pkg.BC.from_dense("A", p_lu.make_dd(n, seed=1), nb, nb, P=2,
                              Q=2, myrank=0)
        return pkg.lu.tiled_lu_ptg(A, devices="cpu")
    dt = pkg.bf16 if bf16 else pkg.f32
    A = pkg.BC("A", n, n, nb, nb, P=2, Q=2, dtype=dt)
    B = pkg.BC("B", n, n, nb, nb, P=2, Q=2, dtype=dt)
    C = pkg.BC("C", n, n, nb, nb, P=2, Q=2, dtype=pkg.f32)
    return pkg.gemm.tiled_gemm_ptg(A, B, C, devices="cpu")


@pytest.mark.parametrize("kind,bf16", [("cholesky", False), ("lu", False),
                                       ("gemm", False), ("gemm", True)])
def test_the_grids_equal_the_jax_package(kind, bf16):
    pcr = _both(lambda k: _grid(kind, k, bf16), 4)
    assert pcr.ok and pcr.total_bytes > 0
    if kind == "gemm":
        # every A and B tile read off its home rank: 16 x 16 x itemsize
        item = 2 if bf16 else 4
        assert all(b % (16 * 16 * item) == 0
                   for b in pcr.edge_bytes.values())


CLASSIFY = {
    "chain-reduce": ({(r, r + 1): 100 for r in range(3)}, 4, {0}),
    "chain-bcast": ({(r, r + 1): 100 for r in range(3)}, 4, {0, 1, 2, 3}),
    "star": ({(0, d): 100 for d in range(1, 5)}, 5, {0, 1, 2, 3, 4}),
    "gather": ({(s, 0): 100 for s in range(1, 5)}, 5, {0}),
    "ring": ({**{(r, (r + 1) % 4): 100 for r in range(4)},
              **{((r + 1) % 4, r): 100 for r in range(4)}}, 4, set()),
    "a2a": ({(s, d): 100 for s in range(4) for d in range(4) if s != d}, 4,
            set()),
    "p2p": ({(0, 2): 100, (3, 1): 100}, 4, set()),
    "empty": ({}, 4, set()),
}


@pytest.mark.parametrize("shape", sorted(CLASSIFY))
def test_the_classifier_equals_the_jax_classifier(shape):
    pairs, n, wb = CLASSIFY[shape]
    assert pcc._classify(pairs, n, wb) == jcc._classify(pairs, n, wb)


# ---------------------------------------------------------------------------
# seeded mutations: one per finding class, with the JAX provenance
# ---------------------------------------------------------------------------

def test_a_duplicate_activation_is_named_as_in_jax():
    def build(k):
        tp = k.coll.bcast_taskpool(_vec(k, "D", 4, P=4), n=4)
        fa = next(f for f in tp.task_classes_by_name["B"].flows
                  if f.name == "A")
        fa.deps_out.append(fa.deps_out[0])
        return tp
    pcr = _both(build, 4)
    hits = [f for f in pcr.findings if f.code == "duplicate-activation"]
    assert hits and (hits[0].task_class, hits[0].flow) == ("B", "A")
    assert hits[0].instance is not None


def _owner_pool(k, drop_w0: bool):
    """W(p) writes V(p) at its home rank, R(q) on rank 1 reads V(q)
    behind its writer; ``drop_w0`` guards W(0)'s write-back away."""
    V = _vec(k, "V", 2, mb=8, P=2)
    p_ = k.ptg.PTGBuilder("ownerw", V=V, N=2)
    w = p_.task("W", p=k.ptg.span(0, lambda g, l: g.N - 1))
    w.affinity("V", lambda g, l: (l.p,))
    fw = w.flow("A", k.ptg.WRITE)
    fw.input(new=True, dtt=V.default_dtt)
    fw.output(data=("V", lambda g, l: (l.p,)))
    w.flow("X", k.ptg.CTL).output(succ=("R", "X", lambda g, l: {"q": l.p}))
    w.body(lambda es, task, g, l: None)
    r = p_.task("R", q=k.ptg.span(0, lambda g, l: g.N - 1))
    r.affinity("V", lambda g, l: (1,))
    r.flow("B", k.ptg.READ).input(data=("V", lambda g, l: (l.q,)))
    r.flow("X", k.ptg.CTL).input(pred=("W", "X", lambda g, l: {"p": l.q}))
    r.body(lambda es, task, g, l: None)
    tp = p_.build()
    if drop_w0:
        fa = next(f for f in tp.task_classes_by_name["W"].flows
                  if f.name == "A")
        wb = next(d for d in fa.deps_out if d.data_ref is not None)
        wb.guard = lambda locals_: locals_["p"] != 0
    return tp


@pytest.mark.parametrize("mutated", [False, True])
def test_an_unowned_remote_read_is_named_as_in_jax(mutated):
    pcr = _both(lambda k: _owner_pool(k, mutated), 2)
    hits = [f for f in pcr.findings if f.code == "unowned-remote-read"]
    if not mutated:
        assert hits == []
        return
    assert hits and (hits[0].task_class, hits[0].flow) == ("R", "B")
    assert "V" in hits[0].message


def _waw_pool(k, unordered: bool):
    """Two writers on two ranks write back T(0), serialized by a CTL
    chain W(0) -> W(1) (stripped when ``unordered``)."""
    V = _vec(k, "V", 2, mb=8, P=2)
    T = _vec(k, "T", 1, mb=8, P=2)
    p_ = k.ptg.PTGBuilder("waw", V=V, T=T, N=2)
    w = p_.task("W", p=k.ptg.span(0, lambda g, l: g.N - 1))
    w.affinity("V", lambda g, l: (l.p,))
    fw = w.flow("A", k.ptg.WRITE)
    fw.input(new=True, dtt=T.default_dtt)
    fw.output(data=("T", lambda g, l: (0,)))
    w.flow("X", k.ptg.CTL).output(
        succ=("W", "Y", lambda g, l: {"p": l.p + 1}),
        guard=lambda g, l: l.p + 1 < g.N)
    w.flow("Y", k.ptg.CTL).input(
        pred=("W", "X", lambda g, l: {"p": l.p - 1}),
        guard=lambda g, l: l.p > 0)
    w.body(lambda es, task, g, l: None)
    tp = p_.build()
    if unordered:
        for f in tp.task_classes_by_name["W"].flows:
            if f.is_ctl:
                f.deps_in.clear()
                f.deps_out.clear()
    return tp


@pytest.mark.parametrize("unordered", [False, True])
def test_a_cross_rank_unordered_write_is_named_as_in_jax(unordered):
    pcr = _both(lambda k: _waw_pool(k, unordered), 2)
    hits = [f for f in pcr.errors if f.code == "cross-rank-unordered-write"]
    if not unordered:
        assert hits == [] and pcr.ok
        return
    assert hits and (hits[0].task_class, hits[0].flow) == ("W", "A")
    assert "T" in hits[0].message and not pcr.ok


@pytest.mark.parametrize("kind", ["star", "binomial"])
def test_a_tree_shape_mismatch_is_named_as_in_jax(kind):
    n, mb = 8, 65536
    pcr = _both(lambda k: k.coll.bcast_taskpool(
        _vec(k, "W", n, mb=mb, P=n), n=n, kind=kind), n)
    hits = [f for f in pcr.warnings if f.code == "tree-shape-mismatch"]
    if kind == "binomial":
        assert hits == []
        return
    assert hits and "star" in hits[0].message \
        and "binomial" in hits[0].message


# ---------------------------------------------------------------------------
# tree selection and the collective prediction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mb,want", [(8, 65536, "binomial"),
                                       (4, 64, "star")])
def test_recommend_tree_equals_the_jax_recommendation(n, mb, want):
    pcr = _both(lambda k: k.coll.bcast_taskpool(
        _vec(k, "T", n, mb=mb, P=n), n=n), n)
    rec = pcc.recommend_tree(pcr)
    assert rec["overall"] == want
    assert all(v in TREE_KINDS for v in rec["per_class"].values())


def test_the_tree_rule_equals_the_jax_rule():
    short = int(params.get("comm_short_limit"))
    for kw in ({"nbytes": short, "n": 4}, {"nbytes": short + 1, "n": 4},
               {"nbytes": 64, "n": 16}, {}):
        assert resolve_tree_kind("auto", **kw) == j_resolve("auto", **kw)
    assert resolve_tree_kind("chain", nbytes=1, n=2) == "chain"
    with pytest.raises(MCAParamValueError):
        resolve_tree_kind("fanfic")
    spec = params.knob_space()["comm_bcast_tree"]
    assert set(spec.values) == {"binomial", "chain", "star", "auto"}


@pytest.mark.parametrize("mb", [64, 65536])
def test_an_auto_tree_resolves_at_build_time_as_in_jax(mb):
    pcr = _both(lambda k: k.coll.bcast_taskpool(
        _vec(k, "A", 4, mb=mb, P=4), n=4, kind="auto"), 4)
    assert pcr.fan_out.get(0) == (3 if mb == 64 else 2)


@pytest.mark.parametrize("payload", [None, 1 << 16])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_the_collective_prediction_equals_the_jax_prediction(n, payload):
    pred = pcc.predict_collective_traffic(n, payload_bytes=payload)
    assert pred == jcc.predict_collective_traffic(n, payload_bytes=payload)
    assert (pred["bcast_pattern"], pred["reduce_pattern"]) \
        == ("broadcast", "reduce")
    nbytes = payload or int(params.get("comm_coll_bench_bytes"))
    assert pred["total_bytes"] == (n - 1) * nbytes + (n - 1) * 256
    assert pcc.agreement_rel_err(100, 110) == pytest.approx(0.1)
    assert pcc.agreement_rel_err(0, 50) == jcc.agreement_rel_err(0, 50)


# ---------------------------------------------------------------------------
# the report block and the CLI
# ---------------------------------------------------------------------------

def test_runtime_report_carries_the_jax_comm_pattern_block():
    _both(lambda k: k.coll.bcast_taskpool(_vec(k, "RB", 4, P=4), n=4), 4)
    rep, jrep = runtime_report(), j_report()
    assert rep["comm_pattern"]["coll_bcast"] \
        == jrep["comm_pattern"]["coll_bcast"]
    assert rep["comm_pattern"]["coll_bcast"]["pattern"] == "broadcast"
    assert set(pcc.report_block(compact=True)) \
        <= set(pcc.report_block())


def test_the_comm_cli_prints_the_jax_lines(capsys):
    assert p_cli(["--comm", "--graph", "comm_bcast", "--nt", "4"]) == 0
    out = capsys.readouterr().out
    assert j_cli(["--comm", "--graph", "comm_bcast", "--nt", "4"]) == 0
    assert out == capsys.readouterr().out
    assert "broadcast" in out
    assert pcc.main(["--self-test"]) == 0


def test_the_comm_cli_fails_on_an_error_finding(capsys):
    """An error finding exits nonzero, as in JAX: the sweep with the
    unordered write-back pool slipped in."""
    sweep = list(_model_graphs(3, ranks=2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("parsec_tpu_torch.analysis.__main__._model_graphs",
                   lambda nt, ranks=1: sweep + [("waw",
                                                 _waw_pool(PORT, True))])
        assert p_cli(["--comm", "--ranks", "2"]) == 1
    assert "cross-rank-unordered-write" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["cholesky", "lu", "gemm"])
def test_the_bytes_split_into_reads_write_backs_and_activations(kind):
    """The GEMM's cross-rank bytes on the grid are all collection reads
    of A and B (its C chain stays on its rank); the factorizations' are
    all activations (each task reads and writes its own rank's tile)."""
    cr = _both(lambda k: _grid(kind, k), 4)
    assert cr.read_bytes + cr.writeback_bytes + cr.activation_bytes \
        == cr.total_bytes > 0
    assert cr.writeback_bytes == 0
    if kind == "gemm":
        assert cr.activation_bytes == 0 and cr.read_bytes == cr.total_bytes
    else:
        assert cr.read_bytes == 0 and cr.activation_bytes == cr.total_bytes

"""The port's lowering cache and structural fingerprint
(``parsec_tpu_torch/ptg/lowering.py``) against the JAX package's.

``structural_fingerprint`` and ``workload_signature`` must equal the JAX
package's exactly on every pool builder both have: the tiled GEMM,
Cholesky, LU and both stencils, each as a pool and lowered; the prefill,
k-step decode, speculative and batched-speculative superpools as pools
and lowered too (their collections have open key spaces, whose stores
grow as the plan references keys: the same rows as the JAX package's).
The kernel-name axis is ``""`` for every class in both (a ``Traceable``
has no ``name``).

Then the cache, mirroring ``tests/test_lowering.py``'s cache cases: a
structurally identical re-lowering is a hit that returns the SAME step
object (its index tensors already on the device) and gives the miss's
result bit for bit; structures that differ (stencil sweep lengths, a
re-registered kernel) miss; the ``lowering_cache`` param turns sharing
off; ``warm()`` executes nothing and puts the plan's index tensors on
the device.  Tolerance: the lowered GEMM against float64 at
``rtol=1e-5, atol=1e-4`` (fp32 sums of 16 products).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from parsec_tpu.analysis.__main__ import _model_graphs as j_model_graphs
from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.models import cholesky as j_chol
from parsec_tpu.models import lu as j_lu
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm
from parsec_tpu.ptg.lowering import lower_taskpool as j_lower
from parsec_tpu.ptg.lowering import structural_fingerprint as j_fingerprint
from parsec_tpu.tune import workload_signature as j_signature
import parsec_tpu_torch.llm as p_llm
import parsec_tpu_torch.ops.ragged_attention  # noqa: F401 — traceables
from parsec_tpu_torch.analysis.__main__ import _model_graphs
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic as PSym
from parsec_tpu_torch.data_dist.matrix import TiledMatrix as PTiled
from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic
from parsec_tpu_torch.models import cholesky as p_chol
from parsec_tpu_torch.models import lu as p_lu
from parsec_tpu_torch.models.stencil import stencil_1d_ptg
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.ptg import lowering
from parsec_tpu_torch.ptg.lowering import (LoweringCache, lower_taskpool,
                                           lowering_cache,
                                           structural_fingerprint)
from parsec_tpu_torch.tune import workload_signature

NB = 4


@pytest.fixture
def port_param():
    saved = {}

    def set_(name, value):
        saved.setdefault(name, params.get(name))
        params.set(name, value)

    yield set_
    for name, value in saved.items():
        params.set(name, value)


def _dense_pools(pkg: str, nt: int, seed: int = 0) -> dict:
    """GEMM, Cholesky and LU of ``nt x nt`` tiles, with each package's
    default chores (the ones whose traceables the lowering finds)."""
    n = nt * NB
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    z = np.zeros((n, n), np.float32)
    spd = j_chol.make_spd(n, seed=seed)
    dd = j_lu.make_dd(n, seed=seed)
    if pkg == "jax":
        return {
            "tiled_gemm": j_gemm(JTiled.from_dense("A", a, NB, NB),
                                 JTiled.from_dense("B", b, NB, NB),
                                 JTiled.from_dense("C", z, NB, NB)),
            "cholesky": j_chol.tiled_cholesky_ptg(
                JSym.from_dense("A", spd, NB, NB)),
            "lu": j_lu.tiled_lu_ptg(JTiled.from_dense("A", dd, NB, NB))}
    return {
        "tiled_gemm": tiled_gemm_ptg(PTiled.from_dense("A", a, NB, NB),
                                     PTiled.from_dense("B", b, NB, NB),
                                     PTiled.from_dense("C", z, NB, NB)),
        "cholesky": p_chol.tiled_cholesky_ptg(
            PSym.from_dense("A", spd, NB, NB)),
        "lu": p_lu.tiled_lu_ptg(PTiled.from_dense("A", dd, NB, NB))}


def _card_chores(f):
    def g(*a, **kw):
        kw["devices"] = "cuda"
        return f(*a, **kw)
    return g


def _graph_pools(pkg: str, nt: int) -> dict:
    """The stencils and the LLM pools of each package's graphcheck CLI
    (the same builders and sizes); the port's LLM pools carry the card's
    chores, which name their traceables (``dyld``)."""
    keep = ("stencil1d", "stencil2d", "llm_prefill", "llm_decode_k",
            "llm_decode_spec", "llm_decode_spec_batched")
    if pkg == "jax":
        return {k: v for k, v in j_model_graphs(nt) if k in keep}
    names = ("prefill_ptg", "decode_superpool_ptg", "spec_superpool_ptg",
             "spec_batched_ptg")
    with mock.patch.multiple(p_llm, **{n: _card_chores(getattr(p_llm, n))
                                       for n in names}):
        return {k: v for k, v in _model_graphs(nt) if k in keep}


LOWERED = ["tiled_gemm", "cholesky", "lu", "stencil1d", "stencil2d"]
POOLS = LOWERED + ["llm_prefill", "llm_decode_k", "llm_decode_spec",
                   "llm_decode_spec_batched"]


def _both(name: str, nt: int):
    if name in ("tiled_gemm", "cholesky", "lu"):
        return _dense_pools("jax", nt)[name], _dense_pools("port", nt)[name]
    return _graph_pools("jax", nt)[name], _graph_pools("port", nt)[name]


@pytest.mark.parametrize("nt", [3, 4])
@pytest.mark.parametrize("name", POOLS)
def test_fingerprint_of_a_pool_is_the_jax_fingerprint(name, nt):
    jtp, ptp = _both(name, nt)
    fp = structural_fingerprint(ptp)
    assert fp == j_fingerprint(jtp)
    assert fp["ntasks"] > 0 and {c[2] for c in fp["classes"]} == {""}
    assert workload_signature(ptp) == j_signature(jtp)
    assert workload_signature(ptp, size_hint=8192) \
        == j_signature(jtp, size_hint=8192)


@pytest.mark.parametrize("nt", [3, 4])
@pytest.mark.parametrize("name", LOWERED)
def test_fingerprint_of_a_lowering_is_the_jax_fingerprint(name, nt):
    jtp, ptp = _both(name, nt)
    jlow, plow = j_lower(jtp), lower_taskpool(ptp, device="cpu")
    fp = structural_fingerprint(plow)
    assert fp == j_fingerprint(jlow)
    assert fp["mode"] == plow.mode and fp["stores"]
    assert workload_signature(plow) == j_signature(jlow)


LLM_POOLS = ["llm_prefill", "llm_decode_k", "llm_decode_spec",
             "llm_decode_spec_batched"]


@pytest.mark.parametrize("nt", [3, 4])
@pytest.mark.parametrize("name", LLM_POOLS)
def test_an_llm_pools_lowered_fingerprint_is_the_jax_fingerprint(name, nt):
    """The open stores: the paged KV cache (not enumerable) and the
    undeclared dict collections grow a row for each key the plan
    references, so the lowered store rows equal the JAX package's."""
    jtp, ptp = _both(name, nt)
    jlow, plow = j_lower(jtp), lower_taskpool(ptp, device="cpu")
    fp = structural_fingerprint(plow)
    assert fp == j_fingerprint(jlow)
    assert fp["mode"] == plow.mode == "wavefront"
    assert plow._stores.open and all(fp["stores"].values())
    assert workload_signature(plow) == j_signature(jlow)


def test_the_tiled_gemm_fingerprint_is_the_documented_dict():
    _, ptp = _both("tiled_gemm", 4)
    assert structural_fingerprint(ptp) == {
        "classes": [["GEMM", 64, "", ["A", "B", "C"], ["C"]]],
        "ntasks": 64, "wavefront": [4, 16]}


def test_a_kernel_swap_keeps_the_fingerprint():
    """Shared with the reference: two pools that differ only in their
    kernel fingerprint alike (the kernel-name axis is always empty)."""
    _, a = _both("stencil1d", 3)
    _, b = _both("stencil1d", 3)
    b.local_traceables = {"stencil1d": lowering.Traceable(
        lambda *x: None)}
    assert structural_fingerprint(a) == structural_fingerprint(b)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def _gemm(seed: int, nt: int = 4, stacked: bool = False):
    n = nt * NB
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    A = PTiled.from_dense("A", a, NB, NB)
    B = PTiled.from_dense("B", b, NB, NB)
    C = PTiled.from_dense("C", np.zeros((n, n), np.float32), NB, NB)
    # A as both operands: not three identity grids, so the chain
    # gathers its tiles by index (the stacked path)
    tp = tiled_gemm_ptg(A, A if stacked else B, C)
    tp.C = C
    return a, b, tp


def test_a_second_lowering_hits_and_returns_the_same_step():
    a, b, tp1 = _gemm(seed=3)
    low1 = lower_taskpool(tp1, device="cpu")
    h0, m0 = lowering_cache.hits, lowering_cache.misses
    out1 = low1.step_fn(low1.initial_stores())["C"]
    _, _, tp2 = _gemm(seed=3)
    low2 = lower_taskpool(tp2, device="cpu")
    assert low2.signature == low1.signature
    assert low2.step_fn is low1.step_fn
    assert (lowering_cache.hits, lowering_cache.misses) == (h0 + 1, m0)
    out2 = low2.step_fn(low2.initial_stores())["C"]
    assert torch.equal(out1, out2)
    np.testing.assert_allclose(out1.numpy(), a.astype(np.float64) @ b,
                               rtol=1e-5, atol=1e-4)
    # the result does not depend on the lowering it came from: other data
    # through the shared step
    a3, b3, tp3 = _gemm(seed=4)
    low3 = lower_taskpool(tp3, device="cpu")
    assert low3.step_fn is low1.step_fn
    low3.execute()
    np.testing.assert_allclose(tp3.C.to_tensor().numpy(),
                               a3.astype(np.float64) @ b3,
                               rtol=1e-5, atol=1e-4)


def test_a_hit_uploads_no_index_again():
    """The chain over a sub-grid gathers by index tensors: the hit's step
    holds the tensors the miss's first step (or ``warm``) put on the
    device, and uploads none."""
    _, _, tp1 = _gemm(seed=5, stacked=True)
    low1 = lower_taskpool(tp1, device="cpu")
    assert low1.mode == "chain-collapse"
    idx = low1.step_fn.indices
    assert idx and all(not i._dev for i in idx)
    w = low1.warm()
    assert set(w) == {"load_s", "upload_s"}
    cpu = torch.device("cpu")
    held = [i._dev.get(cpu) for i in idx if i.sel is None]
    assert held and all(t is not None for t in held)
    _, _, tp2 = _gemm(seed=6, stacked=True)
    low2 = lower_taskpool(tp2, device="cpu")
    assert low2.step_fn is low1.step_fn
    low2.step_fn(low2.initial_stores())
    assert [i._dev.get(cpu) for i in idx if i.sel is None] == held


def test_warm_executes_nothing(monkeypatch):
    calls = []
    kernel = lowering.find_traceable("gemm")
    real = kernel.apply

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(kernel, "apply", counting)
    _, _, tp = _gemm(seed=7)
    low = lower_taskpool(tp, device="cpu")
    low.warm()
    assert calls == []
    low.execute()
    assert calls == [1]


def test_warm_names_the_kernel_libraries_of_the_plan():
    _, _, tp = _gemm(seed=8)
    low = lower_taskpool(tp, device="cpu")
    assert {lib for k in low._kernels for lib in k.libs} == {"gemm"}
    _, ch = _both("cholesky", 3)
    low = lower_taskpool(ch, device="cpu")
    assert {lib for k in low._kernels for lib in k.libs} == {"gemm",
                                                             "factor"}
    assert low.mode == "wavefront" and low.step_fn.indices


def test_wavefront_lowerings_share_a_step():
    _, c1 = _both("cholesky", 4)
    _, c2 = _both("cholesky", 4)
    l1 = lower_taskpool(c1, device="cpu")
    l2 = lower_taskpool(c2, device="cpu")
    assert l1.mode == l2.mode == "wavefront"
    assert l2.step_fn is l1.step_fn and l2.levels == l1.levels


def test_different_structures_miss():
    """Same kernel, same collection names, other sweep lengths: only the
    level plan differs, and the signatures with it."""
    def low(iters):
        V = VectorTwoDimCyclic("V", lm=1 << 10, mb=1 << 8)
        return lower_taskpool(stencil_1d_ptg(V, [1 / 3] * 3, iters),
                              device="cpu")

    l4, l8 = low(4), low(8)
    assert l4.mode == l8.mode == "wavefront"
    assert l4.signature != l8.signature
    assert l4.step_fn is not l8.step_fn


def test_a_reregistered_kernel_misses():
    from parsec_tpu_torch.ops.factor import one_update_dropped
    _, c1 = _both("cholesky", 3)
    l1 = lower_taskpool(c1, device="cpu")
    with one_update_dropped("gemm_nt"):
        _, c2 = _both("cholesky", 3)
        l2 = lower_taskpool(c2, device="cpu")
    assert l2.signature != l1.signature
    assert l2.step_fn is not l1.step_fn


def test_the_param_turns_sharing_off(port_param):
    port_param("lowering_cache", False)
    _, _, tp1 = _gemm(seed=5)
    _, _, tp2 = _gemm(seed=5)
    l1 = lower_taskpool(tp1, device="cpu")
    l2 = lower_taskpool(tp2, device="cpu")
    assert l1.signature == l2.signature
    assert l1.step_fn is not l2.step_fn


def test_the_cache_is_a_bounded_fifo_that_keeps_the_race_winner():
    c = LoweringCache()
    built = []
    for i in range(LoweringCache.MAX_ENTRIES + 3):
        c.get_or_build(("k", i), lambda i=i: built.append(i) or f"s{i}")
    assert c.misses == LoweringCache.MAX_ENTRIES + 3 and c.hits == 0
    assert c.peek(("k", 0)) is None and c.peek(("k", 3)) == "s3"
    assert c.get_or_build(("k", 3), lambda: "other") == "s3"
    assert c.hits == 1
    # a builder that lost a race gets the winner's entry, as a hit

    def build():
        c._built[("race",)] = "winner"  # another thread finished first
        return "loser"

    assert c.get_or_build(("race",), build) == "winner"
    assert c.hits == 2
    assert c.get_or_build(None, lambda: "uncached") == "uncached"
    c.clear()
    assert (c.hits, c.misses, c.peek(("k", 3))) == (0, 0, None)


def test_the_key_holds_the_backend_and_the_device():
    be = lowering._backend_signature()
    assert be[0] == torch.__version__
    assert be[1] == ("cuda" if torch.cuda.is_available() else "cpu")
    _, _, tp = _gemm(seed=9)
    low = lower_taskpool(tp, device="cpu")
    key = ("chain-collapse", "cpu", be, low.signature)
    assert lowering_cache.peek(key) is low.step_fn
    assert lowering_cache.peek(("chain-collapse", "cuda:0", be,
                                low.signature)) is None

"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (K1, the
GEMM, with its transposed and subtracting forms; K2, the ragged
paged-attention page update; K3, the 1-D stencil), the device module,
decode serving, the tiled Cholesky and LU, the lowered taskpools, DTD
task insertion, the compiled-DAG executor, the comm layer's device
fabric with the factorizations across four ranks sharing the card, the
multi-rank lowering over four ranks on the card, and four rank processes
on the card over the device socket tier.  They skip
without one.

This file imports no JAX, so it also runs where JAX is not installed;
there, skip ``tests/conftest.py`` (it sets JAX up)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py

Tolerances: each K1 variant is held against the plain version of its
own arithmetic (cuBLAS with TF32 off): strict fp32 for ``simt_fp32``,
exact bf16 products for ``wgmma_bf16``, and inputs first rounded to TF32
(``gemm_update_plain(tf32=True)``, whose products are exact in fp32) for
``mma_tf32``.  Both sides then sum fp32 products in different orders;
with |C| of order sqrt(k), ``rtol=1e-4, atol=1e-3`` is rounding, a wrong
element is off by O(1).  Where a TF32 result meets a float64 product of
the unrounded inputs, the bound is elementwise, ``2e-3 * (|A| @ |B|) +
1e-2``: each TF32 input is within 2^-11 of its value, so each product
within about 2^-10 (1e-3) of its magnitude.
"""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                               TiledMatrix,
                                               TwoDimBlockCyclic,
                                               VectorTwoDimCyclic)
from parsec_tpu_torch.llm import ToyLM
from parsec_tpu_torch.models import cholesky as chol
from parsec_tpu_torch.models import lu
from parsec_tpu_torch.models.stencil import stencil_1d_ptg, stencil_reference
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.ops import factor
from parsec_tpu_torch.ops import gemm as tg
from parsec_tpu_torch.ops import ragged_attention as ra
from parsec_tpu_torch.ops import stencil as ks
from parsec_tpu_torch.ptg.lowering import (DeviceMesh, _Index,
                                           find_traceable, lower_regions,
                                           lower_taskpool,
                                           register_traceable)
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.serve import RuntimeServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    snapshot = list(registry.devices)
    yield init_cuda_devices()[0]
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


@pytest.fixture
def precision():
    """Restores the ``gemm_precision`` knob after a test that sets it."""
    before = params.get("gemm_precision")
    yield
    params.set("gemm_precision", before)


def _variant_delta(before):
    now = tg.gemm_update.launches_by_variant
    return {v: now[v] - before[v] for v in now if now[v] != before[v]}


def _want(a, b, c, variant):
    return tg.gemm_update_plain(a, b, c, tf32=variant == "mma_tf32")


def _tf32_close(got, a, b, c=None):
    """A TF32 result against the float64 product of the unrounded inputs,
    within ``2e-3 * (|A| @ |B|) + 1e-2`` elementwise."""
    a, b = a.double(), b.double()
    ref = a @ b if c is None else c.double() + a @ b
    bound = 2e-3 * (a.abs() @ b.abs()) + 1e-2
    err = (got.double() - ref).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


# (shape, A/B dtype, C dtype, precision, the variant k1_variant picks)
K1_CASES = [
    ((4, 256, 256, 256), torch.float32, torch.float32, "default", "mma_tf32"),
    ((4, 256, 256, 256), torch.float32, torch.float32, "highest",
     "simt_fp32"),
    ((4, 256, 256, 256), torch.bfloat16, torch.float32, "default",
     "wgmma_bf16"),
    ((4, 256, 256, 256), torch.bfloat16, torch.float32, "highest",
     "wgmma_bf16"),
    ((3, 65, 130, 47), torch.float32, torch.float32, "default", "simt_fp32"),
    ((1000, 700, 300), torch.float32, torch.float32, "default", "mma_tf32"),
    ((1000, 700, 300), torch.float32, torch.float32, "highest", "simt_fp32"),
    ((1000, 700, 300), torch.float32, torch.bfloat16, "default", "mma_tf32"),
    ((1000, 700, 300), torch.bfloat16, torch.bfloat16, "default",
     "simt_fp32"),                   # 600-byte pitch: no TMA
    ((1000, 712, 304), torch.bfloat16, torch.float32, "default",
     "wgmma_bf16"),                  # M/N edges and a K tail
    ((3, 130, 264, 72), torch.bfloat16, torch.float32, "default",
     "wgmma_bf16"),
    ((3, 130, 264, 72), torch.bfloat16, torch.bfloat16, "default",
     "wgmma_bf16"),                  # bf16 out
    ((2, 64, 64, 0), torch.bfloat16, torch.float32, "default",
     "wgmma_bf16"),                  # K = 0: out = C
    ((2, 64, 64, 0), torch.float32, torch.float32, "default", "mma_tf32"),
    ((1, 128, 256, 64), torch.bfloat16, torch.float32, "default",
     "wgmma_bf16"),                  # one k-tile
    ((2, 128, 256, 256), torch.bfloat16, torch.float32, "default",
     "wgmma_bf16"),                  # K = 64 x the ring's 4 stages
    ((1, 256, 512, 4160), torch.bfloat16, torch.float32, "default",
     "wgmma_bf16"),                  # 65 k-tiles: 16 turns of the ring
    ((1, 256, 256, 2052), torch.float32, torch.float32, "default",
     "mma_tf32")]                    # 65 k-tiles of 32, a tail of 4


@pytest.mark.parametrize("shape,in_dtype,c_dtype,prec,variant", K1_CASES)
def test_kernel_matches_plain(card, precision, shape, in_dtype, c_dtype,
                              prec, variant):
    g = torch.Generator(device="cuda").manual_seed(0)
    *lead, m, n, k = shape
    a = torch.randn(*lead, m, k, device="cuda", generator=g).to(in_dtype)
    b = torch.randn(*lead, k, n, device="cuda", generator=g).to(in_dtype)
    c = torch.randn(*lead, m, n, device="cuda", generator=g).to(c_dtype)
    assert tg.k1_variant(in_dtype, c_dtype, m, n, k, True, prec) == variant
    params.set("gemm_precision", prec)
    before = dict(tg.gemm_update.launches_by_variant)
    launches = tg.gemm_update.launches
    got = tg.gemm_update(a, b, c)
    torch.cuda.synchronize()
    assert tg.gemm_update.launches == launches + 1
    assert _variant_delta(before) == {variant: 1}
    assert got.dtype == c_dtype
    tol = dict(rtol=1e-4, atol=1e-3) if c_dtype == torch.float32 \
        else dict(rtol=1e-2, atol=5e-2)   # bf16 output: 8 mantissa bits
    torch.testing.assert_close(got.float(), _want(a, b, c, variant).float(),
                               **tol)
    if k == 0:
        assert torch.equal(got, c)


@pytest.mark.parametrize("in_dtype,prec,variant", [
    (torch.float32, "default", "mma_tf32"),
    (torch.float32, "highest", "simt_fp32"),
    (torch.bfloat16, "default", "wgmma_bf16")])
def test_tile_list_kernel_matches_plain(card, precision, in_dtype, prec,
                                        variant):
    g = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(5, 96, 80, device="cuda", generator=g).to(in_dtype)
    b = torch.randn(5, 80, 112, device="cuda", generator=g).to(in_dtype)
    c = torch.randn(5, 96, 112, device="cuda", generator=g)
    params.set("gemm_precision", prec)
    before = dict(tg.gemm_update.launches_by_variant)
    launches = tg.gemm_update.launches
    got = tg.gemm_update_tiles(list(a), list(b), list(c))
    torch.cuda.synchronize()
    assert tg.gemm_update.launches == launches + 1
    assert _variant_delta(before) == {variant: 1}
    assert len({t.untyped_storage().data_ptr() for t in got}) == 5
    torch.testing.assert_close(torch.stack(got), _want(a, b, c, variant),
                               rtol=1e-4, atol=1e-3)


def test_tile_list_wgmma_reads_tiles_where_they_lie(card):
    """Tiles from separate allocations, with the list's order unlike the
    storage order: each tile gets its own pair of tensor maps."""
    g = torch.Generator(device="cuda").manual_seed(2)
    as_ = [torch.randn(200, 136, device="cuda", generator=g).bfloat16()
           for _ in range(7)]
    bs = [torch.randn(136, 264, device="cuda", generator=g).bfloat16()
          for _ in range(7)][::-1]
    cs = [torch.randn(200, 264, device="cuda", generator=g)
          for _ in range(7)]
    before = dict(tg.gemm_update.launches_by_variant)
    got = tg.gemm_update_tiles(as_, bs, cs)
    torch.cuda.synchronize()
    assert _variant_delta(before) == {"wgmma_bf16": 1}
    for x, a, b, c in zip(got, as_, bs, cs):
        torch.testing.assert_close(x, tg.gemm_update_plain(a, b, c),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_unaligned_tiles_land_on_simt(card, in_dtype):
    """A tile that starts off a 16-byte boundary is neither TMA's nor
    16-byte cp.async's: the rule sends the list to simt_fp32."""
    g = torch.Generator(device="cuda").manual_seed(3)
    m, n, k = 64, 96, 128
    buf = torch.randn(3, m * k + 1, device="cuda", generator=g).to(in_dtype)
    as_ = [row[1:].view(m, k) for row in buf]
    bs = [torch.randn(k, n, device="cuda", generator=g).to(in_dtype)
          for _ in range(3)]
    cs = [torch.randn(m, n, device="cuda", generator=g) for _ in range(3)]
    assert not tg._aligned(*as_)
    before = dict(tg.gemm_update.launches_by_variant)
    got = tg.gemm_update_tiles(as_, bs, cs)
    torch.cuda.synchronize()
    assert _variant_delta(before) == {"simt_fp32": 1}
    for x, a, b, c in zip(got, as_, bs, cs):
        torch.testing.assert_close(x, tg.gemm_update_plain(a, b, c),
                                   rtol=1e-4, atol=1e-3)


def test_wrapper_raises_on_a_mixed_device_call(card):
    a = torch.randn(8, 8, device="cuda")
    with pytest.raises(ValueError, match="different devices"):
        tg.gemm_update(a, a.cpu(), a)


def test_tiled_gemm_on_the_card(card):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 384), dtype=np.float32)
    b = rng.standard_normal((384, 320), dtype=np.float32)
    A = TiledMatrix.from_dense("A", a, 128, 128)
    B = TiledMatrix.from_dense("B", b, 128, 128)
    C = TiledMatrix("C", 512, 320, 128, 128)
    launches = tg.gemm_update.launches
    tf32 = tg.gemm_update.launches_by_variant["mma_tf32"]
    ctx = Context(nb_cores=2)
    try:
        ctx.add_taskpool(tiled_gemm_ptg(A, B, C))
        ctx.wait(timeout=120)
        card.sync()
    finally:
        ctx.fini(timeout=30)
    card.flush_cache()
    assert card.executed_tasks == 4 * 3 * 3
    assert tg.gemm_update.launches > launches
    # fp32 tiles at the default knob: every launch on TF32 tensor cores
    assert tg.gemm_update.launches_by_variant["mma_tf32"] - tf32 \
        == tg.gemm_update.launches - launches
    _tf32_close(torch.from_numpy(C.to_dense()), torch.from_numpy(a),
                torch.from_numpy(b))


def test_recursive_gemm_runs_its_sub_gemms_on_k1(card):
    """The recursive GEMM's nested pools on the card: every sub-GEMM a
    K1 task (``mma_tf32``), none on a host body, each sub-tile's device
    copy released as its pool drains, C within the TF32 bound."""
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_recursive_ptg
    rng = np.random.default_rng(1)
    a = rng.standard_normal((512, 512), dtype=np.float32)
    b = rng.standard_normal((512, 512), dtype=np.float32)
    A = TiledMatrix.from_dense("A", a, 256, 256)
    B = TiledMatrix.from_dense("B", b, 256, 256)
    C = TiledMatrix("C", 512, 512, 256, 256)
    launches = tg.gemm_update.launches
    tf32 = tg.gemm_update.launches_by_variant["mma_tf32"]
    tasks, released = card.tasks_by_class["GEMM"], card.released
    ctx = Context(nb_cores=2)
    try:
        ctx.add_taskpool(tiled_gemm_recursive_ptg(A, B, C, 64, 64))
        ctx.wait(timeout=120)
        card.sync()
    finally:
        ctx.fini(timeout=30)
    # 8 outer tasks, each a 4 x 4 x 4 nested pool of 64-wide sub-GEMMs
    assert card.tasks_by_class["GEMM"] - tasks == 8 * 64
    assert card.released - released == 8 * 3 * 16
    assert tg.gemm_update.launches > launches
    assert tg.gemm_update.launches_by_variant["mma_tf32"] - tf32 \
        == tg.gemm_update.launches - launches
    _tf32_close(torch.from_numpy(C.to_dense()), torch.from_numpy(a),
                torch.from_numpy(b))


def test_a_mesh_recipe_runs_on_the_card(card, monkeypatch):
    """Ring attention over 2 gloo rank processes sharing the card: each
    rank's block within 1e-4 of dense attention on one process, the K/V
    rotations staged through the host (gloo's point-to-point takes host
    tensors)."""
    import json

    from parsec_tpu_torch.comm import run_multiproc
    monkeypatch.setenv("PARSEC_PAR_SPEC", json.dumps([
        {"kind": "ring", "mesh": {"sp": 2}, "shape": [1, 4, 256, 64],
         "causal": True, "seed": 0, "check": 1}]))
    res = run_multiproc(2, "parsec_tpu_torch.parallel.bodies:mesh_body",
                        timeout=120, transport="device", distributed=True)
    for r in res:
        assert r[0]["err"] <= 1e-4, r[0]
        assert r[0]["staged_by_op"].get("send_recv", 0) > 0, r[0]


# ---------------------------------------------------------------------------
# K2: the ragged paged-attention page update, and decode serving on the card
# ---------------------------------------------------------------------------

def _attn_case(batch, P, H, D, seed):
    """Tile batches with fills cycling 0..P and, on odd tasks, a
    non-empty accumulator (one plain update on a full page)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q3 = torch.randn(batch, 3, H, D, device="cuda", generator=g)
    page = torch.randn(batch, 3, P, H, D, device="cuda", generator=g)
    page[:, 2] = 0.0
    page[:, 2, 0, 0, 0] = (torch.arange(batch, device="cuda")
                           % (P + 1)).float()
    acc = torch.zeros(batch, H, D + 2, device="cuda")
    warm = page[1::2].clone()
    warm[:, 2, 0, 0, 0] = float(P)
    acc[1::2] = ra.attn_page_update_plain(q3[1::2], warm, acc[1::2])
    return q3, page, acc


# tolerance: fp32 sums in another order than the plain version; 1e-5 at
# D=8, 1e-4 at D=128 (128-term scores); a wrong or unmasked slot is O(1)
@pytest.mark.parametrize("batch,P,H,D,tol", [
    (64, 16, 4, 8, 1e-5),            # the serving path's ToyLM pages
    (1024, 16, 32, 128, 1e-4)])      # a Llama-2-7B head geometry
def test_ragged_attn_kernel_matches_plain(card, batch, P, H, D, tol):
    q3, page, acc = _attn_case(batch, P, H, D, 5)
    want = ra.attn_page_update_plain(q3, page, acc)
    before = ra.attn_page_update.launches
    tiles = ra.attn_page_update_tiles(list(q3), list(page), list(acc))
    strided = ra.attn_page_update(q3, page, acc)
    torch.cuda.synchronize()
    assert ra.attn_page_update.launches == before + 2
    assert len({t.untyped_storage().data_ptr() for t in tiles}) == batch
    torch.testing.assert_close(torch.stack(tiles), want, rtol=0, atol=tol)
    torch.testing.assert_close(strided, want, rtol=0, atol=tol)
    one = ra.attn_page_update(q3[3], page[3], acc[3])
    torch.testing.assert_close(one, want[3], rtol=0, atol=tol)


def test_ragged_attn_kernel_takes_bf16_pages(card):
    q3, page, acc = _attn_case(32, 16, 4, 8, 6)
    page = page.bfloat16()
    got = ra.attn_page_update(q3, page, acc)
    torch.testing.assert_close(got, ra.attn_page_update_plain(q3, page, acc),
                               rtol=0, atol=1e-5)


# a Llama-2-7B head geometry, fp32 and bf16 pages (bf16 widens exactly to
# fp32 on both sides, so the fp32 tolerance holds); batch 1 and 5 are the
# serving path's, 64 the largest by-value batch, 1024 past it (a device
# array of pointers)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 5, 64, 1024])
def test_ragged_attn_both_forms_at_llama_width(card, batch, dtype):
    q3, page, acc = _attn_case(batch, 16, 32, 128, 8)
    page = page.to(dtype)
    want = ra.attn_page_update_plain(q3, page, acc)
    qs, pages = list(q3), list(page)
    before = ra.attn_page_update.launches
    functional = ra.attn_page_update_tiles(qs, pages, list(acc))
    accs = [a.clone() for a in acc]
    ptrs = [a.data_ptr() for a in accs]
    inplace = ra.attn_page_update_tiles_(qs, pages, accs)
    torch.cuda.synchronize()
    assert ra.attn_page_update.launches == before + 2
    # in place: the very ACC tiles; functional: each in storage of its own
    assert [t.data_ptr() for t in inplace] == ptrs
    assert all(t is a for t, a in zip(inplace, accs))
    assert len({t.untyped_storage().data_ptr() for t in functional}
               | {t.untyped_storage().data_ptr() for t in acc}) \
        == batch + 1
    torch.testing.assert_close(torch.stack(functional), want, rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(torch.stack(inplace), want, rtol=0, atol=1e-4)
    one = acc[batch - 1].clone()
    assert ra.attn_page_update_(q3[batch - 1], page[batch - 1], one) is one
    torch.testing.assert_close(one, want[batch - 1], rtol=0, atol=1e-4)


# pages whose filled K/V outgrows one block (P=1024: 1 MiB a head) walk the
# slots in chunks; odd widths stage with 4-byte (72-byte runs) and 2-byte
# (bf16, 30-byte runs) copies in place of 16-byte ones
@pytest.mark.parametrize("P,H,D,dtype", [
    (1024, 2, 128, torch.float32),
    (1024, 2, 128, torch.bfloat16),
    (16, 3, 6, torch.float32),
    (16, 3, 5, torch.bfloat16)])
def test_ragged_attn_chunks_and_narrow_copies(card, P, H, D, dtype):
    q3, page, acc = _attn_case(8, P, H, D, 9)
    page = page.to(dtype)
    page[:, 2, 0, 0, 0] = torch.tensor([P, P - 1, 700 % (P + 1), 0, 1,
                                        65 % (P + 1), 2 * 64 % (P + 1), 3],
                                       device="cuda", dtype=dtype)
    hg, cs = ra.plan(P, H, D, page.element_size())
    if P > 16:
        assert (hg, cs) == (1, 16 if dtype == torch.float32 else 32)
    want = ra.attn_page_update_plain(q3, page, acc)
    got = ra.attn_page_update_tiles_(list(q3), list(page), list(acc.clone()))
    torch.cuda.synchronize()
    # P = 1024 slots: 1024-term sums, chunked in another order
    torch.testing.assert_close(torch.stack(got), want, rtol=0,
                               atol=1e-4 if P > 16 else 1e-5)


@pytest.mark.parametrize("bad", ["q3_dtype", "acc_shape", "page_heads",
                                 "mixed_device", "noncontiguous"])
def test_ragged_attn_wrapper_raises_on_cuda_without_fallback(card, bad):
    q3, page, acc = _attn_case(2, 16, 4, 8, 7)
    q3, page, acc = q3[0], page[0], acc[0]
    if bad == "q3_dtype":
        q3 = q3.double()
    elif bad == "acc_shape":
        acc = acc[:, :-1].contiguous()
    elif bad == "page_heads":
        page = page[:, :, :2].contiguous()
    elif bad == "mixed_device":
        acc = acc.cpu()
    else:
        page = page.transpose(2, 3).contiguous().transpose(2, 3)
    before = ra.attn_page_update.launches
    with pytest.raises((TypeError, ValueError)):
        ra.attn_page_update(q3, page, acc)
    with pytest.raises((TypeError, ValueError)):
        ra.attn_page_update_(q3, page, acc)
    with pytest.raises((TypeError, ValueError)):
        ra.attn_page_update_tiles_([q3], [page], [acc])
    assert ra.attn_page_update.launches == before


def test_streams_decode_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    model = ToyLM()
    prompts = [list(range(3, 40)), [5, 9, 11], list(range(60, 0, -3))]
    before = ra.attn_page_update.launches
    with RuntimeServer(nb_cores=2) as server:
        tks = [server.submit_stream(p, max_new_tokens=12, tenant=f"t{i % 2}")
               for i, p in enumerate(prompts)]
        fork = server.submit_stream(prompts[0], max_new_tokens=5,
                                    fork_from=tks[0])
        for p, tk in zip(prompts, tks):
            assert tk.result(timeout=120)["tokens"] == \
                model.reference_generate(p, 12)
        assert fork.result(timeout=120)["tokens"] == \
            model.reference_generate(prompts[0], 5)
        assert server.stats()["llm"]["kv"]["physical_pages"] == 0
    dev = [d for d in registry.by_type("cuda") if d.is_cuda][0]
    assert dev.tasks_by_class["ATTN"] > 0 and dev.tasks_by_class["PF"] > 0
    assert ra.attn_page_update.launches > before


# ---------------------------------------------------------------------------
# K3: the 1-D stencil, and the lowered taskpools on the card
# ---------------------------------------------------------------------------

# fp32: the kernel fuses each tap's multiply-add, the plain version rounds
# the product first (a few ulp); bf16 output: one bf16 ulp where the two
# fp32 sums round to neighbouring values
@pytest.mark.parametrize("shape,dtype,taps,tol", [
    ((62, 4104), torch.float32, 9, 1e-5),
    ((62, 4104), torch.bfloat16, 9, 4e-2),
    ((1, (1 << 20) + 8), torch.float32, 9, 1e-5),   # past 2^17: no fallback
    ((3, 5, 2051), torch.float32, 3, 1e-5),         # 3-D, ragged chunk
    ((7, 64), torch.float32, 63, 1e-5)])
def test_stencil_kernel_matches_plain(card, shape, dtype, taps, tol):
    g = torch.Generator(device="cuda").manual_seed(9)
    p = torch.randn(*shape, device="cuda", generator=g).to(dtype)
    w = torch.randn(taps, generator=torch.Generator().manual_seed(taps))
    before = ks.stencil1d.launches
    got = ks.stencil1d(p, w)
    torch.cuda.synchronize()
    assert ks.stencil1d.launches == before + 1
    want = ks.stencil1d_plain(p, w)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("bad", ["float64", "taps", "noncontiguous"])
def test_stencil_wrapper_raises_on_cuda_without_fallback(card, bad):
    p = torch.randn(4, 128, device="cuda")
    w = [0.25, 0.5, 0.25]
    if bad == "float64":
        p = p.double()
    elif bad == "taps":
        w = [0.01] * (ks.MAX_TAPS + 1)
    else:
        p = p[:, ::2]
    before = ks.stencil1d.launches
    with pytest.raises((TypeError, ValueError)):
        ks.stencil1d(p, w)
    assert ks.stencil1d.launches == before


def _rows_case(R, dtype, rows, length, seed, pitch=0, scattered=False):
    """A store of ``rows`` rows of ``length`` (a row pitch ``pitch``
    longer, where set), a group of G = rows - 2 tiles and their left and
    right neighbours' rows (-1 at the two edges), consecutive or in a
    seeded order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = torch.randn(rows, length + pitch, device="cuda", generator=g)
    st = full.to(dtype)[:, :length]
    G = rows - 2
    c = torch.arange(1, G + 1, device="cuda")
    if scattered:
        c = c[torch.randperm(G, generator=torch.Generator().manual_seed(
            seed)).cuda()]
    lt, rt = c - 1, c + 1
    lt[c == 1] = -1
    rt[c == G] = -1
    cr = slice(1, G + 1) if not scattered else c
    w = torch.randn(2 * R + 1, generator=torch.Generator().manual_seed(R))
    return st, cr, lt, rt, w


# fp32: fmaf against the plain version's rounded products (a few ulp of
# |out| of order 1-10); bf16 output: one bf16 ulp (2^-7 of |out|, and
# 4e-2 near 0) where the two fp32 sums round apart
@pytest.mark.parametrize("R,dtype,rows,length,pitch,scattered,tol", [
    (1, torch.float32, 10, 4096, 0, False, 1e-5),
    (4, torch.float32, 10, 4096 + 3, 0, True, 1e-5),     # unaligned rows
    (4, torch.bfloat16, 10, 4100, 0, False, 4e-2),
    (4, torch.bfloat16, 7, 8191, 0, True, 4e-2),
    (4, torch.float32, 9, 5000, 12, True, 1e-5),         # a row pitch
    (31, torch.float32, 5, 70, 0, False, 1e-5),          # 63 taps
    (4, torch.float32, 66, 1 << 18, 0, False, 1e-5),     # one rank's level
    (4, torch.bfloat16, 66, 1 << 18, 0, False, 4e-2)])
def test_stencil_rows_kernel_matches_plain(card, R, dtype, rows, length,
                                           pitch, scattered, tol):
    st, cr, lt, rt, w = _rows_case(R, dtype, rows, length, 20 + R, pitch,
                                   scattered)
    before = ks.stencil1d.launches
    got = ks.stencil1d_rows(st, cr, st, lt, st, rt, w)
    torch.cuda.synchronize()
    assert ks.stencil1d.launches == before + 1
    want = ks.stencil1d_rows_plain(st, cr, st, lt, st, rt, w)
    assert got.shape == want.shape == (rows - 2, length)
    assert got.dtype == dtype
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=tol)


def test_stencil_rows_kernel_three_stores_and_one_row(card):
    """Each flow from its own store, a flow with no rows (zeros), and a
    group of one."""
    R = 4
    g = torch.Generator(device="cuda").manual_seed(31)
    c, lft = (torch.randn(6, 4104, device="cuda", generator=g)
              for _ in range(2))
    w = [0.1] * (2 * R + 1)
    lt = torch.tensor([5, 0, 3], device="cuda")
    for args in ((c, slice(2, 5), lft, lt, None, None),
                 (c, slice(4, 5), None, None, lft,
                  torch.tensor([2], device="cuda"))):
        got = ks.stencil1d_rows(*args, w)
        want = ks.stencil1d_rows_plain(*args, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad", ["float64", "taps", "even", "range",
                                 "cpu_rows", "dtypes"])
def test_stencil_rows_wrapper_raises_on_cuda_without_fallback(card, bad):
    st = torch.randn(6, 256, device="cuda")
    c, lt, rt = slice(1, 5), torch.tensor([-1, 1, 2, 3], device="cuda"), \
        torch.tensor([2, 3, 4, -1], device="cuda")
    lst = st
    w = [0.1] * 9
    if bad == "float64":
        st = lst = st.double()
    elif bad == "taps":
        w = [0.01] * (ks.MAX_TAPS + 1)
    elif bad == "even":
        w = [0.1] * 8
    elif bad == "range":
        lt = torch.tensor([-1, 1, 2, 6], device="cuda")
    elif bad == "cpu_rows":
        lt = lt.cpu()
    else:
        lst = st.bfloat16()
    before = ks.stencil1d.launches
    with pytest.raises((TypeError, ValueError)):
        ks.stencil1d_rows(st, c, lst, lt, st, rt, w)
    assert ks.stencil1d.launches == before


def test_lowered_stencil_on_the_card(card):
    rng = np.random.default_rng(4)
    base = rng.standard_normal(8 * 4096).astype(np.float32)
    V = VectorTwoDimCyclic("V", lm=len(base), mb=4096,
                           init_fn=lambda m, s: base[m * 4096:m * 4096 + s])
    w = np.full(9, 1.0 / 9)
    low = lower_taskpool(stencil_1d_ptg(V, w, 5))
    assert low.mode == "wavefront"
    before = ks.stencil1d.launches
    low.execute()
    assert ks.stencil1d.launches == before + 5     # one a level
    got = torch.cat([V.data_of(i).newest_copy().value for i in range(8)])
    np.testing.assert_allclose(got.numpy(),
                               stencil_reference(base, w, 5).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("ab_dtype", [torch.float32, torch.bfloat16])
def test_lowered_gemm_on_the_card(card, ab_dtype):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((512, 384), dtype=np.float32)
    b = rng.standard_normal((384, 256), dtype=np.float32)
    A = TiledMatrix.from_dense("A", torch.from_numpy(a).to(ab_dtype), 128, 128)
    B = TiledMatrix.from_dense("B", torch.from_numpy(b).to(ab_dtype), 128, 128)
    C = TiledMatrix("C", 512, 256, 128, 128)
    low = lower_taskpool(tiled_gemm_ptg(A, B, C))
    assert low.mode == "chain-collapse" and low.layout["C"] == "dense"
    before = dict(tg.gemm_update.launches_by_variant)
    low.execute()
    variant = "mma_tf32" if ab_dtype == torch.float32 else "wgmma_bf16"
    assert _variant_delta(before) == {variant: 1}
    if ab_dtype == torch.float32:
        _tf32_close(C.to_tensor(), A.to_tensor(), B.to_tensor())
    else:
        want = A.to_tensor().double() @ B.to_tensor().double()
        torch.testing.assert_close(C.to_tensor().double(), want, rtol=1e-4,
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# K1's transposed and subtracting forms; tiled Cholesky and LU on the card
# ---------------------------------------------------------------------------

# (trans_b, subtract, with C): the forms the factorizations call
K1_FORMS = {"nt_sub": (True, True, True),     # gemm_nt, syrk_ln
            "nt": (True, False, False),       # trsm_rlt
            "nn_sub": (False, True, True),    # lu_gemm
            "nt_add": (True, False, True),
            "nn_sub_noc": (False, True, False)}


def _form_inputs(shape, form, in_dtype=torch.float32, seed=20):
    trans_b, subtract, with_c = K1_FORMS[form]
    g = torch.Generator(device="cuda").manual_seed(seed)
    *lead, m, n, k = shape
    a = torch.randn(*lead, m, k, device="cuda", generator=g).to(in_dtype)
    b = torch.randn(*lead, *((n, k) if trans_b else (k, n)), device="cuda",
                    generator=g).to(in_dtype)
    c = torch.randn(*lead, m, n, device="cuda", generator=g) \
        if with_c else None
    return a, b, c, dict(trans_b=trans_b, subtract=subtract)


@pytest.mark.parametrize("entry", ["strided", "tiles"])
@pytest.mark.parametrize("prec,variant", [("default", "mma_tf32"),
                                          ("highest", "simt_fp32")])
@pytest.mark.parametrize("shape", [(3, 130, 264, 72), (2, 256, 192, 2052)])
@pytest.mark.parametrize("form", sorted(K1_FORMS))
def test_k1_forms_match_plain(card, precision, form, shape, prec, variant,
                              entry):
    """Each form on both fp32 variants, strided and as a tile list, held
    against the plain version of the variant's arithmetic (TF32-rounded
    inputs for ``mma_tf32``): M/N edges, and 65 k-tiles of 32 with a tail
    of 4."""
    a, b, c, kw = _form_inputs(shape, form)
    *_, m, n, k = shape
    assert tg.k1_variant(a.dtype, torch.float32, m, n, k, True, prec,
                         **kw) == variant
    params.set("gemm_precision", prec)
    before = dict(tg.gemm_update.launches_by_variant)
    if entry == "strided":
        got = tg.gemm_update(a, b, c, **kw)
    else:
        got = torch.stack(tg.gemm_update_tiles(
            list(a), list(b), None if c is None else list(c), **kw))
    torch.cuda.synchronize()
    assert _variant_delta(before) == {variant: 1}
    want = tg.gemm_update_plain(a, b, c, tf32=variant == "mma_tf32", **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("form", ["nt_sub", "nn_sub"])
def test_bf16_forms_run_on_simt(card, form):
    """``wgmma_bf16`` takes neither new form: the rule sends bf16 with
    ``trans_b`` or ``subtract`` to ``simt_fp32``."""
    a, b, c, kw = _form_inputs((2, 128, 256, 64), form, torch.bfloat16)
    assert tg.k1_variant(a.dtype, c.dtype, 128, 256, 64, True, "default",
                         **kw) == "simt_fp32"
    before = dict(tg.gemm_update.launches_by_variant)
    got = tg.gemm_update(a, b, c, **kw)
    torch.cuda.synchronize()
    assert _variant_delta(before) == {"simt_fp32": 1}
    torch.testing.assert_close(got, tg.gemm_update_plain(a, b, c, **kw),
                               rtol=1e-4, atol=1e-3)


def test_syrk_tile_list_reads_one_tile_as_a_and_b(card, precision):
    params.set("gemm_precision", "highest")
    g = torch.Generator(device="cuda").manual_seed(21)
    as_ = [torch.randn(128, 128, device="cuda", generator=g)
           for _ in range(4)]
    ts = [torch.randn(128, 128, device="cuda", generator=g)
          for _ in range(4)]
    got = chol.syrk_tiles(as_, ts)
    for x, a, t in zip(got, as_, ts):
        torch.testing.assert_close(x, t - a @ a.T, rtol=1e-4, atol=1e-3)


def _rows_of_one_store(G, nb, seed):
    """A store of 3 G tiles ``nb x nb`` on the card and three disjoint
    sets of G scattered rows in it, as a lowered step's indices."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    st = torch.randn(3 * G, nb, nb, device="cuda", generator=g)
    perm = torch.randperm(3 * G, generator=torch.Generator().manual_seed(
        seed)).numpy()
    return (st, *(_Index(perm[i * G:(i + 1) * G]) for i in range(3)))


def test_k1_rows_entry_writes_into_c_bit_for_bit_as_stacked(card):
    """``gemm_update_rows``, ``mma_tf32`` nt-sub over 465 tiles of 512³
    (the lowered Cholesky's largest GEMM group) read where they lie in one
    store, ``out`` the C rows themselves: bit for bit
    ``gemm_update_stacked`` on gathered copies of the same rows (the same
    kernel on the same tiles, read through its tile pointers)."""
    st, a_rows, b_rows, c_rows = _rows_of_one_store(465, 512, 23)
    want = tg.gemm_update_stacked(*(st[r.on(st.device)]
                                    for r in (a_rows, b_rows, c_rows)),
                                  trans_b=True, subtract=True)
    before = dict(tg.gemm_update.launches_by_variant)
    c = (st, c_rows)
    assert tg.gemm_update_rows((st, a_rows), (st, b_rows), c, c,
                               trans_b=True, subtract=True) is None
    torch.cuda.synchronize()
    assert _variant_delta(before) == {"mma_tf32": 1}
    assert torch.equal(st[c_rows.on(st.device)], want)


@pytest.mark.parametrize("over", ["A", "B"])
def test_k1_rows_entry_refuses_out_over_a_or_b(card, over):
    st, a_rows, b_rows, c_rows = _rows_of_one_store(4, 64, 24)
    out_rows = c_rows.rows.copy()
    out_rows[1] = (a_rows if over == "A" else b_rows).rows[2]
    before = dict(tg.gemm_update.launches_by_variant)
    kept = st.clone()
    with pytest.raises(ValueError, match=f"shares rows with {over}"):
        tg.gemm_update_rows((st, a_rows), (st, b_rows), (st, c_rows),
                            (st, _Index(out_rows)), trans_b=True,
                            subtract=True)
    assert _variant_delta(before) == {}
    assert torch.equal(st, kept)


def test_lowered_cholesky_rows_hooks_give_the_stacked_factor(card):
    """The lowered Cholesky with its K1 classes on their rows hooks (read
    in place, SYRK and GEMM written back) and with their list forms on
    gathered (stacked) rows (the hooks unregistered for the run): the
    same factor, bit for bit, and 0 rows gathered against the gathered
    run's."""
    a = chol.make_spd_fast(1024, 25)
    names = ("trsm_rlt", "syrk_ln", "gemm_nt")

    def run():
        A = SymTwoDimBlockCyclic.from_dense("A", a, 128, 128)
        low = lower_taskpool(chol.tiled_cholesky_ptg(A))
        out = low.step_fn(low.initial_stores())["A"]
        torch.cuda.synchronize()
        return low, out

    low, got = run()
    kept = {name: find_traceable(name) for name in names}
    try:
        for name, t in kept.items():
            register_traceable(name, t.apply, libs=t.libs)
        low_st, want = run()
    finally:
        for name, t in kept.items():
            register_traceable(name, t.apply, rows=t.rows,
                               rows_into=t.rows_into, libs=t.libs)
    assert torch.equal(got, want)
    assert low.rows_moved["gather"] == {}
    assert low.rows_moved["in_place"]["written"] == {"A": 8 * 7 * 9 // 6}
    assert low_st.rows_moved["gather"]["A"] > 0


def _spd_tiles(n, count, seed):
    a = torch.from_numpy(np.stack([chol.make_spd_fast(n, seed + i)
                                   for i in range(count)])).cuda()
    return a


@pytest.mark.parametrize("prec", ["default", "highest"])
def test_cholesky_bodies_match_plain(card, precision, prec):
    """The batched POTRF, TRSM, SYRK and GEMM bodies on the card against
    the same list forms on the CPU (the plain route of every operation).
    Under ``highest`` both sides are strict fp32: ``rtol=1e-4, atol=1e-4``
    (the library's factor and solve differ in order only); under
    ``default`` the products are TF32, within 2^-10 of each product's
    size: ``rtol=5e-3, atol=5e-3`` at nb=256 with unit-scale factors."""
    params.set("gemm_precision", prec)
    tol = dict(rtol=1e-4, atol=1e-4) if prec == "highest" \
        else dict(rtol=5e-3, atol=5e-3)
    nb = 256
    spd = _spd_tiles(nb, 3, 30)
    L = chol.potrf_tiles(list(spd))
    for x, s in zip(L, spd):
        torch.testing.assert_close(x.cpu(), factor.potrf(s.cpu()), **tol)
    g = torch.Generator(device="cuda").manual_seed(31)
    cs = [torch.randn(nb, nb, device="cuda", generator=g) for _ in range(5)]
    ls = [L[0], L[0], L[1], L[2], L[0]]         # a shared diagonal tile
    for got, want in zip(chol.trsm_tiles(ls, cs),
                         chol.trsm_tiles([x.cpu() for x in ls],
                                         [c.cpu() for c in cs])):
        torch.testing.assert_close(got.cpu(), want, **tol)
    a, b, c = (torch.randn(4, nb, nb, device="cuda", generator=g)
               for _ in range(3))
    for got, want in ((chol.syrk_tiles(list(a), list(c)),
                       chol.syrk_tiles(list(a.cpu()), list(c.cpu()))),
                      (chol.gemm_nt_tiles(list(a), list(b), list(c)),
                       chol.gemm_nt_tiles(list(a.cpu()), list(b.cpu()),
                                          list(c.cpu())))):
        torch.testing.assert_close(torch.stack(got).cpu(),
                                   torch.stack(want), rtol=tol["rtol"],
                                   atol=tol["atol"] * nb)
    # the TRSM's rows hook, one diagonal tile shared by the group
    st = torch.cat([L[1][None], a])
    rows = chol.trsm_rows((st, _Index(np.zeros(4, np.int64))),
                          (st, _Index(np.arange(1, 5))))
    torch.testing.assert_close(
        rows.cpu(),
        torch.stack(chol.trsm_tiles([L[1].cpu()] * 4, list(a.cpu()))),
        **tol)


def test_lu_bodies_match_plain(card, precision):
    """GETRF on the card (``lu_factor_ex`` without pivoting) against the
    rank-1 loop on the same tile, and the TRSM_L/TRSM_U/GEMM bodies
    against their CPU routes, in strict fp32 (``highest``):
    ``rtol=1e-4, atol=1e-4``; a diagonally dominant tile keeps the
    factors well scaled."""
    params.set("gemm_precision", "highest")
    nb = 256
    t = torch.from_numpy(np.stack([lu.make_dd(nb, 40 + i)
                                   for i in range(2)])).cuda()
    got = lu.getrf_tiles(list(t))
    for x, s in zip(got, t):
        torch.testing.assert_close(x, factor.getrf_nopiv_plain(s),
                                   rtol=1e-4, atol=1e-4)
    g = torch.Generator(device="cuda").manual_seed(41)
    cs = [torch.randn(nb, nb, device="cuda", generator=g) for _ in range(3)]
    ks = [got[0], got[1], got[0]]
    for fn in (lu.trsm_l_tiles, lu.trsm_u_tiles):
        for x, want in zip(fn(ks, cs), fn([k.cpu() for k in ks],
                                          [c.cpu() for c in cs])):
            torch.testing.assert_close(x.cpu(), want, rtol=1e-4, atol=1e-4)
    a, b, c = (torch.randn(3, nb, nb, device="cuda", generator=g)
               for _ in range(3))
    torch.testing.assert_close(
        torch.stack(lu.gemm_tiles(list(a), list(b), list(c))).cpu(),
        torch.stack(lu.gemm_tiles(list(a.cpu()), list(b.cpu()),
                                  list(c.cpu()))), rtol=1e-4, atol=1e-2)


# the diagonal tile's hand kernels (csrc/factor.cu): POTRF and the lower
# triangular inverse, each against its library call and float64.  Both
# routes are fp32 throughout; with a unit-scale SPD input (eigenvalues in
# [1, 5]) each lies within a few fp32 roundings of the float64 factor or
# inverse, relative to its largest entry: ``FACTOR_RTOL`` (both routes read
# 1e-7 to 4e-7 on an H100), where one wrong entry is off by O(1).
FACTOR_RTOL = 2e-6
FACTOR_NB = [32, 64, 128, 256, 512]


def _spd64(nb, batch, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, nb, nb, device="cuda", generator=g,
                    dtype=torch.float64)
    return x @ x.transpose(-1, -2) / nb + torch.eye(
        nb, device="cuda", dtype=torch.float64)


def _rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def _route_delta(before):
    now = factor.launches_by_route
    return {k: now[k] - before.get(k, 0) for k in now
            if now[k] != before.get(k, 0)}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("nb", FACTOR_NB)
def test_hand_potrf_matches_the_library_and_float64(card, nb, batch):
    a64 = _spd64(nb, batch, nb + batch)
    ref = torch.linalg.cholesky(a64)
    before = dict(factor.launches_by_route)
    got = factor.potrf(a64.float())
    assert _route_delta(before) == {("potrf", "hand"): 1}
    lib = torch.linalg.cholesky_ex(a64.float())[0]
    assert got.shape == (batch, nb, nb) and got.is_contiguous()
    assert got.dtype == torch.float32
    assert torch.count_nonzero(torch.triu(got, 1)) == 0
    assert _rel(got, ref) < FACTOR_RTOL
    assert _rel(lib, ref) < FACTOR_RTOL
    assert _rel(got, lib.double()) < FACTOR_RTOL


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("nb", FACTOR_NB)
def test_hand_inverse_matches_the_library_and_float64(card, nb, batch):
    L64 = torch.linalg.cholesky(_spd64(nb, batch, 2 * nb + batch))
    L = L64.float()
    ref = torch.linalg.inv(L.double())
    before = dict(factor.launches_by_route)
    got = factor.tri_inverse(L, upper=False)
    assert _route_delta(before) == {("trsm", "hand"): 1}
    eye = torch.eye(nb, device="cuda").expand(batch, nb, nb)
    lib = torch.linalg.solve_triangular(L, eye, upper=False)
    assert got.shape == (batch, nb, nb) and got.is_contiguous()
    assert torch.count_nonzero(torch.triu(got, 1)) == 0
    assert _rel(got, ref) < FACTOR_RTOL
    assert _rel(got, lib.double()) < FACTOR_RTOL
    # the list form: a tile listed twice is inverted once, by the kernel
    before = dict(factor.launches_by_route)
    invs = factor.tri_inverse_tiles([L[0], L[-1], L[0]], upper=False)
    assert _route_delta(before) == {("trsm", "hand"): 1}
    assert torch.equal(invs[0], invs[2])
    assert torch.equal(invs[1], got[-1])


def test_hand_kernels_read_store_rows_where_they_lie(card):
    """A view of a store row, and a tile inside a wider pitch, give what
    their contiguous copies give, bit for bit, as does a tile whose rows
    are not 16-byte aligned (copied first); a stride-0 broadcast stack is
    inverted once and broadcast back."""
    nb = 512
    st = _spd64(nb, 4, 70).float()
    row = factor.potrf(st[2:3])
    assert row.shape == (1, nb, nb)
    assert torch.equal(row[0], factor.potrf(st[2].clone()))
    wide = torch.zeros(nb, nb + 96, device="cuda")
    wide[:, :nb] = st[1]
    assert torch.equal(factor.potrf(wide[:, :nb]), factor.potrf(st[1]))
    L = factor.potrf(st[0])
    before = dict(factor.launches_by_route)
    inv = factor.tri_inverse(L[None].expand(5, nb, nb), upper=False)
    assert _route_delta(before) == {("trsm", "hand"): 1}
    assert inv.shape == (5, nb, nb) and inv.stride(0) == 0
    assert torch.equal(inv[4], factor.tri_inverse(L, upper=False))
    wl = torch.zeros(nb, nb + 96, device="cuda")
    wl[:, :nb] = L
    assert torch.equal(factor.tri_inverse(wl[:, :nb], upper=False),
                       factor.tri_inverse(L, upper=False))
    # rows that are not 16-byte aligned: read from a contiguous copy
    odd = torch.zeros(nb, nb + 1, device="cuda")
    odd[:, 1:] = st[1]
    assert torch.equal(factor.potrf(odd[:, 1:]), factor.potrf(st[1]))


def test_hand_potrf_gives_a_nan_tile_where_not_spd(card):
    st = _spd64(256, 3, 71).float()
    st[1, 200, 200] = -1e3
    st[2, 7, 7] = float("inf")
    out = factor.potrf(st)
    torch.cuda.synchronize()
    assert out[1].isnan().all() and out[2].isnan().all()
    assert torch.equal(out[0], factor.potrf(st[0]))
    assert out[0].isfinite().all()


def test_a_failed_hand_launch_raises(card, monkeypatch):
    """No fallback: a launch the kernel refuses raises, naming it."""
    def refused(*args):
        return 1
    monkeypatch.setattr(factor, "_entries", lambda: (refused, refused))
    t = _spd64(64, 1, 72).float()
    with pytest.raises(RuntimeError, match="potrf kernel launch failed"):
        factor.potrf(t)
    with pytest.raises(RuntimeError, match="trinv kernel launch failed"):
        factor.tri_inverse(t, upper=False)


def _lowered_factor(a, nb, library):
    """The lowered Cholesky of ``a`` (one step on the card) through the
    hand route, or through the library route with ``library``; the
    factor's lower triangle and the routes' launch counts a solve."""
    A = SymTwoDimBlockCyclic.from_dense("A", a, nb, nb)
    low = lower_taskpool(chol.tiled_cholesky_ptg(A))
    real = factor.hand_route
    if library:
        factor.hand_route = lambda *args, **kw: False
    try:
        before = dict(factor.launches_by_route)
        low.execute()
        torch.cuda.synchronize()
        counts = _route_delta(before)
    finally:
        factor.hand_route = real
    return torch.tril(torch.from_numpy(A.to_dense())).double(), counts


@pytest.mark.parametrize("nt", [4, 32])
def test_lowered_cholesky_hand_route_matches_the_library_route(card, nt):
    """The lowered Cholesky of nt x nt tiles of 512 through the hand
    kernels against the same step through the library: one hand POTRF a
    diagonal tile and one hand inverse a TRSM level, no library call, and
    factors within fp32 roundings of each other tile by tile (their TF32
    products agree), each within the TF32 gate of float64 at nt = 4."""
    nb = 512
    a = chol.make_spd_fast(nt * nb, seed=26)
    hand, counts = _lowered_factor(a, nb, library=False)
    assert counts == {("potrf", "hand"): nt, ("trsm", "hand"): nt - 1}
    lib, lib_counts = _lowered_factor(a, nb, library=True)
    assert lib_counts == {("potrf", "library"): nt,
                          ("trsm", "library"): nt - 1}
    assert factor.tile_error(hand, lib, nb) < 1e-4
    if nt == 4:
        ref = torch.linalg.cholesky(torch.from_numpy(a).double().cuda())
        assert factor.tile_error(hand.cuda(), ref, nb) < TF32_TILE_TOL


# the tile-error gate of TF32 products (chip_smoke.py's FACTOR_TOL): the
# TRSMs' rounding of the panel (2^-11) reads about 4e-4; one dropped
# trailing update reads about sqrt(nb)/n, 2e-2 at n=1024, nb=256
TF32_TILE_TOL = 1e-3


def _tile_error(factored: np.ndarray, a: np.ndarray, kind: str,
                nb: int) -> float:
    """The factor against the float64 factor of ``a``, tile by tile."""
    f = torch.from_numpy(factored).cuda().double()
    ref = torch.from_numpy(a).cuda().double()
    if kind == "cholesky":
        return factor.tile_error(torch.tril(f), torch.linalg.cholesky(ref),
                                 nb)
    return factor.tile_error(
        f, torch.linalg.lu_factor_ex(ref, pivot=False)[0], nb)


def _backward_error(factored: np.ndarray, a: np.ndarray, kind: str) -> float:
    f = torch.from_numpy(factored).cuda().double()
    if kind == "cholesky":
        L = torch.tril(f)
        prod = L @ L.T
    else:
        prod = (torch.tril(f, -1) + torch.eye(len(f), device="cuda",
                                              dtype=torch.float64)) \
            @ torch.triu(f)
    ref = torch.from_numpy(a).cuda().double()
    return float(torch.linalg.norm(ref - prod) / torch.linalg.norm(ref))


def test_dynamic_cholesky_syncs_no_host(card):
    """A small dynamic Cholesky with the card's sync debug mode at
    ``error``: no body (POTRF's ``cholesky_ex``, the inverses, K1's tile
    lists) may wait on the card from the host."""
    n, nb = 1024, 256
    a = chol.make_spd(n, seed=5)
    A = SymTwoDimBlockCyclic.from_dense("A", a, nb, nb)
    launches = tg.gemm_update.launches
    ctx = Context(nb_cores=2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ctx.add_taskpool(chol.tiled_cholesky_ptg(A))
        ctx.wait(timeout=120)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        ctx.fini(timeout=30)
    card.sync()
    card.flush_cache()
    assert tg.gemm_update.launches > launches
    # TF32 products: the backward error is a few 2^-11
    assert _backward_error(A.to_dense(), a, "cholesky") < 5e-3
    assert _tile_error(A.to_dense(), a, "cholesky", nb) < TF32_TILE_TOL


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
@pytest.mark.parametrize("path", ["dynamic", "lowered", "region"])
def test_factorization_on_the_card(card, kind, path):
    """Both factorizations through the three paths (the region path at a
    cap of 8 tasks, its regions on two worker threads) at n=1024, nb=256, fp32 at
    the default knob; every tile product on K1 (``mma_tf32``), the
    backward error within a few TF32 roundings (2^-11): under 5e-3, and
    each tile within ``TF32_TILE_TOL`` of the float64 factor."""
    n, nb = 1024, 256
    a, A = _factor_run(card, kind, path, n, nb)
    assert _backward_error(A.to_dense(), a, kind) < 5e-3
    assert _tile_error(A.to_dense(), a, kind, nb) < TF32_TILE_TOL


def _factor_run(card, kind, path, n, nb):
    """One factorization of ``make_spd_fast``/``make_dd(seed=6)`` on the
    card through the dynamic or lowered path; every product on K1's
    ``mma_tf32``.  Returns the input and the factored matrix."""
    if kind == "cholesky":
        a = chol.make_spd_fast(n, seed=6)
        A = SymTwoDimBlockCyclic.from_dense("A", a.copy(), nb, nb)
        tp = chol.tiled_cholesky_ptg(A)
    else:
        a = lu.make_dd(n, seed=6)
        A = TiledMatrix.from_dense("A", a.copy(), nb, nb)
        tp = lu.tiled_lu_ptg(A)
    before = dict(tg.gemm_update.launches_by_variant)
    if path == "lowered":
        low = lower_taskpool(tp)
        assert low.mode == "wavefront"
        low.execute()
    elif path == "region":
        plan = lower_regions(tp, max_tasks=8)
        assert len(plan.regions) > 2
        ctx = Context(nb_cores=2)
        try:
            plan.execute(context=ctx)
            torch.cuda.synchronize()
        finally:
            ctx.fini(timeout=30)
        assert plan.stats()["xla_calls"] == sum(
            r.step_fn is not None for r in plan.regions)
    else:
        ctx = Context(nb_cores=2)
        try:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=120)
            card.sync()
        finally:
            ctx.fini(timeout=30)
        card.flush_cache()
    ran = _variant_delta(before)
    assert set(ran) == {"mma_tf32"}, ran
    return a, A


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
@pytest.mark.parametrize("path", ["dynamic", "lowered"])
def test_factor_gate_sees_a_dropped_update(card, kind, path):
    """The control of ``TF32_TILE_TOL``: the same run with the first C
    tile of the trailing update's first call passed through (one GEMM
    task's update dropped) reads above the gate."""
    name = "gemm_nt" if kind == "cholesky" else "lu_gemm"
    n, nb = 1024, 256
    with factor.one_update_dropped(name) as dropped:
        a, A = _factor_run(card, kind, path, n, nb)
    assert dropped == [1]
    assert _tile_error(A.to_dense(), a, kind, nb) > TF32_TILE_TOL


@pytest.mark.parametrize("nb_cores", [0, 2])
def test_dtd_gemm_on_the_card(card, precision, nb_cores):
    """DTD GEMM with ``cuda_kernel="gemm"`` on the card: every task is a
    K1 launch (fused batches, ``mma_tf32`` under ``default``), the host
    body never runs, and after ``data_flush_all`` every C tile, home on
    the host, is within the TF32 bound of a float64 product."""
    from parsec_tpu_torch.dtd import DTDTaskpool
    from parsec_tpu_torch.models.tiled_gemm import insert_dtd_gemm
    params.set("gemm_precision", "default")
    nt, nb = 3, 256
    g = torch.Generator().manual_seed(21)
    A = [[torch.randn(nb, nb, generator=g) for _ in range(nt)]
         for _ in range(nt)]
    B = [[torch.randn(nb, nb, generator=g) for _ in range(nt)]
         for _ in range(nt)]
    C = [[torch.zeros(nb, nb) for _ in range(nt)] for _ in range(nt)]
    host_calls = []

    def gemm(a, b, c):
        host_calls.append(1)

    before = dict(tg.gemm_update.launches_by_variant)
    tasks0 = card.tasks_by_class["gemm"]
    ctx = Context(nb_cores=nb_cores)
    tp = DTDTaskpool()
    try:
        ctx.add_taskpool(tp)
        insert_dtd_gemm(tp, A, B, C, body=gemm)
        tp.data_flush_all()
        tp.wait(timeout=120)
    finally:
        ctx.fini(timeout=30)
    ran = _variant_delta(before)
    assert set(ran) == {"mma_tf32"} and 0 < ran["mma_tf32"] < nt ** 3, ran
    assert host_calls == []
    assert card.tasks_by_class["gemm"] - tasks0 == nt ** 3
    a64 = torch.cat([torch.cat(r, 1) for r in A]).double()
    b64 = torch.cat([torch.cat(r, 1) for r in B]).double()
    got = torch.cat([torch.cat(r, 1) for r in C]).double()
    assert got.device.type == "cpu"
    bound = 2e-3 * (a64.abs() @ b64.abs()) + 1e-2
    assert bool(((got - a64 @ b64).abs() <= bound).all())


def test_ep_pool_engages_the_compiled_executor(card):
    """On the card's machine the native core builds with ``g++`` and a
    host EP pool runs on the compiled DAG, every task once."""
    from parsec_tpu_torch import native
    from parsec_tpu_torch.models.ep import ep_pool
    assert native.available(), native.build_error
    done = []
    p = ep_pool(50, 20, lambda d, n: done.append((d, n)))
    tp = p.build()
    ctx = Context(nb_cores=0)
    try:
        ctx.add_taskpool(tp)
        assert type(tp._compiled_dag).__name__ == "VecCompiledDag"
        ctx.wait(timeout=60)
    finally:
        ctx.fini(timeout=30)
    assert sorted(done) == [(d, n) for d in range(20) for n in range(50)]


def test_device_fabric_snapshots_and_lands_on_the_card(card):
    """Registration snapshots a tile on the card (a device-side clone,
    counted in ``bytes_put``); a tile written in place afterwards still
    reaches its consumer as registered, landed on the card and counted
    in ``bytes_got``."""
    from parsec_tpu_torch.comm import DeviceFabric
    fab = DeviceFabric(2, [torch.device("cuda", 0)] * 2)
    e0, e1 = fab.attach(0), fab.attach(1)
    tile = torch.arange(1 << 12, dtype=torch.float32, device="cuda")
    h = e0.mem_register(tile, refcount=2)
    assert h.value.is_cuda and h.value.data_ptr() != tile.data_ptr()
    tile.add_(1.0)
    got = []
    for e in (e1, e1):
        e.get(h.wire(), got.append)
    while len(got) < 2:
        e0.progress()
        e1.progress()
    want = torch.arange(1 << 12, dtype=torch.float32, device="cuda")
    for g in got:
        assert g.is_cuda
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    assert got[0].data_ptr() != got[1].data_ptr()
    assert e0.bytes_put == 1 << 14 and e1.bytes_got == 2 << 14


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_factorization_across_four_ranks_on_the_card(card, kind):
    """Four ranks sharing the card (``devices=[cuda:0] * 4``, a 2 x 2
    grid) factor n=1024, nb=256 with every tile product on K1
    (``mma_tf32``) and tiles moving between the ranks on the card, under
    the gates of ``test_factorization_on_the_card``."""
    from parsec_tpu_torch.comm import run_multirank
    from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic
    n, nb = 1024, 256
    a = chol.make_spd_fast(n, seed=6) if kind == "cholesky" \
        else lu.make_dd(n, seed=6)
    cls = SymTwoDimBlockCyclic if kind == "cholesky" else TwoDimBlockCyclic
    build = chol.tiled_cholesky_ptg if kind == "cholesky" \
        else lu.tiled_lu_ptg
    before = dict(tg.gemm_update.launches_by_variant)

    def body(ctx, rank, nranks):
        A = cls.from_dense("A", a.copy(), nb, nb, P=2, Q=2, myrank=rank)
        ctx.add_taskpool(build(A))
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        return A.to_dense(), ctx.comm_engine.ce.bytes_got

    res = run_multirank(4, body, timeout=240, transport="device",
                        devices=[torch.device("cuda", 0)] * 4)
    card.flush_cache()
    assert set(_variant_delta(before)) == {"mma_tf32"}
    assert sum(r[1] for r in res) > 0
    f = sum(r[0] for r in res)
    assert _backward_error(f, a, kind) < 5e-3
    assert _tile_error(f, a, kind, nb) < TF32_TILE_TOL


def test_gemm_cholesky_and_dtd_across_four_processes_on_the_card(
        card, monkeypatch):
    """Four rank processes (``run_multiproc(transport="device")``), each
    with its own CUDA context and device module on the card: GEMM at
    n=2048, nb=512, every tile product on K1 (``mma_tf32``) in its rank
    and C within the TF32 bound; a Cholesky whose tiles cross the
    processes (D2H, TCP, H2D) under the factor gates; the DTD GEMM with
    its A and B tiles pushed between the processes."""
    from parsec_tpu_torch.comm import run_multiproc
    from parsec_tpu_torch.comm.mp_bodies import factor_input, gemm_dense
    n, nb = 2048, 512
    for key, value in (("KINDS", "gemm,cholesky,dtd"), ("N", n),
                       ("NB", nb), ("SEED", 0), ("CHORES", "cuda"),
                       ("WARMUP", "0")):
        monkeypatch.setenv(f"PARSEC_MP_{key}", str(value))
    res = run_multiproc(4, "parsec_tpu_torch.comm.mp_bodies:pool_body",
                        timeout=300, transport="device")
    assert [r["modules"] for r in res] == [[]] * 4
    a, b = gemm_dense(n, nb, 0)
    for kind in ("gemm", "cholesky", "dtd"):
        recs = [r["kinds"][kind] for r in res]
        assert all(r["k1"] > 0 and set(r["k1_by_variant"]) == {"mma_tf32"}
                   for r in recs), kind
        if kind == "dtd":     # its flushes are host tasks, its GEMMs not
            assert sum(r["dev"]["tasks_by_class"].get("gemm", 0)
                       for r in recs) == (n // nb) ** 3
            assert sum(r["pushes"] for r in recs) > 0
            got = sum(r["C"] for r in recs)
        else:
            assert all(r["cpu_tasks"] == 0 for r in recs), kind
            got = np.zeros((n, n), np.float32)
            for rec in recs:
                for (i, j), tile in rec["tiles"].items():
                    got[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = tile
        if kind == "cholesky":
            assert sum(r["gets"] for r in recs) > 0
            assert sum(r["tiers"]["payload_out"] for r in recs) \
                == sum(r["tiers"]["payload_in"] for r in recs) > 0
            spd = factor_input("cholesky", n)
            assert _backward_error(got, spd, kind) < 5e-3
            assert _tile_error(got, spd, kind, nb) < TF32_TILE_TOL
        else:
            _tf32_close(torch.from_numpy(got), torch.from_numpy(a),
                        torch.from_numpy(b))


def test_cholesky_across_four_processes_lands_fragments_pinned(
        card, monkeypatch):
    """The same Cholesky with ``comm_get_frag_bytes`` below a tile's 1 MiB:
    every GET lands as DATA fragments in a pinned zone, whose H2D is
    issued non-blocking, and the factor still passes its gates."""
    from parsec_tpu_torch.comm import run_multiproc
    from parsec_tpu_torch.comm.mp_bodies import factor_input
    n, nb = 2048, 512
    for key, value in (("KINDS", "cholesky"), ("N", n), ("NB", nb),
                       ("CHORES", "cuda"), ("WARMUP", "0")):
        monkeypatch.setenv(f"PARSEC_MP_{key}", str(value))
    monkeypatch.setenv("PARSEC_MCA_comm_get_frag_bytes", str(1 << 18))
    res = run_multiproc(4, "parsec_tpu_torch.comm.mp_bodies:pool_body",
                        timeout=300, transport="device")
    recs = [r["kinds"]["cholesky"] for r in res]
    gets = sum(r["gets"] for r in recs)
    assert gets > 0 and sum(r["frags_in"] for r in recs) == 4 * gets
    assert all(r["cpu_tasks"] == 0 and set(r["k1_by_variant"])
               == {"mma_tf32"} for r in recs)
    assert sum(r["tiers"]["payload_out"] for r in recs) \
        == sum(r["tiers"]["payload_in"] for r in recs) > 0
    got = np.zeros((n, n), np.float32)
    for rec in recs:
        for (i, j), tile in rec["tiles"].items():
            got[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = tile
    spd = factor_input("cholesky", n)
    assert _backward_error(got, spd, "cholesky") < 5e-3
    assert _tile_error(got, spd, "cholesky", nb) < TF32_TILE_TOL


def test_socket_reply_decodes_into_pinned_memory(card):
    """The device socket tier's whole replies decode their tensors into
    pinned host memory (an asynchronous H2D's source); plain decoding
    does not pin."""
    from parsec_tpu_torch.comm import codec
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    meta, segs = codec.encode({"value": t})
    it = iter(segs)

    def fill(view: memoryview) -> None:
        view[:] = memoryview(next(it)).cast("B")
    got = codec.decode(meta, fill, pin_tensors=True)["value"]
    assert got.is_pinned() and torch.equal(got, t)
    assert not codec.decode_with_segments(meta, segs)["value"].is_pinned()


# ---------------------------------------------------------------------------
# speculative decode, the prefix cache and the KV tiers on the card
# ---------------------------------------------------------------------------

def test_spec_bodies_on_the_card_match_the_cpu(card):
    """The three speculative bodies on the card against the same bodies
    on the CPU (strict fp32 both: same arithmetic, another summation
    order), at Llama-2-7B's attention width."""
    g = torch.Generator().manual_seed(3)
    H, D, S, P, V = 32, 128, 7, 16, 64
    q3t = torch.randn(V, 3, H, D, generator=g)
    qs = torch.randn(4, S, 3, H, D, generator=g)
    page = torch.randn(4, 3, P, H, D, generator=g)
    lim = torch.randint(0, P + 1, (4, S), generator=g).float()
    lim[:, -1] = 0.0
    acc = torch.zeros(4, S, H, D + 2)
    want = ra.spec_attn_page(qs, page, lim, acc)
    got = ra.spec_attn_page(qs.cuda(), page.cuda(), lim.cuda(), acc.cuda())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    dt = torch.zeros(4, S + 2)
    dt[:, 0], dt[:, 1] = S, -1.0
    dt[:, 2] = 5.0
    vw = ra.spec_verify(want, dt, q3t)
    vg = ra.spec_verify(got, dt.cuda(), q3t.cuda())
    assert torch.equal(vg.cpu(), vw)
    st = torch.tensor([[5.0, 1.0, 0.0, -1.0]] * 4)
    o = ra.finalize_acc(want[:, 0])
    assert torch.equal(
        ra.verify_step(o.cuda(), st.cuda(), dt[:, 2:3].cuda(),
                       q3t.cuda()).cpu(),
        ra.verify_step(o, st, dt[:, 2:3], q3t))


def test_rollback_and_staging_bring_the_card_copy_home(card):
    """A page whose newest bytes are on the card: the rollback and the
    seed-time staging start from them (one D2H), leave a host tensor on
    the CPU and detach the card's copy."""
    from parsec_tpu_torch.data.data import DataCopy
    from parsec_tpu_torch.data_dist.collection import DictCollection
    from parsec_tpu_torch.data.datatype import TileType
    from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
    from parsec_tpu_torch.llm import decode as dec
    model = ToyLM()
    kv = PagedKVCollection("KV", page_size=4, num_heads=4, head_dim=8)
    kv.alloc_seq("s")
    kv.alloc_page("s")
    kv.note_appended("s", 3)
    d = kv.data_of("s", 0)
    dev = DataCopy(d, card.device_index,
                   value=torch.full(kv.default_dtt.shape, 2.0,
                                    device="cuda"))
    dev.version = d.get_copy(0).version + 4
    d.attach_copy(dev)
    kv.rollback_tail("s", 1)
    host = d.get_copy(0)
    assert d.get_copy(card.device_index) is None
    assert host.value.device.type == "cpu" and host.version > dev.version
    assert host.value[0, 0, 0, 0] == 2.0 and host.value[2, 0, 0, 0] == 1
    dev2 = DataCopy(d, card.device_index, value=host.value.cuda() * 3)
    dev2.version = host.version + 1
    d.attach_copy(dev2)
    pad = 3
    colls = [DictCollection(n, dtt=TileType(s)) for n, s in (
        ("qs", (pad, 3, 4, 8)), ("lim", (pad,)), ("dt", (pad + 2,)))]
    dec.preallocate_decode_steps(kv, "s", 2)
    dec.seed_spec_batched(model, kv, *colls, "s", 5, [9], pad)
    host = d.get_copy(0)
    assert d.get_copy(card.device_index) is None
    assert host.value.device.type == "cpu" and host.version > dev2.version
    assert host.value[0, 0, 0, 0] == 6.0
    assert torch.equal(host.value[0, 1], model.q3(5)[1])


def test_prefetch_data_copies_to_the_card(card):
    from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
    kv = PagedKVCollection("KV", page_size=16, num_heads=32, head_dim=128)
    datas = []
    for s in range(3):
        kv.alloc_seq(s)
        kv.alloc_page(s)
        datas.append(kv.data_of(s, 0))
    before = card.bytes_copied_in
    assert card.prefetch_data(datas) == 3
    torch.cuda.synchronize()
    assert card.bytes_copied_in - before == 3 * kv.page_bytes
    for d in datas:
        c = d.get_copy(card.device_index)
        assert c.value.is_cuda and c.version == d.get_copy(0).version
    assert card.prefetch_data(datas) == 0
    card.flush_cache()
    assert all(d.get_copy(card.device_index) is None for d in datas)


@pytest.mark.parametrize("mode", ["spec", "prefix"])
def test_spec_and_prefix_serving_on_the_card(card, mode):
    """The batcher on the card with speculative decode or the prefix cache
    on: oracle tokens, the spec pool's classes on the card, prefix hits."""
    key = "llm_spec_k" if mode == "spec" else "llm_prefix_cache"
    saved = params.get(key)
    params.set(key, 4 if mode == "spec" else True)
    model = ToyLM()
    prompt = [5, 9, 13] * 12
    try:
        with RuntimeServer(nb_cores=2) as server:
            first = server.submit_stream(prompt, max_new_tokens=4)
            assert first.result(timeout=120)["tokens"] == \
                model.reference_generate(prompt, 4)
            tks = [server.submit_stream(prompt + [i], max_new_tokens=12)
                   for i in range(3)]
            for i, tk in enumerate(tks):
                assert tk.result(timeout=120)["tokens"] == \
                    model.reference_generate(prompt + [i], 12)
            llm = server.stats()["llm"]
    finally:
        params.set(key, saved)
    s = card.stats()["tasks_by_class"]
    if mode == "spec":
        assert llm["spec_submits"] > 0 and s.get("SATTN", 0) > 0
    else:
        assert llm["kv"]["prefix_hits"] == 3
    assert card.stats()["spill_hook_failures"] == 0


def test_region_superpools_serve_on_the_card(card):
    """``llm_lower_regions`` on the card: oracle tokens, every decode pool
    lowered to regions whose ATTN launches K2, no decode task through the
    device module."""
    saved = params.get("llm_lower_regions")
    params.set("llm_lower_regions", True)
    model = ToyLM()
    prompts = [[5, 9, 13] * 12, [2, 4] * 9, [7] * 30]
    before = dict(card.stats()["tasks_by_class"])
    launches = ra.attn_page_update.launches
    try:
        with RuntimeServer(nb_cores=2) as server:
            tks = [server.submit_stream(p, max_new_tokens=10)
                   for p in prompts]
            for p, tk in zip(prompts, tks):
                assert tk.result(timeout=120)["tokens"] == \
                    model.reference_generate(p, 10)
            llm = server.stats()["llm"]
    finally:
        params.set("llm_lower_regions", saved)
    assert llm["regions"]["pools"] == llm["decode_submits"] > 0
    assert ra.attn_page_update.launches > launches
    s = card.stats()["tasks_by_class"]
    assert s.get("ATTN", 0) == before.get("ATTN", 0)


def _gemm_pool_on_the_card(n=2048, nb=512, drop_chain=False):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    A, B = TiledMatrix.from_dense("A", a, nb, nb), \
        TiledMatrix.from_dense("B", b, nb, nb)
    C = TiledMatrix("C", n, n, nb, nb)
    tp = tiled_gemm_ptg(A, B, C)
    if drop_chain:
        fC = next(f for f in tp.task_class("GEMM").flows if f.name == "C")
        fC.deps_in = [d for d in fC.deps_in if d.target_class is None]
    return tp, (a, b, C)


def test_the_gate_raises_before_any_k1_launch(card):
    """Under ``analysis_check`` the dynamic GEMM with its chain input
    dropped raises ``GraphCheckError`` from ``add_taskpool``: K1 is never
    launched and the context holds no pool; the sound pool then runs."""
    from parsec_tpu_torch.analysis import GraphCheckError
    before = params.get("analysis_check")
    params.set("analysis_check", True)
    try:
        bad, _ = _gemm_pool_on_the_card(drop_chain=True)
        ctx = Context(nb_cores=0)
        k1, ran = tg.gemm_update.launches, card.executed_tasks
        with pytest.raises(GraphCheckError, match="missing-input-edge"):
            ctx.add_taskpool(bad)
        assert tg.gemm_update.launches == k1 and ctx.test()
        assert card.executed_tasks == ran
        good, (a, b, C) = _gemm_pool_on_the_card()
        ctx.add_taskpool(good)
        ctx.wait(timeout=120)
        card.sync()
        ctx.fini()
        assert tg.gemm_update.launches > k1
        _tf32_close(torch.from_numpy(C.to_dense()), torch.from_numpy(a),
                    torch.from_numpy(b))
    finally:
        params.set("analysis_check", before)


def test_the_task_profiler_traces_the_gemm_on_the_card(card, tmp_path):
    """The task profiler and the SDE module on the dynamic GEMM: one EXEC
    span and one retired task a task, the stage-in events summing to the
    device module's ``bytes_in``; the trace reads back."""
    from parsec_tpu_torch.prof import Profiling, pins, sde, trace_state
    from parsec_tpu_torch.prof.counters import TASKS_RETIRED
    from parsec_tpu_torch.prof.pins import PinsEvent
    before = params.get("pins")
    params.set("pins", "task_profiler,sde")
    trace_state.fini()
    sde.reset()
    staged = []

    def on_stage(es, nb):
        staged.append(nb)

    pins.register(PinsEvent.DEVICE_STAGE_IN, on_stage)
    bytes_in = card.bytes_in
    try:
        tp, (a, b, C) = _gemm_pool_on_the_card()
        ctx = Context(nb_cores=0)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        card.sync()
        ctx.fini()
        path = str(tmp_path / "gemm.ptpb")
        trace_state.dump(path)
    finally:
        pins.unregister(PinsEvent.DEVICE_STAGE_IN, on_stage)
        params.set("pins", before)
    recs = Profiling.load(path).to_records()
    trace_state.fini()
    assert len([r for r in recs if r["name"] == "task_exec"]) == 64
    assert sde.get(TASKS_RETIRED) == 64
    assert sum(staged) == card.bytes_in - bytes_in > 0
    _tf32_close(torch.from_numpy(C.to_dense()), torch.from_numpy(a),
                torch.from_numpy(b))


def test_the_comm_thread_on_the_device_socket_tier(card, monkeypatch):
    """The four-process Cholesky with ``comm_thread`` off and on: GETs,
    payload bytes and task counts equal, both factors under the gates."""
    from parsec_tpu_torch.comm import run_multiproc
    from parsec_tpu_torch.comm.mp_bodies import factor_input
    n, nb = 2048, 512
    for key, value in (("KINDS", "cholesky"), ("N", n), ("NB", nb),
                       ("CHORES", "cuda"), ("WARMUP", "0")):
        monkeypatch.setenv(f"PARSEC_MP_{key}", str(value))
    runs = {}
    for on in (False, True):
        monkeypatch.setenv("PARSEC_MCA_comm_thread", "1" if on else "0")
        res = run_multiproc(4, "parsec_tpu_torch.comm.mp_bodies:pool_body",
                            timeout=300, transport="device")
        assert [r["comm_thread"] for r in res] == [on] * 4
        runs[on] = recs = [r["kinds"]["cholesky"] for r in res]
        got = np.zeros((n, n), np.float32)
        for rec in recs:
            for (i, j), tile in rec["tiles"].items():
                got[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = tile
        spd = factor_input("cholesky", n)
        assert _tile_error(got, spd, "cholesky", nb) < TF32_TILE_TOL
    for key in ("gets", "tasks", "payload_bytes_received"):
        assert [r[key] for r in runs[True]] == [r[key] for r in runs[False]]
    assert [r["tiers"]["payload_in"] for r in runs[True]] \
        == [r["tiers"]["payload_in"] for r in runs[False]]


# ---------------------------------------------------------------------------
# the data layer and the runtime round-out on the card (chip_smoke.py's
# data_layer, runtime_roundout and llm_step at small sizes)
# ---------------------------------------------------------------------------

def _seeded(seed):
    def init(m, k, shape):
        rng = np.random.default_rng((seed, m, k))
        return rng.standard_normal(shape, dtype=np.float32)
    return init


def _run_on(card, tp, nb_cores=0):
    ctx = Context(nb_cores=nb_cores)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=300)
        card.sync()
    finally:
        ctx.fini()


def test_redistribute_checkpoint_and_operators_on_the_card(card, tmp_path):
    """A redistributed from tiles of 256 to 128 on the CUDA chore alone,
    the GEMM on K1 over it (the TF32 bound), a bit-equal checkpoint
    resume, and the operators against torch."""
    from parsec_tpu_torch.data.checkpoint import (restore_collections,
                                                  save_collections)
    from parsec_tpu_torch.data_dist import redistribute as rd
    from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.data_dist.operators import (broadcast_taskpool,
                                                      map_taskpool,
                                                      reduce_taskpool)
    params.set("gemm_precision", "default")
    n = 1024
    S = TiledMatrix("S", n, n, 256, 256, init_fn=_seeded(1))
    A = TwoDimBlockCyclic("A", n, n, 128, 128)
    B = TiledMatrix("B", n, n, 128, 128, init_fn=_seeded(2))
    C = TiledMatrix("C", n, n, 128, 128)
    before = dict(rd.copies)
    tp = rd.redistribute_taskpool(S, A)
    _run_on(card, tp)
    assert tp.nb_frags == 64
    assert rd.copies["cuda"] - before.get("cuda", 0) == 64
    assert rd.copies["host"] == before.get("host", 0)
    launches = tg.gemm_update.launches
    _run_on(card, tiled_gemm_ptg(A, B, C))
    assert tg.gemm_update.launches > launches
    card.flush_cache()
    assert np.array_equal(A.to_dense(), S.to_dense())
    _tf32_close(C.to_tensor(), S.to_tensor(), B.to_tensor())
    path = str(tmp_path / "c.npz")
    save_collections(path, C)
    _run_on(card, tiled_gemm_ptg(A, B, C))
    card.flush_cache()
    C2 = TiledMatrix("C", n, n, 128, 128)
    restore_collections(path, C2)
    _run_on(card, tiled_gemm_ptg(A, B, C2))
    card.flush_cache()
    assert torch.equal(C2.to_tensor(), C.to_tensor())
    c = C.to_tensor()
    _run_on(card, map_taskpool(C, lambda key, t: t * 0.5))
    card.flush_cache()
    assert torch.equal(C.to_tensor(), c * 0.5)
    out = {}
    _run_on(card, reduce_taskpool(C, lambda x, y: x + y, out=out,
                                  transform=torch.sum))
    assert out["value"].is_cuda
    c = C.to_tensor().double()
    assert abs(float(out["value"]) - float(c.sum())) \
        <= 1e-5 * float(c.abs().sum())
    D = TiledMatrix("D", 256, 256, 128, 128)
    _run_on(card, broadcast_taskpool(C, (0, 0), D))
    card.flush_cache()
    t = C.data_of(0, 0).newest_copy().value.cpu()
    for i in range(2):
        for j in range(2):
            assert torch.equal(D.data_of(i, j).newest_copy().value.cpu(), t)


def test_compose_on_two_virtual_processes_and_paranoid_on_the_card(card):
    from parsec_tpu_torch.core.output import show_help_flush
    from parsec_tpu_torch.runtime import compose
    params.set("gemm_precision", "default")
    n, nb = 1024, 256
    A = TiledMatrix("A", n, n, nb, nb, init_fn=_seeded(3))
    B = TiledMatrix("B", n, n, nb, nb, init_fn=_seeded(4))
    C = TiledMatrix("C", n, n, nb, nb)
    saved = params.get("runtime_nb_vp")
    params.set("runtime_nb_vp", 2)
    try:
        ctx = Context(nb_cores=2)
    finally:
        params.set("runtime_nb_vp", saved)
    first, second = tiled_gemm_ptg(A, B, C), tiled_gemm_ptg(A, B, C)
    try:
        ctx.add_taskpool(compose(first, second))
        ctx.wait_taskpool(first, timeout=300)
        ctx.wait_taskpool(second, timeout=300)
        card.sync()
        assert ctx.vp_stats()["cross_vp"] == 0
    finally:
        ctx.fini()
    card.flush_cache()
    _tf32_close(C.to_tensor() / 2, A.to_tensor(), B.to_tensor())
    show_help_flush()
    params.set("debug_paranoid", True)
    try:
        C1 = TiledMatrix("C1", n, n, nb, nb)
        _run_on(card, tiled_gemm_ptg(A, B, C1))
    finally:
        params.set("debug_paranoid", False)
    assert not [k for k in show_help_flush() if k[0] == "paranoid"]
    card.flush_cache()
    _tf32_close(C1.to_tensor(), A.to_tensor(), B.to_tensor())


@pytest.mark.parametrize("kind", ["cholesky", "lu", "upper"])
def test_auto_factorizations_take_the_card_chores(card, kind):
    params.set("gemm_precision", "default")
    n, nb = 1024, 256
    if kind == "lu":
        a = lu.make_dd(n, seed=1)
        A = TiledMatrix.from_dense("A", a.copy(), nb, nb)
        tp = lu.tiled_lu_ptg(A, devices="auto")
    else:
        a = chol.make_spd_fast(n)
        A = SymTwoDimBlockCyclic.from_dense(
            "A", a.copy(), nb, nb, uplo=int(kind == "upper"))
        tp = chol.tiled_cholesky_ptg(A, devices="auto")
    host = sum(factor.host_runs.values())
    ran = card.executed_tasks
    _run_on(card, tp)
    card.flush_cache()
    assert sum(factor.host_runs.values()) == host
    assert card.executed_tasks - ran == tp.nb_local_tasks()
    got = A.to_dense()
    if kind == "upper":
        got = np.ascontiguousarray(np.triu(got).T)
    err = _tile_error(got, a, "lu" if kind == "lu" else "cholesky", nb)
    assert err < TF32_TILE_TOL


def test_decode_steps_on_k2_equal_the_superpool(card):
    from parsec_tpu_torch.data.datatype import TileType
    from parsec_tpu_torch.data_dist.collection import DictCollection
    from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
    from parsec_tpu_torch.llm import decode as dec
    model = ToyLM(num_heads=32, head_dim=128)
    H, D = model.num_heads, model.head_dim
    rng = np.random.default_rng(5)
    prompts = {f"s{i}": [int(t) for t in rng.integers(0, model.vocab, 40)]
               for i in range(2)}
    kv = PagedKVCollection("KVs", page_size=16, num_heads=H, head_dim=D)
    Q = DictCollection("Qs", dtt=TileType((3, H, D)))
    O = DictCollection("Os", dtt=TileType((H, D)))
    launches = ra.attn_page_update.launches

    def run(tp):
        _run_on(card, tp, nb_cores=2)

    got = dec.generate_by_steps(model, kv, Q, O, prompts, 4, run)
    assert ra.attn_page_update.launches > launches
    kv2 = PagedKVCollection("KVs2", page_size=16, num_heads=H, head_dim=D)
    Q2 = DictCollection("Qs2", dtt=TileType((3, H, D)))
    O2 = DictCollection("Os2", dtt=TileType((H, D)))
    TOK = DictCollection("TOKs", dtt=TileType((3,)))
    EMB = DictCollection("EMBs", dtt=TileType(tuple(model.q3_table().shape)))
    dec.seed_decode_superpool(model, kv2, Q2, TOK, EMB, prompts,
                              {s: 4 for s in prompts})
    _run_on(card, dec.decode_superpool_ptg(kv2, Q2, O2, TOK, EMB,
                                           list(prompts), [4, 4]))
    for s, prompt in prompts.items():
        assert got[s] == dec.read_token_chain(TOK, s, 4)[0] \
            == model.reference_generate(prompt, 4), s


# ---------------------------------------------------------------------------
# the multi-rank (SPMD) lowering: four ranks sharing the card
# ---------------------------------------------------------------------------

def _mesh_pool(kind, devices, seed=8):
    """The sharded pool of ``kind`` over 4 ranks, lowered over a mesh of
    ``devices``: GEMM (bf16 A/B, fp32 C) on a 2 x 2 grid, Cholesky on 4
    x 1, the stencil on 4 cyclic ranks.  Returns the lowered pool and
    its output collection."""
    rng = np.random.default_rng(seed)
    if kind == "gemm":
        n, nb = 1024, 256
        a, b = (torch.from_numpy(rng.standard_normal((n, n),
                                                     dtype=np.float32))
                .bfloat16() for _ in range(2))
        A = TwoDimBlockCyclic.from_dense("A", a, nb, nb, P=2, Q=2)
        B = TwoDimBlockCyclic.from_dense("B", b, nb, nb, P=2, Q=2)
        out = TwoDimBlockCyclic("C", n, n, nb, nb, P=2, Q=2)
        tp = tiled_gemm_ptg(A, B, out)
    elif kind == "cholesky":
        a = chol.make_spd_fast(1024, seed=6)
        out = SymTwoDimBlockCyclic.from_dense("A", a.copy(), 256, 256, P=4,
                                              Q=1)
        tp = chol.tiled_cholesky_ptg(out)
    else:
        base = rng.standard_normal(16 * 4096).astype(np.float32)
        out = VectorTwoDimCyclic("V", lm=len(base), mb=4096, P=4,
                                 init_fn=lambda m, s:
                                 base[m * 4096:m * 4096 + s])
        tp = stencil_1d_ptg(out, np.full(9, 1.0 / 9), 5)
    return lower_taskpool(tp, mesh=DeviceMesh(devices)), out


def _probe():
    return {**{f"k1:{v}": k for v, k in
               tg.gemm_update.launches_by_variant.items()},
            "k3": ks.stencil1d.launches}


@pytest.mark.parametrize("kind", ["gemm", "cholesky", "stencil"])
def test_mesh_lowering_on_the_card_matches_the_cpu(card, kind):
    """The same pool lowered over ``DeviceMesh(["cuda:0"] * 4)`` and over
    four CPU ranks (the plain versions): the same pass and exchange, each
    rank's groups launching its kernel on the card (K1's ``wgmma_bf16``
    for the GEMM, ``mma_tf32`` for the Cholesky, K3 for the stencil),
    and the same tiles (bf16 products are exact in fp32: ``rtol=1e-4,
    atol=1e-3``; TF32 against fp32 within ``TF32_TILE_TOL`` tile by tile;
    the stencil's fp32 taps ``atol=1e-5``)."""
    on_card, got = _mesh_pool(kind, ["cuda:0"] * 4)
    on_cpu, want = _mesh_pool(kind, ["cpu"] * 4)
    assert on_card.mode == on_cpu.mode
    assert on_card.exchange_bytes == on_cpu.exchange_bytes
    stores = on_card.initial_stores()
    assert all(t.device.type == "cuda" for parts in stores.values()
               for t in parts)
    out, by_rank = on_card.run_by_rank(stores, _probe)
    torch.cuda.synchronize()
    groups = on_card.exchange["groups_by_rank"]
    for r, delta in enumerate(by_rank):
        ran = {k: v for k, v in delta.items() if v}
        if kind == "gemm":
            assert ran == {"k1:wgmma_bf16": 1}, (r, ran)
        elif kind == "cholesky":
            # rank 0 holds only the first diagonal tile: POTRF, no K1
            assert set(ran) == ({"k1:mma_tf32"} if r else set()), (r, ran)
        else:
            assert ran == {"k3": groups[r]}, (r, ran)
    on_card._stores.writeback(out)
    on_cpu.execute()
    if kind == "gemm":
        torch.testing.assert_close(got.to_tensor(), want.to_tensor(),
                                   rtol=1e-4, atol=1e-3)
    elif kind == "cholesky":
        err = factor.tile_error(torch.tril(got.to_tensor().cuda().double()),
                                torch.tril(want.to_tensor().cuda().double()),
                                256)
        assert err < TF32_TILE_TOL
    else:
        g = torch.cat([got.data_of(i).newest_copy().value.cpu()
                       for i in range(got.mt)])
        w = torch.cat([want.data_of(i).newest_copy().value
                       for i in range(want.mt)])
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)

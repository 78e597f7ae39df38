"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (K1, the
GEMM; K2, the ragged paged-attention page update; K3, the 1-D stencil),
the device module, decode serving and the lowered taskpools on the card.
They skip without one.

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
from parsec_tpu_torch.data_dist.matrix import TiledMatrix
from parsec_tpu_torch.llm import ToyLM
from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic
from parsec_tpu_torch.models.stencil import stencil_1d_ptg, stencil_reference
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.ops import gemm as tg
from parsec_tpu_torch.ops import ragged_attention as ra
from parsec_tpu_torch.ops import stencil as ks
from parsec_tpu_torch.ptg.lowering import lower_taskpool
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
    assert ks.stencil1d.launches == before + 3 * 5
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

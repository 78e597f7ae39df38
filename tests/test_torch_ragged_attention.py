"""The port's ragged paged-attention bodies against the JAX package's.

``parsec_tpu_torch.ops.ragged_attention`` holds K2's plain version (the
page update), the OUT, SAMPLE and PF bodies and their batched forms.
The same inputs, made with numpy from a seed, go through the port's
plain PyTorch versions and through the JAX package's numpy bodies, jnp
twins and the Pallas kernel ``build_pallas_page_update`` in interpret
mode (as ``tests/test_llm.py`` runs it on the CPU).

Tolerance: 1e-5 abs, as ``tests/test_llm.py`` uses — fp32 on both
sides, only the summation order differs.  One documented difference:
for an empty accumulator on an empty page, the numpy body returns the
accumulator unchanged while the masked versions (jnp, Pallas and the
port) write ``m = NEG_INF``; ``l == 0`` marks the state empty either
way, so against numpy the running max is compared only where ``l > 0``.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.llm.model import ToyLM as JToyLM
from parsec_tpu.ops import ragged_attention as jra
from parsec_tpu_torch.ops import _build
from parsec_tpu_torch.ops import ragged_attention as ra

TOL = 1e-5
H, D, P = 4, 8, 16
MODEL = JToyLM()
PALLAS = jra.build_pallas_page_update(interpret=True)


def _case(seed, fill, acc_kind):
    rng = np.random.default_rng(seed)
    q3 = rng.standard_normal((3, H, D)).astype(np.float32)
    page = rng.standard_normal((3, P, H, D)).astype(np.float32)
    page[2] = 0.0
    page[2, 0, 0, 0] = fill
    if acc_kind == "empty":
        acc = np.zeros((H, D + 2), np.float32)
    else:
        warm = rng.standard_normal((3, P, H, D)).astype(np.float32)
        warm[2, 0, 0, 0] = P
        acc = jra.attn_page_update_np(q3, warm,
                                      np.zeros((H, D + 2), np.float32))
    return q3, page, acc


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _same_state(got, want, tol=TOL):
    """Equal flash states: o and l everywhere, m where the state is
    non-empty (an empty state's m is a don't-care)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got[:, :D] - want[:, :D]).max() <= tol
    assert np.abs(got[:, D + 1] - want[:, D + 1]).max() <= tol
    live = want[:, D + 1] > 0
    assert np.abs(got[live, D] - want[live, D]).max(initial=0.0) <= tol


FILLS = [0, 1, 7, P - 1, P]


@pytest.mark.parametrize("acc_kind", ["empty", "warm"])
@pytest.mark.parametrize("fill", FILLS)
def test_page_update_matches_jax_incarnations(fill, acc_kind):
    q3, page, acc = _case(10 + fill, fill, acc_kind)
    got = ra.attn_page_update(*_t(q3, page, acc)).numpy()
    jnp_out = np.asarray(jra._page_update_jnp(q3, page, acc))
    pallas_out = np.asarray(PALLAS(q3, page, acc))
    # the masked incarnations agree on every column, m included
    assert np.abs(got - jnp_out).max() <= TOL
    assert np.abs(got - pallas_out).max() <= TOL
    _same_state(got, jra.attn_page_update_np(q3, page, acc))


def test_page_chain_matches_dense_reference():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, MODEL.vocab, 41)            # 3 pages, ragged
    q3t = MODEL.q3_table()
    ks, vs = q3t[toks, 1], q3t[toks, 2]
    q3 = q3t[17]
    acc = torch.zeros(H, D + 2)
    for p0 in range(0, len(toks), P):
        page = np.zeros((3, P, H, D), np.float32)
        n = min(P, len(toks) - p0)
        page[0, :n], page[1, :n] = ks[p0:p0 + n], vs[p0:p0 + n]
        page[2, 0, 0, 0] = n
        acc = ra.attn_page_update(torch.from_numpy(q3), torch.from_numpy(page),
                                  acc)
    want = jra.ragged_attention_reference(q3[0], ks, vs)
    assert np.abs(ra.finalize_acc(acc).numpy() - want).max() <= TOL
    ours = ra.ragged_attention_reference(torch.from_numpy(q3[0]),
                                         torch.from_numpy(ks),
                                         torch.from_numpy(vs))
    assert np.abs(ours.numpy() - want).max() <= 1e-6


def test_reference_of_an_empty_cache_is_zero():
    o = ra.ragged_attention_reference(torch.ones(H, D), [], [])
    assert o.shape == (H, D) and float(o.abs().max()) == 0.0


@pytest.mark.parametrize("acc_kind", ["empty", "warm"])
def test_finalize_matches_numpy(acc_kind):
    _, _, acc = _case(4, 5, acc_kind)
    got = ra.finalize_acc(torch.from_numpy(acc)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - jra.finalize_acc_np(acc)).max() <= TOL


@pytest.mark.parametrize("fill", [0, 1, 9, P - 1])
def test_out_update_matches_numpy_and_jnp(fill):
    q3, page, acc = _case(20 + fill, fill, "warm")
    new_page, o = ra.attn_out(*_t(acc, q3, page))
    np_page, np_o = jra.attn_out_np(acc, q3, page)
    j_page, j_o = jra._out_update_jnp(acc, q3, page,
                                      np.zeros((H, D), np.float32))
    for want_page, want_o in ((np_page, np_o), (j_page, j_o)):
        assert np.abs(new_page.numpy() - np.asarray(want_page)).max() == 0.0
        assert np.abs(o.numpy() - np.asarray(want_o)).max() <= TOL
    assert new_page[2, 0, 0, 0] == fill + 1


def test_out_update_past_a_full_page_writes_nothing():
    """As ``.at[fill].set`` in the jnp twin: a fill at P selects no slot."""
    q3, page, acc = _case(5, P, "warm")
    new_page, _ = ra.attn_out(*_t(acc, q3, page))
    j_page, _ = jra._out_update_jnp(acc, q3, page,
                                    np.zeros((H, D), np.float32))
    assert np.abs(new_page.numpy() - np.asarray(j_page)).max() == 0.0


@pytest.mark.parametrize("tok_prev", [
    [5.0, 0.0, -1.0],       # EOS disabled
    [5.0, 1.0, 3.0],        # already done: holds its token
    "eos_hit",              # samples the EOS token now
    "eos_miss"])            # EOS set, not sampled
def test_sample_step_matches_numpy_and_jnp(tok_prev):
    rng = np.random.default_rng(7)
    o = rng.standard_normal((H, D)).astype(np.float32)
    q3t = MODEL.q3_table()
    samp = int(np.argmax(q3t[:, 0].reshape(MODEL.vocab, -1) @ o.reshape(-1)))
    if tok_prev == "eos_hit":
        tok_prev = [2.0, 0.0, float(samp)]
    elif tok_prev == "eos_miss":
        tok_prev = [2.0, 0.0, float((samp + 1) % MODEL.vocab)]
    tok_prev = np.array(tok_prev, np.float32)
    tok, qn = ra.sample_step(*_t(o, tok_prev, q3t))
    np_tok, np_qn = jra.sample_step_np(o, tok_prev, q3t)
    j_tok, j_qn = jra._sample_jnp(o, tok_prev, q3t)
    for want_tok, want_qn in ((np_tok, np_qn), (j_tok, j_qn)):
        assert tok.numpy().tolist() == np.asarray(want_tok).tolist()
        assert np.abs(qn.numpy() - np.asarray(want_qn)).max() == 0.0


def test_sample_with_per_task_tables_equals_shared_table():
    rng = np.random.default_rng(8)
    o = torch.from_numpy(rng.standard_normal((5, H, D)).astype(np.float32))
    toks = torch.tensor([[1.0, 0.0, -1.0]] * 5)
    table = torch.from_numpy(MODEL.q3_table())
    shared = ra.sample_step(o, toks, table)
    stacked = ra.sample_step(o, toks, table.expand(5, *table.shape))
    for a, b in zip(shared, stacked):
        assert torch.equal(a, b)


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    q3 = rng.standard_normal((n, 3, H, D)).astype(np.float32)
    page = rng.standard_normal((n, 3, P, H, D)).astype(np.float32)
    page[:, 2] = 0.0
    page[:, 2, 0, 0, 0] = np.arange(n) % (P + 1)
    acc = np.zeros((n, H, D + 2), np.float32)
    return [list(torch.from_numpy(x).unbind(0)) for x in (q3, page, acc)]


def test_tile_list_bodies_equal_per_task_bodies():
    qs, pages, accs = _batch(6, 9)
    got = ra.attn_page_update_tiles(qs, pages, accs)
    for g, q, p, a in zip(got, qs, pages, accs):
        assert torch.equal(g, ra.attn_page_update_plain(q, p, a))
    # OUT: new pages and outputs, each in storage of its own
    os_ = [torch.zeros(H, D) for _ in qs]
    new_pages, outs = ra.attn_out_tiles(got, qs, pages, os_)
    for npg, o, a, q, p in zip(new_pages, outs, got, qs, pages):
        want_page, want_o = ra.attn_out(a, q, p)
        assert torch.equal(npg, want_page) and torch.equal(o, want_o)
    assert len({t.untyped_storage().data_ptr()
                for t in new_pages + outs}) == 2 * len(qs)
    # SAMPLE over one shared EMB tile
    emb = torch.from_numpy(MODEL.q3_table())
    toks = [torch.tensor([float(i), 0.0, -1.0]) for i in range(len(qs))]
    new_toks, qns = ra.sample_tiles(outs, toks, [emb] * len(qs),
                                    [torch.zeros(3, H, D)] * len(qs))
    for t, qn, o, tp in zip(new_toks, qns, outs, toks):
        want_t, want_qn = ra.sample_step(o, tp, emb)
        assert torch.equal(t, want_t) and torch.equal(qn, want_qn)
    # PF: copies of the chunks, never aliases
    copies = ra.prefill_copy_tiles(pages, [torch.zeros_like(p)
                                           for p in pages])
    for c, p in zip(copies, pages):
        assert torch.equal(c, p)
        assert c.untyped_storage().data_ptr() != p.untyped_storage().data_ptr()


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_nothing():
    qs, pages, accs = _batch(3, 11)
    before = ra.attn_page_update.launches
    ra.attn_page_update(torch.stack(qs), torch.stack(pages),
                        torch.stack(accs))
    ra.attn_page_update_tiles(qs, pages, accs)
    assert ra.attn_page_update.launches == before


@pytest.mark.parametrize("bad", ["q3_dtype", "acc_shape", "page_heads",
                                 "page_dtype", "ragged_list"])
def test_wrapper_validates_before_any_device_choice(bad):
    qs, pages, accs = _batch(2, 12)
    q3, page, acc = qs[0], pages[0], accs[0]
    if bad == "q3_dtype":
        q3 = q3.double()
    elif bad == "acc_shape":
        acc = acc[:, :-1].contiguous()
    elif bad == "page_heads":
        page = page[:, :, :2].contiguous()
    elif bad == "page_dtype":
        page = page.to(torch.float16)
    if bad == "ragged_list":                 # tile lists of unequal length
        with pytest.raises(ValueError, match="lengths"):
            ra.attn_page_update_tiles(qs, pages[:1], accs)
        return
    with pytest.raises((TypeError, ValueError)):
        ra.attn_page_update(q3, page, acc)


def test_kernel_launch_refuses_a_host_tensor():
    """The kernel path never runs on the host: the launcher raises for a
    CPU tensor instead of falling back."""
    qs, pages, accs = _batch(1, 13)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ra._launch(qs[0], pages[0], accs[0], torch.empty_like(accs[0]),
                   1, P, H, D)


def test_k2_source_is_a_kernel_of_the_build():
    assert "ragged_attn" in _build.sources()
    src = (_build.CSRC / "ragged_attn.cu").read_text()
    assert "build_pallas_page_update" in src and "__global__" in src
    assert "parsec_ragged_attn_page" in src


# ---------------------------------------------------------------------------
# the in-place forms: the ATTN bodies the device module runs
# ---------------------------------------------------------------------------

WIDE = (32, 128)          # a Llama-2-7B head geometry: H=32, D=128


def _shaped_case(seed, fill, acc_kind, heads, dim):
    """``_case`` at any head geometry (pages of P slots)."""
    rng = np.random.default_rng(seed)
    q3 = rng.standard_normal((3, heads, dim)).astype(np.float32)
    page = rng.standard_normal((3, P, heads, dim)).astype(np.float32)
    page[2] = 0.0
    page[2, 0, 0, 0] = fill
    acc = np.zeros((heads, dim + 2), np.float32)
    if acc_kind == "warm":
        warm = rng.standard_normal((3, P, heads, dim)).astype(np.float32)
        warm[2, 0, 0, 0] = P
        acc = np.asarray(jra._page_update_jnp(q3, warm, acc))
    return q3, page, acc


# fp32 on both sides, only the summation order differs: 1e-5 at D=8,
# 1e-4 at D=128 (128-term scores)
@pytest.mark.parametrize("acc_kind", ["empty", "warm"])
@pytest.mark.parametrize("fill", [0, 1, P - 1, P])
@pytest.mark.parametrize("heads,dim,tol", [(H, D, TOL), (*WIDE, 1e-4)])
def test_inplace_update_matches_jax_incarnations(heads, dim, tol, fill,
                                                 acc_kind):
    q3, page, acc = _shaped_case(30 + fill, fill, acc_kind, heads, dim)
    qt, pt, at = _t(q3, page, acc)
    got = ra.attn_page_update_tiles_([qt], [pt], [at])[0]
    assert got is at
    want_jnp = np.asarray(jra._page_update_jnp(q3, page, acc))
    want_pallas = np.asarray(PALLAS(q3, page, acc))
    assert np.abs(got.numpy() - want_jnp).max() <= tol
    assert np.abs(got.numpy() - want_pallas).max() <= tol
    one = _t(acc)[0]
    assert ra.attn_page_update_(qt, pt, one) is one
    assert torch.equal(one, got)


def test_inplace_tiles_write_into_the_given_acc_tiles():
    qs, pages, accs = _batch(6, 14)
    accs[1].copy_(ra.attn_page_update_plain(qs[1], pages[1], accs[1]))
    q_before = [q.clone() for q in qs]
    p_before = [p.clone() for p in pages]
    want = ra.attn_page_update_tiles(qs, pages, accs)
    got = ra.attn_page_update_tiles_(qs, pages, accs)
    assert all(g is a for g, a in zip(got, accs))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for q, qb, p, pb in zip(qs, q_before, pages, p_before):
        assert torch.equal(q, qb) and torch.equal(p, pb)


def test_in_place_bodies_are_registered():
    """The fused ATTN dispatch runs the in-place tile-list form, the
    lowering keeps the functional one, and the per-task body returns the
    ACC tile it was given, updated."""
    from types import SimpleNamespace

    from parsec_tpu_torch.ptg.lowering import find_traceable
    tr = find_traceable("ragged_attn_page")
    assert tr.inplace is ra.attn_page_update_tiles_
    assert tr.apply is ra.attn_page_update_tiles
    qs, pages, accs = _batch(1, 15)
    pages[0][2, 0, 0, 0] = P
    acc = SimpleNamespace(value=accs[0], version=3)
    task = SimpleNamespace(data=[SimpleNamespace(value=qs[0]),
                                 SimpleNamespace(value=pages[0]), acc])
    want = ra.attn_page_update_plain(qs[0], pages[0], accs[0])
    assert ra._page_body(None, task) is accs[0]
    assert acc.value is accs[0] and acc.version == 4
    assert torch.equal(accs[0], want)


@pytest.mark.parametrize("shape,esize,want", [
    ((16, 4, 8), 4, (4, 16)),           # ToyLM: every head in one block
    ((16, 32, 128), 4, (1, 16)),        # Llama fp32: 16 KiB of K/V a block
    ((16, 32, 128), 2, (2, 16)),        # Llama bf16
    ((16, 5, 8), 4, (5, 16)),
    ((1024, 2, 128), 4, (1, 16))])      # one head's page outgrows a block
def test_plan_fits_each_block_in_shared_memory(shape, esize, want):
    Pp, Hh, Dd = shape
    hg, cs = ra.plan(Pp, Hh, Dd, esize)
    assert (hg, cs) == want
    assert 2 * cs * ra._round16(hg * Dd * esize) <= ra._KV_SMEM_BYTES
    assert ra.smem_bytes(hg, cs, Dd, esize) <= ra._SMEM_OPTIN
    # balanced groups: no group of fewer heads than the blocks need
    groups = -(-Hh // hg)
    assert hg * (groups - 1) < Hh <= hg * groups

"""The port's speculative decode against the JAX package's.

The three speculative bodies (``verify_step``, ``spec_attn_page``,
``spec_verify``) against both the JAX package's branchless jnp twins and
its numpy bodies on the same seeded inputs; ``NgramDrafter``; the paged
KV cache's ``rollback_tail`` and seed-time staging under the
recycle-detach discipline; both spec pools against the JAX pools (tokens
and task counts by class), with the port's tasks on the CUDA device
module around the host (``init_cuda_devices(device="cpu")``); and the
batcher's acceptance sweep against the JAX batcher.  Tolerances: fp32
flash states agree to ``rtol=1e-5, atol=1e-6`` (the same fp32 math in
another summation order); tokens, states and counts are exact.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from parsec_tpu.data.datatype import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.data_dist.paged_kv import PagedKVCollection as JPagedKV
from parsec_tpu.llm import NgramDrafter as JNgramDrafter
from parsec_tpu.llm import ToyLM as JToyLM
from parsec_tpu.llm import decode as jdec
from parsec_tpu.ops import ragged_attention as jra
from parsec_tpu.runtime import Context as JContext
from parsec_tpu.serve import RuntimeServer as JRuntimeServer
from parsec_tpu_torch.core.params import params as port_params
from parsec_tpu_torch.data.data import DataCopy
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.llm import ContinuousBatcher, NgramDrafter, ToyLM
from parsec_tpu_torch.llm import decode as pdec
from parsec_tpu_torch.ops import ragged_attention as ra
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.serve import RuntimeServer

JMODEL = JToyLM()
MODEL = ToyLM()
H, D = MODEL.num_heads, MODEL.head_dim
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cpu_cuda_device():
    """The port's CUDA device module around the host CPU, registered for
    the test and unregistered after."""
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


@pytest.fixture
def port_param():
    saved = {}

    def set_(name, value):
        saved.setdefault(name, port_params.get(name))
        port_params.set(name, value)

    yield set_
    for name, value in saved.items():
        port_params.set(name, value)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the three bodies
# ---------------------------------------------------------------------------

STATES = ([5.0, 1.0, 0.0, -1.0],    # live, no EOS
          [5.0, 1.0, 0.0, 7.0],     # live, EOS armed
          [5.0, 0.0, 0.0, 7.0],     # rejected: dead
          [5.0, 1.0, 1.0, 7.0])     # done: dead


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("dtok", [5.0, 6.0])
def test_verify_step_equals_both_jax_twins(state, dtok):
    q3t = JMODEL.q3_table()
    o = JMODEL.q3(13)[2]
    prev = np.array(state, np.float32)
    d = np.array([dtok], np.float32)
    want = jra.verify_step_np(o, prev, d, q3t)
    assert np.array_equal(np.asarray(jra._verify_jnp(o, prev, d, q3t)), want)
    got = ra.verify_step(_t(o), _t(prev), _t(d), _t(q3t))
    assert np.array_equal(got.numpy(), want)


def test_verify_step_batched_and_eos_in_a_rejected_branch():
    q3t = JMODEL.q3_table()
    o = JMODEL.q3(13)[2]
    live = jra.verify_step_np(o, np.array([5, 1, 0, -1], np.float32),
                              np.array([5.0], np.float32), q3t)
    eos = float(live[0])                  # the token the target samples
    rows = [([5, 0, 0, eos], 5.0),        # dead: the EOS is never seen
            ([5, 1, 0, eos], 5.0),        # live: the EOS finishes it
            ([5, 1, 0, eos], 4.0)]        # the draft mismatches: dead
    os_ = np.stack([o] * 3)
    st = np.array([r[0] for r in rows], np.float32)
    dt = np.array([[r[1]] for r in rows], np.float32)
    got = ra.verify_step(_t(os_), _t(st), _t(dt), _t(q3t)).numpy()
    for i in range(3):
        assert np.array_equal(
            got[i], jra.verify_step_np(o, st[i], dt[i], q3t)), i
    assert got[0].tolist() == [5.0, 0.0, 0.0, eos]
    assert got[1].tolist() == [eos, 1.0, 1.0, eos]


def _spec_page(tokens, P=8):
    page = np.zeros((3, P, H, D), np.float32)
    for i, t in enumerate(tokens):
        q3 = JMODEL.q3(t)
        page[0, i], page[1, i] = q3[1], q3[2]
    page[2, 0, 0, 0] = len(tokens)
    return page


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_attn_page_equals_both_jax_twins(seed):
    """Ragged causal limits, a padded row (``lim = 0``) and, on the second
    seed, a non-empty starting state."""
    page = _spec_page([3, 7, 11, 5, 9, 2, 40])
    S = 4
    qs = np.zeros((S, 3, H, D), np.float32)
    for i, t in enumerate((13, 22, 8)):
        qs[i] = JMODEL.q3(t)
    lim = np.array([3, 7, 5, 0], np.float32)
    acc = np.zeros((S, H, D + 2), np.float32)
    if seed:
        acc = jra._spec_attn_page_jnp(qs, _spec_page([1, 2, 3]), lim, acc)
        acc = np.array(acc, np.float32)
        acc[3] = 0.0                       # the padded row stays empty
    want_j = np.asarray(jra._spec_attn_page_jnp(qs, page, lim, acc))
    want_n = jra.spec_attn_page_np(qs, page, lim, acc)
    got = ra.spec_attn_page(_t(qs), _t(page), _t(lim), _t(acc)).numpy()
    _close(got, want_j)
    # the numpy body returns an untouched row where nothing is valid, the
    # branchless ones a NEG_INF running max there: equal where l > 0
    _close(got[:3], want_n[:3])
    assert np.abs(got[3][:, :D]).max() == 0.0
    assert np.abs(got[3][:, D + 1]).max() == 0.0
    # against S serial single-query updates, through K2's plain version
    for s in range(3):
        pg = page.copy()
        pg[2, 0, 0, 0] = lim[s]
        one = ra.attn_page_update_plain(_t(qs[s]), _t(pg), _t(acc[s]))
        _close(got[s], one.numpy())


def test_spec_attn_page_batched_form():
    rng = np.random.default_rng(5)
    pages = np.stack([_spec_page(list(rng.integers(0, 64, 8)))
                      for _ in range(3)])
    qs = rng.standard_normal((3, 5, 3, H, D)).astype(np.float32)
    lim = rng.integers(0, 9, (3, 5)).astype(np.float32)
    acc = np.zeros((3, 5, H, D + 2), np.float32)
    outs = ra.spec_attn_page_tiles(list(_t(qs)), list(_t(pages)),
                                   list(_t(lim)), list(_t(acc)))
    for b in range(3):
        _close(outs[b].numpy(), np.asarray(jra._spec_attn_page_jnp(
            qs[b], pages[b], lim[b], acc[b])))


def _verify_acc(S=5, seed=7):
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((S, H, D + 2)).astype(np.float32)
    acc[:, :, D + 1] = np.abs(acc[:, :, D + 1]) + 0.5
    o = acc[:, :, :D] / acc[:, :, D + 1][:, :, None]
    q3t = JMODEL.q3_table()
    tgt = np.argmax(o.reshape(S, -1) @ q3t[:, 0].reshape(
        JMODEL.vocab, -1).T, axis=1)
    return acc, [int(t) for t in tgt]


def _chains(tgt):
    return (([9] + tgt[:4], -1.0),              # full acceptance
            ([9] + tgt[:2] + [63, 63], -1.0),   # rejected at position 3
            ([9, 63, 63, 63, 63], -1.0),        # rejected at position 1
            ([9] + tgt[:4], float(tgt[1])),     # EOS at live position 1
            ([9, 63, 63, 63, 63], float(tgt[2])),   # EOS on a dead one
            ([9] + tgt[:2] + [0, 0], -1.0))     # padded: n = 3


@pytest.mark.parametrize("case", range(6))
def test_spec_verify_equals_both_jax_twins(case):
    S = 5
    acc, tgt = _verify_acc(S)
    chain, eos = _chains(tgt)[case]
    dt = np.zeros(S + 2, np.float32)
    dt[0], dt[1] = (3 if case == 5 else S), eos
    dt[2:2 + S] = chain
    q3t = JMODEL.q3_table()
    want = jra.spec_verify_np(acc, dt, q3t)
    assert np.array_equal(np.asarray(jra._spec_verify_jnp(acc, dt, q3t)),
                          want)
    got = ra.spec_verify(_t(acc), _t(dt), _t(q3t)).numpy()
    assert np.array_equal(got, want), (got, want)
    batched = ra.spec_verify_tiles([_t(acc)] * 2, [_t(dt)] * 2,
                                   [_t(q3t)] * 2, [None, None])
    assert all(np.array_equal(b.numpy(), want) for b in batched)


# ---------------------------------------------------------------------------
# the drafter and the KV cache's speculative primitives
# ---------------------------------------------------------------------------

def test_ngram_drafter_drafts_equal_the_jax_drafter():
    rng = np.random.default_rng(11)
    for trial in range(20):
        hist = [int(t) for t in rng.integers(0, 6 + trial, 40)]
        mine, theirs = NgramDrafter(), JNgramDrafter()
        for t in hist:
            mine.observe(t)
            theirs.observe(t)
            for cur in (t, hist[0], 99):
                for k in (0, 1, 4, 9):
                    assert mine.draft(cur, k) == theirs.draft(cur, k)


def _kv(page_size=4, **kw):
    return PagedKVCollection("KV", page_size=page_size, num_heads=H,
                             head_dim=D, **kw)


def _jkv(page_size=4, **kw):
    return JPagedKV("KV", page_size=page_size, num_heads=H, head_dim=D, **kw)


def test_rollback_tail_across_a_page_boundary_equals_the_jax_cache():
    caches = {}
    for name, kv, chunks_of in (("port", _kv(), pdec.prefill_chunks),
                                ("jax", _jkv(), jdec.prefill_chunks)):
        model = MODEL if name == "port" else JMODEL
        kv.alloc_seq("s")
        for key, tile in chunks_of(model, kv, "s", [3, 7, 11]).items():
            c = kv.data_of(*key).get_copy(0)
            c.value = tile
            c.version += 1
        (pdec if name == "port" else jdec).preallocate_decode_steps(
            kv, "s", 5)
        for t in range(5):             # appends at slots 3..7: two pages
            pg, slot = divmod(3 + t, 4)
            c = kv.data_of("s", pg).get_copy(0)
            c.value[0, slot] = 1.0 + t
            c.value[2, 0, 0, 0] = min(4, 8 - pg * 4)
            c.version += 1
        kv.note_appended("s", 5)
        assert kv.rollback_tail("s", 5) == 3
        caches[name] = kv
    p, j = caches["port"], caches["jax"]
    for page in range(2):
        assert np.array_equal(
            p.data_of("s", page).newest_copy().value.numpy(),
            np.asarray(j.data_of("s", page).newest_copy().value)), page
    p1 = p.data_of("s", 1).newest_copy().value
    assert p1[2, 0, 0, 0] == 1 and p1[0, 0, 0, 0] == 2.0
    assert p1[0, 1:].abs().max() == 0.0
    keys = ("seqs", "tokens", "tail_rollbacks", "slots_rolled_back",
            "physical_pages", "cow_copies", "prefix_hits",
            "host_tier_bytes", "prefetch_inflight")
    assert {k: p.stats()[k] for k in keys} == \
        {k: j.stats()[k] for k in keys}
    assert p.seq_len("s") == 5 and p.live_seqs() == ["s"]
    for bad in (6, -1):
        with pytest.raises(ValueError):
            p.rollback_tail("s", bad)


def test_rollback_tail_refuses_shared_pages():
    kv = _kv()
    kv.alloc_seq("p")
    kv.alloc_page("p")
    kv.note_appended("p", 4)
    kv.fork("p", "c")
    with pytest.raises(RuntimeError, match="shared"):
        kv.rollback_tail("c", 2)


def test_rollback_tail_detaches_a_stale_device_copy():
    """A device copy holding the rejected appends, ahead of the host copy,
    is detached; the host copy starts from its bytes and versions past
    it."""
    kv = _kv()
    kv.alloc_seq("s")
    kv.alloc_page("s")
    kv.note_appended("s", 3)
    d = kv.data_of("s", 0)
    dev = DataCopy(d, 1, value=torch.full(kv.default_dtt.shape, 2.0))
    dev.version = d.get_copy(0).version + 5
    d.attach_copy(dev)
    kv.rollback_tail("s", 1)
    assert d.get_copy(1) is None
    host = d.get_copy(0)
    assert host.version > dev.version
    assert host.value[2, 0, 0, 0] == 1
    assert host.value[0, 0, 0, 0] == 2.0 and host.value[0, 1:].abs().max() == 0
    assert host.value.device.type == "cpu"


def test_seed_staging_detaches_stale_device_copies():
    kv = _kv()
    pad = 4
    QS = DictCollection("qs", dtt=TileType((pad, 3, H, D)))
    LIM = DictCollection("lim", dtt=TileType((pad,)))
    DTOKS = DictCollection("dt", dtt=TileType((pad + 2,)))
    kv.alloc_seq("s")
    kv.alloc_page("s")
    kv.note_appended("s", 2)
    d = kv.data_of("s", 0)
    dev = DataCopy(d, 1, value=torch.full(kv.default_dtt.shape, 7.0))
    dev.version = d.get_copy(0).version + 3
    d.attach_copy(dev)
    pdec.preallocate_decode_steps(kv, "s", 3)
    assert pdec.seed_spec_batched(MODEL, kv, QS, LIM, DTOKS, "s", 5,
                                  [9, 2], pad) == 3
    assert d.get_copy(1) is None
    host = d.get_copy(0)
    assert host.version > dev.version
    assert host.value[0, 0, 0, 0] == 7.0          # from the newest copy
    assert host.value[2, 0, 0, 0] == 4            # the staged fill
    assert torch.equal(host.value[0, 2], MODEL.q3(5)[1])
    assert torch.equal(host.value[1, 3], MODEL.q3(9)[2])


# ---------------------------------------------------------------------------
# the pools against the JAX pools
# ---------------------------------------------------------------------------

def _by_class(tp):
    """A spec pool's tasks by class, from its page schedule: ATTN on
    every attended page of every position, OUT and VERIFY a position (the
    per-position pool); SATTN a page and SVERIFY a stream (the batched
    one)."""
    g = tp.globals
    if "VERIFY" in {tc.name for tc in tp.task_classes}:
        n = sum(g["S"])
        return {"ATTN": sum(sum(nps) for nps in g["NP"]), "OUT": n,
                "VERIFY": n}
    return {"SATTN": sum(g["NP"]), "SVERIFY": g["NS"]}


def _run_jax(tp):
    ctx = JContext(nb_cores=0)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=120)
    ctx.fini()


def _run_port(tp, nb_cores=2):
    with Context(nb_cores=nb_cores) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)


def _general(pkg, model, prompts, drafts, eos):
    d, Dict, TT, KV = ((jdec, JDict, JTileType, _jkv) if pkg == "jax"
                       else (pdec, DictCollection, TileType, _kv))
    kv = KV()
    colls = dict(DRAFT=Dict("DRAFT", dtt=TT((3, H, D))),
                 O=Dict("O", dtt=TT((H, D))),
                 STOK=Dict("STOK", dtt=TT((4,))),
                 DTOK=Dict("DTOK", dtt=TT((1,))),
                 EMB=Dict("EMB", dtt=TT(tuple(model.q3_table().shape))))
    npos = d.seed_spec_superpool(model, kv, colls["DRAFT"], colls["DTOK"],
                                 colls["STOK"], colls["EMB"], prompts,
                                 drafts, eos=eos)
    tp = d.spec_superpool_ptg(kv, colls["DRAFT"], colls["O"],
                              colls["STOK"], colls["DTOK"], colls["EMB"],
                              list(prompts), [npos[s] for s in prompts])
    return tp, colls["STOK"], npos


def _batched(pkg, model, prompts, drafts, eos):
    d, Dict, TT, KV = ((jdec, JDict, JTileType, _jkv) if pkg == "jax"
                       else (pdec, DictCollection, TileType, _kv))
    kv = KV()
    pad = max(len(x) for x in drafts.values()) + 1
    colls = dict(QS=Dict("QS", dtt=TT((pad, 3, H, D))),
                 LIM=Dict("LIM", dtt=TT((pad,))),
                 DTOKS=Dict("DTOKS", dtt=TT((pad + 2,))),
                 VOUT=Dict("VOUT", dtt=TT((pad + 2,))),
                 EMB=Dict("EMB", dtt=TT(tuple(model.q3_table().shape))))
    npos, pad = d.seed_spec_batched_pool(
        model, kv, colls["QS"], colls["LIM"], colls["DTOKS"], colls["EMB"],
        prompts, drafts, pad=pad, eos=eos)
    tp = d.spec_batched_ptg(kv, colls["QS"], colls["LIM"], colls["DTOKS"],
                            colls["VOUT"], colls["EMB"], list(prompts),
                            [npos[s] for s in prompts], pad=pad)
    return tp, colls["VOUT"], npos


def _pool_tokens(kind, dev, prompts, drafts, eos=None):
    """Both packages' pool of ``kind`` on the same prompts and drafts:
    returns ``({seq: (tokens, done)}, tasks by class)`` after checking
    the port's against the JAX package's."""
    build = _general if kind == "general" else _batched
    jtp, jout, npos = build("jax", JMODEL, prompts, drafts, eos)
    ptp, pout, _ = build("port", MODEL, prompts, drafts, eos)
    assert _by_class(ptp) == _by_class(jtp)
    assert ptp.nb_local_tasks() == jtp.nb_local_tasks() \
        == sum(_by_class(jtp).values())
    before = dict(dev.tasks_by_class)
    _run_jax(jtp)
    _run_port(ptp)
    ran = {c: n - before.get(c, 0) for c, n in dev.tasks_by_class.items()
           if n - before.get(c, 0)}
    assert ran == _by_class(jtp)
    if kind == "general":
        got = pdec.read_spec_chains(pout, npos)
        want = {s: jdec.read_spec_chain(jout, s, npos[s]) for s in prompts}
    else:
        got = pdec.read_spec_batched(pout, list(prompts))
        want = {s: jdec.read_spec_batched(jout, s) for s in prompts}
    for s in prompts:
        assert got[s][0] == want[s][0] and bool(got[s][1]) == \
            bool(want[s][1]), (s, got[s], want[s])
    return got, ran


@pytest.mark.parametrize("kind", ["general", "batched"])
def test_spec_pools_acceptance_sweep_equals_the_jax_pools(cpu_cuda_device,
                                                          kind):
    """Acceptance 1.0, partial and 0 on both packages' pools: the same
    tokens, the oracle's accepted prefix, the same tasks by class."""
    prompts = {"a": [3, 7, 11, 5], "b": [1, 40], "c": list(range(2, 13))}
    ref = {s: MODEL.reference_generate(p, 6) for s, p in prompts.items()}
    full = {s: ref[s][:5] for s in prompts}
    partial = {s: ref[s][:2] + [(ref[s][2] + 1) % 64, 5] for s in prompts}
    garbage = {s: [(t + 1) % 64 for t in ref[s][:5]] for s in prompts}
    for drafts, n in ((full, 6), (partial, 3), (garbage, 1)):
        got, ran = _pool_tokens(kind, cpu_cuda_device, prompts, drafts)
        for s in prompts:
            assert got[s][0] == ref[s][:n], (s, got[s])
    if kind == "batched":
        assert set(ran) == {"SATTN", "SVERIFY"}
    else:
        assert set(ran) == {"ATTN", "OUT", "VERIFY"}


@pytest.mark.parametrize("kind", ["general", "batched"])
def test_spec_pools_eos_in_a_live_and_a_rejected_branch(cpu_cuda_device,
                                                        kind):
    prompt = [3, 7, 11, 5]
    ref = MODEL.reference_generate(prompt, 6)
    eos = ref[2]
    want = MODEL.reference_generate(prompt, 6, eos=eos)
    got, _ = _pool_tokens(kind, cpu_cuda_device, {"a": prompt},
                          {"a": ref[:5]}, eos=eos)
    assert got["a"][0] == want and got["a"][1]
    bad = [(ref[0] + 1) % 64] + ref[1:5]
    got, _ = _pool_tokens(kind, cpu_cuda_device, {"a": prompt},
                          {"a": bad}, eos=eos)
    assert got["a"][0] == ref[:1] and not got["a"][1]


def test_spec_pools_carry_only_the_device_chore():
    kv = _kv()
    colls = [DictCollection(n, dtt=TileType((1,))) for n in "QLDVE"]
    kv.alloc_seq("a")
    pdec.preallocate_decode_steps(kv, "a", 2)
    tp = pdec.spec_batched_ptg(kv, *colls, ["a"], [2])
    assert {c.device_type for tc in tp.task_classes for c in tc.chores} \
        == {"cuda"}
    tp = pdec.spec_superpool_ptg(kv, *colls[:5], ["a"], [2])
    assert {c.device_type for tc in tp.task_classes for c in tc.chores} \
        == {"cuda"}
    with pytest.raises(ValueError):
        pdec.spec_batched_ptg(kv, *colls, ["a"], [2], pad=1)


# ---------------------------------------------------------------------------
# the batcher against the JAX batcher
# ---------------------------------------------------------------------------

class OracleDrafter(NgramDrafter):
    """Drafts the true continuation (acceptance 1.0)."""

    __slots__ = ("hist",)

    def __init__(self):
        self.hist = []

    def observe(self, token):
        self.hist.append(int(token))

    def draft(self, cur, k):
        assert self.hist and self.hist[-1] == int(cur)
        return MODEL.reference_generate(self.hist, k)


class GarbageDrafter(OracleDrafter):
    """Drafts wrong tokens at the full cap (acceptance 0)."""

    __slots__ = ()

    def draft(self, cur, k):
        return [(t + 1) % MODEL.vocab
                for t in MODEL.reference_generate(self.hist, k)]


def _serve_both(prompts, max_new, params, drafter=None, eos=None,
                model=None, jmodel=None):
    """The same streams through the JAX package's server and the port's
    (on the device module around the host), each with ``params`` set and
    ``drafter`` in place of ``NgramDrafter``.  Returns ``{"jax": (tokens,
    stats), "port": (...)}``."""
    from parsec_tpu.core.params import params as jax_params
    out = {}
    for name, server_cls, batcher_cls, pp, mod, m in (
            ("jax", JRuntimeServer, None, jax_params, "parsec_tpu",
             jmodel),
            ("port", RuntimeServer, ContinuousBatcher, port_params,
             "parsec_tpu_torch", model)):
        saved = {k: pp.get(k) for k in params}
        for k, v in params.items():
            pp.set(k, v)
        patch = mock.patch(f"{mod}.llm.batcher.NgramDrafter", drafter) \
            if drafter else None
        try:
            if patch:
                patch.start()
            with server_cls(nb_cores=2) as server:
                if m is None:
                    submit = server.submit_stream
                    b = None
                else:
                    if name == "jax":
                        from parsec_tpu.llm import ContinuousBatcher as JCB
                        b = JCB(server, model=m)
                    else:
                        b = batcher_cls(server, model=m)
                    submit = b.submit_stream
                tks = [submit(p, max_new_tokens=max_new, eos=eos,
                              tenant=f"t{i % 2}")
                       for i, p in enumerate(prompts)]
                toks = [tk.result(timeout=300)["tokens"] for tk in tks]
                stats = b.stats() if b is not None \
                    else server.stats()["llm"]
                if b is not None:
                    b.stop()
            out[name] = (toks, stats, tks)
        finally:
            if patch:
                patch.stop()
            for k, v in saved.items():
                pp.set(k, v)
    return out


# per-stream counters: which pools a stream rides depends on its own
# history alone (decode_submits, a count of pools, depends on which streams
# an iteration finds live, so on timing)
SPEC_KEYS = ("spec_submits", "spec_tokens", "spec_drafted",
             "spec_drafts_accepted", "spec_accept_rate", "tokens_generated")


@pytest.mark.parametrize("drafter,accept", [
    (OracleDrafter, 1.0), (None, None), (GarbageDrafter, 0.0)],
    ids=["accept-1.0", "accept-ngram", "accept-0"])
def test_batcher_spec_acceptance_sweep_equals_the_jax_batcher(
        cpu_cuda_device, drafter, accept):
    """Every stream token for token the oracle's and the JAX batcher's,
    and the spec counters (acceptance included) equal to the JAX
    batcher's, whatever the drafter."""
    prompts = [[3, 7, 11, 5], [1, 40], [8, 8, 2, 6] * 3, [5, 9]]
    out = _serve_both(prompts, 14, {"llm_spec_k": 6,
                                    "llm_spec_adaptive": False},
                      drafter=drafter)
    (jtoks, jst, _), (ptoks, pst, _) = out["jax"], out["port"]
    for p, j, t in zip(prompts, jtoks, ptoks):
        assert t == j == MODEL.reference_generate(p, 14), p
    assert {k: pst.get(k) for k in SPEC_KEYS} == \
        {k: jst.get(k) for k in SPEC_KEYS}
    assert pst["spec_submits"] > 0
    assert pst["kv"]["tail_rollbacks"] == jst["kv"]["tail_rollbacks"]
    assert pst["kv"]["slots_rolled_back"] == jst["kv"]["slots_rolled_back"]
    assert pst["kv"]["physical_pages"] == 0
    if accept is not None:
        assert pst["spec_accept_rate"] == accept
    if accept == 0.0:
        assert pst["kv"]["tail_rollbacks"] == pst["spec_submits"]
    s = cpu_cuda_device.stats()["tasks_by_class"]
    assert s.get("SATTN", 0) > 0 and s.get("SVERIFY", 0) > 0


def test_batcher_spec_eos_mid_draft(cpu_cuda_device):
    ref = MODEL.reference_generate([3, 7, 11, 5], 16)
    eos = ref[5]
    out = _serve_both([[3, 7, 11, 5], [1, 40]], 16,
                      {"llm_spec_k": 8, "llm_spec_adaptive": False},
                      drafter=OracleDrafter, eos=eos)
    (jtoks, _, _), (ptoks, pst, _) = out["jax"], out["port"]
    assert ptoks == jtoks
    assert ptoks[0] == MODEL.reference_generate([3, 7, 11, 5], 16, eos=eos)
    assert len(ptoks[0]) < 16
    assert pst["kv"]["physical_pages"] == 0


def test_adaptive_spec_k_converges_off_on_garbage(cpu_cuda_device):
    prompts = [[(7 * i + 3 * j) % 64 for j in range(8)] for i in range(4)]
    out = _serve_both(prompts, 40, {"llm_spec_k": 16,
                                    "llm_spec_adaptive": True},
                      drafter=GarbageDrafter)
    (jtoks, jst, jtks), (ptoks, pst, ptks) = out["jax"], out["port"]
    assert ptoks == jtoks == [MODEL.reference_generate(p, 40)
                              for p in prompts]
    # the tenant prior a stream starts from depends on which streams
    # finished pools before its first look (timing), so the counts are
    # bounded, not compared
    assert pst["spec_accept_rate"] == jst["spec_accept_rate"] == 0.0
    assert all((tk.spec_k or 0) <= 1 for tk in ptks + jtks)
    assert pst["spec_submits"] <= 6 * len(prompts)
    assert pst["kv"]["tail_rollbacks"] == pst["spec_submits"]


def test_wide_heads_spec_equals_the_jax_batcher(cpu_cuda_device):
    """Speculative decode at Llama-2-7B's attention width (32 heads of
    128): two repetitive prompts the drafter proposes on, one random."""
    rng = np.random.default_rng(4)
    model = ToyLM(num_heads=32, head_dim=128)
    jmodel = JToyLM(num_heads=32, head_dim=128)
    prompts = [[5, 9, 13] * 6, [2, 4] * 9,
               [int(t) for t in rng.integers(0, 64, 20)]]
    margins = []
    for p in prompts:
        model.reference_generate(p, 10, margins=margins)
    assert min(margins) > 1e-2          # no near-tie for fp32 to flip
    out = _serve_both(prompts, 10, {"llm_spec_k": 4,
                                    "llm_spec_adaptive": False},
                      model=model, jmodel=jmodel)
    (jtoks, jst, _), (ptoks, pst, _) = out["jax"], out["port"]
    assert ptoks == jtoks == [model.reference_generate(p, 10)
                              for p in prompts]
    assert {k: pst.get(k) for k in SPEC_KEYS} == \
        {k: jst.get(k) for k in SPEC_KEYS}
    assert pst["spec_submits"] > 0

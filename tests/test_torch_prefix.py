"""The port's prefix cache against the JAX package's.

The radix tree (``llm/prefix_tree.py``) against a brute-force
longest-common-prefix oracle and against the JAX tree on the same
donation and adoption sequence (hypothesis draws the sequences), its LRU
eviction under the byte budget, adoption surviving the eviction of its
donor; the KV cache's ``fork_prefix``; the tail-only prefill pool; and
the batcher with ``llm_prefix_cache`` on, whose tokens, prefix hits,
skipped prefill tokens and PF tasks must equal the JAX batcher's, with
the port's tasks on the CUDA device module around the host.  Tokens and
counts are compared exactly.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from parsec_tpu.core.params import params as jax_params
from parsec_tpu.data_dist.paged_kv import PagedKVCollection as JPagedKV
from parsec_tpu.llm import ContinuousBatcher as JContinuousBatcher
from parsec_tpu.llm import ToyLM as JToyLM
from parsec_tpu.llm.batcher import aggregate_report as jaggregate_report
from parsec_tpu.llm.prefix_tree import PrefixTree as JPrefixTree
from parsec_tpu.serve import RuntimeServer as JRuntimeServer
from parsec_tpu_torch.core.params import params as port_params
from parsec_tpu_torch.data.data import DataCopy
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.llm import ContinuousBatcher, PrefixTree, ToyLM
from parsec_tpu_torch.llm import aggregate_report
from parsec_tpu_torch.llm import decode as pdec
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.serve import RuntimeServer

MODEL = ToyLM()
H, D = MODEL.num_heads, MODEL.head_dim


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def _kv(page_size=4, **kw):
    return PagedKVCollection("KV", page_size=page_size, num_heads=H,
                             head_dim=D, **kw)


def _fill_seq(kv, seq, ntokens):
    """Allocate a sequence and advance its ledger as if prefilled."""
    kv.alloc_seq(seq)
    P = kv.page_size
    for _ in range((ntokens + P - 1) // P):
        kv.alloc_page(seq)
    kv.note_appended(seq, ntokens)


def _lcp(a, b):
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

_OPS = st.lists(st.tuples(st.booleans(),
                          st.lists(st.integers(0, 3), min_size=1,
                                   max_size=29)),
                min_size=1, max_size=60)


@settings(max_examples=40, deadline=None)
@given(ops=_OPS)
def test_trie_adopts_the_longest_common_prefix_like_the_jax_trie(ops):
    """Random donations and adoptions on both packages' trees: adoption
    reuses exactly the longest full-page common prefix over every retained
    run (the brute-force oracle), as the JAX tree does."""
    kv = _kv(max_pages=4096)
    jkv = JPagedKV("KV", page_size=4, num_heads=H, head_dim=D,
                   max_pages=4096)
    tree = PrefixTree(kv, budget_bytes=1 << 30)
    jtree = JPrefixTree(jkv, budget_bytes=1 << 30)
    P = kv.page_size
    retained = []
    for i, (donate, prompt) in enumerate(ops):
        if donate:
            for k, t in ((kv, tree), (jkv, jtree)):
                _fill_seq(k, f"d{i}", len(prompt) - 1)
            r = tree.donate(f"d{i}", prompt)
            assert (r is None) == (jtree.donate(f"d{i}", prompt) is None)
            if r is not None:
                retained.append(tuple(prompt[:(len(prompt) - 1) // P * P]))
            kv.free_seq(f"d{i}")
            jkv.free_seq(f"d{i}")
        else:
            cacheable = prompt[:-1]
            want = max((_lcp(cacheable, r) // P for r in retained),
                       default=0)
            got = tree.adopt(f"c{i}", cacheable)
            assert got == want == jtree.adopt(f"c{i}", cacheable)
            assert kv.seq_len(f"c{i}") == got * P
            assert kv.npages(f"c{i}") == got
            kv.free_seq(f"c{i}")
            jkv.free_seq(f"c{i}")
    s, js = tree.stats(), jtree.stats()
    assert s == js
    assert s["entries"] == len(set(retained)) == s["donations"]
    assert kv.stats()["physical_pages"] == jkv.stats()["physical_pages"]


def test_trie_lru_eviction_recycles_pages_and_keeps_warm_entries():
    kv = _kv(page_size=2, max_pages=64)
    tree = PrefixTree(kv, budget_bytes=2 * 2 * kv.page_bytes)  # 2 entries
    runs = {}
    for name, base in (("a", 10), ("b", 20), ("c", 30)):
        prompt = [base, base + 1, base + 2, base + 3, 0]
        _fill_seq(kv, name, 4)
        runs[name] = tuple(prompt[:4])
        tree.donate(name, prompt)
        kv.free_seq(name)
        if name == "b":                 # touch "a": "b" is the cold one
            assert tree.adopt("toucher", list(runs["a"])) == 2
            kv.free_seq("toucher")
    assert tree.stats()["evictions"] == 1
    kept = {e[0] for e in tree.live_entries().values()}
    assert runs["a"] in kept and runs["c"] in kept
    assert runs["b"] not in kept
    assert tree.adopt("miss", list(runs["b"])) == 0
    assert kv.stats()["free_pages"] >= 2


def test_an_adopted_prefix_outlives_the_eviction_of_its_donor():
    kv = _kv(page_size=2)
    tree = PrefixTree(kv, budget_bytes=1 << 30)
    _fill_seq(kv, "donor", 4)
    d0 = kv.data_of("donor", 0)
    d0.get_copy(0).value[0, 0, 0, 0] = 7.0
    tree.donate("donor", [1, 2, 3, 4, 9])
    kv.free_seq("donor")
    assert tree.adopt("child", [1, 2, 3, 4]) == 2
    tree.clear()
    assert tree.stats()["entries"] == 0
    assert kv.data_of("child", 0) is d0
    assert kv.data_of("child", 0).get_copy(0).value[0, 0, 0, 0] == 7.0
    assert kv.stats()["prefix_hits"] == 1
    assert kv.stats()["prefix_pages_reused"] == 2


def test_fork_prefix_checks_bounds_and_page_alignment():
    kv = _kv(page_size=4)
    _fill_seq(kv, "p", 6)
    with pytest.raises(ValueError):
        kv.fork_prefix("p", "c", 3)     # past the table
    with pytest.raises(ValueError):
        kv.fork_prefix("p", "c", 2)     # page 1 holds 2 tokens
    kv.fork_prefix("p", "c", 1)
    assert kv.seq_len("c") == 4 and kv.npages("c") == 1
    with pytest.raises(KeyError):
        kv.fork_prefix("p", "c", 1)


def test_privatize_copies_the_newest_device_bytes_home():
    """A shared tail whose device copy runs ahead of the host copy is
    privatized from the device bytes, into a host tensor, versioned past
    every copy."""
    kv = _kv(page_size=4)
    kv.alloc_seq("parent")
    for _ in range(2):
        kv.ensure_tail_slot("parent")
        kv.note_appended("parent")
    d = kv.data_of("parent", 0)
    host = d.get_copy(0)
    stale = host.value.clone()
    fresh = host.value.clone()
    fresh[0, 0, 0, 0] = 99.0
    dev = DataCopy(d, 1, value=fresh)
    dev.version = host.version + 3
    d.attach_copy(dev)
    kv.fork("parent", "child")
    kv.ensure_tail_slot("child")
    c = kv.data_of("child", 0).get_copy(0)
    assert c.value[0, 0, 0, 0] == 99.0 and c.value is not fresh
    assert c.version > dev.version
    assert torch.equal(host.value, stale)


def test_kv_stats_carry_the_tier_and_prefix_keys():
    s = _kv().stats()
    for key in ("prefix_hits", "prefix_pages_reused", "host_tier_bytes",
                "prefetch_inflight", "tail_rollbacks", "slots_rolled_back"):
        assert s[key] == 0


# ---------------------------------------------------------------------------
# tail-only prefill
# ---------------------------------------------------------------------------

def test_tail_prefill_pool_writes_only_the_tail_pages(cpu_cuda_device):
    kv = _kv(page_size=4)
    _fill_seq(kv, "donor", 8)
    kv.data_of("donor", 0).get_copy(0).value[0, 0, 0, 0] = 123.0
    tree = PrefixTree(kv, budget_bytes=1 << 30)
    tree.donate("donor", [1, 2, 3, 4, 5, 6, 7, 8, 9])
    kv.free_seq("donor")
    assert tree.adopt("child", [1, 2, 3, 4, 5, 6, 7, 8, 11]) == 2
    chunks = pdec.prefill_chunks(MODEL, kv, "child", [11])
    assert list(chunks) == [("child", 2)]
    assert kv.seq_len("child") == 9 and kv.npages("child") == 3
    T = DictCollection("T", dtt=kv.default_dtt,
                       init_fn=lambda *k: chunks[k], keys=list(chunks))
    tp = pdec.prefill_ptg(kv, T, ["child"], starts=[2])
    assert tp.nb_local_tasks() == 1
    with Context(nb_cores=0) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
    assert cpu_cuda_device.tasks_by_class["PF"] == 1
    assert kv.data_of("child", 0).newest_copy().value[0, 0, 0, 0] == 123.0
    tail = kv.data_of("child", 2).newest_copy().value
    assert torch.equal(tail[0, 0], MODEL.q3(11)[1])
    with pytest.raises(ValueError):
        pdec.prefill_ptg(kv, T, ["child"], starts=[7])


# ---------------------------------------------------------------------------
# the batcher against the JAX batcher
# ---------------------------------------------------------------------------

def _serve_waves(waves, max_new, model=None, jmodel=None, cache=True):
    """Each wave's streams through both packages' batchers with
    ``llm_prefix_cache`` set; a wave starts when the previous one
    finished (and donated).  Returns ``{pkg: (tokens, stats, pf_tasks)}``,
    ``pf_tasks`` the PF tasks of each wave's prefill pools."""
    out = {}
    for name, server_cls, batcher_cls, pp, m in (
            ("jax", JRuntimeServer, JContinuousBatcher, jax_params,
             jmodel or JToyLM()),
            ("port", RuntimeServer, ContinuousBatcher, port_params,
             model or MODEL)):
        saved = pp.get("llm_prefix_cache")
        pp.set("llm_prefix_cache", cache)
        try:
            with server_cls(nb_cores=2) as server:
                b = batcher_cls(server, model=m)
                pf = []
                real = server.submit

                def submit(tp, *a, _pf=pf, _real=real, **kw):
                    if tp.name.startswith("llm_prefill"):
                        _pf[-1] += tp.nb_local_tasks()
                    return _real(tp, *a, **kw)

                server.submit = submit
                toks = []
                for wave in waves:
                    pf.append(0)
                    tks = [b.submit_stream(p, max_new_tokens=max_new,
                                           tenant=f"t{i % 2}")
                           for i, p in enumerate(wave)]
                    toks.append([tk.result(timeout=300)["tokens"]
                                 for tk in tks])
                stats = b.stats()
                b.stop()
            out[name] = (toks, stats, pf)
        finally:
            pp.set("llm_prefix_cache", saved)
    return out


PREFIX_KEYS = ("prefix_hits", "prefix_pages_reused")


def _shared_waves(seed, sys_len=33, n=5, suffix=(1, 9)):
    rng = np.random.default_rng(seed)
    system = [int(t) for t in rng.integers(0, 64, sys_len)]
    wave = [system + [int(t) for t in rng.integers(
        0, 64, int(rng.integers(*suffix)))] for _ in range(n)]
    return system, wave


def test_prefix_batcher_equals_the_jax_batcher(cpu_cuda_device):
    """Shared-system-prompt traffic: a first wave donates, a second wave
    of full hits, extensions, a mid-page divergence and a miss adopts —
    tokens, hits, skipped prefill tokens and each wave's PF tasks equal
    the JAX batcher's."""
    system, wave2 = _shared_waves(1)
    wave2 += [system[:20] + [50, 51], [60, 61, 62, 63], list(system)]
    out = _serve_waves([[system + [3]], wave2], 4)
    (jtoks, jst, jpf), (ptoks, pst, ppf) = out["jax"], out["port"]
    assert ptoks == jtoks
    for wave, toks in zip([[system + [3]], wave2], ptoks):
        assert toks == [MODEL.reference_generate(p, 4) for p in wave]
    assert {k: pst["kv"][k] for k in PREFIX_KEYS} == \
        {k: jst["kv"][k] for k in PREFIX_KEYS}
    assert pst["prefill_tokens_skipped"] == jst["prefill_tokens_skipped"]
    assert pst["prefill_tokens_total"] == jst["prefill_tokens_total"]
    assert ppf == jpf
    # 5 extensions, the mid-page divergence (1 page) and the exact repeat
    assert pst["kv"]["prefix_hits"] == 7
    assert pst["prefix"]["donations"] >= 1
    assert pst["kv"]["physical_pages"] == jst["kv"]["physical_pages"]


def test_prefix_cache_off_by_default_and_the_control(cpu_cuda_device):
    system, wave = _shared_waves(2)
    out = _serve_waves([[system + [7]], wave], 3, cache=False)
    (jtoks, jst, jpf), (ptoks, pst, ppf) = out["jax"], out["port"]
    assert ptoks == jtoks
    assert pst["kv"]["prefix_hits"] == 0 and "prefix" not in pst
    assert pst["kv"]["physical_pages"] == 0
    assert ppf == jpf
    assert port_params.get("llm_prefix_cache") is False


def test_aggregate_report_survives_batcher_retirement(cpu_cuda_device):
    before, jbefore = aggregate_report(), jaggregate_report()
    system, _ = _shared_waves(3)
    _serve_waves([[system + [1]], [system + [2]]], 2)
    after, jafter = aggregate_report(), jaggregate_report()
    for key in ("prefix_hits", "tokens_generated", "prefill_tokens_skipped"):
        assert after.get(key, 0) - before.get(key, 0) == \
            jafter.get(key, 0) - jbefore.get(key, 0), key
    assert after["prefix_hits"] - before.get("prefix_hits", 0) == 1


def test_residency_len_and_load(cpu_cuda_device):
    port_params.set("llm_prefix_cache", True)
    try:
        with RuntimeServer(nb_cores=2) as server:
            b = ContinuousBatcher(server, model=MODEL)
            prompt = list(range(1, 40))
            assert b.residency_len(prompt) == 0
            b.submit_stream(prompt, max_new_tokens=2).result(timeout=60)
            assert b.residency_len(prompt) == 32
            assert b.residency_len(prompt[:20] + [0] * 20) == 16
            assert b.load() == {"live": 0, "queued": 0}
            b.stop()
    finally:
        port_params.set("llm_prefix_cache", False)


def test_wide_heads_prefix_equals_the_jax_batcher(cpu_cuda_device):
    """The prefix cache at Llama-2-7B's attention width (32 heads of
    128): a 2-page system prompt, one donor, three adopters."""
    model = ToyLM(num_heads=32, head_dim=128)
    jmodel = JToyLM(num_heads=32, head_dim=128)
    system, wave = _shared_waves(6, n=3)
    margins = []
    for p in [system + [3]] + wave:
        model.reference_generate(p, 4, margins=margins)
    assert min(margins) > 1e-2
    out = _serve_waves([[system + [3]], wave], 4, model=model,
                       jmodel=jmodel)
    (jtoks, jst, jpf), (ptoks, pst, ppf) = out["jax"], out["port"]
    assert ptoks == jtoks
    assert ptoks[1] == [model.reference_generate(p, 4) for p in wave]
    assert pst["kv"]["prefix_hits"] == jst["kv"]["prefix_hits"] == 3
    assert ppf == jpf

"""The port's paged KV cache against the JAX package's, and the
recycle-detach discipline against the CUDA device module's tile cache.

The same scripted ledger operations (allocate, append, fork, copy on
write, free, recycle) run on ``parsec_tpu``'s and ``parsec_tpu_torch``'s
``PagedKVCollection``: block tables, lengths, tallies, page contents and
host versions must agree.  Device copies are exercised through
``init_cuda_devices(device="cpu")``: the device module around the host.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.data_dist.paged_kv import PagedKVCollection as JPagedKV
from parsec_tpu_torch.data.data import (COHERENCY_INVALID, COHERENCY_OWNED,
                                        DataCopy)
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices

H, D = 4, 8
_STATS = ("seqs", "tokens", "logical_pages", "physical_pages",
          "shared_pages", "free_pages", "page_bytes", "bytes_in_use",
          "pages_allocated", "pages_recycled", "cow_copies")


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def _pair(**kw):
    return (JPagedKV("KV", page_size=4, num_heads=H, head_dim=D, **kw),
            PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D,
                              **kw))


def _agree(jkv, kv, seqs):
    js, ps = jkv.stats(), kv.stats()
    assert {k: js[k] for k in _STATS} == {k: ps[k] for k in _STATS}
    for s in seqs:
        assert jkv.block_table(s) == kv.block_table(s), s
        assert jkv.seq_len(s) == kv.seq_len(s)
        for p in range(kv.npages(s)):
            jc, pc = jkv.data_of(s, p).get_copy(0), kv.data_of(s, p).get_copy(0)
            assert np.array_equal(np.asarray(jc.value), pc.value.numpy())
            assert jc.version == pc.version, (s, p)
            assert kv.page_fill(s, p) == jkv.page_fill(s, p)


def _script(kv, write):
    """The ledger script both collections run, yielding the live
    sequences at each checkpoint; ``write(kv, seq, page, x)`` puts a
    marker into a page's host copy."""
    kv.alloc_seq("a")
    for _ in range(6):                       # 1.5 pages of 4 slots
        kv.ensure_tail_slot("a")
        kv.note_appended("a")
    write(kv, "a", 1, 42.0)
    kv.fork("a", "b")
    yield ["a", "b"]                          # shared pages, no copy yet
    kv.ensure_tail_slot("b")                  # CoW: b privatizes its tail
    yield ["a", "b"]
    kv.ensure_tail_slot("a")                  # a's tail is private again
    for _ in range(3):
        kv.ensure_tail_slot("b")
        kv.note_appended("b")
    yield ["a", "b"]
    kv.free_seq("a")
    kv.free_seq("b")
    kv.alloc_seq("c")
    kv.alloc_page("c")                        # a recycled page
    kv.alloc_page("c")
    yield ["c"]


def _write(kv, s, p, x):
    kv.data_of(s, p).get_copy(0).value[0, 0, 0, 0] = x


def test_ledger_matches_the_jax_collection():
    jkv, kv = _pair()
    for jseqs, pseqs in zip(_script(jkv, _write), _script(kv, _write)):
        assert jseqs == pseqs
        _agree(jkv, kv, pseqs)
    assert kv.cow_copies == 1 and kv.pages_recycled == 2
    # recycled pages come back zeroed with a bumped version
    c = kv.data_of("c", 0).get_copy(0)
    assert float(c.value.abs().max()) == 0.0 and c.version >= 2


def test_cow_copy_carries_the_shared_contents():
    _, kv = _pair()
    gen = _script(kv, _write)
    next(gen)
    next(gen)                                 # after b's CoW
    assert kv.block_table("a")[0] == kv.block_table("b")[0]
    assert kv.block_table("a")[1] != kv.block_table("b")[1]
    assert float(kv.data_of("b", 1).get_copy(0).value[0, 0, 0, 0]) == 42.0


def test_recycle_version_jumps_past_a_device_copy_ahead_of_host():
    """The JAX collection's recycle rule, held on both sides: a device
    copy that ran ahead of the host is detached and the host version
    jumps past it."""
    from parsec_tpu.data.data import DataCopy as JDataCopy
    jkv, kv = _pair()
    for c, (mk, ones) in ((jkv, (JDataCopy, np.ones)),
                          (kv, (DataCopy, torch.ones))):
        c.alloc_seq("a")
        c.alloc_page("a")
        d = c.data_of("a", 0)
        dev = mk(d, 1, value=ones(tuple(c.default_dtt.shape)))
        dev.version = d.get_copy(0).version + 5
        d.attach_copy(dev)
        c.free_seq("a")
        c.alloc_seq("b")
        c.alloc_page("b")
        d2 = c.data_of("b", 0)
        assert d2 is d and d2.get_copy(1) is None
        assert dev.coherency == 0                 # COHERENCY_INVALID
        assert d2.get_copy(0).version > dev.version
    assert jkv.data_of("b", 0).get_copy(0).version == \
        kv.data_of("b", 0).get_copy(0).version


@pytest.mark.parametrize("where", ["lru", "evict_queue"])
def test_scrubbed_copy_never_writes_back_or_satisfies_stage_in(
        cpu_cuda_device, where):
    """A dirty device copy still sitting in the tile cache (or in its
    deferred-eviction queue) when its page recycles must not write over
    the zeroed host page, and a new reader must not hit it."""
    dev = cpu_cuda_device
    kv = PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D)
    kv.alloc_seq("a")
    kv.alloc_page("a")
    d = kv.data_of("a", 0)
    stale = DataCopy(d, dev.device_index,
                     value=torch.full(kv.default_dtt.shape, 7.0))
    stale.version = d.get_copy(0).version + 3
    stale.coherency = COHERENCY_OWNED
    d.attach_copy(stale)
    dev._cache_insert(d.key, stale, 0)
    if where == "evict_queue":
        with dev._lru_lock:
            del dev._mem_lru[d.key]
            dev._evict_q.append(stale)
    kv.free_seq("a")
    kv.alloc_seq("b")
    kv.alloc_page("b")                        # recycles the page
    host = d.get_copy(0)
    v_host = host.version
    assert stale.coherency == COHERENCY_INVALID
    assert d.get_copy(dev.device_index) is None
    dev.flush_cache()                         # drains the queue too
    assert float(host.value.abs().max()) == 0.0
    assert host.version == v_host > stale.version
    # a new reader of the page misses the stale copy and lands the zeros
    from parsec_tpu_torch.runtime.task import Flow, Task, TaskClass
    tc = TaskClass("R", [], [Flow("KV", 1)], [])
    t = Task(None, tc, {})
    t.data[0] = kv.data_of("b", 0).newest_copy()
    hits = dev.cache_hits
    dev.stage_in_many([t])
    assert dev.cache_hits == hits
    assert t.data[0] is not stale and float(t.data[0].value.abs().max()) == 0


def test_privatize_sources_a_device_copy_ahead_of_host():
    kv = PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D)
    kv.alloc_seq("p")
    kv.ensure_tail_slot("p")
    kv.note_appended("p")
    d = kv.data_of("p", 0)
    ahead = DataCopy(d, 1, value=torch.full(kv.default_dtt.shape, 3.0))
    ahead.version = d.get_copy(0).version + 2
    d.attach_copy(ahead)
    kv.fork("p", "q")
    kv.ensure_tail_slot("q")                  # CoW from the newest copy
    priv = kv.data_of("q", 0).get_copy(0)
    assert float(priv.value.min()) == 3.0
    assert priv.version > ahead.version
    assert kv.data_of("p", 0) is d            # the parent keeps its page


def test_page_budget_and_double_alloc_raise():
    kv = PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D,
                           max_pages=2)
    kv.alloc_seq("a")
    kv.alloc_page("a")
    kv.alloc_page("a")
    with pytest.raises(MemoryError):
        kv.alloc_page("a")
    with pytest.raises(KeyError):
        kv.alloc_seq("a")
    assert kv.has_key("a", 1) and not kv.has_key("a", 2)
    assert not kv.has_key("z", 0) and not kv.has_key("a")


def test_dict_collection_lazy_keys_and_discard():
    dc = DictCollection("Q", dtt=TileType((2, 3)))
    d = dc.data_of("s")
    assert d.key == ("Q", "s") and float(d.get_copy(0).value.sum()) == 0
    assert dc.data_of("s") is d and ("s",) in dc
    assert dc.discard("s") and not dc.discard("s")
    assert dc.data_of("s") is not d           # re-materializes fresh
    closed = DictCollection("T", init_fn=lambda *k: np.full(2, k[1],
                                                            np.float32),
                            keys=[(0, 1), (0, 2)])
    assert closed.has_key(0, 1) and not closed.has_key(0, 3)
    assert closed.data_of(0, 2).get_copy(0).value.tolist() == [2.0, 2.0]
    assert closed.known_keys() == [(0, 1), (0, 2)]
    with pytest.raises(KeyError):
        DictCollection("X").data_of(1)

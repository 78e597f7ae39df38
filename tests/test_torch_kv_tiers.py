"""The port's KV tiers against the JAX package's.

The tier map's ledger fed by the device module's spill hook, the
prefetch back onto the device (``CUDADevice.prefetch_data`` on the
module around the host), the peer tier over ``InprocFabric`` (a spill by
AM, custody acknowledged, the way back by ``prefetch_get``, whole and
fragmented), the soak of a batcher whose tile budget is below its live
KV, a subscriber that raises (counted, never fatal to the write-back),
and an injected kernel failure, which stops the run: the device module
has no demote path to the host.  Tokens, bytes, versions and counts are
compared exactly with the JAX package's on the same inputs.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.comm.engine import InprocFabric as JInprocFabric
from parsec_tpu.data_dist.kv_tiers import KVTierMap as JKVTierMap
from parsec_tpu.data_dist.kv_tiers import PeerKVStore as JPeerKVStore
from parsec_tpu.data_dist.paged_kv import PagedKVCollection as JPagedKV
from parsec_tpu.llm import ContinuousBatcher as JContinuousBatcher
from parsec_tpu.llm import ToyLM as JToyLM
from parsec_tpu.serve import RuntimeServer as JRuntimeServer
from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm.engine import InprocFabric
from parsec_tpu_torch.core.params import params as port_params
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.kv_tiers import KVTierMap, PeerKVStore
from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import (init_cuda_devices,
                                         register_spill_hook)
from parsec_tpu_torch.device.kernels import register_kernel
from parsec_tpu_torch.llm import ContinuousBatcher, ToyLM
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.serve import RuntimeServer

MODEL = ToyLM()
H, D = MODEL.num_heads, MODEL.head_dim
PAGE_BYTES = 3 * 4 * H * D * 4           # a (3, 4, 4, 8) fp32 page
SERVE_PAGE_BYTES = 3 * 16 * H * D * 4    # the batcher's (3, 16, 4, 8)


@pytest.fixture
def cpu_cuda_device():
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


def _kvs():
    return (PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D),
            JPagedKV("KV", page_size=4, num_heads=H, head_dim=D))


def _page(kv, seq, version, base):
    kv.alloc_seq(seq)
    kv.alloc_page(seq)
    kv.note_appended(seq, 4)
    d = kv.data_of(seq, 0)
    host = d.get_copy(0)
    shape = kv.default_dtt.shape
    vals = np.arange(base, base + int(np.prod(shape)),
                     dtype=np.float32).reshape(shape)
    host.value = torch.from_numpy(vals.copy()) \
        if isinstance(kv, PagedKVCollection) else vals.copy()
    host.version = version
    return d, vals


def _progress(*engines, rounds=20):
    for _ in range(rounds):
        for e in engines:
            e.progress()


# ---------------------------------------------------------------------------
# the peer tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frag", [0, 1024])
def test_peer_round_trip_equals_the_jax_tier(port_param, param, frag):
    """A host page past the host budget spills to the peer rank by an AM;
    once the peer acknowledges custody the local bytes drop; the prefetch
    pulls them back by a prefetch GET (whole, or in 1 KiB fragments under
    the credit window) with bytes and version intact — as in the JAX
    tier."""
    port_param("kv_host_tier_bytes", 1)
    param("kv_host_tier_bytes", 1)
    port_param("comm_get_frag_bytes", frag)
    param("comm_get_frag_bytes", frag)
    kv, jkv = _kvs()
    out = {}
    for name, k, fab_cls, tier_cls, store_cls in (
            ("port", kv, InprocFabric, KVTierMap, PeerKVStore),
            ("jax", jkv, JInprocFabric, JKVTierMap, JPeerKVStore)):
        fab = fab_cls(2)
        e0, e1 = fab.attach(0), fab.attach(1)
        store = store_cls(e1)
        tiers = tier_cls(k)
        tiers.attach_peer(e0, 1)
        d, vals = _page(k, "a", 5, 3.0)
        tiers.note_spill(d, PAGE_BYTES)        # as the device hook would
        _progress(e0, e1)
        assert d.get_copy(0).value is None     # custody moved
        held = store.stats()
        peer = tiers.stats()["peer_tier_pages"]
        tiers.prefetch_seqs(["a"])
        _progress(e0, e1)
        back = d.get_copy(0)
        out[name] = (held, peer, np.asarray(back.value).copy(),
                     back.version, tiers.stats()["peer_fetches"],
                     store.stats(), e0.prefetch_gets)
        assert np.array_equal(out[name][2], vals)
    p, j = out["port"], out["jax"]
    assert p[0] == j[0] == {"pages_held": 1, "bytes_held": PAGE_BYTES}
    assert p[1] == j[1] == 1
    assert np.array_equal(p[2], j[2]) and p[3] == j[3] == 5
    assert p[4] == j[4] == 1
    assert p[5] == j[5] == {"pages_held": 0, "bytes_held": 0}
    assert p[6] == j[6] == 1


def test_peer_spill_keeps_the_local_bytes_until_the_ack(port_param):
    port_param("kv_host_tier_bytes", 1)
    fab = InprocFabric(2)
    e0 = fab.attach(0)
    fab.attach(1)                      # a peer with no store: no ACK
    kv, _ = _kvs()
    tiers = KVTierMap(kv)
    tiers.attach_peer(e0, 1)
    d, _ = _page(kv, "a", 2, 0.0)
    tiers.note_spill(d, PAGE_BYTES)
    e0.progress()
    assert d.get_copy(0).value is not None
    assert tiers.stats()["peer_tier_pages"] == 1


def test_a_page_spills_once_while_its_spill_is_in_flight(port_param):
    """Evicted again before its custody settles, a page is not spilled a
    second time: two pending spills of one page would race their ACKs."""
    port_param("kv_host_tier_bytes", 1)
    fab = InprocFabric(2)
    e0, e1 = fab.attach(0), fab.attach(1)
    store = PeerKVStore(e1)
    kv, _ = _kvs()
    tiers = KVTierMap(kv)
    tiers.attach_peer(e0, 1)
    d, vals = _page(kv, "a", 2, 1.0)
    for _ in range(3):
        tiers.note_spill(d, PAGE_BYTES)
    assert tiers.stats()["peer_spills"] == 1
    _progress(e0, e1)
    assert store.stats()["pages_held"] == 1 and d.get_copy(0).value is None
    tiers.prefetch_seqs(["a"])
    assert np.array_equal(d.get_copy(0).value.numpy(), vals)


def test_a_page_rewritten_before_the_ack_keeps_its_bytes(port_param):
    """The page changes between the spill and the ACK (a rollback): the
    peer replica is stale, the local bytes stay and the handle drains."""
    port_param("kv_host_tier_bytes", 1)
    fab = InprocFabric(2)
    e0, e1 = fab.attach(0), fab.attach(1)
    store = PeerKVStore(e1)
    kv, _ = _kvs()
    tiers = KVTierMap(kv)
    tiers.attach_peer(e0, 1)
    d, _ = _page(kv, "a", 2, 0.0)
    tiers.note_spill(d, PAGE_BYTES)
    e1.progress()                      # the peer takes custody
    kv.rollback_tail("a", 2)           # the page is rewritten meanwhile
    _progress(e0, e1)
    assert d.get_copy(0).value is not None
    assert d.get_copy(0).value[2, 0, 0, 0] == 2
    assert tiers.stats()["peer_tier_pages"] == 0
    assert store.stats()["pages_held"] == 0


# ---------------------------------------------------------------------------
# the device tier: spill hook and prefetch
# ---------------------------------------------------------------------------

def test_no_cuda_device_means_no_prefetch():
    snapshot = list(registry.devices)
    registry.devices = [d for d in snapshot if d.type != "cuda"]
    try:
        kv, _ = _kvs()
        tiers = KVTierMap(kv)
        d, _ = _page(kv, "a", 1, 0.0)
        tiers.note_spill(d, PAGE_BYTES)
        assert tiers.stats()["host_tier_pages"] == 1
        assert tiers.prefetch_seqs(["a"]) == 0
        assert tiers.stats()["prefetched_pages"] == 0
    finally:
        registry.devices = snapshot


def test_prefetch_data_stages_at_the_snapshot_version(cpu_cuda_device):
    kv, _ = _kvs()
    datas = [_page(kv, s, 3, float(i))[0] for i, s in enumerate("abc")]
    dev = cpu_cuda_device
    assert dev.prefetch_data(datas) == 3
    for d in datas:
        c = d.get_copy(dev.device_index)
        assert c.version == 3 and c.value is d.get_copy(0).value
    assert dev.prefetch_data(datas) == 0          # current: skipped
    datas[0].get_copy(0).version = 4
    assert dev.prefetch_data(datas) == 1
    assert dev.stats()["prefetched"] == 4


def test_the_drain_fires_the_spill_hook(cpu_cuda_device):
    """An eviction write-back leaves the page on the host alone: the tier
    map hears of it, and the prefetch stages it back."""
    kv, _ = _kvs()
    tiers = KVTierMap(kv)
    datas = [_page(kv, s, 1, 0.0)[0] for s in "abcd"]
    dev = cpu_cuda_device
    dev._mem_budget = 2 * PAGE_BYTES
    assert dev.prefetch_data(datas[:2]) == 1      # half the budget a call
    assert dev.prefetch_data(datas[1:3]) == 1
    assert dev.prefetch_data(datas[2:]) == 1      # evicts "a", the coldest
    dev._drain_evictions()
    st = tiers.stats()
    assert st["spills"] == 1 and st["host_tier_pages"] == 1
    assert kv.stats()["host_tier_bytes"] == PAGE_BYTES
    assert tiers.prefetch_seqs(["a"]) == 1
    assert tiers.stats()["prefetched_pages"] == 1


def _serve(server_cls, batcher_cls, m, prompts, max_new, dev=None,
           budget=None):
    with server_cls(nb_cores=2) as server:
        kw = {"devices": "tpu"} if batcher_cls is JContinuousBatcher else {}
        b = batcher_cls(server, model=m, **kw)
        if budget is not None:
            dev._mem_budget = budget
        tks = [b.submit_stream(p, max_new_tokens=max_new) for p in prompts]
        toks = [tk.result(timeout=240)["tokens"] for tk in tks]
        stats = b.stats()
        b.stop()
    return toks, stats


def test_the_tier_soak_equals_the_jax_soak(cpu_cuda_device, accel_device,
                                           port_param, param):
    """A tile budget of four pages under a live KV of about sixteen: pages
    spill to the host and come back one superpool ahead; every stream
    equals the oracle and the JAX soak's tokens."""
    prompts = [list(range(1, 50)), list(range(2, 51)), [7, 9, 11] * 16]
    jtoks, jst = _serve(JRuntimeServer, JContinuousBatcher, JToyLM(),
                        prompts, 20, accel_device, 4 * SERVE_PAGE_BYTES)
    toks, st = _serve(RuntimeServer, ContinuousBatcher, MODEL, prompts, 20,
                      cpu_cuda_device, 4 * SERVE_PAGE_BYTES)
    assert toks == jtoks == [MODEL.reference_generate(p, 20)
                             for p in prompts]
    assert st["tiers"]["spills"] > 0 and jst["tiers"]["spills"] > 0
    assert st["tiers"]["prefetched_pages"] > 0
    assert st["tiers"]["prefetch_failures"] == 0
    assert cpu_cuda_device.deferred_evictions > 0
    assert "host_tier_bytes" in st["kv"] and "prefetch_inflight" in st["kv"]


class _Raises:
    def note_spill(self, data, nbytes):
        raise RuntimeError("a faulty subscriber")


def test_a_failing_spill_hook_is_counted(cpu_cuda_device):
    """A subscriber that raises neither stops the write-back nor the other
    subscribers; the device counts it in ``spill_hook_failures``."""
    kv, _ = _kvs()
    bad = _Raises()
    register_spill_hook(bad)
    tiers = KVTierMap(kv)
    datas = [_page(kv, s, 1, 0.0)[0] for s in "abc"]
    dev = cpu_cuda_device
    dev._mem_budget = 2 * PAGE_BYTES
    assert dev.prefetch_data(datas[:1]) == 1
    assert dev.prefetch_data(datas[1:2]) == 1
    assert dev.prefetch_data(datas[2:]) == 1      # evicts "a"
    dev._drain_evictions()
    assert dev.stats()["spill_hook_failures"] == 1
    assert tiers.stats()["spills"] == 1
    assert datas[0].get_copy(dev.device_index) is None


# ---------------------------------------------------------------------------
# a kernel failure stops the run
# ---------------------------------------------------------------------------

class _Boom(RuntimeError):
    pass


def _failing_pool(n: int = 6):
    """n tasks of one class with a CUDA chore that raises (the injected
    kernel failure) and, with ``host``, a host chore: each writes k + 1
    into its tile."""
    X = DictCollection("X", dtt=TileType((4,)))

    def build(host: bool):
        p = ptg.PTGBuilder("demote", X=X, N=n)
        t = p.task("T", k=ptg.span(0, lambda g, l: g.N - 1))
        f = t.flow("X", ptg.RW)
        f.input(data=("X", lambda g, l: (l.k,)))
        f.output(data=("X", lambda g, l: (l.k,)))
        t.body(device="cuda", dyld="test_torch_kv_tiers_boom")

        def body(es, task, g, l):
            c = task.data[0]
            c.value = torch.full((4,), float(l.k + 1))
            c.version += 1

        if host:
            t.body(body)
        return p.build()

    return X, build


def _boom(es, task, device=None):
    raise _Boom("injected kernel failure")


register_kernel("test_torch_kv_tiers_boom", "cuda", _boom)


def _run(tp):
    ctx = Context(nb_cores=0)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)
    finally:
        ctx.fini(timeout=10)


@pytest.mark.parametrize("host", [True, False],
                         ids=["with-host-chore", "device-only-class"])
def test_a_kernel_failure_stops_the_run(cpu_cuda_device, host):
    """The device chore's failure poisons the run, even where the class
    has a host chore: no task moves to the host, the device stays
    enabled, and no tile holds a value the host body would have
    written."""
    X, build = _failing_pool()
    with pytest.raises(Exception) as err:
        _run(build(host=host))
    assert "injected kernel failure" in repr(err.value) \
        or isinstance(err.value, _Boom) or err.value.__cause__ is not None
    assert cpu_cuda_device.enabled
    for k in range(6):
        c = X.data_of(k).newest_copy()
        assert c is None or c.value is None \
            or c.value.tolist() != [k + 1.0] * 4

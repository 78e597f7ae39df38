"""The port's socket fabric, at the level of the JAX package's
``test_comm_wire.py`` and ``test_comm_fault.py``.

Binary CTRL frames with arrays, tensors and traffic ledgers; a partial or
garbage frame drops only its connection; a fragmented GET lands by
``recv_into`` in its destination, also across injected disconnects;
reconnect-and-replay keeps 100 rounds of numbered traffic exactly-once
and in order, in both directions; a clean path replays nothing; a dead
peer releases its registration shares.  And one JAX ``SocketFabric``
(rank 0) and one port ``SocketFabric`` (rank 1) exchange 200 CTRL frames
each way, in order and intact: the wire format is the same.
"""

import socket as socket_mod
import threading
import time

import numpy as np
import pytest
import torch

from parsec_tpu.comm.socket_fabric import SocketFabric as JSocketFabric
from parsec_tpu_torch.comm.engine import AM_TAG_GET_REPLY
from parsec_tpu_torch.comm.multiproc import _free_port_base
from parsec_tpu_torch.comm.socket_fabric import (_HDR, K_CTRL,
                                                 SocketCommEngine,
                                                 SocketFabric)
from parsec_tpu_torch.core.params import params

TAG = 16       # the first application tag


@pytest.fixture
def port_param():
    saved = {}

    def set_(name, value):
        saved.setdefault(name, params.get(name))
        params.set(name, value)

    yield set_
    for name, value in saved.items():
        params.set(name, value)


def _wait(engines, pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        for e in engines:
            e.progress()
        time.sleep(0.0005)
        if time.monotonic() > deadline:
            raise TimeoutError("socket test wait timed out")


def _fabrics(nranks, ranks=None, classes=None):
    """Fabrics of ``ranks`` (all by default) on one free port range; a
    range taken between the probe and the binds (another test process)
    is probed again."""
    ranks = range(nranks) if ranks is None else ranks
    classes = classes or [SocketFabric] * len(ranks)
    for _attempt in range(5):
        base = _free_port_base(nranks)
        made = []
        try:
            for cls, r in zip(classes, ranks):
                made.append(cls(nranks, r, base_port=base))
            return made
        except OSError:
            for f in made:
                f.close()
    raise OSError("no free port range for the test's fabrics")


def _engines(nranks=2):
    return [SocketCommEngine(f) for f in _fabrics(nranks)]


@pytest.fixture
def socket_pair():
    e0, e1 = _engines()
    yield e0, e1
    e0.fini()
    e1.fini()


def test_binary_am_with_arrays_tensors_and_ledgers(socket_pair):
    e0, e1 = socket_pair
    landed = []
    e1.tag_register(TAG, lambda eng, src, p: landed.append(p))
    arr = np.arange(5000, dtype=np.float32).reshape(50, 100)
    t = torch.arange(600, dtype=torch.float32).reshape(20, 30)
    e0.send_am(TAG, 1, {"tile": arr, "view": arr[:, 3:9], "t": t,
                        "bf": t.to(torch.bfloat16)[:, 1:4], "k": 1})
    _wait((e0, e1), lambda: landed)
    got = landed[0]
    np.testing.assert_array_equal(got["tile"], arr)
    np.testing.assert_array_equal(got["view"], arr[:, 3:9])
    assert torch.equal(got["t"], t) and got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"], t.to(torch.bfloat16)[:, 1:4])
    assert e0.fabric.peer_stats()["tx"][1]["bytes"] > arr.nbytes
    _wait((e0, e1), lambda: e1.fabric.bytes_recv > arr.nbytes)
    assert e1.fabric.peer_stats()["rx"][0]["frames"] >= 1


def test_partial_frame_drops_only_that_connection(socket_pair):
    e0, e1 = socket_pair
    port = e1.fabric.base_port + 1
    for junk in (b"\x01\x00\x00",                          # half a header
                 bytes(range(40)) * 2,                    # unknown kind
                 _HDR.pack(K_CTRL, 0, TAG, 0, 1, 100, 0, 0)):   # no body
        s = socket_mod.create_connection(("127.0.0.1", port), timeout=5)
        s.sendall(junk)
        s.close()
    time.sleep(0.1)
    landed = []
    e1.tag_register(TAG, lambda eng, src, p: landed.append(p))
    e0.send_am(TAG, 1, {"alive": True})
    _wait((e0, e1), lambda: landed)
    assert landed[0] == {"alive": True}


def test_fragmented_get_lands_by_recv_into(socket_pair, port_param):
    port_param("comm_get_frag_bytes", 1 << 16)
    port_param("comm_get_window", 4)
    e0, e1 = socket_pair
    src = torch.randn(512, 300, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1))
    h = e1.mem_register(src, refcount=1)
    done = []
    e0.get(h.wire(), done.append)
    _wait((e0, e1), lambda: done)
    assert done[0].dtype == torch.float64 and torch.equal(done[0], src)
    nfrags = -(-src.numel() * 8 // (1 << 16))
    assert e0.frags_in == nfrags
    assert e0.fabric.peer_stats()["rx"][1]["frags"] == nfrags
    assert e1.fabric.peer_stats()["tx"][0]["frags"] == nfrags
    assert not e0._landing and not e1._frag_sends and not e1._mem
    assert e0.frag_active == 0 and e1.frag_active == 0


def test_fragmented_get_survives_midstream_disconnects(port_param):
    port_param("comm_socket_fault_p", 0.2)
    port_param("comm_socket_fault_seed", 11)
    port_param("comm_get_frag_bytes", 1 << 15)
    port_param("comm_get_window", 4)
    port_param("comm_socket_ack_every", 4)
    e0, e1 = _engines()
    try:
        src = torch.randint(0, 255, (1 << 20,), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(2))
        h = e1.mem_register(src, refcount=1)
        done = []
        e0.get(h.wire(), done.append)
        _wait((e0, e1), lambda: done, timeout=60)
        assert torch.equal(done[0], src)
        assert e1.fabric.replays > 0          # the fault path fired
    finally:
        e0.fini()
        e1.fini()


def test_monolithic_reply_below_the_fragment_size(socket_pair, port_param):
    port_param("comm_get_frag_bytes", 1 << 20)
    e0, e1 = socket_pair
    src = torch.arange(64, dtype=torch.float32)
    h = e1.mem_register(src, refcount=1)
    done = []
    e0.get(h.wire(), done.append)
    _wait((e0, e1), lambda: done)
    assert torch.equal(done[0], src) and e0.frags_in == 0
    # a replayed reply is dropped, not landed twice
    e0.fabric.deliver(0, AM_TAG_GET_REPLY, 1, {"get_id": 1, "value": src})
    e0.progress()
    assert len(done) == 1 and e0.dup_get_replies == 1


@pytest.fixture
def fabric_pair(port_param):
    port_param("comm_socket_fault_p", 0.05)
    port_param("comm_socket_fault_seed", 1234)
    f0, f1 = _fabrics(2)
    yield f0, f1
    f0.close()
    f1.close()


def _drain_until(fabric, want, timeout=30.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < want:
        got.extend(fabric.drain(fabric.rank, limit=256))
        if time.monotonic() > deadline:
            raise TimeoutError(f"only {len(got)}/{want} frames arrived")
        time.sleep(0.0005)
    return got


def test_replay_survives_100_rounds_of_broken_connections(fabric_pair):
    f0, f1 = fabric_pair
    N = 60
    for round_ in range(100):
        for i in range(N):
            f0.deliver(1, TAG, 0, (round_, i))
        frames = _drain_until(f1, N)
        assert [p for _, _, p in frames] == [(round_, i) for i in range(N)]
        assert all(tag == TAG and src == 0 for tag, src, _ in frames)
    assert f0.replays > 0


def test_replay_survives_faults_in_both_directions(fabric_pair):
    f0, f1 = fabric_pair
    N = 400
    err = []

    def pump(src_f, dst):
        try:
            for i in range(N):
                src_f.deliver(dst, TAG, src_f.rank, i)
        except Exception as e:          # pragma: no cover
            err.append(e)

    threads = [threading.Thread(target=pump, args=(f0, 1)),
               threading.Thread(target=pump, args=(f1, 0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not err
    for fab in (f0, f1):
        assert [p for _, _, p in _drain_until(fab, N)] == list(range(N))


def test_a_clean_path_has_no_replays():
    f0, f1 = _fabrics(2)
    try:
        for i in range(200):
            f0.deliver(1, TAG, 0, i)
        assert [p for _, _, p in _drain_until(f1, 200)] == list(range(200))
        assert f0.replays == 0 and f1.dup_frames == 0
    finally:
        f0.close()
        f1.close()


def test_peer_death_releases_the_handles_shares():
    """A consumer that stays unreachable past the connect budget releases
    its share of every registration that names it; a consumer that pulled
    its share first releases nothing twice."""
    f0, f1 = _fabrics(3, ranks=[0, 1])           # rank 2 never starts
    e0, e1 = SocketCommEngine(f0), SocketCommEngine(f1)
    try:
        h = e0.mem_register(torch.arange(3.0), refcount=2, peers={1, 2})
        done = []
        e1.get(h.wire(), done.append)
        _wait((e0, e1), lambda: done)
        assert e0.on_peer_failed(1) == 0           # pulled its share
        assert e0.mem_retrieve(h.handle_id) is not None
        with pytest.raises(OSError):
            f0._connect(2, retry_s=0.2)            # reports rank 2 dead
        assert e0.mem_retrieve(h.handle_id) is None
        assert e0.on_peer_failed(2) == 0           # idempotent
    finally:
        e0.fini()
        e1.fini()


def test_a_jax_fabric_and_a_port_fabric_share_the_wire():
    jf, pf = _fabrics(2, classes=[JSocketFabric, SocketFabric])
    rng = np.random.default_rng(5)
    out = [{"i": i, "a": rng.standard_normal(i % 7 + 1).astype(np.float32),
            "s": f"m{i}", "t": (i, -i)} for i in range(200)]
    back = [{"i": i, "a": np.arange(i % 5 + 2, dtype=np.int64) * i,
             "b": bytes([i % 256]) * (600 if i % 50 == 0 else 3)}
            for i in range(200)]
    try:
        for i in range(200):
            jf.deliver(1, TAG, 0, out[i])
            pf.deliver(0, TAG + 1, 1, back[i])
        for fab, want, tag, src in ((pf, out, TAG, 0), (jf, back, TAG + 1, 1)):
            got = _drain_until(fab, 200)
            assert [(t, s) for t, s, _ in got] == [(tag, src)] * 200
            for (_, _, p), w in zip(got, want):
                assert p.keys() == w.keys() and p["i"] == w["i"]
                np.testing.assert_array_equal(p["a"], w["a"])
                assert p.get("s") == w.get("s") and p.get("t") == w.get("t")
                assert p.get("b") == w.get("b")
        assert pf.dup_frames == 0 and jf.dup_frames == 0
    finally:
        jf.close()
        pf.close()

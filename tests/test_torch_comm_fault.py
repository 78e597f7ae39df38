"""The comm tier's legacy framing and its mid-tree fault path, in the port.

- ``comm_wire_binary=False``: the length-prefixed pickle framing.  A
  fabric pair delivers the same CTRL payloads (arrays, tensors, bf16,
  views) under either framing; a GET comes back whole (unfragmented)
  under it; a JAX fabric and a port fabric exchange numpy payloads over
  it; a garbage frame, or one whose pickle names a global outside the
  codec's allowlist, drops only its connection with a warning; and with
  injected connection breaks the replay window keeps 100 rounds
  exactly-once and in order.
- ``resume_get``: a staging parent dies with a GET partly landed; the
  requester resumes from the grandparent, which serves only the missing
  offsets, and a zombie fragment of the dead parent deduplicates once.
  Its counts and landed bytes equal the JAX package's run of the same
  scenario (``tests/test_comm_fault.py``).
"""

import logging
import pickle
import socket as socket_mod
import struct
import time

import numpy as np
import pytest
import torch

from parsec_tpu.comm.engine import InprocFabric as JInprocFabric
from parsec_tpu.comm.socket_fabric import SocketFabric as JSocketFabric
from parsec_tpu.core.params import params as jparams
from parsec_tpu_torch.comm.engine import (AM_TAG_GET_FRAG, Capabilities,
                                          CommEngine, InprocFabric)
from parsec_tpu_torch.comm.multiproc import _free_port_base
from parsec_tpu_torch.comm.socket_fabric import SocketCommEngine, SocketFabric
from parsec_tpu_torch.core.params import params

TAG = 16


@pytest.fixture
def port_param():
    saved = {}

    def set_(name, value, reg=params):
        saved.setdefault((id(reg), name), (reg, reg.get(name)))
        reg.set(name, value)

    yield set_
    for (_, name), (reg, value) in saved.items():
        reg.set(name, value)


def _fabrics(classes):
    n = len(classes)
    for _attempt in range(5):
        base = _free_port_base(n)
        made = []
        try:
            for r, cls in enumerate(classes):
                made.append(cls(n, r, base_port=base))
            return made
        except OSError:
            for f in made:
                f.close()
    raise OSError("no free port range for the test's fabrics")


def _drain_until(fabric, want, timeout=30.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < want:
        got.extend(fabric.drain(fabric.rank, limit=256))
        if time.monotonic() > deadline:
            raise TimeoutError(f"only {len(got)}/{want} frames arrived")
        time.sleep(0.0005)
    return got


def _wait(engines, pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        for e in engines:
            e.progress()
        time.sleep(0.0005)
        if time.monotonic() > deadline:
            raise TimeoutError("wait timed out")


def _payloads():
    rng = np.random.default_rng(11)
    t = torch.from_numpy(rng.standard_normal((6, 10)).astype(np.float32))
    return [{"i": i, "a": rng.standard_normal(i % 5 + 1).astype(np.float32),
             "t": t * i, "bf": (t * i).to(torch.bfloat16)[:, 2:5],
             "s": f"m{i}", "k": (i, -i), "none": None}
            for i in range(60)]


def _deliver_all(binary, port_param):
    port_param("comm_wire_binary", binary)
    f0, f1 = _fabrics([SocketFabric, SocketFabric])
    try:
        assert f0.binary is binary and f1.binary is binary
        for p in _payloads():
            f0.deliver(1, TAG, 0, p)
        got = _drain_until(f1, 60)
        return [p for _, _, p in got], f0.bytes_sent, f1.bytes_recv
    finally:
        f0.close()
        f1.close()


def _same(p, w):
    assert p.keys() == w.keys()
    for k in p:
        if isinstance(w[k], torch.Tensor):
            assert p[k].dtype == w[k].dtype and torch.equal(p[k], w[k])
        elif isinstance(w[k], np.ndarray):
            np.testing.assert_array_equal(p[k], w[k])
        else:
            assert p[k] == w[k]


def test_both_framings_deliver_the_same_payloads(port_param):
    legacy, lsent, lrecv = _deliver_all(False, port_param)
    binary, bsent, brecv = _deliver_all(True, port_param)
    want = _payloads()
    for got in (legacy, binary):
        assert len(got) == len(want)
        for p, w in zip(got, want):
            _same(p, w)
    # every framed byte sent was received, under each framing
    assert lsent == lrecv > 0 and bsent == brecv > 0


@pytest.mark.parametrize("binary", [False, True], ids=["legacy", "binary"])
def test_get_round_trip(binary, port_param):
    """A GET above the fragment size: fragmented DATA frames under the
    binary framing, one whole reply under the legacy one."""
    port_param("comm_wire_binary", binary)
    port_param("comm_get_frag_bytes", 1 << 12)
    f0, f1 = _fabrics([SocketFabric, SocketFabric])
    e0, e1 = SocketCommEngine(f0), SocketCommEngine(f1)
    try:
        src = torch.arange(20000, dtype=torch.float32).reshape(100, 200)
        h = e1.mem_register(src, refcount=1)
        done = []
        e0.get(h.wire(), done.append)
        _wait((e0, e1), lambda: done)
        assert torch.equal(done[0], src)
        assert (e0.frags_in > 0) is binary
    finally:
        e0.fini()
        e1.fini()


def test_a_jax_and_a_port_fabric_share_the_legacy_wire(port_param):
    port_param("comm_wire_binary", False)
    port_param("comm_wire_binary", False, reg=jparams)
    jf, pf = _fabrics([JSocketFabric, SocketFabric])
    try:
        assert not jf.binary and not pf.binary
        out = [{"i": i, "a": np.arange(i % 7 + 1, dtype=np.float32) * i}
               for i in range(100)]
        for i, p in enumerate(out):
            jf.deliver(1, TAG, 0, p)
            pf.deliver(0, TAG + 1, 1, dict(p, i=-i))
        for fab, tag, sign in ((pf, TAG, 1), (jf, TAG + 1, -1)):
            got = _drain_until(fab, 100)
            assert [t for t, _, _ in got] == [tag] * 100
            for (_, _, p), w in zip(got, out):
                assert p["i"] == sign * w["i"]
                np.testing.assert_array_equal(p["a"], w["a"])
    finally:
        jf.close()
        pf.close()


def _frame(body: bytes) -> bytes:
    return struct.pack("<Q", len(body)) + body


class _Evil:
    def __reduce__(self):
        import os
        return (os.getcwd, ())


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_a_corrupt_legacy_frame_drops_only_its_connection(port_param):
    port_param("comm_wire_binary", False)
    # the fabric's own logger: the package's logger does not propagate
    log = logging.getLogger("parsec_tpu_torch.comm.socket_fabric")
    seen = _Records()
    log.addHandler(seen)
    f0, f1 = _fabrics([SocketFabric, SocketFabric])
    try:
        port = f1.base_port + 1
        junk = [_frame(b"\x80\x05not a pickle"),
                _frame(pickle.dumps(("d", 1, pickle.dumps(
                    (TAG, 0, _Evil()))))),
                _frame(pickle.dumps(_Evil()))]
        for j in junk:
            s = socket_mod.create_connection(("127.0.0.1", port),
                                             timeout=5)
            s.sendall(j)
            s.close()
        deadline = time.monotonic() + 10
        while len(seen.records) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        dropped = [r for r in seen.records
                   if "dropping connection" in r.getMessage()]
        assert len(dropped) == 3
        assert any("outside the allowlist" in r.getMessage()
                   for r in dropped)
        # nothing of the junk was delivered; the real peer still is
        assert f1.drain(1) == []
        f0.deliver(1, TAG, 0, {"alive": True})
        assert _drain_until(f1, 1)[0][2] == {"alive": True}
    finally:
        log.removeHandler(seen)
        f0.close()
        f1.close()


def test_legacy_replay_survives_broken_connections(port_param):
    """Injected breaks on every ~20th frame: the replay window re-sends
    what the broken connection lost, the receiver drops duplicates, and
    100 rounds arrive exactly once, in order, both ways."""
    port_param("comm_wire_binary", False)
    port_param("comm_socket_fault_p", 0.05)
    port_param("comm_socket_fault_seed", 1234)
    f0, f1 = _fabrics([SocketFabric, SocketFabric])
    try:
        for i in range(100):
            f0.deliver(1, TAG, 0, {"n": i, "t": torch.full((3,), float(i))})
            f1.deliver(0, TAG, 1, {"n": -i})
        got1 = _drain_until(f1, 100)
        got0 = _drain_until(f0, 100)
        assert [p["n"] for _, _, p in got1] == list(range(100))
        assert [p["n"] for _, _, p in got0] == [-i for i in range(100)]
        assert all(torch.equal(p["t"], torch.full((3,), float(p["n"])))
                   for _, _, p in got1)
        assert f0.replays + f1.replays > 0
        time.sleep(0.2)
        assert f1.drain(1) == [] and f0.drain(0) == []
    finally:
        f0.close()
        f1.close()


def _mid_tree(port):
    """rank 2 pulls from rank 1 (the staging parent), which dies after
    one window; rank 2 resumes from rank 0 (the grandparent)."""
    reg = params if port else jparams
    old = (reg.get("comm_get_frag_bytes"), reg.get("comm_get_window"))
    reg.set("comm_get_frag_bytes", 64)
    reg.set("comm_get_window", 2)
    try:
        fabric = (InprocFabric if port else JInprocFabric)(3)
        e0, e1, e2 = (fabric.attach(r) for r in range(3))
        value = np.arange(64, dtype=np.float64)          # 512 B, 8 frags
        mk = (lambda v: torch.from_numpy(v.copy())) if port else np.copy
        h0 = e0.mem_register(mk(value), refcount=1)
        h1 = e1.mem_register(mk(value), refcount=1)
        landed = []
        gid = e2.get(h1.wire(), landed.append)
        e1.progress()               # serve the first window
        e2.progress()               # land it
        with e2._frag_lock:
            part = sorted(e2._landing[gid].landed)
        raw = value.view(np.uint8)
        off = part[0]
        zombie = raw[off:off + 64].copy()
        if port:
            zombie = torch.from_numpy(zombie)
        frag_tag = AM_TAG_GET_FRAG
        fabric.deliver(2, frag_tag, 1, (gid, off, 64, None, zombie))
        e2.progress()
        dup = e2.dup_frags
        resumed = e2.resume_get(h0.wire(), gid)
        e2.on_peer_failed(1)
        with e2._frag_lock:
            retargeted = gid in e2._landing
        for _ in range(16):
            e0.progress()
            e2.progress()
            if landed:
                break
        out = np.asarray(landed[0]) if landed else None
        with e2._frag_lock:
            retired = gid not in e2._landing
        again = e2.resume_get(h0.wire(), gid)
        return dict(part=part, dup=dup, resumed=resumed,
                    retargeted=retargeted, served=e0.frags_out,
                    frags_in=e2.frags_in, bytes_in=e2.frag_bytes_in,
                    retired=retired, again=again, n_landed=len(landed),
                    out=out)
    finally:
        reg.set("comm_get_frag_bytes", old[0])
        reg.set("comm_get_window", old[1])


def test_mid_tree_resume_matches_the_jax_package():
    got, want = _mid_tree(True), _mid_tree(False)
    np.testing.assert_array_equal(got.pop("out"), want.pop("out"))
    assert got == want
    assert got["part"] == [0, 64] and got["dup"] == 1
    assert got["resumed"] and got["retargeted"] and got["retired"]
    # the grandparent served only the six offsets still missing, and
    # every offset landed exactly once: 8 fragments, 512 bytes
    assert got["served"] == 6 and got["frags_in"] == 8
    assert got["bytes_in"] == 512 and not got["again"]


def test_a_completed_get_has_nothing_to_resume():
    fabric = InprocFabric(2)
    e0, e1 = fabric.attach(0), fabric.attach(1)
    h = e1.mem_register(torch.arange(4.0), refcount=2)
    done = []
    gid = e0.get(h.wire(), done.append)
    _wait((e0, e1), lambda: done)
    assert e0.resume_get(h.wire(), gid) is False


def test_capabilities_record():
    caps = CommEngine.capabilities
    assert isinstance(caps, Capabilities)
    assert (caps.sided, caps.multithreaded, caps.supports_noncontiguous) \
        == (1, True, True)

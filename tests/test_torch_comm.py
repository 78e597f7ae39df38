"""The port's comm layer against the JAX package's, on the CPU.

Engine-level cases (registration, GETs, fragments, the device fabric over
``torch.device("cpu")`` devices, the barrier) stand on their own; the
protocol cases (trees, activations inline and by rendezvous GET, wire
views, write-backs, the four-counter detector, the collectives) run the
same PTGs through ``parsec_tpu.comm.run_multirank`` and the port's, and
hold the port to the JAX package's results and to the payload bytes each
rank received, exactly.  The mutable-snapshot cases show the port's
deliberate departure from the JAX engine: a tensor written in place after
its registration still reaches its consumer as it was registered.
"""

import time

import numpy as np
import pytest
import torch

from parsec_tpu import ptg as jptg
from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.comm import collectives as jcoll
from parsec_tpu.comm.remote_dep import tree_children as j_tree_children
from parsec_tpu.comm.remote_dep import tree_parent as j_tree_parent
from parsec_tpu.core.params import params as jparams
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVec
from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import (DeviceFabric, InprocFabric,
                                   bcast_taskpool, reduce_op,
                                   reduce_taskpool, register_reduce_op,
                                   run_multirank)
from parsec_tpu_torch.comm.remote_dep import (TREE_KINDS, pack_activation,
                                              resolve_tree_kind,
                                              tree_children, tree_parent,
                                              unpack_activation)
from parsec_tpu_torch.core.params import MCAParamValueError, params
from parsec_tpu_torch.data.data import data_create
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic
from parsec_tpu_torch.runtime import Context

KINDS = ["binomial", "chain", "star"]


@pytest.fixture
def port_param():
    """Scoped override of the port's params, restored at test exit."""
    saved = {}

    def set_(name, value):
        saved.setdefault(name, params.get(name))
        params.set(name, value)

    yield set_
    for name, value in saved.items():
        params.set(name, value)


@pytest.fixture
def both_params(port_param):
    """The same override in both packages (restored at exit)."""
    saved = {}

    def set_(name, value):
        port_param(name, value)
        saved.setdefault(name, jparams.get(name))
        jparams.set(name, value)

    yield set_
    for name, value in saved.items():
        jparams.set(name, value)


def _wait(engines, pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        for e in engines:
            e.progress()
        if time.monotonic() > deadline:
            raise TimeoutError("comm test wait timed out")


def _pull(src_eng, dst_eng, handle):
    done = []
    dst_eng.get(handle.wire(), done.append)
    _wait((src_eng, dst_eng), lambda: done)
    return done[0]


# ---------------------------------------------------------------------------
# the engine: registration snapshots, GETs, fragments, the device fabric
# ---------------------------------------------------------------------------

def _fabric(kind, n):
    return InprocFabric(n) if kind == "inproc" else \
        DeviceFabric(n, [torch.device("cpu")] * n)


@pytest.mark.parametrize("fabric", ["inproc", "device"])
def test_registered_tensor_written_in_place_reaches_consumer_unchanged(
        fabric):
    """The mutable-snapshot rule: the producer's tile is written in place
    after its registration (a local successor's update); the consumer
    still receives the registered version."""
    fab = _fabric(fabric, 2)
    e0, e1 = fab.attach(0), fab.attach(1)
    tile = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    h = e0.mem_register(tile)
    tile += 100.0
    tile[0, 0] = -1.0
    got = _pull(e0, e1, h)
    torch.testing.assert_close(
        got, torch.arange(16, dtype=torch.float32).reshape(4, 4))
    assert got.data_ptr() != tile.data_ptr()


@pytest.mark.parametrize("fabric", ["inproc", "device"])
def test_owned_registration_aliases(fabric):
    fab = _fabric(fabric, 1)
    e0 = fab.attach(0)
    buf = torch.ones(4)
    assert e0.mem_register(buf, owned=True).value is buf
    assert e0.mem_register(buf).value is not buf


@pytest.mark.parametrize("fabric", ["inproc", "device"])
def test_each_consumer_owns_its_payload(fabric):
    """Two pulls of one registration: the first consumer gets a copy,
    the last the registered snapshot itself; neither aliases the other,
    and the registration drops after the last pull."""
    fab = _fabric(fabric, 3)
    e0, e1, e2 = (fab.attach(r) for r in range(3))
    h = e0.mem_register(torch.full((8,), 3.0), refcount=2)
    first = _pull(e0, e1, h)
    assert e0.mem_retrieve(h.handle_id) is h
    last = _pull(e0, e2, h)
    assert last is h.value and first is not h.value
    first += 1.0
    torch.testing.assert_close(last, torch.full((8,), 3.0))
    assert e0.mem_retrieve(h.handle_id) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_fragmented_get_host_tier_lands_and_cleans_up(port_param, dtype):
    port_param("comm_get_frag_bytes", 1 << 12)
    port_param("comm_get_window", 3)
    fab = InprocFabric(2)
    e0, e1 = fab.attach(0), fab.attach(1)
    g = torch.Generator().manual_seed(0)
    src = torch.randn(40, 130, generator=g).to(dtype)
    h = e1.mem_register(src)
    got = _pull(e1, e0, h)
    assert got.dtype == dtype and got.shape == src.shape
    torch.testing.assert_close(got, src, rtol=0, atol=0)
    nbytes = src.numel() * src.element_size()
    nfrags = -(-nbytes // (1 << 12))
    assert e0.frags_in == nfrags and e1.frags_out == nfrags
    assert e0.frag_bytes_in == nbytes
    assert not e0._landing and not e1._frag_sends and not e1._mem
    assert e0.frag_active == 0 and e1.frag_active == 0


def test_fragmented_get_device_tier_concatenates(port_param):
    """Device payloads above the fragment size move as device-side
    slices, concatenated on the consumer's device."""
    port_param("comm_get_frag_bytes", 1 << 14)
    fab = DeviceFabric(2, ["cpu", "cpu"])
    e0, e1 = fab.attach(0), fab.attach(1)
    src = torch.randn(120, 120, generator=torch.Generator().manual_seed(3))
    h = e1.mem_register(src)
    assert e1.bytes_put == src.numel() * 4
    got = _pull(e1, e0, h)
    assert got.device == fab.devices[0]
    torch.testing.assert_close(got, src, rtol=0, atol=0)
    assert e0.frags_in == 4 and e0.bytes_got == src.numel() * 4
    assert not e0._landing and e0.frag_active == 0


def test_monolithic_reply_at_the_threshold(port_param):
    port_param("comm_get_frag_bytes", 256)
    fab = InprocFabric(2)
    e0, e1 = fab.attach(0), fab.attach(1)
    src = torch.arange(64, dtype=torch.float32)          # 256 bytes
    got = _pull(e1, e0, e1.mem_register(src))
    torch.testing.assert_close(got, src)
    assert e0.frags_in == 0


def test_device_fabric_refuses_to_hide_the_card():
    """No card: the default device list, a CUDA device, and the device
    transport of ``run_multirank`` raise; fewer devices than ranks
    raise unless the caller passes them."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card rules do not "
                    "apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFabric(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFabric(1, ["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_multirank(2, lambda ctx, r, n: None, transport="device")
    with pytest.raises(ValueError, match="needs 4 devices"):
        DeviceFabric(4, ["cpu"] * 2)
    assert DeviceFabric(4, ["cpu"] * 4).ranks_per_device == 4
    with pytest.raises(ValueError, match="transport"):
        run_multirank(2, lambda ctx, r, n: None, transport="socket")


def test_barrier_progresses_every_rank():
    import threading
    fab = InprocFabric(3)
    engs = [fab.attach(r) for r in range(3)]
    errs = []

    def run(e):
        try:
            e.sync(timeout=10)
            e.sync(timeout=10)
        except Exception as ex:        # noqa: BLE001 — surfaced below
            errs.append(ex)

    ts = [threading.Thread(target=run, args=(e,)) for e in engs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)
    assert not any(t.is_alive() for t in ts) and errs == []
    assert all(e._barrier_seen == {} for e in engs)


# ---------------------------------------------------------------------------
# trees and the activation wire form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_trees_equal_jax_and_cover_every_node_once(kind, n):
    seen, frontier = {0}, [0]
    while frontier:
        nxt = []
        for p in frontier:
            for c in tree_children(kind, p, n):
                assert c not in seen
                seen.add(c)
                nxt.append(c)
        frontier = nxt
    assert seen == set(range(n))
    for p in range(n):
        assert tree_children(kind, p, n) == j_tree_children(kind, p, n)
        assert tree_parent(kind, p, n) == j_tree_parent(kind, p, n)
        for c in tree_children(kind, p, n):
            assert tree_parent(kind, c, n) == p


@pytest.mark.parametrize("kind,n,expect", [
    ("chain", 5, {0: [1], 1: [2], 2: [3], 3: [4], 4: []}),
    ("star", 4, {0: [1, 2, 3], 1: [], 2: [], 3: []}),
    ("binomial", 6, {0: [1, 2, 4], 1: [3, 5], 2: [], 3: [], 4: [], 5: []}),
])
def test_tree_shapes_exact(kind, n, expect):
    assert {p: tree_children(kind, p, n) for p in range(n)} == expect


def test_unknown_tree_kind_raises_typed_error(port_param):
    with pytest.raises(MCAParamValueError) as ei:
        tree_children("fibonacci", 0, 8)
    assert ei.value.param == "comm_bcast_tree"
    assert ei.value.value == "fibonacci"
    assert set(ei.value.allowed) == set(TREE_KINDS)
    assert isinstance(ei.value, ValueError)
    with pytest.raises(MCAParamValueError):
        tree_parent("ring", 3, 8)
    port_param("comm_bcast_tree", "auto")
    assert resolve_tree_kind(nbytes=64, n=4) == "star"
    assert resolve_tree_kind(nbytes=1 << 20, n=4) == "binomial"
    assert resolve_tree_kind(nbytes=64, n=16) == "binomial"


def test_activation_pack_roundtrip_with_wire_view():
    msg = {"tp": 9, "tc": 2, "locals": {"m": 4, "n": 0},
           "outputs": [
               {"flow_index": 0, "writeback": False, "version": 3,
                "wire": (1, 77), "shape": (8, 34), "dtype": torch.float32,
                "wire_view": ((None, None, None), (1, 3, None))},
               {"flow_index": 1, "writeback": True}],
           "ranks": [1, 0, 3], "tree": "chain", "priority": 5,
           "seq": 12, "pos": 1, "trace": 0xBEEF01}
    assert unpack_activation(pack_activation(msg)) == msg


# ---------------------------------------------------------------------------
# protocol: the PTGs of tests/test_comm_multirank.py in both packages
# ---------------------------------------------------------------------------

def _chain_tp(P, V, nt):
    """T(0) reads V(0); T(i) -> T(i+1) crosses ranks; T(nt-1) writes
    V(0), a remote write-back on every layout of more than one rank."""
    p = P.PTGBuilder("chain", V=V, NT=nt)
    t = p.task("T", i=P.span(0, lambda g, l: g.NT - 1))
    t.affinity("V", lambda g, l: (l.i,))
    f = t.flow("A", P.RW)
    f.input(data=("V", lambda g, l: (0,)), guard=lambda g, l: l.i == 0)
    f.input(pred=("T", "A", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "A", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.NT - 1)
    f.output(data=("V", lambda g, l: (0,)),
             guard=lambda g, l: l.i == g.NT - 1)

    def body(es, task, g, l):
        task.flow_data("A").value[...] += 1.0

    t.body(body)
    return p.build()


def _vec(pkg, name, nt, mb, nranks, rank, init):
    cls = JVec if pkg == "jax" else VectorTwoDimCyclic
    return cls(name, lm=nt * mb, mb=mb, P=nranks, myrank=rank, init_fn=init)


def _value(pkg, V, m):
    return np.array(np.asarray(V.data_of(m).newest_copy().value)) \
        if pkg == "jax" else V.data_of(m).newest_copy().value.numpy().copy()


def _chain_body(pkg, fence=True, mb=4):
    P = jptg if pkg == "jax" else ptg

    def body(ctx, rank, nranks):
        V = _vec(pkg, "V", 7, mb, nranks, rank,
                 lambda m, size: np.zeros(size))
        ctx.add_taskpool(_chain_tp(P, V, 7))
        ctx.wait(timeout=60)
        if fence:
            ctx.comm_barrier()
        return (_value(pkg, V, 0) if rank == 0 else None,
                ctx.comm_engine.payload_bytes_received)
    return body


def _both(nranks, make_body, transport="inproc", nb_cores=0, timeout=120):
    """Run a rank body of each package over ``nranks``.  The JAX package
    runs caller-driven (``nb_cores=0``) whatever the port runs: with a
    worker a rank its barrier now and then times out on a rank's first
    run (seen once in 160 broadcasts), a fault of the reference that the
    comparison must not inherit; results do not depend on the workers."""
    j = j_run_multirank(nranks, make_body("jax"), transport=transport,
                        timeout=timeout)
    p = run_multirank(nranks, make_body("port"), transport=transport,
                      nb_cores=nb_cores, timeout=timeout,
                      devices=(["cpu"] * nranks if transport == "device"
                               else None))
    return j, p


@pytest.mark.parametrize("nranks,transport", [(2, "inproc"), (4, "inproc"),
                                              (2, "device"), (4, "device"),
                                              (8, "device")])
def test_chain_across_ranks(nranks, transport):
    """Ex03: a value threads through every rank, +1 a hop, and its final
    version writes back to rank 0's home tile."""
    j, p = _both(nranks, _chain_body, transport)
    np.testing.assert_allclose(p[0][0], np.full(4, 7.0))
    np.testing.assert_array_equal(p[0][0], j[0][0])
    assert [r[1] for r in p] == [r[1] for r in j]


def test_rendezvous_get_lands_on_the_rank_device(both_params):
    """Above the short limit the chain's tile rides the registered-memory
    GET and lands on each rank's device."""
    both_params("comm_short_limit", 8)
    seen = []

    def body(ctx, rank, nranks):
        res = _chain_body("port")(ctx, rank, nranks)
        seen.append((ctx.comm_engine.ce.bytes_got, ctx.comm_engine.ce.gets))
        return res

    res = run_multirank(2, body, transport="device", devices=["cpu"] * 2)
    np.testing.assert_allclose(res[0][0], np.full(4, 7.0))
    assert all(b > 0 and g > 0 for b, g in seen)


def test_single_rank_unaffected():
    res = run_multirank(1, _chain_body("port"))
    np.testing.assert_allclose(res[0][0], np.full(4, 7.0))
    assert res[0][1] == 0


def _bcast_tp(P, V, nranks, payload, create):
    p = P.PTGBuilder("bcast", V=V, NR=nranks, PAY=payload)
    w = p.task("W", z=P.span(0, 0))
    w.affinity("V", lambda g, l: (0,))
    fw = w.flow("A", P.WRITE)
    for r in range(nranks):
        fw.output(succ=("R", "X", lambda g, l, r=r: {"r": r}))

    def wbody(es, task, g, l):
        task.set_flow_data("A", create(g.PAY))

    w.body(wbody)
    t = p.task("R", r=P.span(0, lambda g, l: g.NR - 1))
    t.affinity("V", lambda g, l: (l.r,))
    fx = t.flow("X", P.READ)
    fx.input(pred=("W", "A", lambda g, l: {"z": 0}))
    fy = t.flow("Y", P.RW)
    fy.input(data=("V", lambda g, l: (l.r,)))
    fy.output(data=("V", lambda g, l: (l.r,)))

    def rbody(es, task, g, l):
        task.flow_data("Y").value[...] = float(task.flow_data("X").value
                                               .sum())

    t.body(rbody)
    return p.build()


def _bcast_body(payload):
    def make(pkg):
        if pkg == "jax":
            from parsec_tpu.data.data import data_create as jcreate
            P = jptg

            def create(n):
                return jcreate(np.arange(n, dtype=np.float32),
                               key=("w", 0)).get_copy(0)
        else:
            P = ptg

            def create(n):
                return data_create(torch.arange(n, dtype=torch.float32),
                                   key=("w", 0)).get_copy(0)

        def body(ctx, rank, nranks):
            V = _vec(pkg, "V", nranks, 1, nranks, rank,
                     lambda m, size: np.zeros(size))
            ctx.add_taskpool(_bcast_tp(P, V, nranks, payload, create))
            ctx.wait(timeout=60)
            return (float(_value(pkg, V, rank)[0]),
                    ctx.comm_engine.payload_bytes_received,
                    ctx.comm_engine.payload_bytes_staged)
        return body
    return make


@pytest.mark.parametrize("nranks,tree", [(2, "binomial"), (4, "binomial"),
                                         (4, "chain"), (4, "star")])
def test_broadcast_inline(both_params, nranks, tree):
    """Ex05 with a short payload riding inside the activation."""
    both_params("comm_bcast_tree", tree)
    j, p = _both(nranks, _bcast_body(8))
    assert [r[0] for r in p] == [float(sum(range(8)))] * nranks
    assert p == j


@pytest.mark.parametrize("tree", KINDS)
def test_broadcast_rendezvous_get(both_params, tree):
    """Above ``comm_short_limit`` the payload moves by registered-memory
    GET and is re-registered at every interior tree node."""
    both_params("comm_short_limit", 64)
    both_params("comm_bcast_tree", tree)
    j, p = _both(4, _bcast_body(4096), transport="device")
    assert [r[0] for r in p] == [float(sum(range(4096)))] * 4
    assert p == j


@pytest.mark.parametrize("nranks", [2, 4, 8])
def test_fourcounter_global_termination(both_params, nranks):
    """The chain's remote write-back read right after ``wait()`` with no
    fence: only the global (wave) termination makes that correct."""
    both_params("termdet", "fourcounter")
    j, p = _both(nranks, lambda pkg: _chain_body(pkg, fence=False))
    np.testing.assert_allclose(p[0][0], np.full(4, 7.0))
    assert [r[1] for r in p] == [r[1] for r in j]


def test_fourcounter_broadcast(both_params):
    both_params("termdet", "fourcounter")
    j, p = _both(4, _bcast_body(8))
    assert p == j


def test_activation_ahead_of_the_enqueue_is_replayed():
    """Rank 1 enqueues its pool late: rank 0's activation waits in the
    pending list and is replayed at registration."""
    def body(ctx, rank, nranks):
        if rank == 1:
            deadline = time.monotonic() + 10
            eng = ctx.comm_engine
            while not eng._pending_unknown_tp:
                eng.progress()
                assert time.monotonic() < deadline
        return _chain_body("port")(ctx, rank, nranks)

    res = run_multirank(2, body)
    np.testing.assert_allclose(res[0][0], np.full(4, 7.0))


def test_a_failed_rank_releases_its_peers_at_once():
    """Rank 1 fails before it enqueues its pool; rank 0, whose chain
    needs rank 1, is poisoned and returns at once, and the error raised
    is rank 1's own."""
    def body(ctx, rank, nranks):
        if rank == 1:
            raise ValueError("rank 1 gives up")
        return _chain_body("port")(ctx, rank, nranks)

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed") as ei:
        run_multirank(2, body, timeout=60)
    assert time.monotonic() - t0 < 20
    assert isinstance(ei.value.__cause__, ValueError)


def test_local_successor_writing_the_sent_tile_does_not_reach_the_peer(
        port_param):
    """Protocol-level snapshot: W on rank 0 sends its tile to R on rank
    1 by rendezvous GET and to L on rank 0, which adds 100 in place; rank
    0 runs L before it serves rank 1's GET (its comm progress runs only
    when it has no task), and R still reads W's version."""
    port_param("comm_short_limit", 0)

    def build(V, O):
        p = ptg.PTGBuilder("snap", V=V, O=O)
        w = p.task("W", z=ptg.span(0, 0))
        w.affinity("V", lambda g, l: (0,))
        fw = w.flow("A", ptg.RW)
        fw.input(data=("V", lambda g, l: (0,)))
        fw.output(succ=("R", "X", lambda g, l: {"z": 0}))
        fw.output(succ=("L", "X", lambda g, l: {"z": 0}))

        def wbody(es, task, g, l):
            task.flow_data("A").value.fill_(5.0)

        w.body(wbody)
        lt = p.task("L", z=ptg.span(0, 0))
        lt.affinity("V", lambda g, l: (0,))
        lt.flow("X", ptg.RW).input(pred=("W", "A", lambda g, l: {"z": 0}))

        def lbody(es, task, g, l):
            task.flow_data("X").value.add_(100.0)

        lt.body(lbody)
        r = p.task("R", z=ptg.span(0, 0))
        r.affinity("V", lambda g, l: (1,))
        r.flow("X", ptg.READ).input(pred=("W", "A", lambda g, l: {"z": 0}))
        fo = r.flow("Y", ptg.RW)
        fo.input(data=("O", lambda g, l: (1,)))
        fo.output(data=("O", lambda g, l: (1,)))

        def rbody(es, task, g, l):
            task.flow_data("Y").value.copy_(task.flow_data("X").value)

        r.body(rbody)
        return p.build()

    def body(ctx, rank, nranks):
        V = VectorTwoDimCyclic("V", 8, 4, P=2, myrank=rank)
        O = VectorTwoDimCyclic("O", 8, 4, P=2, myrank=rank)
        ctx.add_taskpool(build(V, O))
        ctx.wait(timeout=60)
        ctx.comm_barrier()
        return (O.data_of(1).newest_copy().value.clone() if rank == 1
                else ctx.comm_engine.ce._mem)

    res = run_multirank(2, body)
    torch.testing.assert_close(res[1], torch.full((4,), 5.0))


@pytest.mark.parametrize("wire", [(slice(0, 2), slice(None)),
                                  (slice(None), slice(-1, None))])
def test_wire_view_ships_the_sub_tile(both_params, wire):
    """``output(wire=...)``: a remote successor receives only the declared
    sub-view, as a tensor of its own, in the JAX package's byte count."""
    both_params("comm_short_limit", 16)

    def make(pkg):
        P = jptg if pkg == "jax" else ptg

        def build(V, O):
            p = P.PTGBuilder("wire", V=V, O=O)
            w = p.task("W", z=P.span(0, 0))
            w.affinity("V", lambda g, l: (0, 0))
            fw = w.flow("A", P.READ)
            fw.input(data=("V", lambda g, l: (0, 0)))
            fw.output(succ=("R", "X", lambda g, l: {"z": 0}), wire=wire)
            w.body(lambda es, task, g, l: None)
            r = p.task("R", z=P.span(0, 0))
            r.affinity("V", lambda g, l: (0, 1))
            r.flow("X", P.READ).input(pred=("W", "A",
                                            lambda g, l: {"z": 0}))
            fo = r.flow("Y", P.RW)
            fo.input(data=("O", lambda g, l: (1,)))
            fo.output(data=("O", lambda g, l: (1,)))

            def rbody(es, task, g, l):
                x = task.flow_data("X").value
                task.flow_data("Y").value[...] = float(x.sum()) \
                    + 1000.0 * x.shape[0] + 10.0 * x.shape[1]

            r.body(rbody)
            return p.build()

        def body(ctx, rank, nranks):
            tile = np.arange(32, dtype=np.float32).reshape(4, 8)
            if pkg == "jax":
                from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic
            else:
                from parsec_tpu_torch.data_dist.matrix import \
                    TwoDimBlockCyclic
            V = TwoDimBlockCyclic("V", 4, 16, 4, 8, Q=2, myrank=rank,
                                  init_fn=lambda m, n, s: tile)
            O = _vec(pkg, "O", 2, 1, 2, rank, lambda m, s: np.zeros(s))
            ctx.add_taskpool(build(V, O))
            ctx.wait(timeout=60)
            ctx.comm_barrier()
            return ((_value(pkg, O, 1)[0] if rank == 1 else None),
                    ctx.comm_engine.payload_bytes_received)
        return body

    j, p = _both(2, make)
    sub = np.arange(32, dtype=np.float32).reshape(4, 8)[wire]
    assert p[1][0] == float(sub.sum()) + 1000.0 * sub.shape[0] \
        + 10.0 * sub.shape[1]
    assert p == j
    assert p[1][1] == sub.nbytes


def test_typed_remote_edge_is_refused():
    """A remote edge whose consumer (on rank 0) declares another tile type
    would need the typed reshape, which is not ported: the run fails with
    ``NotImplementedError``, never silently, and rank 1, whose
    activation is never acknowledged, is released at once."""
    def build(V):
        p = ptg.PTGBuilder("typed", V=V)
        w = p.task("W", z=ptg.span(0, 0))
        w.affinity("V", lambda g, l: (1,))
        fw = w.flow("A", ptg.READ)
        fw.input(data=("V", lambda g, l: (1,)))
        fw.output(succ=("R", "X", lambda g, l: {"z": 0}))
        w.body(lambda es, task, g, l: None)
        r = p.task("R", z=ptg.span(0, 0))
        r.affinity("V", lambda g, l: (0,))
        r.flow("X", ptg.READ).input(
            pred=("W", "A", lambda g, l: {"z": 0}),
            dtt=TileType((2, 2), torch.float32))
        r.body(lambda es, task, g, l: None)
        return p.build()

    def body(ctx, rank, nranks):
        ctx.add_taskpool(build(VectorTwoDimCyclic("V", 8, 4, P=2,
                                                  myrank=rank)))
        ctx.wait(timeout=60)    # rank 0's failure poisons rank 1 at once

    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        run_multirank(2, body, timeout=30)
    assert time.monotonic() - t0 < 20
    cause = ei.value.__cause__
    while cause is not None and not isinstance(cause, NotImplementedError):
        cause = cause.__cause__
    assert isinstance(cause, NotImplementedError)
    assert "item 10" in str(cause)


# ---------------------------------------------------------------------------
# the context's wire identity
# ---------------------------------------------------------------------------

def test_context_ranks_comm_ids_and_local_pools():
    from parsec_tpu_torch.models.ep import ep_pool
    with pytest.raises(ValueError, match="outside"):
        Context(nb_cores=0, nb_ranks=2, my_rank=2)
    ctx = Context(nb_cores=0, nb_ranks=2, my_rank=1)
    try:
        a, b = ep_pool(2, 2).build(), ep_pool(2, 2).build()
        ctx.add_taskpool(a)
        ctx.add_taskpool(b, local_only=True)
        assert a.comm_id == 1 and b.comm_id is None
        # a rank-private pool stays on the compiled DAG; a wire pool not
        assert getattr(b, "_compiled_dag", None) is not None
        assert getattr(a, "_compiled_dag", None) is None
        ctx.wait(timeout=30)
    finally:
        ctx.fini(timeout=30)


def test_unknown_termdet_is_refused(port_param):
    port_param("termdet", "nonesuch")
    ctx = Context(nb_cores=0)
    try:
        with pytest.raises(ValueError, match="nonesuch"):
            ctx.add_taskpool(ptg.PTGBuilder("empty").build())
    finally:
        ctx.fini(timeout=10)


# ---------------------------------------------------------------------------
# collectives (tests/test_comm_collectives.py)
# ---------------------------------------------------------------------------

def test_reduce_op_registry():
    assert reduce_op("sum") is torch.add
    with pytest.raises(KeyError, match="register_reduce_op"):
        reduce_op("xor")
    register_reduce_op("absmax", lambda a, b: torch.maximum(a.abs(),
                                                            b.abs()))
    assert reduce_op("absmax") is not None


def test_bad_root_rejected():
    with pytest.raises(ValueError, match="root"):
        bcast_taskpool(VectorTwoDimCyclic("V", 16, 4), n=4, root=4)


@pytest.mark.parametrize("kind", KINDS)
def test_bcast_single_rank(kind):
    V = VectorTwoDimCyclic("V", 20, 4, init_fn=lambda m, s: (
        np.arange(s, dtype=np.float32) + 9.0 if m == 0
        else np.zeros(s, np.float32)))
    ctx = Context(nb_cores=0)
    try:
        ctx.add_taskpool(bcast_taskpool(V, n=5, kind=kind))
        ctx.wait(timeout=30)
    finally:
        ctx.fini(timeout=30)
    for m in range(5):
        torch.testing.assert_close(V.data_of(m).newest_copy().value,
                                   torch.arange(4.0) + 9.0)


@pytest.mark.parametrize("op", ["sum", "max", "prod"])
def test_reduce_single_rank_matches_jax_package(op):
    cols = np.random.RandomState(14).uniform(0.5, 1.5, size=(6, 4)) \
        .astype(np.float32)
    R = VectorTwoDimCyclic("R", 24, 4, init_fn=lambda m, s: cols[m].copy())
    O = VectorTwoDimCyclic("O", 4, 4)
    ctx = Context(nb_cores=0)
    try:
        ctx.add_taskpool(reduce_taskpool(R, O, op=op, n=6))
        ctx.wait(timeout=30)
    finally:
        ctx.fini(timeout=30)
    oracle = {"sum": np.sum, "max": np.max, "prod": np.prod}[op]
    np.testing.assert_allclose(O.data_of(0).newest_copy().value.numpy(),
                               oracle(cols, axis=0), rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nranks", [2, 4])
def test_bcast_multirank_matches_jax_package(kind, nranks):
    def make(pkg):
        bcast = jcoll.bcast_taskpool if pkg == "jax" else bcast_taskpool

        def body(ctx, rank, nranks):
            V = _vec(pkg, "V", nranks, 4, nranks, rank, lambda m, s: (
                np.arange(s, dtype=np.float32) * 2.0 + 3.0 if m == 0
                else np.zeros(s, np.float32)))
            ctx.add_taskpool(bcast(V, n=nranks, kind=kind))
            ctx.wait(timeout=60)
            ctx.comm_barrier()
            return (_value(pkg, V, rank).tolist(),
                    ctx.comm_engine.payload_bytes_received)
        return body

    j, p = _both(nranks, make, nb_cores=1, timeout=120)
    want = (np.arange(4, dtype=np.float32) * 2.0 + 3.0).tolist()
    assert [r[0] for r in p] == [want] * nranks
    assert p == j


@pytest.mark.parametrize("nranks", [3, 4])
def test_reduce_multirank_matches_jax_package(nranks):
    def make(pkg):
        reduce = jcoll.reduce_taskpool if pkg == "jax" else reduce_taskpool

        def body(ctx, rank, nranks):
            R = _vec(pkg, "R", nranks, 4, nranks, rank,
                     lambda m, s: np.full(s, float(m + 1), np.float32))
            O = _vec(pkg, "O", 1, 4, nranks, rank,
                     lambda m, s: np.zeros(s, np.float32))
            ctx.add_taskpool(reduce(R, O, op="sum", n=nranks))
            ctx.wait(timeout=60)
            ctx.comm_barrier()
            return ((_value(pkg, O, 0).tolist() if rank == 0 else None),
                    ctx.comm_engine.payload_bytes_received)
        return body

    j, p = _both(nranks, make, nb_cores=1, timeout=120)
    assert p[0][0] == [float(sum(range(1, nranks + 1)))] * 4
    assert p == j

"""The port's native runtime core (``parsec_tpu_torch/native``, built by
``g++`` from ``parsec_tpu_torch/csrc/native_core.cpp``) against the JAX
package's (``parsec_tpu/native``): the same operations on both give the
same answers.

Mirrors ``tests/test_native.py``: LIFO thread stress, the two-ended
deque, heap order, the dep table's satisfied-mask protocol and its
double-release check, the counter, the exact-or-refused 64-bit key
packing (bit for bit equal to the JAX package's on the same keys), the
EP pool through the native dep table, and the native and Python dep
tiers agreeing on a GEMM.  Integers compare exactly; the GEMM compares
fp32 sums of the same products in the same order exactly and against
float64 at ``atol=1e-5``.
"""

import threading
from pathlib import Path

import numpy as np
import pytest

from parsec_tpu import native as jnative
from parsec_tpu.runtime.deps import _pack_key64 as j_pack_key64
from parsec_tpu_torch import native
from parsec_tpu_torch.core.params import params as port_params
from parsec_tpu_torch.runtime.deps import _pack_key64

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def port_param():
    """Scoped override of port params, restored at test exit."""
    saved = {}

    def set_(name, value):
        saved.setdefault(name, port_params.get(name))
        port_params.set(name, value)

    yield set_
    for name, value in saved.items():
        port_params.set(name, value)


def test_the_library_is_the_ports_own_build():
    path = native.ensure_built()
    assert path is not None and native.available(), native.build_error
    rel = Path(path).resolve().relative_to(REPO)
    assert rel.parts[:3] == ("parsec_tpu_torch", "csrc", "build"), rel
    assert rel.name.startswith("libparsec_tpu_torch_native-")
    assert native.SRC == REPO / "parsec_tpu_torch" / "csrc" / \
        "native_core.cpp"
    assert Path(native.loaded_path()).resolve() == Path(path).resolve()
    assert native.ensure_built() == path      # current: no rebuild


@pytest.mark.parametrize("mod", [native, jnative], ids=["port", "jax"])
def test_lifo_threaded_stress(mod):
    lifo = mod.NativeLifo()
    N, T = 2000, 4
    seen, seen_lock = [], threading.Lock()

    def worker(base):
        got = []
        for i in range(N):
            lifo.push(base + i)
            if i % 3 == 0:
                v = lifo.pop()
                if v is not None:
                    got.append(v)
        while (v := lifo.pop()) is not None:
            got.append(v)
        with seen_lock:
            seen.extend(got)

    ts = [threading.Thread(target=worker, args=(t * N,)) for t in range(T)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    while (v := lifo.pop()) is not None:
        seen.append(v)
    assert sorted(seen) == list(range(N * T))
    assert len(lifo) == 0


def _deque_trace(mod):
    dq = mod.NativeDeque()
    dq.push_back(1)
    dq.push_back(2)
    dq.push_front(0)
    return [len(dq), dq.pop_front(), dq.pop_back(), dq.pop_front(),
            dq.pop_front(), dq.pop_back()]


def test_deque_two_ended():
    assert _deque_trace(native) == _deque_trace(jnative) \
        == [3, 0, 2, 1, None, None]


def _heap_order(mod, items):
    h = mod.NativeHeap()
    for prio, v in items:
        h.push(prio, v)
    return [h.pop() for _ in range(len(items) + 1)]


def test_heap_priority_order():
    rng = np.random.default_rng(3)
    items = [(int(p), i) for i, p in enumerate(rng.integers(-50, 50, 40))]
    got = _heap_order(native, items)
    assert got == _heap_order(jnative, items)
    prios = dict((v, p) for p, v in items)
    assert got[-1] is None
    assert [prios[v] for v in got[:-1]] == sorted(prios.values(),
                                                  reverse=True)


def _mask_trace(mod):
    t = mod.NativeDepTable(64)
    out = [t.release(7, 0b001, 0b111), t.release(7, 0b100, 0b111), len(t),
           t.release(7, 0b010, 0b111), len(t),
           t.release(7, 0b1, 0b1)]      # the key is reusable once ready
    return out


def test_deptable_mask_protocol():
    assert _mask_trace(native) == _mask_trace(jnative) \
        == [False, False, 1, True, 0, True]


@pytest.mark.parametrize("mod", [native, jnative], ids=["port", "jax"])
def test_deptable_double_release_raises(mod):
    t = mod.NativeDepTable(64)
    t.release(9, 0b01, 0b11)
    with pytest.raises(AssertionError):
        t.release(9, 0b01, 0b11)


def test_deptable_threaded_stress():
    t = native.NativeDepTable(256)
    NKEYS, NBITS = 500, 8
    required = (1 << NBITS) - 1
    ready_counts = [0] * NBITS

    def worker(bit):
        ready_counts[bit] = sum(t.release(k, 1 << bit, required)
                                for k in range(NKEYS))

    ts = [threading.Thread(target=worker, args=(b,)) for b in range(NBITS)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in ts)
    assert sum(ready_counts) == NKEYS       # each key ready exactly once
    assert len(t) == 0


def test_counter():
    for mod in (native, jnative):
        c = mod.NativeCounter(2)
        assert [c.add(-1), c.add(-1), c.get(), c.add(5)] == [1, 0, 0, 5]


def test_dag_fetch_complete_matches():
    """The CSR executor: the same graph, fetch/complete sequence and
    priorities give the same ids and counts in both libraries."""
    import ctypes
    rng = np.random.default_rng(11)
    n = 60
    edges = {(int(a), int(b)) for a, b in rng.integers(0, n, (150, 2))
             if a < b}
    succ = [[b for a, b in sorted(edges) if a == i] for i in range(n)]
    indeg = np.zeros(n, np.int32)
    for _, b in edges:
        indeg[b] += 1
    off = np.zeros(n + 1, np.int32)
    off[1:] = np.cumsum([len(s) for s in succ])
    flat = np.array([b for s in succ for b in s], np.int32)
    prio = rng.integers(0, 9, n).astype(np.int64)

    def drive(mod, p):
        dag = mod.NativeDag(indeg, off, flat, p)
        buf = (ctypes.c_int32 * 7)()
        order, rems = [], []
        while True:
            k = dag.fetch(buf, 7)
            if not k:
                break
            ids = list(buf[:k])
            order.append(ids)
            rems.append(dag.complete(buf, k))
        return order, rems, dag.remaining()

    for p in (None, prio):
        got = drive(native, p)
        assert got == drive(jnative, p)
        assert sorted(i for ids in got[0] for i in ids) == list(range(n))
        assert got[2] == 0


def _keys():
    rng = np.random.default_rng(7)
    keys = [(), (0,), (3, 4, 5), (1 << 47,), (1 << 48,), (-1,), ("x",),
            (1.0,), (2, 1 << 24), (2, (1 << 24) - 1), (True,)]
    keys += [tuple(int(v) for v in rng.integers(0, 1 << 16, k))
             for k in (1, 2, 3, 4) for _ in range(20)]
    ids = [(1, 2), (1023, 63), (1024, 0), (0, 64), (5, 0)]
    return [(tp, tc, k) for tp, tc in ids for k in keys]


def test_pack_key64_is_exact_or_refused_like_the_jax_package():
    packed = [_pack_key64(*a) for a in _keys()]
    assert packed == [j_pack_key64(*a) for a in _keys()]
    assert packed.count(None) > 0 and any(p is not None for p in packed)
    # injective on a grid
    grid = {_pack_key64(1, 2, (m, n, k))
            for m in range(8) for n in range(8) for k in range(8)}
    assert len(grid) == 512
    for bad in ((1, 2, (-1,)), (1, 2, (1 << 50,)), (1, 2, ("x",)),
                (1 << 12, 2, (0,)), (1, 1 << 8, (0,))):
        assert _pack_key64(*bad) is None


class _CountingTable:
    """A native dep table that counts its releases."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def release(self, *a):
        self.calls += 1
        return self.inner.release(*a)

    def __len__(self):
        return len(self.inner)


def test_ep_dag_runs_through_native_deptable(port_param):
    """With the compiled DAG off and the index-array tier off, every
    dependency of the EP pool goes through the native table; the tasks
    and their per-lane order equal the JAX package's run."""
    from parsec_tpu.runtime import Context as JContext
    from parsec_tpu_torch.models.ep import ep_pool
    from parsec_tpu_torch.runtime import Context
    from test_torch_dagrun import jax_ep_pool

    port_param("runtime_dag_compile", False)
    port_param("deps_storage", "hash")
    done = []
    ctx = Context(nb_cores=2)
    try:
        assert ctx.deps.native_enabled
        counting = ctx.deps._native = _CountingTable(ctx.deps._native)
        ctx.add_taskpool(
            ep_pool(10, 20, lambda d, n: done.append((d, n))).build())
        ctx.wait(timeout=60)
    finally:
        ctx.fini()
    assert counting.calls == 10 * 19 and len(counting) == 0
    assert len(ctx.deps) == 0
    jdone = []
    jctx = JContext(nb_cores=2)
    try:
        jctx.add_taskpool(
            jax_ep_pool(10, 20, lambda d, n: jdone.append((d, n))).build())
        jctx.wait(timeout=60)
    finally:
        jctx.fini()
    assert sorted(done) == sorted(jdone) == sorted(
        (d, n) for d in range(20) for n in range(10))
    for lane in range(10):
        assert [d for d, n in done if n == lane] == list(range(20))


@pytest.mark.parametrize("storage", ["index-array", "hash"])
def test_native_and_python_tiers_agree_on_gemm(port_param, storage):
    """The host GEMM through the dynamic scheduler with the native dep
    table on and off (and each dep storage): the same C, equal to the
    JAX package's host GEMM."""
    from parsec_tpu.data_dist.matrix import TiledMatrix as JTiledMatrix
    from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as jgemm
    from parsec_tpu.runtime import Context as JContext
    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
    from parsec_tpu_torch.runtime import Context

    rng = np.random.default_rng(5)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    b = rng.standard_normal((8, 8)).astype(np.float32)
    port_param("runtime_dag_compile", False)
    port_param("deps_storage", storage)
    outs = []
    for native_on in (True, False):
        port_param("runtime_native", native_on)
        A = TiledMatrix.from_dense("A", a, 4, 4)
        B = TiledMatrix.from_dense("B", b, 4, 4)
        C = TiledMatrix.from_dense("C", np.zeros((8, 8), np.float32), 4, 4)
        ctx = Context(nb_cores=2)
        try:
            assert ctx.deps.native_enabled == native_on
            ctx.add_taskpool(tiled_gemm_ptg(A, B, C, devices="cpu"))
            ctx.wait(timeout=60)
        finally:
            ctx.fini()
        outs.append(C.to_dense())
    jA = JTiledMatrix.from_dense("A", a, 4, 4)
    jB = JTiledMatrix.from_dense("B", b, 4, 4)
    jC = JTiledMatrix.from_dense("C", np.zeros((8, 8), np.float32), 4, 4)
    jctx = JContext(nb_cores=2)
    try:
        jctx.add_taskpool(jgemm(jA, jB, jC, devices="cpu"))
        jctx.wait(timeout=60)
    finally:
        jctx.fini()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], jC.to_dense(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(outs[0], a.astype(np.float64) @ b, atol=1e-5)


@pytest.mark.parametrize("cap", [16, 48])
def test_index_array_cap_matches_the_jax_package(port_param, monkeypatch,
                                                 cap):
    """A static box past the index-array tier's slot cap is not backed
    densely: the class takes the hashed tiers.  The port's cap is a
    module constant, the JAX package's a param; set both to ``cap``
    around an EP pool of box volume 48 (8 lanes, depth 6): the dense
    array is allocated exactly when the box fits, in both packages, and
    every task runs once."""
    import parsec_tpu.runtime.deps  # noqa: F401  (registers its params)
    from parsec_tpu.core.params import params as jparams
    from parsec_tpu.runtime import Context as JContext
    from parsec_tpu_torch.models.ep import ep_pool
    from parsec_tpu_torch.runtime import Context
    from parsec_tpu_torch.runtime import deps
    from test_torch_dagrun import jax_ep_pool

    port_param("runtime_dag_compile", False)
    port_param("deps_storage", "index-array")
    monkeypatch.setattr(deps, "_INDEX_ARRAY_MAX_SLOTS", cap)
    saved = {k: jparams.get(k) for k in (
        "runtime_dag_compile", "deps_storage", "deps_index_array_max_slots")}
    jparams.set("runtime_dag_compile", False)
    jparams.set("deps_storage", "index-array")
    jparams.set("deps_index_array_max_slots", cap)
    allocated, done = [], []
    try:
        for C, ep in ((JContext, jax_ep_pool), (Context, ep_pool)):
            ran = []
            ctx = C(nb_cores=0)
            try:
                store = ctx.deps._index_store
                ctx.add_taskpool(
                    ep(8, 6, lambda d, n: ran.append((d, n))).build())
                ctx.wait(timeout=60)
                allocated.append(store.allocated)
            finally:
                ctx.fini()
            done.append(sorted(ran))
    finally:
        for k, v in saved.items():
            jparams.set(k, v)
    assert allocated == [int(cap >= 48)] * 2
    assert done[0] == done[1] == sorted(
        (d, n) for d in range(6) for n in range(8))

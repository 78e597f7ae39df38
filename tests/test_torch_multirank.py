"""The port's GEMM, Cholesky and LU across ranks, against the JAX package's.

The same seeded numpy inputs go through ``parsec_tpu.comm.run_multirank``
(the JAX package's host chores) and the port's ``run_multirank`` on a
2-D block-cyclic grid (``P=2``, ``Q=nranks/2``), over the in-process
fabric and over the device fabric (the JAX package on its virtual CPU
devices, the port on ``torch.device("cpu")`` devices passed explicitly).
The port runs its host chores, and its device chores on the device
module around the host (``init_cuda_devices(device="cpu")``): then one
device module serves every rank's context, as on the card.

Each rank returns its own tiles (``to_dense`` over several ranks), its
local task count (``nb_local_tasks``: the pool terminated, so exactly that
many tasks completed there) and the payload bytes its comm engine
received.  The tests hold:

- the assembled result to the JAX package's to ``rtol=1e-4`` (the
  factorizations to ``rtol=1e-4, atol=1e-5``, as ``test_torch_cholesky``
  and ``test_torch_lu`` hold the single-rank factors: the port's TRSM
  multiplies by an inverse), and to float64 under the JAX tests'
  tolerances (``tests/test_comm_device.py``, ``test_cholesky.py``,
  ``test_lu.py``);
- the per-rank task counts, exactly, and their sum to the single-rank
  count;
- the payload bytes each rank received, exactly (the same trees and
  short limit run on both sides).
"""

import numpy as np
import pytest

from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JBC
from parsec_tpu.models import cholesky as jchol
from parsec_tpu.models import lu as jlu
from parsec_tpu.models import tiled_gemm as jgemm
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                               TwoDimBlockCyclic)
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models import cholesky as chol
from parsec_tpu_torch.models import lu
from parsec_tpu_torch.models import tiled_gemm as gemm
from parsec_tpu_torch.runtime import Context

PKG_TOL = dict(rtol=1e-4, atol=1e-5)
# (ranks, transport): the JAX tests' cases, and the device fabric over 2
CASES = [(2, "inproc"), (4, "inproc"), (2, "device"), (4, "device")]


@pytest.fixture
def cpu_cuda_device():
    """The port's device module around the host CPU, registered for the
    test and unregistered after."""
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


def _grid(nranks):
    P = 2 if nranks % 2 == 0 else 1
    return P, nranks // P


def _matrices(kind, pkg, a, b, nb, P, Q, rank):
    """The input collections of ``kind`` in package ``pkg`` ("jax" or
    "port") on one rank."""
    bc, sym = (JBC, JSym) if pkg == "jax" else (TwoDimBlockCyclic,
                                                 SymTwoDimBlockCyclic)
    kw = dict(P=P, Q=Q, myrank=rank)
    if kind == "gemm":
        n = len(a)
        return (bc.from_dense("A", a, nb, nb, **kw),
                bc.from_dense("B", b, nb, nb, **kw),
                bc("C", n, n, nb, nb, **kw))
    cls = sym if kind == "cholesky" else bc
    return (cls.from_dense("A", a.copy(), nb, nb, **kw),)


def _pool(kind, pkg, mats, chores):
    mod = {"gemm": (jgemm, gemm), "cholesky": (jchol, chol),
           "lu": (jlu, lu)}[kind][pkg == "port"]
    build = {"gemm": "tiled_gemm_ptg", "cholesky": "tiled_cholesky_ptg",
             "lu": "tiled_lu_ptg"}[kind]
    return getattr(mod, build)(*mats, devices=chores)


def _body(kind, pkg, a, b, nb, chores):
    def body(ctx, rank, nranks):
        P, Q = _grid(nranks)
        mats = _matrices(kind, pkg, a, b, nb, P, Q, rank)
        tp = _pool(kind, pkg, mats, chores)
        ctx.add_taskpool(tp)
        ntasks = tp.nb_local_tasks()
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        got = mats[-1].to_dense()
        eng = ctx.comm_engine
        return (got, ntasks,
                eng.payload_bytes_received if eng is not None else 0)
    return body


def _inputs(kind, n):
    if kind == "gemm":
        rng = np.random.RandomState(7)
        return (rng.randn(n, n).astype(np.float32),
                rng.randn(n, n).astype(np.float32))
    if kind == "cholesky":
        return chol.make_spd(n, seed=1), None
    return lu.make_dd(n, seed=1), None


def _run(kind, pkg, n, nb, nranks, transport, chores="cpu"):
    a, b = _inputs(kind, n)
    body = _body(kind, pkg, a, b, nb, chores)
    if pkg == "jax":
        res = j_run_multirank(nranks, body, transport=transport,
                              timeout=240)
    else:
        res = run_multirank(nranks, body, transport=transport, timeout=240,
                            devices=(["cpu"] * nranks
                                     if transport == "device" else None))
    got = sum(r[0] for r in res)
    if kind == "cholesky":
        got = np.tril(got)
    return got, [r[1] for r in res], [r[2] for r in res], (a, b)


SIZES = {"gemm": (64, 16), "cholesky": (192, 32), "lu": (64, 16)}
SINGLE = {"gemm": 64, "cholesky": 56, "lu": 30}    # single-rank task counts


def _check_float64(kind, got, a, b):
    if kind == "gemm":
        np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)
    elif kind == "cholesky":
        np.testing.assert_allclose(
            got, np.linalg.cholesky(a.astype(np.float64)), rtol=1e-3,
            atol=1e-4)
    else:
        L, U = lu.unpack_lu(got.astype(np.float64))
        np.testing.assert_allclose(L @ U, a, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kind", ["gemm", "cholesky", "lu"])
@pytest.mark.parametrize("nranks,transport", CASES)
def test_host_chores_match_jax_package(kind, nranks, transport):
    n, nb = SIZES[kind]
    want, jcounts, jbytes, _ = _run(kind, "jax", n, nb, nranks, transport)
    got, counts, nbytes, (a, b) = _run(kind, "port", n, nb, nranks,
                                       transport)
    np.testing.assert_allclose(got, want, **PKG_TOL)
    _check_float64(kind, got, a, b)
    assert counts == jcounts
    assert sum(counts) == SINGLE[kind]
    assert nbytes == jbytes
    if kind != "gemm":
        assert all(x > 0 for x in nbytes)   # tiles crossed to every rank
    else:
        assert nbytes == [0] * nranks       # A and B are read on C's rank


@pytest.mark.parametrize("kind", ["gemm", "cholesky", "lu"])
@pytest.mark.parametrize("nranks,transport", [(2, "device"), (4, "device"),
                                              (4, "inproc")])
def test_device_chores_match_jax_package(cpu_cuda_device, kind, nranks,
                                         transport):
    """The card's configuration on the host: every rank's device chores
    go through ONE device module (the first rank into it manages it for
    all), and each rank's batches stay its own."""
    n, nb = SIZES[kind]
    want, jcounts, jbytes, _ = _run(kind, "jax", n, nb, nranks, transport)
    got, counts, nbytes, _ = _run(kind, "port", n, nb, nranks, transport,
                                  chores="cuda")
    np.testing.assert_allclose(got, want, **PKG_TOL)
    assert counts == jcounts and nbytes == jbytes
    assert cpu_cuda_device.executed_tasks == SINGLE[kind]
    assert sum(cpu_cuda_device.tasks_by_class.values()) == SINGLE[kind]


@pytest.mark.parametrize("storage", ["index-array", "hash"])
@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_every_dep_tier_takes_remote_releases(kind, storage):
    """A released remote dependency reaches the index-array tier (the
    default), and, under ``deps_storage=hash``, the native tier or the
    Python table: each gives the same factor."""
    saved = params.get("deps_storage")
    params.set("deps_storage", storage)
    try:
        n, nb = SIZES[kind]
        got, counts, _, _ = _run(kind, "port", n, nb, 4, "inproc")
    finally:
        params.set("deps_storage", saved)
    want, jcounts, _, _ = _run(kind, "jax", n, nb, 4, "inproc")
    np.testing.assert_allclose(got, want, **PKG_TOL)
    assert counts == jcounts


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_fourcounter_factorization(kind):
    """Under the wave detector every rank's wait returns only at global
    termination; the factor needs no barrier to be whole."""
    n, nb = SIZES[kind]
    a, _ = _inputs(kind, n)

    def body(ctx, rank, nranks):
        P, Q = _grid(nranks)
        mats = _matrices(kind, "port", a, None, nb, P, Q, rank)
        tp = _pool(kind, "port", mats, "cpu")
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        return mats[-1].to_dense(), type(tp.tdm).__name__

    saved = params.get("termdet")
    params.set("termdet", "fourcounter")
    try:
        res = run_multirank(4, body, transport="device",
                            devices=["cpu"] * 4)
    finally:
        params.set("termdet", saved)
    assert {r[1] for r in res} == {"FourCounterTermDet"}
    got = sum(r[0] for r in res)
    want, _, _, _ = _run(kind, "jax", n, nb, 4, "inproc")
    if kind == "cholesky":
        got = np.tril(got)
    np.testing.assert_allclose(got, want, **PKG_TOL)


def test_comm_counters_hold_under_fast_thread_switching(cpu_cuda_device):
    """Stress: 4 ranks with 2 workers each, their device chores through
    the one device module (a rank's activations then run on whichever
    thread manages it), under a 10 µs switch interval: every activation
    sent is received, and the payload bytes staged at the tree roots equal
    the bytes received, which a lost counter update would break."""
    import sys
    n, nb = SIZES["cholesky"]
    a, _ = _inputs("cholesky", n)

    def body(ctx, rank, nranks):
        P, Q = _grid(nranks)
        (A,) = _matrices("cholesky", "port", a, None, nb, P, Q, rank)
        ctx.add_taskpool(chol.tiled_cholesky_ptg(A))
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        return A.to_dense(), ctx.comm_engine.stats()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        res = run_multirank(4, body, nb_cores=2, transport="device",
                            devices=["cpu"] * 4, timeout=240)
    finally:
        sys.setswitchinterval(old)
    st = [r[1] for r in res]
    assert sum(s["activations_sent"] for s in st) \
        == sum(s["activations_received"] for s in st) > 0
    assert sum(s["payload_bytes_staged"] for s in st) \
        == sum(s["payload_bytes_received"] for s in st)
    np.testing.assert_allclose(
        np.tril(sum(r[0] for r in res)),
        np.linalg.cholesky(a.astype(np.float64)), rtol=1e-3, atol=1e-4)


def test_single_rank_run_equals_plain_context():
    """One rank through ``run_multirank`` runs the pool as a plain
    ``Context`` does, and the comm seams stay unused."""
    n, nb = SIZES["cholesky"]
    got, counts, nbytes, _ = _run("cholesky", "port", n, nb, 1, "inproc")
    a, _ = _inputs("cholesky", n)
    A = SymTwoDimBlockCyclic.from_dense("A", a.copy(), nb, nb)
    ctx = Context(nb_cores=0)
    try:
        ctx.add_taskpool(chol.tiled_cholesky_ptg(A, devices="cpu"))
        ctx.wait(timeout=60)
    finally:
        ctx.fini(timeout=30)
    np.testing.assert_array_equal(got, np.tril(A.to_dense()))
    assert counts == [56] and nbytes == [0]


def test_block_cyclic_ownership_matches_jax_package():
    """``rank_of`` with supertiles, and the local-tile assembly, equal to
    the JAX package's distribution."""
    a = np.arange(36 * 36, dtype=np.float32).reshape(36, 36)
    for P, Q, kp, kq in ((2, 2, 1, 1), (2, 3, 2, 1), (1, 4, 1, 2)):
        parts = []
        for rank in range(P * Q):
            kw = dict(P=P, Q=Q, kp=kp, kq=kq, myrank=rank)
            M = TwoDimBlockCyclic.from_dense("A", a, 8, 8, **kw)
            J = JBC.from_dense("A", a, 8, 8, **kw)
            assert [M.rank_of(m, n) for m in range(5) for n in range(5)] \
                == [J.rank_of(m, n) for m in range(5) for n in range(5)]
            np.testing.assert_array_equal(M.to_dense(), J.to_dense())
            parts.append(M.to_dense())
        np.testing.assert_array_equal(sum(parts), a)

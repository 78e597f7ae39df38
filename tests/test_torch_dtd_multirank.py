"""DTD across ranks in the port, against the JAX package: every case of
``tests/test_dtd_multirank.py`` (the chain, the GEMM, the device
transport, one rank staying clean, WAR across ranks), run by both
packages' ``run_multirank`` on the same inputs.  Each case holds the
values, each rank's local task count and the pushes each rank received
to the JAX package's.  The DTD GEMM with ``cuda_kernel="gemm"`` runs
across 4 ranks on the device module around the host, every GEMM there.
"""

import types

import numpy as np
import pytest

from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JBC
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVec
from parsec_tpu.dtd import insert as jinsert
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.data_dist.matrix import (TwoDimBlockCyclic,
                                               VectorTwoDimCyclic)
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.dtd import insert
from parsec_tpu_torch.dtd.multirank_check import (dtd_gemm_multirank_check,
                                                  dtd_gemm_rank_body)


class _JCounting(jinsert.DTDTaskpool):
    """The JAX pool with the port's two counters: tasks inserted to run
    here, and pushes landed here."""

    def __init__(self, name):
        super().__init__(name)
        self.local_tasks = 0

    def _insert_task_locked(self, *args):
        task = super()._insert_task_locked(*args)
        self.local_tasks += not task.is_shell
        return task

    @property
    def pushes_received(self):
        return sum(a.landed for a in self._arrivals.values())


PKGS = {
    "jax": types.SimpleNamespace(run=j_run_multirank, Vec=JVec, BC=JBC,
                                 Pool=_JCounting, f=jinsert),
    "port": types.SimpleNamespace(run=run_multirank, Vec=VectorTwoDimCyclic,
                                  BC=TwoDimBlockCyclic,
                                  Pool=insert.DTDTaskpool, f=insert),
}


def _value(copy):
    return float(np.asarray(copy.value.cpu() if hasattr(copy.value, "cpu")
                            else copy.value)[0])


def _hop(anchor, x):
    return x + 1.0


def _chain_body(pkg):
    def body(ctx, rank, nranks):
        """A value hops rank to rank: task i runs on rank i % n (AFFINITY
        on a per-rank anchor), INOUT on the shared tile X."""
        f = pkg.f
        X = pkg.Vec("X", lm=1, mb=1, P=nranks, myrank=rank,
                    init_fn=lambda m, size: np.zeros(size))
        anchors = pkg.Vec("W", lm=nranks, mb=1, P=nranks, myrank=rank,
                          init_fn=lambda m, size: np.zeros(size))
        tp = pkg.Pool("chain")
        ctx.add_taskpool(tp)
        tX = tp.tile_of(X, 0)
        for i in range(6):
            tA = tp.tile_of(anchors, i % nranks)
            tp.insert_task(_hop, (tA, f.INPUT | f.AFFINITY), (tX, f.INOUT),
                           name="hop")
        tp.data_flush_all()
        tp.wait(timeout=60)
        ctx.comm_barrier()
        value = _value(X.data_of(0).newest_copy()) if rank == 0 else None
        return value, tp.local_tasks, tp.pushes_received
    return body


def _war_body(pkg):
    def body(ctx, rank, nranks):
        """Rank 0 writes X, a remote rank reads it, rank 0 overwrites it:
        the reader sees the first version (a snapshot, not an alias)."""
        f = pkg.f
        X = pkg.Vec("X", lm=1, mb=1, P=nranks, myrank=rank,
                    init_fn=lambda m, size: np.zeros(size))
        R = pkg.Vec("R", lm=nranks, mb=1, P=nranks, myrank=rank,
                    init_fn=lambda m, size: np.zeros(size))
        tp = pkg.Pool("war")
        ctx.add_taskpool(tp)
        tX = tp.tile_of(X, 0)
        tR = tp.tile_of(R, 1 % nranks)
        tp.insert_task(lambda x: x * 0 + 7.0, (tX, f.INOUT | f.AFFINITY),
                       name="w7")
        tp.insert_task(lambda r, x: x + 0, (tR, f.INOUT | f.AFFINITY),
                       (tX, f.INPUT), name="cap")
        tp.insert_task(lambda x: x * 0 + 9.0, (tX, f.INOUT | f.AFFINITY),
                       name="w9")
        tp.data_flush_all()
        tp.wait(timeout=60)
        ctx.comm_barrier()
        value = _value(R.data_of(1 % nranks).newest_copy()) \
            if rank == 1 % nranks else None
        return value, tp.local_tasks, tp.pushes_received
    return body


def _both(make_body, nranks, **kw):
    want = PKGS["jax"].run(nranks, make_body(PKGS["jax"]), **kw)
    got = PKGS["port"].run(nranks, make_body(PKGS["port"]), **kw)
    return got, want


@pytest.mark.parametrize("nranks", [2, 3, 4])
def test_chain_across_ranks(nranks):
    got, want = _both(_chain_body, nranks)
    assert got == want
    assert got[0][0] == 6.0


def test_single_rank_stays_clean():
    got, want = _both(_chain_body, 1)
    assert got == want == [(6.0, 8, 0)]   # 6 hops, 2 flushes, no push


@pytest.mark.parametrize("nranks", [2, 4])
def test_war_across_ranks(nranks):
    got, want = _both(_war_body, nranks)
    assert got == want
    assert got[1 % nranks][0] == 7.0


def _jax_gemm_body(a, b, nb, P, Q):
    """``parsec_tpu.dtd.multirank_check.dtd_gemm_rank_body``, counting."""
    f = jinsert

    def body(ctx, rank, nranks):
        n = a.shape[0]
        A = JBC.from_dense("A", a, nb, nb, P=P, Q=Q, myrank=rank)
        B = JBC.from_dense("B", b, nb, nb, P=P, Q=Q, myrank=rank)
        C = JBC("C", n, n, nb, nb, P=P, Q=Q, myrank=rank)
        tp = _JCounting("dtd_gemm")
        ctx.add_taskpool(tp)
        for m in range(C.mt):
            for nn in range(C.nt):
                for k in range(A.nt):
                    tp.insert_task(_jgemm, (tp.tile_of(A, m, k), f.INPUT),
                                   (tp.tile_of(B, k, nn), f.INPUT),
                                   (tp.tile_of(C, m, nn),
                                    f.INOUT | f.AFFINITY), name="gemm")
        tp.data_flush_all()
        tp.wait(timeout=120)
        ctx.comm_barrier()
        return C.to_dense(), tp.local_tasks, tp.pushes_received
    return body


def _jgemm(a, b, c):
    return np.asarray(c) + np.asarray(a, np.float32) @ np.asarray(b,
                                                                  np.float32)


def _gemm_inputs(n=48):
    rng = np.random.RandomState(11)
    return (rng.randn(n, n).astype(np.float32),
            rng.randn(n, n).astype(np.float32))


def _jax_gemm(nranks, transport="inproc"):
    a, b = _gemm_inputs()
    P = 2 if nranks % 2 == 0 else 1
    res = j_run_multirank(nranks, _jax_gemm_body(a, b, 16, P, nranks // P),
                          transport=transport, timeout=240)
    return sum(r[0] for r in res), [r[1] for r in res], [r[2] for r in res]


def _check_gemm(parts, nranks, transport="inproc"):
    want, jtasks, jpushes = _jax_gemm(nranks, transport)
    np.testing.assert_allclose(sum(p["C"] for p in parts), want, rtol=1e-4,
                               atol=1e-5)
    assert [p["tasks"] for p in parts] == jtasks
    assert [p["pushes"] for p in parts] == jpushes


@pytest.mark.parametrize("nranks", [2, 4, 8])
def test_dtd_gemm_multirank(nranks):
    _check_gemm(dtd_gemm_multirank_check(nranks), nranks)


def test_dtd_gemm_multirank_device_transport():
    parts = dtd_gemm_multirank_check(4, transport="device",
                                     devices=["cpu"] * 4)
    _check_gemm(parts, 4, transport="device")


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


@pytest.mark.parametrize("transport", ["inproc", "device"])
def test_dtd_gemm_on_k1_across_four_ranks(cpu_cuda_device, transport):
    """``cuda_kernel="gemm"``: every GEMM of every rank through the one
    device module (here around the host, so K1's plain version)."""
    a, b = _gemm_inputs()
    body = dtd_gemm_rank_body(a, b, 16, 2, 2, cuda_kernel="gemm")
    parts = run_multirank(4, body, transport=transport,
                          devices=["cpu"] * 4 if transport == "device"
                          else None)
    _check_gemm(parts, 4)
    assert cpu_cuda_device.tasks_by_class == {"gemm": 27}


def _early_push_body(pkg):
    def body(ctx, rank, nranks):
        """A local reader R of X's home value waits behind a slow task;
        meanwhile rank 1 overwrites X and a later local task T2 runs on
        that push.  R must still read the value before rank 1's write."""
        import time
        f = pkg.f
        zeros = lambda m, size: np.zeros(size)       # noqa: E731
        X = pkg.Vec("X", lm=1, mb=1, P=2, myrank=rank, init_fn=zeros)
        Z = pkg.Vec("Z", lm=1, mb=1, P=2, myrank=rank, init_fn=zeros)
        W = pkg.Vec("W", lm=2, mb=1, P=2, myrank=rank, init_fn=zeros)
        tp = pkg.Pool("early")
        ctx.add_taskpool(tp)
        tX, tZ = tp.tile_of(X, 0), tp.tile_of(Z, 0)

        def slow(z):
            time.sleep(0.3)
            return z + 0

        tp.insert_task(slow, (tZ, f.INOUT | f.AFFINITY), name="slow")
        tp.insert_task(lambda z, x: x + 0, (tZ, f.INOUT | f.AFFINITY),
                       (tX, f.INPUT), name="read")          # rank 0
        tp.insert_task(lambda a, x: x * 0 + 9.0,
                       (tp.tile_of(W, 1), f.INPUT | f.AFFINITY),
                       (tX, f.INOUT), name="w9")             # rank 1
        tp.insert_task(lambda a, x: x + 1.0,
                       (tp.tile_of(W, 0), f.INPUT | f.AFFINITY),
                       (tX, f.INOUT), name="inc")            # rank 0
        tp.data_flush_all()
        tp.wait(timeout=60)
        ctx.comm_barrier()
        if rank:
            return None
        return (_value(Z.data_of(0).newest_copy()),
                _value(X.data_of(0).newest_copy()))
    return body


def test_a_push_landing_early_does_not_reach_an_older_reader():
    """Two workers a rank, so the slow task holds one while the other
    lands rank 1's push and runs the task after it."""
    got, want = _both(_early_push_body, 2, nb_cores=2)
    assert got[0] == want[0] == (0.0, 10.0)

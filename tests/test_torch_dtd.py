"""The port's DTD (``parsec_tpu_torch/dtd``) against the JAX package's
(``parsec_tpu/dtd``), on one rank.

Mirrors the eleven cases of ``tests/test_dtd.py`` under both of its
fixtures (caller-driven and three workers): each runs the same
insertions on the same seeded tiles through both packages (numpy arrays
on the JAX side, tensors on the port's) and compares.  Then the DTD
GEMM with ``cuda_kernel="gemm"`` on the device module around the host,
every task on the device and batches fused, against the JAX package's
DTD GEMM on its host chore; the same under a window smaller than the
task count; ``ptg_to_dtd`` of the tiled GEMM and the tiled Cholesky
against the PTG run; and termination held by the pending action until
``close()``.

Tolerances: integer-valued and exactly representable results compare
exactly; fp32 GEMMs ``rtol=1e-4, atol=1e-4`` (as ``tests/test_dtd.py``:
sums of the same fp32 products in another order); Cholesky ``atol=1e-5``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import parsec_tpu.dtd as jdtd
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiledMatrix
from parsec_tpu.runtime.context import Context as JContext
import parsec_tpu_torch.ops.gemm  # noqa: F401  (registers "gemm")
from parsec_tpu_torch import dtd
from parsec_tpu_torch.data_dist.matrix import TiledMatrix
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models.tiled_gemm import insert_dtd_gemm
from parsec_tpu_torch.runtime.context import Context

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(params=[0, 3], ids=["caller-driven", "3workers"])
def ctxs(request):
    """A JAX context and a port context with the same worker count."""
    jc, pc = JContext(nb_cores=request.param), Context(nb_cores=request.param)
    yield jc, pc
    jc.fini()
    pc.fini()


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


def _pools(ctxs):
    jc, pc = ctxs
    jtp, ptp = jdtd.DTDTaskpool(), dtd.DTDTaskpool()
    jc.add_taskpool(jtp)
    pc.add_taskpool(ptp)
    return (jdtd, jtp, np), (dtd, ptp, torch)


def test_insert_chain_raw(ctxs):
    """RAW chain: each task increments the same tile; order holds."""
    out = []
    for D, tp, xp in _pools(ctxs):
        a = xp.zeros((4,), dtype=xp.int64)
        trace = []

        def bump(arr, i, trace=trace):
            arr += 1
            trace.append((i, int(arr[0])))

        for i in range(50):
            tp.insert_task(bump, (a, D.INOUT), (i, D.VALUE))
        tp.wait()
        out.append((int(a[0]), trace))
    assert out[0] == out[1] == (50, [(i, i + 1) for i in range(50)])


def test_war_waw_hazards(ctxs):
    """Readers between two writers all run before the second writer
    (WAR), and writers serialize (WAW)."""
    out = []
    for D, tp, xp in _pools(ctxs):
        a = xp.asarray([7.0]) if xp is np else torch.tensor([7.0])
        reads = []

        def write(arr, v):
            arr[0] = v

        def read(arr, reads=reads):
            reads.append(float(arr[0]))

        tp.insert_task(write, (a, D.OUTPUT), (1.0, D.VALUE))
        for _ in range(8):
            tp.insert_task(read, (a, D.INPUT))
        tp.insert_task(write, (a, D.OUTPUT), (2.0, D.VALUE))
        tp.insert_task(read, (a, D.INPUT))
        tp.wait()
        out.append((reads, float(a[0])))
    assert out[0] == out[1] == ([1.0] * 8 + [2.0], 2.0)


def test_two_tiles_parallel_then_join(ctxs):
    out = []
    for D, tp, xp in _pools(ctxs):
        x, y, z = (xp.asarray([v]) if xp is np else torch.tensor([v])
                   for v in (1.0, 2.0, 0.0))

        def scale(arr, s):
            arr *= s

        def add_into(dst, xa, ya):
            dst[0] = xa[0] + ya[0]

        tp.insert_task(scale, (x, D.INOUT), (10.0, D.VALUE))
        tp.insert_task(scale, (y, D.INOUT), (100.0, D.VALUE))
        tp.insert_task(add_into, (z, D.OUTPUT), (x, D.INPUT), (y, D.INPUT))
        tp.wait()
        out.append(float(z[0]))
    assert out == [210.0, 210.0]


def test_scratch_and_value(ctxs):
    out = []
    for D, tp, xp in _pools(ctxs):
        dst = xp.zeros((3,), dtype=xp.float64)

        def body(d, scratch, k):
            scratch[:] = k
            d[:] = scratch * 2

        tp.insert_task(body, (dst, D.OUTPUT),
                       (D.Scratch((3,), np.float64), D.SCRATCH),
                       (21.0, D.VALUE))
        tp.wait()
        out.append([float(v) for v in dst])
    assert out[0] == out[1] == [42.0] * 3


def test_functional_update_return(ctxs):
    """A body may return replacement values for its written flows."""
    out = []
    for D, tp, xp in _pools(ctxs):
        arr = np.array([3.0]) if xp is np else torch.tensor([3.0])
        t = tp.tile_of_array(arr, key="t")

        def fbody(a):
            return a + 1.0   # replaces, does not mutate

        for _ in range(4):
            tp.insert_task(fbody, (t, D.INOUT))
        tp.wait()
        out.append(float(t.data.newest_copy().value[0]))
    assert out == [7.0, 7.0]


def test_window_backpressure(ctxs):
    out = []
    for D, tp, xp in _pools(ctxs):
        tp.window_size, tp.threshold_size = 16, 8
        a = xp.zeros((1,), dtype=xp.int64)
        peak = [0]

        def inc(arr, tp=tp, peak=peak):
            arr += 1
            peak[0] = max(peak[0], tp._inflight)

        for _ in range(300):
            tp.insert_task(inc, (a, D.INOUT))
        tp.wait()
        out.append((int(a[0]), peak[0] <= 17))
    assert out == [(300, True), (300, True)]


def test_dont_track(ctxs):
    out = []
    for D, tp, xp in _pools(ctxs):
        a = xp.zeros((1,), dtype=xp.float64)
        seen = []
        tp.insert_task(lambda arr, seen=seen: seen.append(float(arr[0])),
                       (a, D.INPUT | D.DONT_TRACK))
        tp.wait()
        out.append(seen)
    assert out == [[0.0], [0.0]]


def test_data_flush(ctxs):
    """Flush leaves the final version in the collection's home copy."""
    out = []
    for (D, tp, _), M in zip(_pools(ctxs), (JTiledMatrix, TiledMatrix)):
        A = M("A", 8, 8, 4, 4, dtype=np.float64)
        t = tp.tile_of(A, 0, 0)

        def setv(arr):
            arr[:] = 5.0

        tp.insert_task(setv, (t, D.INOUT))
        tp.data_flush(t)
        tp.wait()
        assert t.flushed
        out.append(np.asarray(A.data_of(0, 0).get_copy(0).value).copy())
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(out[1], np.full((4, 4), 5.0))


def _gemm_inputs(n=64, nb=16, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    return a, b


def test_dtd_gemm_correctness(ctxs):
    """DTD tiled GEMM, host bodies, against the JAX package's."""
    a, b = _gemm_inputs()
    nb, nt = 16, 4
    outs = []
    for (D, tp, _), M in zip(_pools(ctxs), (JTiledMatrix, TiledMatrix)):
        dA, dB = M.from_dense("A", a, nb, nb), M.from_dense("B", b, nb, nb)
        dC = M.from_dense("C", np.zeros_like(a), nb, nb)

        def gemm(c, x, y):
            c += x @ y

        for m in range(nt):
            for nn in range(nt):
                tc = tp.tile_of(dC, m, nn)
                for k in range(nt):
                    tp.insert_task(gemm, (tc, D.INOUT),
                                   (tp.tile_of(dA, m, k), D.INPUT),
                                   (tp.tile_of(dB, k, nn), D.INPUT))
        tp.data_flush_all()
        tp.wait()
        outs.append(dC.to_dense())
    np.testing.assert_allclose(outs[1], outs[0], **GEMM_TOL)
    np.testing.assert_allclose(outs[1], a @ b, **GEMM_TOL)


def test_task_class_reuse_and_limit(ctxs):
    for D, tp, xp in _pools(ctxs):
        a = xp.zeros((1,), dtype=xp.float64)

        def inc(arr):
            arr += 1

        for _ in range(5):
            tp.insert_task(inc, (a, D.INOUT))
        tp.wait()
        assert len(tp._classes) == 1 and float(a[0]) == 5.0
    # the class cache's limit: a 26th distinct body is refused
    tp = dtd.DTDTaskpool()
    ctxs[1].add_taskpool(tp)
    t = torch.zeros(1)
    for i in range(25):
        tp.insert_task(lambda arr, i=i: None, (t, dtd.INPUT))
    with pytest.raises(RuntimeError, match="too many DTD task classes"):
        tp.insert_task(lambda arr: None, (t, dtd.INPUT))
    tp.wait()


def test_priority_hint(ctxs):
    out = []
    for D, tp, xp in _pools(ctxs):
        a = xp.zeros((1,), dtype=xp.float64)

        def inc(arr):
            arr += 1

        t = tp.insert_task(inc, (a, D.INOUT), priority=7)
        tp.wait()
        out.append((t.priority, t.completed, float(a[0])))
    assert out == [(7, True, 1.0)] * 2


def _jax_dtd_gemm(a, b, nb, nb_cores):
    """The JAX package's DTD GEMM on its host chore: C tiles in order."""
    nt = a.shape[0] // nb
    A = [[a[m*nb:(m+1)*nb, k*nb:(k+1)*nb].copy() for k in range(nt)]
         for m in range(nt)]
    B = [[b[k*nb:(k+1)*nb, n*nb:(n+1)*nb].copy() for n in range(nt)]
         for k in range(nt)]
    C = [[np.zeros((nb, nb), np.float32) for _ in range(nt)]
         for _ in range(nt)]

    def gemm(x, y, c):
        c += x @ y

    ctx = JContext(nb_cores=nb_cores)
    tp = jdtd.DTDTaskpool()
    try:
        ctx.add_taskpool(tp)
        for m in range(nt):
            for n in range(nt):
                for k in range(nt):
                    tp.insert_task(gemm, (A[m][k], jdtd.INPUT),
                                   (B[k][n], jdtd.INPUT),
                                   (C[m][n], jdtd.INOUT))
        tp.wait(timeout=60)
    finally:
        ctx.fini()
    return np.block(C)


def _port_dtd_gemm(a, b, nb, nb_cores, window=None):
    """The port's DTD GEMM through ``insert_dtd_gemm`` (``cuda_kernel=
    "gemm"``, the bench stage's insertion order: m, n, then k): (C,
    host-body calls)."""
    nt = a.shape[0] // nb
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    A = [[ta[m*nb:(m+1)*nb, k*nb:(k+1)*nb].clone() for k in range(nt)]
         for m in range(nt)]
    B = [[tb[k*nb:(k+1)*nb, n*nb:(n+1)*nb].clone() for n in range(nt)]
         for k in range(nt)]
    C = [[torch.zeros(nb, nb) for _ in range(nt)] for _ in range(nt)]
    host_calls = []

    def gemm(x, y, c):
        host_calls.append(1)
        c += x @ y

    ctx = Context(nb_cores=nb_cores)
    tp = dtd.DTDTaskpool()
    try:
        ctx.add_taskpool(tp)
        if window is not None:
            tp.window_size, tp.threshold_size = window
        insert_dtd_gemm(tp, A, B, C, body=gemm)
        tp.data_flush_all()
        tp.wait(timeout=60)
    finally:
        ctx.fini()
    return torch.cat([torch.cat(r, 1) for r in C]).numpy(), len(host_calls)


@pytest.mark.parametrize("nb_cores", [0, 3])
@pytest.mark.parametrize("window", [None, (16, 8)],
                         ids=["window-default", "window-16"])
def test_dtd_gemm_on_the_device_module(cpu_cuda_device, nb_cores, window):
    """Every GEMM task runs on the device module (none on the host body),
    ready same-class tasks fuse into batched launches, the flush brings
    every C tile home, and C equals the JAX package's DTD GEMM.  With a
    window of 16 over 64 tasks the inserter drives the device manager
    itself (caller-driven) or waits on the workers."""
    a, b = _gemm_inputs(n=64, seed=3)
    nb = 16
    before = dict(cpu_cuda_device.tasks_by_class)
    got, host_calls = _port_dtd_gemm(a, b, nb, nb_cores, window)
    want = _jax_dtd_gemm(a, b, nb, nb_cores)
    np.testing.assert_allclose(got, want, **GEMM_TOL)
    np.testing.assert_allclose(got, a.astype(np.float64) @ b, **GEMM_TOL)
    assert host_calls == 0
    ran = cpu_cuda_device.tasks_by_class["gemm"] - before.get("gemm", 0)
    assert ran == 64
    assert cpu_cuda_device.batched_dispatches > 0


def test_dtd_gemm_without_a_device_runs_the_host_body():
    """No CUDA device registered: the class carries only its CUDA chore,
    so the host body never runs and the tasks fail with no runnable
    chore, as a PTG pool built with ``devices="cuda"`` does."""
    snapshot = list(port_registry.devices)
    port_registry.devices = [d for d in snapshot if d.type != "cuda"]
    host_calls = []

    def gemm(x, y, c):
        host_calls.append(1)
        c += x @ y

    ctx = Context(nb_cores=0)
    tp = dtd.DTDTaskpool()
    try:
        ctx.add_taskpool(tp)
        with pytest.raises(RuntimeError, match="no runnable chore"):
            tp.insert_task(gemm, (torch.ones(4, 4), dtd.INPUT),
                           (torch.ones(4, 4), dtd.INPUT),
                           (torch.zeros(4, 4), dtd.INOUT), cuda_kernel="gemm")
            tp.wait(timeout=30)
    finally:
        port_registry.devices = snapshot
        ctx.fini(timeout=30)
    assert host_calls == []
    assert [c.device_type for c in tp.task_classes[0].chores] == ["cuda"]


def test_cuda_kernel_must_be_registered(ctxs):
    tp = dtd.DTDTaskpool()
    ctxs[1].add_taskpool(tp)
    with pytest.raises(ValueError, match="no CUDA incarnation"):
        tp.insert_task(lambda x: None, (torch.zeros(1), dtd.INOUT),
                       cuda_kernel="no_such_kernel")
    tp.wait()


def test_host_body_reads_a_device_version_through_a_copy(cpu_cuda_device):
    """A host body after a device task on the same tile sees the device's
    version copied into the host tile, not the device tensor itself."""
    c = torch.zeros(8, 8)
    x = torch.eye(8)
    seen = []
    ctx = Context(nb_cores=0)
    tp = dtd.DTDTaskpool()
    try:
        ctx.add_taskpool(tp)
        tp.insert_task(lambda *_: None, (x, dtd.INPUT), (x, dtd.INPUT),
                       (c, dtd.INOUT), cuda_kernel="gemm")
        tp.insert_task(lambda t: seen.append((t is c, float(t.sum()))),
                       (c, dtd.INPUT))
        tp.wait(timeout=30)
    finally:
        ctx.fini()
    assert seen == [(True, 8.0)]
    dev_copy = tp.tile_of_array(c).data.get_copy(
        cpu_cuda_device.device_index)
    assert dev_copy is not None and dev_copy.value is not c


def test_ptg_to_dtd_gemm_and_cholesky():
    from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic
    from parsec_tpu_torch.models.cholesky import make_spd, tiled_cholesky_ptg
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg

    a, b = _gemm_inputs(n=32, seed=5)
    mats = []
    for _ in range(2):
        mats.append([TiledMatrix.from_dense("A", a, 8, 8),
                     TiledMatrix.from_dense("B", b, 8, 8),
                     TiledMatrix("C", 32, 32, 8, 8)])
    ctx = Context(nb_cores=2)
    replay = dtd.ptg_to_dtd(tiled_gemm_ptg(*mats[0], devices="cpu"), ctx)
    ctx.add_taskpool(tiled_gemm_ptg(*mats[1], devices="cpu"))
    ctx.wait(timeout=60)
    ctx.fini()
    assert replay.test()
    np.testing.assert_array_equal(mats[0][2].to_dense(),
                                  mats[1][2].to_dense())
    np.testing.assert_allclose(mats[0][2].to_dense(), a @ b, **GEMM_TOL)

    spd = make_spd(64, seed=2)
    S = [SymTwoDimBlockCyclic.from_dense(f"S{i}", spd, 16, 16)
         for i in range(2)]
    ctx = Context(nb_cores=0)
    dtd.ptg_to_dtd(tiled_cholesky_ptg(S[0], devices="cpu"), ctx)
    ctx.add_taskpool(tiled_cholesky_ptg(S[1], devices="cpu"))
    ctx.wait(timeout=60)
    ctx.fini()
    got, want = np.tril(S[0].to_dense()), np.tril(S[1].to_dense())
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.linalg.cholesky(
        spd.astype(np.float64)), atol=1e-4)


@pytest.mark.parametrize("nb_cores", [0, 3])
def test_termination_waits_for_close(nb_cores):
    """The pool holds one pending action from enqueue until ``close()``:
    with every inserted task done and nobody waiting on it, it has not
    terminated; ``close()`` ends it."""
    ctx = Context(nb_cores=nb_cores)
    tp = dtd.DTDTaskpool()
    ended = threading.Event()
    tp.add_completion_listener(lambda _: ended.set())
    try:
        ctx.add_taskpool(tp)
        a = torch.zeros(1)
        for _ in range(10):
            tp.insert_task(lambda x: x.add_(1), (a, dtd.INOUT))
        def drained():
            return tp.tdm.snapshot()["nb_tasks"] == 0

        if nb_cores == 0:
            ctx._drive_until(drained, timeout=30)
        else:
            ctx.start()
            deadline = time.monotonic() + 30
            while not drained() and time.monotonic() < deadline:
                time.sleep(0.001)
        snap = tp.tdm.snapshot()
        assert snap == {"state": "BUSY", "nb_tasks": 0,
                        "nb_pending_actions": 1}
        assert not ended.is_set() and not tp.test()
        tp.close()
        assert ended.wait(timeout=30) and tp.test()
        assert tp.tdm.snapshot()["state"] == "TERMINATED"
        assert float(a[0]) == 10.0
        ctx.wait(timeout=30)
    finally:
        ctx.fini()


def test_accessor_chains_under_thread_stress():
    """Eight workers (more than this host's cores may be), a shortened
    switch interval, 16 tiles, interleaved readers and writers: every
    write lands once, in chain order (a lost update or a reader racing
    its writer breaks the count or the snapshot)."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ctx = Context(nb_cores=8)
        tp = dtd.DTDTaskpool()
        tp.window_size, tp.threshold_size = 64, 32
        tiles = [torch.zeros(1, dtype=torch.int64) for _ in range(16)]
        seen = {i: [] for i in range(16)}

        def inc(x):
            x += 1

        def look(x, i):
            seen[i].append(int(x[0]))

        try:
            ctx.add_taskpool(tp)
            for step in range(40):
                for i, t in enumerate(tiles):
                    tp.insert_task(inc, (t, dtd.INOUT))
                    if step % 5 == 4:
                        tp.insert_task(look, (t, dtd.INPUT), (i, dtd.VALUE))
            tp.wait(timeout=60)
        finally:
            ctx.fini(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert [int(t[0]) for t in tiles] == [40] * 16
    for i in range(16):
        assert seen[i] == [5, 10, 15, 20, 25, 30, 35, 40]

"""The comm thread (``comm_thread``): one progress thread per rank.

The four-rank GEMM and Cholesky, on a 2 x 2 grid with tiles past the
short limit (every remote tile moves by GET), run with the thread off and
on: as rank threads over the device fabric on the host with the device
module's chores (``init_cuda_devices(device="cpu")``, the card's shape),
and as rank processes of ``run_multiproc`` on the device tier's host
stand-in.  The results, every rank's GETs and received payload bytes (and
across processes the bytes by tier) must be equal with the thread on and
off, and equal to the float64 reference.  A comm thread whose progress
raises must fail the run well inside its timeout; ``fini()`` joins the
thread, ``abort()`` too, and ``debug_state()`` reports it.
"""

import threading
import time

import numpy as np
import pytest

from parsec_tpu_torch.comm import run_multiproc, run_multirank
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                               TwoDimBlockCyclic)
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models import cholesky as chol
from parsec_tpu_torch.models import tiled_gemm as gemm
from parsec_tpu_torch.runtime import Context

N, NB = 192, 48         # 9 KiB tiles: past the 4 KiB short limit
BODIES = "parsec_tpu_torch.comm.mp_bodies"


@pytest.fixture
def port_param():
    saved = {}

    def set_(name, value):
        saved.setdefault(name, params.get(name))
        params.set(name, value)

    yield set_
    for name, value in saved.items():
        params.set(name, value)


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


def _inputs(kind):
    if kind == "gemm":
        rng = np.random.RandomState(11)
        a = rng.randn(N, N).astype(np.float32)
        b = rng.randn(N, N).astype(np.float32)
        return a, b, a.astype(np.float64) @ b
    a = chol.make_spd(N, seed=2)
    return a, None, np.linalg.cholesky(a.astype(np.float64))


def _body(kind, a, b, chores):
    def body(ctx, rank, nranks):
        kw = dict(P=2, Q=2, myrank=rank)
        if kind == "gemm":
            mats = (TwoDimBlockCyclic.from_dense("A", a, NB, NB, **kw),
                    TwoDimBlockCyclic.from_dense("B", b, NB, NB, **kw),
                    TwoDimBlockCyclic("C", N, N, NB, NB, **kw))
            tp = gemm.tiled_gemm_ptg(*mats, devices=chores)
        else:
            mats = (SymTwoDimBlockCyclic.from_dense("A", a.copy(), NB, NB,
                                                    **kw),)
            tp = chol.tiled_cholesky_ptg(*mats, devices=chores)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        eng = ctx.comm_engine
        st = eng.stats()
        return (mats[-1].to_dense(), st["gets"], st["payload_bytes_received"],
                eng.debug_state()["comm_thread"])
    return body


def _threads(kind, on, chores):
    params.set("comm_thread", on)
    a, b, want = _inputs(kind)
    res = run_multirank(4, _body(kind, a, b, chores), transport="device",
                        devices=["cpu"] * 4, timeout=240)
    got = sum(r[0] for r in res)
    return (np.tril(got) if kind == "cholesky" else got), want, \
        [r[1:] for r in res]


@pytest.mark.parametrize("chores", ["cuda", "cpu"])
@pytest.mark.parametrize("kind", ["gemm", "cholesky"])
def test_rank_threads_give_the_same_run_with_the_thread(
        port_param, cpu_cuda_device, kind, chores):
    port_param("comm_thread", False)
    off, want, off_stats = _threads(kind, False, chores)
    on, _want, on_stats = _threads(kind, True, chores)
    np.testing.assert_allclose(off, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(on, off, rtol=1e-5, atol=1e-5)
    assert [s[:2] for s in on_stats] == [s[:2] for s in off_stats]
    assert [s[2] for s in off_stats] == [False] * 4
    assert [s[2] for s in on_stats] == [True] * 4
    if kind == "cholesky":
        assert all(s[0] > 0 for s in on_stats)      # tiles moved by GET


def _processes(monkeypatch, on):
    params.set("comm_thread", on)
    for key, value in (("KINDS", "gemm,cholesky"), ("N", N), ("NB", NB),
                       ("SEED", 3), ("CHORES", "cuda"), ("WARMUP", "0")):
        monkeypatch.setenv(f"PARSEC_MP_{key}", str(value))
    return run_multiproc(4, f"{BODIES}:pool_body", timeout=120,
                         transport="device", device="cpu")


def test_rank_processes_give_the_same_run_with_the_thread(monkeypatch,
                                                          port_param):
    """``run_multiproc`` forwards ``comm_thread`` to the ranks."""
    port_param("comm_thread", False)
    off = _processes(monkeypatch, False)
    on = _processes(monkeypatch, True)
    assert [r["comm_thread"] for r in off] == [False] * 4
    assert [r["comm_thread"] for r in on] == [True] * 4
    for kind in ("gemm", "cholesky"):
        a, b = [r["kinds"][kind] for r in off], [r["kinds"][kind]
                                                for r in on]
        for x, y in zip(a, b):
            assert x["tiles"].keys() == y["tiles"].keys()
            for k in x["tiles"]:
                np.testing.assert_allclose(y["tiles"][k], x["tiles"][k],
                                           rtol=1e-5, atol=1e-5)
            for key in ("gets", "payload_bytes_received", "tasks"):
                assert y[key] == x[key], (kind, key)
            for key in ("payload_in", "payload_out"):
                assert y["tiers"][key] == x["tiers"][key], (kind, key)
        if kind == "cholesky":
            assert sum(x["gets"] for x in a) > 0


def test_a_failing_comm_thread_fails_the_run(port_param):
    """The thread's progress raises: the failure is recorded on its
    context, so the run raises well inside its timeout instead of
    hanging on the GETs the thread no longer serves."""
    port_param("comm_thread", True)
    a, _b, _want = _inputs("cholesky")

    def body(ctx, rank, nranks):
        ce = ctx.comm_engine.ce
        real = ce.progress

        def progress():
            if threading.current_thread().name.startswith("parsec-comm"):
                raise RuntimeError("comm thread fault")
            return real()

        ce.progress = progress
        A = SymTwoDimBlockCyclic.from_dense("A", a.copy(), NB, NB, P=2, Q=2,
                                            myrank=rank)
        ctx.add_taskpool(chol.tiled_cholesky_ptg(A, devices="cpu"))
        ctx.wait(timeout=60)

    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        run_multirank(4, body, timeout=90)
    assert time.monotonic() - t0 < 45
    cause, seen = ei.value, []
    while cause is not None:
        seen.append(str(cause))
        cause = cause.__cause__
    assert any("comm thread fault" in s for s in seen), seen
    leftover = [t for t in threading.enumerate()
                if t.name.startswith("parsec-comm")]
    for t in leftover:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in leftover)


def test_fini_joins_the_thread_and_debug_state_reports_it(port_param):
    from parsec_tpu_torch.comm.engine import InprocFabric
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    port_param("comm_thread", True)
    fabric = InprocFabric(1)
    ctx = Context(nb_cores=0, nb_ranks=1, my_rank=0)
    eng = RemoteDepEngine(ctx, fabric.attach(0))
    assert eng.debug_state()["comm_thread"] is False
    ctx.start()
    th = eng._comm_thread
    assert th is not None and th.is_alive()
    assert th.name == "parsec-comm-r0"
    state = eng.debug_state()
    assert state["comm_thread"] is True and state["rank"] == 0
    assert state["inflight_activations"] == 0 and state["staged_sends"] == {}
    from parsec_tpu_torch.prof import properties, sde
    assert "comm::rank0::inflight" in sde.snapshot()
    assert properties.has("comm", "rank0")
    ctx.fini()
    assert eng._comm_thread is None and not th.is_alive()
    assert "comm::rank0::inflight" not in sde.snapshot()
    assert not properties.has("comm", "rank0")


def test_abort_stops_the_thread(port_param):
    from parsec_tpu_torch.comm.engine import InprocFabric
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    port_param("comm_thread", True)
    ctx = Context(nb_cores=0, nb_ranks=1, my_rank=0)
    eng = RemoteDepEngine(ctx, InprocFabric(1).attach(0))
    ctx.start()
    th = eng._comm_thread
    ctx.abort()
    assert eng._comm_thread is None and not th.is_alive()
    eng.fini()


def test_the_thread_is_off_by_default():
    assert params.get("comm_thread") is False
    from parsec_tpu_torch.comm import multiproc
    assert "comm_thread" in multiproc._FORWARDED

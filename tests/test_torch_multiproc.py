"""Ranks as processes: the port's ``run_multiproc`` over the socket
fabric, against the JAX package's results.

Every rank is an interpreter of its own that imports the port (never
``jax``); the bodies are ``parsec_tpu_torch.comm.mp_bodies``.  The tests
hold the chain across 2 and 3 processes, the block-cyclic GEMM across 4
against the dense product, the device socket tier on the host stand-in
(``device="cpu"``) against the JAX package's own 4-process device tier
(broadcast sum, C to ``rtol=1e-4``, each rank's payload bytes served and
landed exactly), the gloo process group at 2 processes, and GEMM,
Cholesky and LU across 4 processes with the device module's chores (the
card's configuration, on the host) against the JAX package's
``run_multirank``: tiles to ``rtol=1e-4, atol=1e-5``, per-rank task
counts and received payload bytes exactly; the DTD GEMM in the same
launch against the JAX package's pushes; and the collectives across 3
processes (digests, the reduction, the root's egress).  A missing body
and a hanging
one surface as ``RuntimeError`` and ``TimeoutError`` with the ranks' log
tails; the device transport without a card, and without ``device="cpu"``,
raises before any rank starts.
"""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.comm.multiproc import run_multiproc as j_run_multiproc
from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JBC
from parsec_tpu.models import cholesky as jchol
from parsec_tpu.models import lu as jlu
from parsec_tpu.models import tiled_gemm as jgemm
from parsec_tpu_torch.comm import run_multiproc
from parsec_tpu_torch.comm.mp_bodies import factor_input, gemm_dense
from parsec_tpu_torch.core.params import params

BODIES = "parsec_tpu_torch.comm.mp_bodies"
J_BODIES = str(pathlib.Path(__file__).parent / "mp_bodies.py")
PKG_TOL = dict(rtol=1e-4, atol=1e-5)


def _small_gemm_inputs():
    n = 64
    rng = np.random.RandomState(23)
    return (rng.randn(n, n).astype(np.float32),
            rng.randn(n, n).astype(np.float32))


@pytest.mark.parametrize("nranks", [2, 3])
def test_chain_across_processes(nranks):
    res = run_multiproc(nranks, f"{BODIES}:chain_body", timeout=60)
    assert res[0] == 2 * nranks
    assert res[1:] == [None] * (nranks - 1)


def test_gemm_across_four_processes():
    res = run_multiproc(4, f"{BODIES}:gemm_body", timeout=60)
    a, b = _small_gemm_inputs()
    np.testing.assert_allclose(sum(res), a @ b, rtol=1e-4, atol=1e-4)


def test_device_tier_matches_the_jax_packages():
    """4 rank processes on the host stand-in of the device tier: the
    broadcast sum, C, and each rank's payload bytes served (D2H) and
    landed (H2D) equal to the JAX package's 4-process device tier."""
    got = run_multiproc(4, f"{BODIES}:device_bcast_gemm_body", timeout=90,
                        transport="device", device="cpu")
    want = j_run_multiproc(4, f"{J_BODIES}:device_bcast_gemm_body",
                           timeout=120, transport="device")
    expect = float(np.arange(4096, dtype=np.float32).sum())
    assert [r["bsum"] for r in got] == [expect] * 4
    np.testing.assert_allclose(sum(r["C"] for r in got),
                               sum(r["C"] for r in want), rtol=1e-4)
    a, b = _small_gemm_inputs()
    np.testing.assert_allclose(sum(r["C"] for r in got), a @ b, rtol=1e-4,
                               atol=1e-4)
    for key in ("payload_out", "payload_in"):
        assert [r["tiers"][key] for r in got] \
            == [r["tiers"][key] for r in want], key
    assert sum(r["tiers"]["payload_out"] for r in got) \
        == sum(r["tiers"]["payload_in"] for r in got) > 0
    assert all(r["tiers"]["control_sent"] > 0 for r in got)


def test_the_gloo_process_group_spans_two_processes():
    res = run_multiproc(2, f"{BODIES}:distributed_bootstrap_body",
                        timeout=90, transport="device", device="cpu",
                        distributed=True)
    assert [r["world_size"] for r in res] == [2, 2]
    expect = float(np.arange(4096, dtype=np.float32).sum())
    assert [r["bsum"] for r in res] == [expect, expect]


def _jax_reference(kind, n, nb, seed):
    """The JAX package's run of ``kind`` over 4 rank threads on the same
    input: the assembled result, per-rank task counts and received
    payload bytes."""
    if kind == "gemm":
        a, b = gemm_dense(n, nb, seed)
    else:
        a, b = factor_input(kind, n), None

    def body(ctx, rank, nranks):
        kw = dict(P=2, Q=2, myrank=rank)
        if kind == "gemm":
            mats = (JBC.from_dense("A", a, nb, nb, **kw),
                    JBC.from_dense("B", b, nb, nb, **kw),
                    JBC("C", n, n, nb, nb, **kw))
            tp = jgemm.tiled_gemm_ptg(*mats, devices="cpu")
        elif kind == "cholesky":
            mats = (JSym.from_dense("A", a.copy(), nb, nb, **kw),)
            tp = jchol.tiled_cholesky_ptg(*mats, devices="cpu")
        else:
            mats = (JBC.from_dense("A", a.copy(), nb, nb, **kw),)
            tp = jlu.tiled_lu_ptg(*mats, devices="cpu")
        ctx.add_taskpool(tp)
        ntasks = tp.nb_local_tasks()
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        return (mats[-1].to_dense(), ntasks,
                ctx.comm_engine.payload_bytes_received)

    res = j_run_multirank(4, body, timeout=120)
    got = sum(r[0] for r in res)
    return (np.tril(got) if kind == "cholesky" else got,
            [r[1] for r in res], [r[2] for r in res])


def _jax_dtd_reference(n, nb, seed):
    """The JAX package's DTD GEMM over 4 rank threads: C, and each rank's
    local tasks and landed pushes."""
    from parsec_tpu.dtd import insert as jinsert

    class Counting(jinsert.DTDTaskpool):
        local = 0

        def _insert_task_locked(self, *args):
            task = super()._insert_task_locked(*args)
            self.local += not task.is_shell
            return task

    a, b = gemm_dense(n, nb, seed)

    def gemm(x, y, c):
        return c + x @ y

    def body(ctx, rank, nranks):
        kw = dict(P=2, Q=2, myrank=rank)
        A = JBC.from_dense("A", a, nb, nb, **kw)
        B = JBC.from_dense("B", b, nb, nb, **kw)
        C = JBC("C", n, n, nb, nb, **kw)
        tp = Counting("dtd_gemm")
        ctx.add_taskpool(tp)
        for m in range(C.mt):
            for nn in range(C.nt):
                for k in range(A.nt):
                    tp.insert_task(
                        gemm, (tp.tile_of(A, m, k), jinsert.INPUT),
                        (tp.tile_of(B, k, nn), jinsert.INPUT),
                        (tp.tile_of(C, m, nn),
                         jinsert.INOUT | jinsert.AFFINITY), name="gemm")
        tp.data_flush_all()
        tp.wait(timeout=120)
        ctx.comm_barrier()
        return (C.to_dense(), tp.local,
                sum(x.landed for x in tp._arrivals.values()))

    res = j_run_multirank(4, body, timeout=120)
    return (sum(r[0] for r in res), [r[1] for r in res],
            [r[2] for r in res])


def test_factorizations_across_four_processes(monkeypatch):
    """GEMM, Cholesky, LU and the DTD GEMM across 4 rank processes on the
    device tier's host stand-in, each rank's chores on its own device
    module, against the JAX package's in-process ranks; each kind after
    its 2 x 2-tile warm-up, whose counts stay out of the kind's record."""
    n, nb, seed = 192, 48, 3    # tiles past the short limit: all by GET
    for key, value in (("KINDS", "gemm,cholesky,lu,dtd"), ("N", n),
                       ("NB", nb),
                       ("SEED", seed), ("CHORES", "cuda"), ("WARMUP", "1")):
        monkeypatch.setenv(f"PARSEC_MP_{key}", str(value))
    res = run_multiproc(4, f"{BODIES}:pool_body", timeout=120,
                        transport="device", device="cpu")
    assert [r["modules"] for r in res] == [[]] * 4
    for kind in ("gemm", "cholesky", "lu"):
        recs = [r["kinds"][kind] for r in res]
        got = np.zeros((n, n), np.float32)
        for rec in recs:
            for (i, j), tile in rec["tiles"].items():
                got[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = tile
        want, jtasks, jbytes = _jax_reference(kind, n, nb, seed)
        np.testing.assert_allclose(got, want, **PKG_TOL)
        assert [r["tasks"] for r in recs] == jtasks, kind
        assert [r["payload_bytes_received"] for r in recs] == jbytes, kind
        assert [r["tiers"]["payload_in"] for r in recs] == jbytes, kind
        assert sum(r["tiers"]["payload_out"] for r in recs) == sum(jbytes)
        # every task ran on the rank's device module, none on a host chore
        assert [sum(r["dev"]["tasks_by_class"].values()) for r in recs] \
            == jtasks
        assert all(r["cpu_tasks"] == 0 for r in recs)
        assert {r["termdet"] for r in recs} == \
            {"fourcounter" if kind == "cholesky" else "local"}
    # the DTD GEMM: every tile product on the device modules, A and B
    # tiles pushed across the processes as the JAX package's ranks push
    recs = [r["kinds"]["dtd"] for r in res]
    want, jtasks, jpushes = _jax_dtd_reference(n, nb, seed)
    np.testing.assert_allclose(sum(r["C"] for r in recs), want, **PKG_TOL)
    assert [r["tasks"] for r in recs] == jtasks
    assert [r["pushes"] for r in recs] == jpushes
    assert sum(r["dev"]["tasks_by_class"].get("gemm", 0) for r in recs) \
        == (n // nb) ** 3


def test_the_collectives_across_three_processes():
    """The staged broadcast and the tree reduction across 3 processes:
    every rank holds the root's bytes, rank 0 the sum, and the root sends
    one payload a tree child (binomial: 2 children of 3 positions)."""
    saved = params.get("comm_coll_bench_bytes")
    params.set("comm_coll_bench_bytes", 1 << 16)    # forwarded to ranks
    try:
        res = run_multiproc(
            3, "parsec_tpu_torch.comm.collectives:_mp_collective_body",
            timeout=60)
    finally:
        params.set("comm_coll_bench_bytes", saved)
    root = np.arange(1 << 14, dtype=np.float32) * 0.5 + 7.0
    digest = hashlib.sha256(root.tobytes()).hexdigest()
    assert [r["digest"] for r in res] == [digest] * 3
    assert res[0]["reduce0"] == 6.0 and res[0]["tree"] == "binomial"
    tx = res[0]["peer_stats"]["tx"]
    assert sorted(tx) == [1, 2] and all(
        1 << 16 < tx[d]["bytes"] < 2 << 16 for d in tx)


def test_a_missing_body_fails_with_the_log_tail():
    with pytest.raises(RuntimeError, match="no_such_body"):
        run_multiproc(1, f"{BODIES}:no_such_body", timeout=60)


def test_a_hanging_body_times_out_with_the_log_tail():
    with pytest.raises(TimeoutError, match="did not finish") as e:
        run_multiproc(1, f"{BODIES}:hang_body", timeout=5)
    assert "rank0.log" in str(e.value)


def test_the_device_transport_needs_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the device transport binds it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_multiproc(2, f"{BODIES}:chain_body", transport="device")
    with pytest.raises(ValueError):
        run_multiproc(2, f"{BODIES}:chain_body", distributed=True)
    from parsec_tpu_torch.comm.device_socket import DeviceSocketCommEngine
    from parsec_tpu_torch.comm.multiproc import _free_port_base
    from parsec_tpu_torch.comm.socket_fabric import SocketFabric
    fabric = SocketFabric(1, 0, base_port=_free_port_base(1))
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceSocketCommEngine(fabric)
    finally:
        fabric.close()

"""Distributed DTD GEMM: the rank body and its check, shared by the tests
and ``chip_smoke.py``.

Port of ``parsec_tpu/dtd/multirank_check.py`` (the analog of the
reference's ``dtd_test_simple_gemm.c`` under ``mpiexec -np N``): every
rank runs the same insertion program, ``AFFINITY`` routes each GEMM to
its C tile's owner, A and B tiles cross ranks as pushes of their home
values, and each C tile's k-chain serializes on its owner.  With
``cuda_kernel="gemm"`` every GEMM runs K1 on the rank's device module.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from ..comm.multirank import run_multirank
from ..data_dist.matrix import TwoDimBlockCyclic
from ..ops import gemm as _k1  # noqa: F401  registers the "gemm" incarnation
from .insert import AFFINITY, INOUT, INPUT, DTDTaskpool


def _gemm_kernel(a, b, c):
    """The host body: a functional update."""
    return c + a @ b


def dtd_gemm_rank_body(a: np.ndarray, b: np.ndarray, nb: int, P: int,
                       Q: int, cuda_kernel: str | None = None,
                       timeout: float = 120.0):
    """The per-rank body of a distributed DTD GEMM ``C = A @ B`` on a
    P x Q block-cyclic grid.  It returns this rank's tiles of C
    (``to_dense``), its local task count, the pushes it received and
    their bytes, the seconds spent inside ``insert_task``, and the
    ``time.perf_counter()``
    stamps of the first insertion and of ``wait``'s return."""

    def body(ctx, rank, nranks):
        n = a.shape[0]
        A = TwoDimBlockCyclic.from_dense("A", a, nb, nb, P=P, Q=Q,
                                         myrank=rank)
        B = TwoDimBlockCyclic.from_dense("B", b, nb, nb, P=P, Q=Q,
                                         myrank=rank)
        C = TwoDimBlockCyclic("C", n, n, nb, nb, P=P, Q=Q, myrank=rank)
        tp = DTDTaskpool("dtd_gemm")
        ctx.add_taskpool(tp)
        insert_s = 0.0
        t0 = time.perf_counter()
        for m in range(C.mt):
            for nn in range(C.nt):
                for k in range(A.nt):
                    tA = tp.tile_of(A, m, k)
                    tB = tp.tile_of(B, k, nn)
                    tC = tp.tile_of(C, m, nn)
                    t1 = time.perf_counter()
                    tp.insert_task(_gemm_kernel, (tA, INPUT), (tB, INPUT),
                                   (tC, INOUT | AFFINITY), name="gemm",
                                   cuda_kernel=cuda_kernel)
                    insert_s += time.perf_counter() - t1
        tp.data_flush_all()
        tp.wait(timeout=timeout)
        t_wait = time.perf_counter()
        ctx.comm_barrier()
        return {"C": C.to_dense(), "tasks": tp.local_tasks,
                "pushes": tp.pushes_received,
                "push_bytes": tp.push_bytes_received, "insert_s": insert_s,
                "t_start": t0, "t_wait": t_wait}

    return body


def dtd_gemm_multirank_check(nranks: int, n: int = 48, nb: int = 16,
                             transport: str = "inproc",
                             devices: list | None = None,
                             cuda_kernel: str | None = None) -> list[Any]:
    """Run the distributed DTD GEMM on ``nranks`` ranks and assert that
    the assembled C matches the dense product (raises on mismatch);
    returns the per-rank records."""
    rng = np.random.RandomState(11)
    a = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n, n).astype(np.float32)
    P = 2 if nranks % 2 == 0 else 1
    Q = nranks // P
    parts = run_multirank(
        nranks, dtd_gemm_rank_body(a, b, nb, P, Q, cuda_kernel=cuda_kernel),
        transport=transport, devices=devices, timeout=240)
    got = sum(p["C"] for p in parts)
    np.testing.assert_allclose(got, a @ b, rtol=1e-4)
    return parts

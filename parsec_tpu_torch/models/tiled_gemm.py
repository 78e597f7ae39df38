"""Flagship: tiled GEMM as a PTG taskpool.

Port of :func:`tiled_gemm_ptg` and :func:`gemm_flops` from
``parsec_tpu/models/tiled_gemm.py``: a GEMM(m,n,k) task class whose C flow
chains along k, run through the dynamic runtime.  With ``devices="cuda"``
(the default) the class carries only the device chore, resolved by name
(``dyld="gemm"``) to the CUDA body — there is no CPU chore a missing
device could fall through to.  ``devices="cpu"`` carries only the host
body.

:func:`tiled_gemm_fused` is the one-program form for dense operands
(what ``lower_taskpool(tiled_gemm_ptg(A, B, C))`` runs on identity tile
grids): one launch of the K1 kernel.

:func:`insert_dtd_gemm` is the same product through DTD insertion (the
reference's ``dtd_test_simple_gemm.c``): one task per (m, n, k), each on
the card as K1.

Over several ranks (``TwoDimBlockCyclic`` grids, one pool a rank through
:func:`parsec_tpu_torch.comm.run_multirank`) each GEMM runs on C's rank,
which reads its A and B tiles through their collections: no tile crosses
ranks, and the ranks' ``to_dense`` of C sum to the product.

Left out until later slices: the recursive variant.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from .. import ptg
from ..data_dist.matrix import TiledMatrix
from ..dtd.insert import INOUT, INPUT
from ..ops import gemm as gemm_ops


def tiled_gemm_ptg(A: TiledMatrix, B: TiledMatrix, C: TiledMatrix,
                   devices: str = "cuda") -> ptg.PTGTaskpool:
    """Build the GEMM(m,n,k) PTG over tiled matrices: C += A·B.

    Flows (positionally fixed for the kernel bodies): 0=A READ, 1=B READ,
    2=C RW chained over k.
    """
    if devices not in ("cuda", "cpu"):
        raise ValueError(f"tiled_gemm_ptg: devices must be 'cuda' or 'cpu', "
                         f"got {devices!r}")
    MT, NT, KT = C.mt, C.nt, A.nt
    if not (A.mt == MT and B.nt == NT and B.mt == KT):
        raise ValueError(f"tiled_gemm_ptg: tile grids do not chain: "
                         f"A {A.mt}x{A.nt}, B {B.mt}x{B.nt}, C {MT}x{NT}")

    p = ptg.PTGBuilder("tiled_gemm", A=A, B=B, C=C, MT=MT, NT=NT, KT=KT)
    t = p.task("GEMM",
               m=ptg.span(0, lambda g, l: g.MT - 1),
               n=ptg.span(0, lambda g, l: g.NT - 1),
               k=ptg.span(0, lambda g, l: g.KT - 1))
    t.affinity("C", lambda g, l: (l.m, l.n))
    t.priority(lambda g, l: g.KT - l.k)   # deeper chains first
    fa = t.flow("A", ptg.READ)
    fa.input(data=("A", lambda g, l: (l.m, l.k)))
    fb = t.flow("B", ptg.READ)
    fb.input(data=("B", lambda g, l: (l.k, l.n)))
    fc = t.flow("C", ptg.RW)
    fc.input(data=("C", lambda g, l: (l.m, l.n)), guard=lambda g, l: l.k == 0)
    fc.input(pred=("GEMM", "C", lambda g, l: {"m": l.m, "n": l.n, "k": l.k - 1}),
             guard=lambda g, l: l.k > 0)
    fc.output(succ=("GEMM", "C", lambda g, l: {"m": l.m, "n": l.n, "k": l.k + 1}),
              guard=lambda g, l: l.k < g.KT - 1)
    fc.output(data=("C", lambda g, l: (l.m, l.n)),
              guard=lambda g, l: l.k == g.KT - 1)
    # flops-based time estimate feeds best-device selection
    flops = 2.0 * A.mb * C.nb * A.nb
    t.time_estimate(lambda task, dev: flops / (dev.gflops_fp32 * 1e9))
    if devices == "cuda":
        t.body(device="cuda", dyld="gemm")
    else:
        t.body(_cpu_wrap, device="cpu")
    return p.build()


def _cpu_wrap(es: Any, task: Any, g: Any, l: Any) -> None:
    gemm_ops.gemm_cpu_body(es, task)


def tiled_gemm_fused(a: Any, b: Any, c: Any,
                     precision: str | None = None) -> Any:
    """``c + a@b`` on dense operands in one call: K1 on CUDA tensors, the
    plain version on CPU tensors; fp32 accumulate, in ``c``'s dtype.
    ``precision`` is ``"default"`` or ``"highest"`` (None: the
    ``gemm_precision`` knob), as ``gemm_update`` takes it."""
    return gemm_ops.gemm_update(a, b, c, precision=precision)


def gemm_flops(M: int, N: int, K: int) -> float:
    return 2.0 * M * N * K


def _dtd_gemm_body(a: Any, b: Any, c: Any) -> None:
    """The DTD GEMM class's host body.  It names the class; a task
    inserted with ``cuda_kernel="gemm"`` runs K1 and never calls it."""
    c += a @ b


def insert_dtd_gemm(tp: Any, A: list, B: list, C: list,
                    body: Callable = _dtd_gemm_body) -> float:
    """Insert ``C += A @ B`` into the DTD pool ``tp`` (enqueued in a
    context): ``A``, ``B`` and ``C`` are square grids (lists of rows) of
    host tiles, and each ``(m, n, k)``, in that order, is one
    ``insert_task(body, (A[m][k], INPUT), (B[k][n], INPUT), (C[m][n],
    INOUT), cuda_kernel="gemm")``.  Returns the seconds the calling
    thread spent inside ``insert_task``."""
    nt = len(C)
    spent = 0.0
    for m in range(nt):
        for n in range(nt):
            for k in range(nt):
                t0 = time.perf_counter()
                tp.insert_task(body, (A[m][k], INPUT), (B[k][n], INPUT),
                               (C[m][n], INOUT), cuda_kernel="gemm")
                spent += time.perf_counter() - t0
    return spent

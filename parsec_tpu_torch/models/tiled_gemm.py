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

:func:`tiled_gemm_recursive_ptg` is the GEMM whose bodies recurse
(``PARSEC_DEV_RECURSIVE``): each outer GEMM(m,n,k) views its three flow
tiles as :class:`~parsec_tpu_torch.data_dist.matrix.SubtileCollection`
views and runs a nested :func:`tiled_gemm_ptg` over them, whose chore is K1 on
the card (``devices="cuda"``) or the host body (``devices="cpu"``, the
JAX function's exact counterpart).
"""

from __future__ import annotations

import time
from typing import Any, Callable

from .. import ptg
from ..data_dist.matrix import SubtileCollection, TiledMatrix
from ..dtd.insert import INOUT, INPUT
from ..ops import gemm as gemm_ops
from ..runtime.recursive import recursive_call
from ..runtime.task import HOOK_RETURN_DONE, HOOK_RETURN_NEXT


def _gemm_graph(name: str, A: TiledMatrix, B: TiledMatrix,
                C: TiledMatrix) -> tuple[ptg.PTGBuilder, Any]:
    """The GEMM(m,n,k) DAG both builders share: the builder and its task
    class, with its flows and no chore yet."""
    MT, NT, KT = C.mt, C.nt, A.nt
    if not (A.mt == MT and B.nt == NT and B.mt == KT):
        raise ValueError(f"{name}: tile grids do not chain: "
                         f"A {A.mt}x{A.nt}, B {B.mt}x{B.nt}, C {MT}x{NT}")
    p = ptg.PTGBuilder(name, A=A, B=B, C=C, MT=MT, NT=NT, KT=KT)
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
    return p, t


def _pool_chore(t: Any, devices: str) -> None:
    if devices == "cuda":
        t.body(device="cuda", dyld="gemm")
    else:
        t.body(_cpu_wrap, device="cpu")


def tiled_gemm_ptg(A: TiledMatrix, B: TiledMatrix, C: TiledMatrix,
                   devices: str = "cuda") -> ptg.PTGTaskpool:
    """Build the GEMM(m,n,k) PTG over tiled matrices: C += A·B.

    Flows (positionally fixed for the kernel bodies): 0=A READ, 1=B READ,
    2=C RW chained over k.
    """
    if devices not in ("cuda", "cpu"):
        raise ValueError(f"tiled_gemm_ptg: devices must be 'cuda' or 'cpu', "
                         f"got {devices!r}")
    p, t = _gemm_graph("tiled_gemm", A, B, C)
    # flops-based time estimate feeds best-device selection
    flops = 2.0 * A.mb * C.nb * A.nb
    t.time_estimate(lambda task, dev: flops / (dev.gflops_fp32 * 1e9))
    _pool_chore(t, devices)
    return p.build()


def _cpu_wrap(es: Any, task: Any, g: Any, l: Any) -> None:
    gemm_ops.gemm_cpu_body(es, task)


def tiled_gemm_recursive_ptg(A: TiledMatrix, B: TiledMatrix, C: TiledMatrix,
                             sub_mb: int, sub_nb: int, min_tile: int = 0,
                             devices: str = "cuda") -> ptg.PTGTaskpool:
    """The GEMM PTG whose bodies recurse: each GEMM(m,n,k) spawns a
    nested :func:`tiled_gemm_ptg` over ``sub_mb x sub_nb`` sub-tiles of
    its own flow tiles and detaches until it drains.

    ``devices`` is the chore of the nested pools and of the cut-off:
    ``"cuda"`` (each sub-GEMM a K1 task) or ``"cpu"`` (the host body).
    ``min_tile`` is the recursion cut-off, the role of a recursive
    chore's evaluate hook: a tile whose dims are all ``<= min_tile``
    skips the recursive chore and takes the pool's own chore, K1 on the
    whole tile (``"cuda"``) or the host body (``"cpu"``)."""
    if devices not in ("cuda", "cpu"):
        raise ValueError(f"tiled_gemm_recursive_ptg: devices must be "
                         f"'cuda' or 'cpu', got {devices!r}")
    p, t = _gemm_graph("tiled_gemm_rec", A, B, C)

    def _too_small(es: Any, task: Any) -> int:
        if max(task.data[2].value.shape) <= min_tile:
            return HOOK_RETURN_NEXT   # fall through to the pool's chore
        return HOOK_RETURN_DONE

    def _recurse(es: Any, task: Any, g: Any, l: Any) -> int:
        a = SubtileCollection.of_copy(task.data[0], sub_mb, sub_nb,
                                      name=f"Asub{task.key}")
        b = SubtileCollection.of_copy(task.data[1], sub_mb, sub_nb,
                                      name=f"Bsub{task.key}")
        c = SubtileCollection.of_copy(task.data[2], sub_mb, sub_nb,
                                      name=f"Csub{task.key}")
        inner = tiled_gemm_ptg(a, b, c, devices=devices)

        def _release_inputs(tp: Any, outer: Any) -> None:
            a.release_copies()
            b.release_copies()

        # A's and B's sub-tiles were only read: their device copies go
        # and their parents keep their versions.  C's sync_parent
        # publishes the sub-writes into the outer flow tile before the
        # outer task completes
        return recursive_call(es, task, inner, callback=_release_inputs,
                              collections=(c,))

    t.body(_recurse, device="recursive",
           evaluate=_too_small if min_tile else None)
    _pool_chore(t, devices)
    return p.build()


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

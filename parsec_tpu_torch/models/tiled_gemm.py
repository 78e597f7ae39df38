"""Flagship: tiled GEMM as a PTG taskpool.

Port of :func:`tiled_gemm_ptg` and :func:`gemm_flops` from
``parsec_tpu/models/tiled_gemm.py``: a GEMM(m,n,k) task class whose C flow
chains along k, run through the dynamic runtime.  With ``devices="cuda"``
(the default) the class carries only the device chore, resolved by name
(``dyld="gemm"``) to the CUDA body — there is no CPU chore a missing
device could fall through to.  ``devices="cpu"`` carries only the host
body.

Left out until later slices: the recursive variant and the fused
single-program path (``tiled_gemm_fused``), which the lowering slice
brings.
"""

from __future__ import annotations

from typing import Any

from .. import ptg
from ..data_dist.matrix import TiledMatrix
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


def gemm_flops(M: int, N: int, K: int) -> float:
    return 2.0 * M * N * K

"""The diagonal tiles' factors and inverses (``ops/factor.py``: ``potrf``,
``tri_inverse``): the profiler's device milliseconds a traced solve of the
operations whose names hold one of the patterns of ``factor_ms.json``:
the two hand kernels of ``csrc/factor.cu``, and the factor and solve
kernels that ``cholesky_ex`` (``getrf_wo_pivot``, ``xxtrf4_set_info_ker``)
and ``solve_triangular`` (``kernel_trsm_l_mul32``) launch on the library
route.  Only names that no other operation of a solve carries: the
library route's fills, compares, ``tril`` and fp32 GEMMs are left out,
since any other fill or fp32 GEMM of the solve would carry the same
names, and so are those calls' layout copies, which ``movement_ms``
counts."""

import json
from pathlib import Path

UNIT = "ms"
BETTER = "lower"
MOVES = "tflops"
PATTERNS = json.loads(
    (Path(__file__).with_suffix(".json")).read_text())["patterns"]


def read(run):
    t = run.trace
    if t is None or not t.solves:
        return None
    ns = sum(v for n, v in t.device_ns.items()
             if any(p in n for p in PATTERNS))
    return ns / 1e6 / t.solves if ns else None

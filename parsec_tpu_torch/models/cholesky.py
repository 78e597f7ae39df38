"""Tiled Cholesky factorization as a PTG taskpool (POTRF/TRSM/SYRK/GEMM).

Port of ``parsec_tpu/models/cholesky.py``: the DPLASMA-style ``dpotrf``
over the lower symmetric distribution, factorizing in place ``A = L·Lᵀ``
with four task classes whose mix shifts with ``k``:

- ``POTRF(k)``: ``T = chol(A[k,k])``; feeds every ``TRSM(m,k)``.
- ``TRSM(m,k)``: ``C = A[m,k] · inv(Lₖₖ)ᵀ``; feeds ``SYRK(m,k)`` and the
  ``GEMM``\\ s of row/column ``m``.
- ``SYRK(m,k)``: ``A[m,m] -= C·Cᵀ`` accumulated along ``k``; the last one
  feeds ``POTRF(m)``.
- ``GEMM(m,n,k)``: ``A[m,n] -= A[m,k]·A[n,k]ᵀ`` accumulated along ``k``;
  the last one feeds ``TRSM(m,n)``.

The four incarnations (``potrf``, ``trsm_rlt``, ``syrk_ln``,
``gemm_nt``) are each registered once as a batched list form, with a
stacked form for the wavefront lowering; the per-task device body and the
host chore run the same list form (:mod:`parsec_tpu_torch.ops.factor`).
So the device module's fused same-class dispatch and the wavefront pass
both take them, and every tile product runs on K1 under the
``gemm_precision`` knob, as the JAX package's ``_mm_precision`` has it:

- POTRF: ``torch.linalg.cholesky_ex`` (no host sync; NaNs on failure);
- TRSM: the inverse of ``Lₖₖ`` from one identity solve, each distinct
  diagonal tile of a batch once, then K1's transposed form with no C
  (``C · inv(Lₖₖ)ᵀ``);
- SYRK and GEMM: K1's transposed, subtracting form (``t - a·aᵀ``,
  ``c - a·bᵀ``).

None of them is registered as bilinear (the JAX package's are not), so
chain collapse never claims the pool and the lowering takes the
wavefront pass.  With ``devices="cuda"`` (the default) the classes carry
only the device chores; ``devices="cpu"`` carries only the host chores,
where the same list forms take the CPU route of every operation (the
JAX package's host bodies solve the TRSM directly; here the host chore
uses the inverse as the device does).

Over several ranks (a ``SymTwoDimBlockCyclic`` with ``P``, ``Q`` and
``myrank``, one pool a rank through :func:`parsec_tpu_torch.comm.run_multirank`)
each task runs on its tile's rank: POTRF's factor reaches the TRSMs, and
the TRSMs' panels the SYRKs and GEMMs, by the comm layer; each rank's
``to_dense`` holds its own tiles, and their sum is the factor.

Left out: ``devices="auto"`` (a class with both chores) and the upper
distribution (``uplo=UPPER`` raises).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ptg
from ..data_dist.matrix import SymTwoDimBlockCyclic, TiledMatrix
from ..device.kernels import register_kernel
from ..ops import gemm as gemm_ops
from ..ops.factor import host_body, potrf, tile_body, tri_inverse, \
    tri_inverse_tiles
from ..ptg.lowering import register_traceable

# ---------------------------------------------------------------------------
# the four incarnations: list forms (one call over a batch of tasks) and
# stacked forms (a leading group axis), in flow declaration order
# ---------------------------------------------------------------------------


def potrf_tiles(ts: list[torch.Tensor]) -> list[torch.Tensor]:
    """POTRF over a list of diagonal tiles (one a level on both paths)."""
    return [potrf(t) for t in ts]


def trsm_tiles(ls: list[torch.Tensor],
               cs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``X = C · inv(L)ᵀ`` for each (L, C): the inverses once per distinct
    L, then one K1 launch of ``C @ inv(L)ᵀ`` (transposed B, no C)."""
    invs = tri_inverse_tiles(ls, upper=False)
    return gemm_ops.gemm_update_tiles([c.float() for c in cs], invs,
                                      trans_b=True)


def syrk_tiles(as_: list[torch.Tensor],
               ts: list[torch.Tensor]) -> list[torch.Tensor]:
    """``T - A·Aᵀ``: one K1 launch, A's tile as both A and B."""
    as_ = [a.float() for a in as_]
    return gemm_ops.gemm_update_tiles(as_, as_, [t.float() for t in ts],
                                      trans_b=True, subtract=True)


def gemm_nt_tiles(as_: list[torch.Tensor], bs: list[torch.Tensor],
                  cs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``C - A·Bᵀ``: one K1 launch."""
    return gemm_ops.gemm_update_tiles(
        [a.float() for a in as_], [b.float() for b in bs],
        [c.float() for c in cs], trans_b=True, subtract=True)


def trsm_stacked(ls: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    return gemm_ops.gemm_update_stacked(cs.float(), tri_inverse(ls, False),
                                        trans_b=True)


def syrk_stacked(as_: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    a = as_.float().contiguous()
    return gemm_ops.gemm_update_stacked(a, a, ts.float(), trans_b=True,
                                        subtract=True)


def gemm_nt_stacked(as_: torch.Tensor, bs: torch.Tensor,
                    cs: torch.Tensor) -> torch.Tensor:
    return gemm_ops.gemm_update_stacked(as_.float(), bs.float(), cs.float(),
                                        trans_b=True, subtract=True)


_FORMS = {"potrf": (potrf_tiles, potrf), "trsm_rlt": (trsm_tiles,
                                                      trsm_stacked),
          "syrk_ln": (syrk_tiles, syrk_stacked),
          "gemm_nt": (gemm_nt_tiles, gemm_nt_stacked)}
for _name, (_tiles, _stacked) in _FORMS.items():
    register_kernel(_name, "cuda", tile_body(_tiles))
    register_traceable(_name, _tiles, stacked=_stacked)


# ---------------------------------------------------------------------------
# the PTG
# ---------------------------------------------------------------------------


def tiled_cholesky_ptg(A: TiledMatrix,
                       devices: str = "cuda") -> ptg.PTGTaskpool:
    """Build the lower-Cholesky PTG over a square tile grid (the lower
    triangle of a :class:`SymTwoDimBlockCyclic`, factored in place)."""
    if devices not in ("cuda", "cpu"):
        raise ValueError(f"tiled_cholesky_ptg: devices must be 'cuda' or "
                         f"'cpu', got {devices!r}")
    if A.mt != A.nt:
        raise ValueError(f"tiled_cholesky_ptg: {A.mt}x{A.nt} tiles; "
                         f"Cholesky needs a square tile grid")
    if getattr(A, "uplo", SymTwoDimBlockCyclic.LOWER) \
            != SymTwoDimBlockCyclic.LOWER:
        raise ValueError("tiled_cholesky_ptg: the upper distribution is "
                         "not ported; store the lower triangle")
    NT = A.mt
    p = ptg.PTGBuilder("cholesky", A=A, NT=NT)

    # ---- POTRF(k) ---------------------------------------------------------
    po = p.task("POTRF", k=ptg.span(0, lambda g, l: g.NT - 1))
    po.affinity("A", lambda g, l: (l.k, l.k))
    po.priority(lambda g, l: 3 * (g.NT - l.k) + 3)   # critical path first
    fT = po.flow("T", ptg.RW)
    fT.input(data=("A", lambda g, l: (l.k, l.k)), guard=lambda g, l: l.k == 0)
    fT.input(pred=("SYRK", "T", lambda g, l: {"m": l.k, "k": l.k - 1}),
             guard=lambda g, l: l.k > 0)
    # range arrow: -> T TRSM(k+1..NT-1, k)
    fT.output(succ=("TRSM", "T",
                    lambda g, l: [{"m": m, "k": l.k}
                                  for m in range(l.k + 1, g.NT)]),
              guard=lambda g, l: l.k < g.NT - 1)
    fT.output(data=("A", lambda g, l: (l.k, l.k)))

    # ---- TRSM(m, k), m > k ------------------------------------------------
    tr = p.task("TRSM",
                k=ptg.span(0, lambda g, l: g.NT - 2),
                m=ptg.span(lambda g, l: l.k + 1, lambda g, l: g.NT - 1))
    tr.affinity("A", lambda g, l: (l.m, l.k))
    tr.priority(lambda g, l: 3 * (g.NT - l.m) + 2)
    tT = tr.flow("T", ptg.READ)
    tT.input(pred=("POTRF", "T", lambda g, l: {"k": l.k}))
    tC = tr.flow("C", ptg.RW)
    tC.input(data=("A", lambda g, l: (l.m, l.k)), guard=lambda g, l: l.k == 0)
    tC.input(pred=("GEMM", "C",
                   lambda g, l: {"m": l.m, "n": l.k, "k": l.k - 1}),
             guard=lambda g, l: l.k > 0)
    tC.output(succ=("SYRK", "A", lambda g, l: {"m": l.m, "k": l.k}))
    # range arrow: A-operand of GEMM(m, k+1..m-1, k)
    tC.output(succ=("GEMM", "A",
                    lambda g, l: [{"m": l.m, "n": n, "k": l.k}
                                  for n in range(l.k + 1, l.m)]),
              guard=lambda g, l: l.m - l.k > 1)
    # range arrow: B-operand of GEMM(m+1..NT-1, m, k)
    tC.output(succ=("GEMM", "B",
                    lambda g, l: [{"m": mm, "n": l.m, "k": l.k}
                                  for mm in range(l.m + 1, g.NT)]),
              guard=lambda g, l: l.m < g.NT - 1)
    tC.output(data=("A", lambda g, l: (l.m, l.k)))

    # ---- SYRK(m, k), k < m ------------------------------------------------
    sy = p.task("SYRK",
                m=ptg.span(1, lambda g, l: g.NT - 1),
                k=ptg.span(0, lambda g, l: l.m - 1))
    sy.affinity("A", lambda g, l: (l.m, l.m))
    sy.priority(lambda g, l: 3 * (g.NT - l.m) + 1)
    sA = sy.flow("A", ptg.READ)
    sA.input(pred=("TRSM", "C", lambda g, l: {"m": l.m, "k": l.k}))
    sT = sy.flow("T", ptg.RW)
    sT.input(data=("A", lambda g, l: (l.m, l.m)), guard=lambda g, l: l.k == 0)
    sT.input(pred=("SYRK", "T", lambda g, l: {"m": l.m, "k": l.k - 1}),
             guard=lambda g, l: l.k > 0)
    sT.output(succ=("SYRK", "T", lambda g, l: {"m": l.m, "k": l.k + 1}),
              guard=lambda g, l: l.k < l.m - 1)
    sT.output(succ=("POTRF", "T", lambda g, l: {"k": l.m}),
              guard=lambda g, l: l.k == l.m - 1)

    # ---- GEMM(m, n, k), k < n < m ----------------------------------------
    ge = p.task("GEMM",
                m=ptg.span(2, lambda g, l: g.NT - 1),
                n=ptg.span(1, lambda g, l: l.m - 1),
                k=ptg.span(0, lambda g, l: l.n - 1))
    ge.affinity("A", lambda g, l: (l.m, l.n))
    ge.priority(lambda g, l: 3 * (g.NT - l.m))
    gA = ge.flow("A", ptg.READ)
    gA.input(pred=("TRSM", "C", lambda g, l: {"m": l.m, "k": l.k}))
    gB = ge.flow("B", ptg.READ)
    gB.input(pred=("TRSM", "C", lambda g, l: {"m": l.n, "k": l.k}))
    gC = ge.flow("C", ptg.RW)
    gC.input(data=("A", lambda g, l: (l.m, l.n)), guard=lambda g, l: l.k == 0)
    gC.input(pred=("GEMM", "C",
                   lambda g, l: {"m": l.m, "n": l.n, "k": l.k - 1}),
             guard=lambda g, l: l.k > 0)
    gC.output(succ=("GEMM", "C",
                    lambda g, l: {"m": l.m, "n": l.n, "k": l.k + 1}),
              guard=lambda g, l: l.k < l.n - 1)
    gC.output(succ=("TRSM", "C", lambda g, l: {"m": l.m, "k": l.n}),
              guard=lambda g, l: l.k == l.n - 1)

    # flops-based time estimates feed best-device selection
    nb = A.mb
    po.time_estimate(lambda task, dev:
                     (nb ** 3 / 3) / (dev.gflops_fp32 * 1e9))
    tr.time_estimate(lambda task, dev: nb ** 3 / (dev.gflops_fp32 * 1e9))
    sy.time_estimate(lambda task, dev: nb ** 3 / (dev.gflops_fp32 * 1e9))
    ge.time_estimate(lambda task, dev:
                     2 * nb ** 3 / (dev.gflops_fp32 * 1e9))

    for tc, name in ((po, "potrf"), (tr, "trsm_rlt"), (sy, "syrk_ln"),
                     (ge, "gemm_nt")):
        if devices == "cuda":
            tc.body(device="cuda", dyld=name)
        else:
            tc.body(host_body(_FORMS[name][0]))
    return p.build()


def cholesky_flops(N: int) -> float:
    return N ** 3 / 3.0 + N ** 2 / 2.0


def make_spd(n: int, seed: int = 0) -> np.ndarray:
    """A well-conditioned SPD test matrix (the JAX package's, bit for
    bit)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n).astype(np.float32) / np.sqrt(n)
    return (a @ a.T + np.eye(n, dtype=np.float32) * 4.0).astype(np.float32)


def make_spd_fast(n: int, seed: int = 0) -> np.ndarray:
    """A diagonally-dominant SPD matrix in O(n²) host work, the bench-scale
    constructor (``make_spd``'s Gram product is an n³ host matmul).
    Symmetric with diag >= Σ|off-diag| + 1 per row, so SPD by Gershgorin;
    entries ~N(0,1) keep the factors dense and well-scaled."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n).astype(np.float32)
    s = (a + a.T) * 0.5
    np.fill_diagonal(s, np.abs(s).sum(axis=1) + 1.0)
    return s

"""Tiled LU factorization (no pivoting) as a PTG taskpool.

Port of ``parsec_tpu/models/lu.py``: the right-looking tile algorithm
(the dplasma ``dgetrf_nopiv`` shape; Cholesky's anatomy with two panel
classes):

- ``GETRF(k)`` — packed in-place LU of the diagonal tile;
- ``TRSM_L(k,n)`` — row panel: ``U(k,n) = inv(unit-L_kk) · A(k,n)``;
- ``TRSM_U(m,k)`` — column panel: ``L(m,k) = A(m,k) · inv(U_kk)``;
- ``GEMM(m,n,k)`` — trailing update ``A(m,n) -= L(m,k) · U(k,n)``,
  chained over ``k`` like the Cholesky GEMM chain.

No pivoting: callers supply diagonally dominant (or otherwise
nopiv-stable) matrices, the contract of the reference's nopiv variants.

The four incarnations (``lu_getrf``, ``lu_trsm_l``, ``lu_trsm_u``,
``lu_gemm``) are registered as batched list forms with stacked forms, as
in :mod:`parsec_tpu_torch.models.cholesky`:

- GETRF: ``torch.linalg.lu_factor_ex(pivot=False)`` on the card, the JAX
  traceable's fp32 rank-1 loop on the CPU, which PyTorch's nopiv LU
  refuses (:func:`~parsec_tpu_torch.ops.factor.getrf_nopiv`);
- TRSM_L / TRSM_U: the inverse of the unit-lower or upper triangle from
  one identity solve, each distinct diagonal tile once, then one K1
  launch with no C (``inv(L)·C``, ``C·inv(U)``);
- GEMM: K1's subtracting form, ``C - A·B``.

Over several ranks (a ``TwoDimBlockCyclic`` with ``P``, ``Q`` and
``myrank``, one pool a rank through :func:`parsec_tpu_torch.comm.run_multirank`)
each task runs on its tile's rank: GETRF's factor reaches the panels, and
the panels reach the trailing updates, by the comm layer; each rank's
``to_dense`` holds its own tiles, and their sum is the packed factor.

Left out: ``devices="auto"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ptg
from ..data_dist.matrix import TiledMatrix
from ..device.kernels import register_kernel
from ..ops import gemm as gemm_ops
from ..ops.factor import getrf_nopiv, host_body, tile_body, tri_inverse, \
    tri_inverse_tiles
from ..ptg.lowering import register_traceable


def lu_flops(n: int) -> float:
    return 2.0 * n ** 3 / 3.0


def make_dd(n: int, seed: int = 0) -> np.ndarray:
    """A diagonally dominant matrix (nopiv-stable), the JAX package's bit
    for bit."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n).astype(np.float32)
    return a + n * np.eye(n, dtype=np.float32)


def unpack_lu(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a packed in-place factorization into (unit-L, U)."""
    L = np.tril(packed, -1) + np.eye(packed.shape[0], dtype=packed.dtype)
    return L, np.triu(packed)


# ---------------------------------------------------------------------------
# the four incarnations: list forms and stacked forms, in flow order
# ---------------------------------------------------------------------------


def getrf_tiles(ts: list[torch.Tensor]) -> list[torch.Tensor]:
    """GETRF over a list of diagonal tiles (one a level on both paths)."""
    return [getrf_nopiv(t) for t in ts]


def trsm_l_tiles(lks: list[torch.Tensor],
                 cs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``inv(unit-L) · C``: one K1 launch after the inverses."""
    invs = tri_inverse_tiles(lks, upper=False, unit=True)
    return gemm_ops.gemm_update_tiles(invs, [c.float() for c in cs])


def trsm_u_tiles(uks: list[torch.Tensor],
                 cs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``C · inv(U)``: one K1 launch after the inverses."""
    invs = tri_inverse_tiles(uks, upper=True)
    return gemm_ops.gemm_update_tiles([c.float() for c in cs], invs)


def gemm_tiles(as_: list[torch.Tensor], bs: list[torch.Tensor],
               cs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``C - A·B``: one K1 launch."""
    return gemm_ops.gemm_update_tiles(
        [a.float() for a in as_], [b.float() for b in bs],
        [c.float() for c in cs], subtract=True)


def trsm_l_stacked(lks: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    return gemm_ops.gemm_update_stacked(tri_inverse(lks, False, True),
                                        cs.float())


def trsm_u_stacked(uks: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    return gemm_ops.gemm_update_stacked(cs.float(), tri_inverse(uks, True))


def gemm_stacked(as_: torch.Tensor, bs: torch.Tensor,
                 cs: torch.Tensor) -> torch.Tensor:
    return gemm_ops.gemm_update_stacked(as_.float(), bs.float(), cs.float(),
                                        subtract=True)


_FORMS = {"lu_getrf": (getrf_tiles, getrf_nopiv),
          "lu_trsm_l": (trsm_l_tiles, trsm_l_stacked),
          "lu_trsm_u": (trsm_u_tiles, trsm_u_stacked),
          "lu_gemm": (gemm_tiles, gemm_stacked)}
for _name, (_tiles, _stacked) in _FORMS.items():
    register_kernel(_name, "cuda", tile_body(_tiles))
    # every form but the diagonal factor launches K1
    register_traceable(_name, _tiles, stacked=_stacked,
                       libs=() if _name == "lu_getrf" else ("gemm",))


# ---------------------------------------------------------------------------
# the PTG
# ---------------------------------------------------------------------------


def tiled_lu_ptg(A: TiledMatrix, devices: str = "cuda") -> ptg.PTGTaskpool:
    """Build the nopiv LU PTG over a square tile grid (factors in place)."""
    if devices not in ("cuda", "cpu"):
        raise ValueError(f"tiled_lu_ptg: devices must be 'cuda' or 'cpu', "
                         f"got {devices!r}")
    if A.mt != A.nt:
        raise ValueError(f"tiled_lu_ptg: {A.mt}x{A.nt} tiles; LU needs a "
                         f"square tile grid")
    NT = A.mt
    p = ptg.PTGBuilder("lu", A=A, NT=NT)

    # ---- GETRF(k) ---------------------------------------------------------
    ge_ = p.task("GETRF", k=ptg.span(0, lambda g, l: g.NT - 1))
    ge_.affinity("A", lambda g, l: (l.k, l.k))
    ge_.priority(lambda g, l: 4 * (g.NT - l.k) + 4)
    fT = ge_.flow("T", ptg.RW)
    fT.input(data=("A", lambda g, l: (l.k, l.k)), guard=lambda g, l: l.k == 0)
    fT.input(pred=("GEMM", "C", lambda g, l: {"m": l.k, "n": l.k,
                                              "k": l.k - 1}),
             guard=lambda g, l: l.k > 0)
    fT.output(succ=("TRSM_L", "LK",
                    lambda g, l: [{"k": l.k, "n": n}
                                  for n in range(l.k + 1, g.NT)]),
              guard=lambda g, l: l.k < g.NT - 1)
    fT.output(succ=("TRSM_U", "UK",
                    lambda g, l: [{"m": m, "k": l.k}
                                  for m in range(l.k + 1, g.NT)]),
              guard=lambda g, l: l.k < g.NT - 1)
    fT.output(data=("A", lambda g, l: (l.k, l.k)))

    # ---- TRSM_L(k, n): row panel -----------------------------------------
    tl = p.task("TRSM_L",
                k=ptg.span(0, lambda g, l: g.NT - 2),
                n=ptg.span(lambda g, l: l.k + 1, lambda g, l: g.NT - 1))
    tl.affinity("A", lambda g, l: (l.k, l.n))
    tl.priority(lambda g, l: 4 * (g.NT - l.k) + 2)
    tl.flow("LK", ptg.READ).input(
        pred=("GETRF", "T", lambda g, l: {"k": l.k}))
    tlc = tl.flow("C", ptg.RW)
    tlc.input(data=("A", lambda g, l: (l.k, l.n)),
              guard=lambda g, l: l.k == 0)
    tlc.input(pred=("GEMM", "C", lambda g, l: {"m": l.k, "n": l.n,
                                               "k": l.k - 1}),
              guard=lambda g, l: l.k > 0)
    tlc.output(succ=("GEMM", "B",
                     lambda g, l: [{"m": m, "n": l.n, "k": l.k}
                                   for m in range(l.k + 1, g.NT)]))
    tlc.output(data=("A", lambda g, l: (l.k, l.n)))

    # ---- TRSM_U(m, k): column panel --------------------------------------
    tu = p.task("TRSM_U",
                k=ptg.span(0, lambda g, l: g.NT - 2),
                m=ptg.span(lambda g, l: l.k + 1, lambda g, l: g.NT - 1))
    tu.affinity("A", lambda g, l: (l.m, l.k))
    tu.priority(lambda g, l: 4 * (g.NT - l.m) + 2)
    tu.flow("UK", ptg.READ).input(
        pred=("GETRF", "T", lambda g, l: {"k": l.k}))
    tuc = tu.flow("C", ptg.RW)
    tuc.input(data=("A", lambda g, l: (l.m, l.k)),
              guard=lambda g, l: l.k == 0)
    tuc.input(pred=("GEMM", "C", lambda g, l: {"m": l.m, "n": l.k,
                                               "k": l.k - 1}),
              guard=lambda g, l: l.k > 0)
    tuc.output(succ=("GEMM", "A",
                     lambda g, l: [{"m": l.m, "n": n, "k": l.k}
                                   for n in range(l.k + 1, g.NT)]))
    tuc.output(data=("A", lambda g, l: (l.m, l.k)))

    # ---- GEMM(m, n, k): trailing update, chained over k -------------------
    gm = p.task("GEMM",
                m=ptg.span(1, lambda g, l: g.NT - 1),
                n=ptg.span(1, lambda g, l: g.NT - 1),
                k=ptg.span(0, lambda g, l: min(l.m, l.n) - 1))
    gm.affinity("A", lambda g, l: (l.m, l.n))
    gm.priority(lambda g, l: 4 * (g.NT - max(l.m, l.n)))
    gm.flow("A", ptg.READ).input(
        pred=("TRSM_U", "C", lambda g, l: {"m": l.m, "k": l.k}))
    gm.flow("B", ptg.READ).input(
        pred=("TRSM_L", "C", lambda g, l: {"k": l.k, "n": l.n}))
    gc = gm.flow("C", ptg.RW)
    gc.input(data=("A", lambda g, l: (l.m, l.n)),
             guard=lambda g, l: l.k == 0)
    gc.input(pred=("GEMM", "C", lambda g, l: {"m": l.m, "n": l.n,
                                              "k": l.k - 1}),
             guard=lambda g, l: l.k > 0)
    gc.output(succ=("GEMM", "C", lambda g, l: {"m": l.m, "n": l.n,
                                               "k": l.k + 1}),
              guard=lambda g, l: l.k < min(l.m, l.n) - 1)
    gc.output(succ=("GETRF", "T", lambda g, l: {"k": l.m}),
              guard=lambda g, l: l.k == l.m - 1 and l.m == l.n)
    gc.output(succ=("TRSM_L", "C", lambda g, l: {"k": l.m, "n": l.n}),
              guard=lambda g, l: l.k == min(l.m, l.n) - 1 and l.m < l.n)
    gc.output(succ=("TRSM_U", "C", lambda g, l: {"m": l.m, "k": l.n}),
              guard=lambda g, l: l.k == min(l.m, l.n) - 1 and l.m > l.n)

    nb = A.mb
    ge_.time_estimate(lambda task, dev:
                      (2 * nb ** 3 / 3) / (dev.gflops_fp32 * 1e9))
    for t in (tl, tu):
        t.time_estimate(lambda task, dev: nb ** 3 / (dev.gflops_fp32 * 1e9))
    gm.time_estimate(lambda task, dev:
                     2 * nb ** 3 / (dev.gflops_fp32 * 1e9))

    for tc, name in ((ge_, "lu_getrf"), (tl, "lu_trsm_l"),
                     (tu, "lu_trsm_u"), (gm, "lu_gemm")):
        if devices == "cuda":
            tc.body(device="cuda", dyld=name)
        else:
            tc.body(host_body(_FORMS[name][0]))
    return p.build()

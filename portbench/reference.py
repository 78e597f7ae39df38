"""The plain reference, its comparisons and its lower-precision controls.

Plain torch only: it imports nothing of the program and takes nothing the
program made but the outputs it judges.  The reference is float64, run in
row blocks (the GEMM) or whole (the factor) once the measured window has
closed; the program's outputs are compared with it as relative errors:

- GEMM: ``max|C - A@B| / max|A@B|`` over all of C;
- Cholesky: the worst tile's ``max|L_t - R_t| / max|R_t|`` over every
  tile of the lower factor (the lower triangle of a diagonal tile), so an
  error in a small off-diagonal tile counts as much as one on the
  diagonal.

The controls are the reference put in the program's place and computed in
the precision just below the configuration's, as a later change might be
tempted to compute it: the GEMM's fp32 result stored in bf16, or its bf16
operands cut to fp8; the factorization's tile products on bf16-rounded
operands (with fp32 accumulation) where the program takes TF32, either all
of them or only the trailing updates (SYRK and GEMM, most of the work).
The faults are the reference put in its place with one task left out.
"""

from __future__ import annotations

import contextlib
import math

import torch


def worst(values) -> float:
    """The largest of ``values``, or NaN where any is NaN."""
    values = list(values)
    return (float("nan") if any(math.isnan(v) for v in values)
            else max(values))


@contextlib.contextmanager
def strict_fp32():
    """fp32 matrix products in full fp32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

def gemm_errors(a: torch.Tensor, b: torch.Tensor, outs: list,
                block_rows: int = 2048) -> list[float]:
    """For each product in ``outs`` (``n x n``), ``max|C - A@B| /
    max|A@B|`` against the float64 product of ``a`` and ``b``, made in
    blocks of ``block_rows`` rows.  A NaN anywhere reads NaN."""
    bd = b.double()
    gap = [torch.zeros((), dtype=torch.float64, device=a.device)
           for _ in outs]
    scale = torch.zeros((), dtype=torch.float64, device=a.device)
    for r0 in range(0, a.shape[0], block_rows):
        ref = a[r0:r0 + block_rows].double() @ bd
        scale = torch.maximum(scale, ref.abs().max())
        for i, c in enumerate(outs):
            d = (c[r0:r0 + block_rows].double() - ref).abs().max()
            gap[i] = torch.maximum(gap[i], d)
        del ref
    return [(g / scale).item() for g in gap]


def gemm_control(a: torch.Tensor, b: torch.Tensor, lower: str, nb: int,
                 block_rows: int = 2048) -> torch.Tensor:
    """The product as the reference computes it one precision below the
    configuration's: ``"bf16_out"`` keeps the exact fp32 products and
    sums of the bf16 operands and stores the result in bf16;
    ``"fp8_in"`` cuts the operands to fp8 (e4m3) first and keeps an fp32
    result.  ``"drop_task"`` is a fault, not a control: the fp32 product
    with one task of the tiled product left out, ``C_mn += A_mk·B_kn`` for
    the last ``nb x nb`` tile of C and the first ``nb`` of the sum."""
    out = torch.empty(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    if lower == "fp8_in":
        a = a.to(torch.float8_e4m3fn)
        b = b.to(torch.float8_e4m3fn)
    elif lower not in ("bf16_out", "drop_task"):
        raise ValueError(f"unknown GEMM control {lower!r}")
    bf = b.float()
    with strict_fp32():
        for r0 in range(0, a.shape[0], block_rows):
            blk = a[r0:r0 + block_rows].float() @ bf
            if lower == "bf16_out":
                blk = blk.to(torch.bfloat16).float()
            out[r0:r0 + block_rows] = blk
        if lower == "drop_task":
            out[-nb:, -nb:] -= a[-nb:, :nb].float() @ bf[:nb, -nb:]
    return out


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------

def tile_grid(m: torch.Tensor, nb: int, keys: list) -> torch.Tensor:
    """The ``nb x nb`` tiles ``keys`` (``(row, col)`` tile coordinates) of
    the square matrix ``m``, stacked ``[len(keys), nb, nb]``."""
    nt = m.shape[0] // nb
    grid = m.view(nt, nb, nt, nb).permute(0, 2, 1, 3)
    rows = torch.tensor([k[0] for k in keys], device=m.device)
    cols = torch.tensor([k[1] for k in keys], device=m.device)
    return grid[rows, cols]


def factor_errors(a: torch.Tensor, nb: int, keys: list,
                  outs: list) -> dict[str, list[float]]:
    """For each factor in ``outs`` (its lower tiles ``keys``, stacked
    ``[len(keys), nb, nb]``, in row-major order), two numbers:

    - ``factor_tile_rel_err``: the worst tile's ``max|L_t - R_t| /
      max|R_t|`` against the float64 Cholesky factor ``R`` of ``a``;
    - ``diag_tile_residual``: the worst diagonal tile's ``max|(L·Lᵀ -
      A)_kk| / max|A_kk|``, ``(L·Lᵀ)_kk`` summed in float64 over the
      factor's tile row ``k``.  A diagonal tile is factored from ``A_kk``
      less the updates of the SYRK tasks, so this reads the rounding of
      those updates alone: the errors of the panels (TRSM) cancel in it.

    A factor with a NaN, or a reference that fails, reads NaN."""
    ref, info = torch.linalg.cholesky_ex(a.double())
    if int(info) != 0:
        nan = [float("nan")] * len(outs)
        return {"factor_tile_rel_err": nan, "diag_tile_residual": nan}
    want = tile_grid(ref, nb, keys)
    del ref
    diag = torch.tensor([k[0] == k[1] for k in keys], device=a.device)
    lower = torch.ones(nb, nb, dtype=torch.bool, device=a.device).tril()
    # the upper triangle of a diagonal tile is not part of the factor
    keep = (~diag)[:, None, None] | lower
    scale = want.abs().amax(dim=(1, 2))
    fwd, res = [], []
    for got in outs:
        d = (got.double() - want).where(keep, 0.0).abs().amax(dim=(1, 2))
        fwd.append((d / scale).max().item())
        res.append(_diag_residual(a, nb, keys, got.where(keep, 0.0)))
    return {"factor_tile_rel_err": fwd, "diag_tile_residual": res}


def _diag_residual(a: torch.Tensor, nb: int, keys: list,
                   tiles: torch.Tensor) -> float:
    """The worst diagonal tile's ``max|(L·Lᵀ - A)_kk| / max|A_kk|`` of
    the factor ``tiles`` (row-major lower tiles ``keys``)."""
    row = {}
    for i, (m, _) in enumerate(keys):
        row.setdefault(m, []).append(i)
    rs = []
    for k, idx in row.items():
        panel = tiles[idx[0]:idx[-1] + 1].double()        # [k+1, nb, nb]
        panel = panel.permute(1, 0, 2).reshape(nb, -1)     # L_k0 .. L_kk
        akk = a[k * nb:(k + 1) * nb, k * nb:(k + 1) * nb].double()
        rs.append((panel @ panel.T - akk).abs().max() / akk.abs().max())
    return worst(torch.stack(rs).tolist())


def cholesky_control(a: torch.Tensor, nb: int, rounded: str = "all",
                     operand: torch.dtype = torch.bfloat16,
                     drop: tuple[int, int, int] | None = None
                     ) -> torch.Tensor:
    """The lower factor of ``a`` as a blocked right-looking Cholesky
    computes it: the diagonal tiles factored and inverted in fp32, the
    panel as ``C · inv(L_kk)ᵀ`` (the TRSM tasks) and the trailing update
    as ``A - P·Pᵀ`` (the SYRK and GEMM tasks), accumulated in fp32.  The
    operands of the tile products named by ``rounded`` are rounded to
    ``operand`` first: ``"all"`` (TRSM, SYRK and GEMM), ``"updates"``
    (SYRK and GEMM only) or ``"none"``.  ``drop``, a GEMM task
    ``(m, n, k)`` (tile coordinates, ``m > n > k``), leaves that task's
    update of tile ``(m, n)`` out.  Returns the whole ``n x n`` factor
    (zeros above the diagonal)."""
    if rounded not in ("all", "updates", "none"):
        raise ValueError(f"unknown rounding {rounded!r}")
    n = a.shape[0]

    def rnd(x: torch.Tensor, part: str) -> torch.Tensor:
        return x.to(operand).float() \
            if rounded == "all" or rounded == part else x

    w = a.float().clone()
    with strict_fp32():
        for k0 in range(0, n, nb):
            k1 = k0 + nb
            lkk = torch.linalg.cholesky(w[k0:k1, k0:k1])
            w[k0:k1, k0:k1] = lkk
            if k1 == n:
                break
            eye = torch.eye(nb, dtype=torch.float32, device=a.device)
            inv = torch.linalg.solve_triangular(lkk, eye, upper=False)
            p = rnd(w[k1:, k0:k1], "trsm") @ rnd(inv, "trsm").T
            w[k1:, k0:k1] = p
            rp = rnd(p, "updates")
            w[k1:, k1:] -= rp @ rp.T
            if drop is not None and drop[2] * nb == k0:
                m0, c0 = drop[0] * nb - k1, drop[1] * nb - k1
                w[k1 + m0:k1 + m0 + nb, k1 + c0:k1 + c0 + nb] += \
                    rp[m0:m0 + nb] @ rp[c0:c0 + nb].T
    return w.tril()

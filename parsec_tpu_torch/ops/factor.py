"""Tile operations of the dense factorizations (Cholesky, nopiv LU).

The JAX package leaves these to XLA's library calls inside its model
modules (``parsec_tpu/models/cholesky.py:86-91,151-167``,
``models/lu.py:105-136``); there is no TPU kernel behind them.  Here they
are the library calls the port allows beside K1, gathered so that both
models share them:

- :func:`potrf` — ``torch.linalg.cholesky_ex(check_errors=False)``: no
  host sync (the plain ``cholesky`` checks ``info`` on the host and
  would stall the device module's manager thread at every POTRF), and a
  failed factorization comes back as NaNs, as ``jnp.linalg.cholesky``
  returns it.
- :func:`getrf_nopiv` — on the card ``torch.linalg.lu_factor_ex(pivot=
  False, check_errors=False)``, batched and free of host syncs; PyTorch
  refuses ``pivot=False`` on the CPU, so a CPU tensor takes
  :func:`getrf_nopiv_plain`, the JAX traceable's fp32 rank-1 loop.
- :func:`tri_inverse` / :func:`tri_inverse_tiles` — the inverse of a
  triangular tile from one identity solve
  (``torch.linalg.solve_triangular``), the JAX traceables' form; the
  product with it runs on K1.  A tile shared by a group (a broadcast
  view, or the same tile listed again) is inverted once.
- :func:`tile_body` / :func:`host_body` — a batched list form as the
  per-task device body and as the host chore.
- :func:`tile_error` — how far a factor lies from its reference, tile
  by tile: the check of the card runs and of the card tests; and
  :func:`one_update_dropped`, the fault its control runs inject.

Each takes a CUDA or a CPU tensor; any other device raises.  Every
result is row-major and contiguous (the solvers return column-major
batches), as K1 and the tile cache want it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator

import torch

from ..data.data import ACCESS_WRITE


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"factor: no route for device {t.device}")
    return t.device.type


def potrf(t: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``t`` (``[..., n, n]``, its lower triangle
    read) in fp32; NaNs where a factorization failed."""
    _device_kind(t)
    L, info = torch.linalg.cholesky_ex(t.float(), check_errors=False)
    return L.masked_fill((info != 0)[..., None, None],
                         float("nan")).contiguous()


def getrf_nopiv_plain(t: torch.Tensor) -> torch.Tensor:
    """Packed in-place LU without pivoting (unit L below the diagonal, U on
    and above it) of ``t`` (``[..., n, n]``) in fp32: the rank-1 loop of
    the JAX traceable (``parsec_tpu/models/lu.py:105-119``)."""
    a = t.float().clone()
    n = a.shape[-1]
    for j in range(n - 1):
        a[..., j + 1:, j] /= a[..., j, j, None]
        a[..., j + 1:, j + 1:] -= a[..., j + 1:, j, None] \
            * a[..., j, None, j + 1:]
    return a


def getrf_nopiv(t: torch.Tensor) -> torch.Tensor:
    """Packed nopiv LU of ``t`` (``[..., n, n]``) in fp32: the library's
    ``lu_factor_ex`` on the card, :func:`getrf_nopiv_plain` on the CPU."""
    if _device_kind(t) == "cpu":
        return getrf_nopiv_plain(t)
    lu, _, _ = torch.linalg.lu_factor_ex(t.float(), pivot=False,
                                         check_errors=False)
    return lu.contiguous()


def tri_inverse(ts: torch.Tensor, upper: bool,
                unit: bool = False) -> torch.Tensor:
    """Inverses of the triangular tiles ``ts`` (``[..., n, n]``; only the
    ``upper`` or lower triangle is read, its diagonal taken as ones with
    ``unit``), in fp32.  A stack broadcast along its leading axis (one
    tile shared by a group) is inverted once and broadcast back."""
    _device_kind(ts)
    if ts.dim() == 3 and ts.shape[0] > 1 and ts.stride(0) == 0:
        return tri_inverse(ts[:1], upper, unit).expand(ts.shape)
    n = ts.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=ts.device).expand(
        ts.shape)
    return torch.linalg.solve_triangular(ts.float(), eye, upper=upper,
                                         unitriangular=unit).contiguous()


def tri_inverse_tiles(ts: list[torch.Tensor], upper: bool,
                      unit: bool = False) -> list[torch.Tensor]:
    """:func:`tri_inverse` of each tile of a list, each distinct tile
    once (one batched solve); the inverses come back in list order,
    contiguous, a tile listed twice getting the same inverse."""
    first: dict[int, int] = {}
    uniq = []
    for t in ts:
        if t.data_ptr() not in first:
            first[t.data_ptr()] = len(uniq)
            uniq.append(t)
    inv = tri_inverse(torch.stack(uniq), upper, unit)
    return [inv[first[t.data_ptr()]] for t in ts]


def _run(apply: Callable, task: Any) -> Any:
    """One task through a batched list form: its flows' values as
    one-element lists, the written flow's copy updated."""
    flows = [f for f in task.task_class.flows if not f.is_ctl]
    out = apply(*([task.data[f.flow_index].value] for f in flows))
    (w,) = [f for f in flows if f.access & ACCESS_WRITE]
    c = task.data[w.flow_index]
    c.value = out[0]
    c.version += 1
    return c.value


def tile_body(apply: Callable) -> Callable:
    """The per-task device body ``(es, task, device)`` of a class whose
    batched list form is ``apply`` (one written flow)."""
    def body(es: Any, task: Any, device: Any) -> Any:
        return _run(apply, task)
    return body


def host_body(apply: Callable) -> Callable:
    """The host chore ``(es, task, g, l)`` over the same list form: on
    the host tiles every operation takes its CPU route."""
    def body(es: Any, task: Any, g: Any, l: Any) -> None:
        _run(apply, task)
    return body


def tile_error(got: torch.Tensor, want: torch.Tensor, nb: int) -> float:
    """The largest relative error of a factor ``got`` against its
    reference ``want`` (two ``n x n`` matrices, packed as the
    factorization stores them), taken over each ``nb x nb`` tile's part
    below, on and above the matrix diagonal apart: ``||got - want||_F /
    ||want||_F`` over that part's entries.  A part the reference holds
    as zeros counts its absolute error (any nonzero reads infinite).

    A whole-matrix norm cannot see one wrong tile of a diagonally
    dominant input, whose diagonal carries nearly all of the norm; here
    each tile's off-diagonal entries are held on their own scale (an LU
    tile's unit-L part is ``1/n`` of its U part)."""
    n = got.shape[-1]
    if got.shape != want.shape or got.shape != (n, n) or n % nb:
        raise ValueError(f"tile_error: {tuple(got.shape)} against "
                         f"{tuple(want.shape)} in tiles of {nb}")
    t = n // nb
    diff = got - want

    def by_tile(sq: torch.Tensor) -> torch.Tensor:
        return sq.reshape(t, nb, t, nb).sum((1, 3))

    parts = [(by_tile(f(diff).square()), by_tile(f(want).square()))
             for f in (lambda x: torch.tril(x, -1),
                       lambda x: torch.triu(x, 1))]
    parts.append((diff.diagonal().square().reshape(t, nb).sum(1),
                  want.diagonal().square().reshape(t, nb).sum(1)))
    worst = 0.0
    for e, r in parts:
        rel = torch.where(r > 0, (e / r.clamp_min(1e-300)).sqrt(),
                          torch.where(e > 0, float("inf"), 0.0))
        worst = max(worst, rel.max().item())
    return worst


@contextlib.contextmanager
def one_update_dropped(name: str, tiles: Callable,
                       stacked: Callable) -> Iterator[list]:
    """Register the trailing update ``name`` (its list form ``tiles`` and
    stacked form ``stacked``, ``(as_, bs, cs)``) again so that the first
    C tile it is given passes through unchanged: one GEMM task's update
    is dropped, the fault that :func:`tile_error`'s gate must catch.
    Yields the list that records the drop; on leaving, ``tiles`` and
    ``stacked`` are registered as before.  Register it before a pool is
    lowered: the lowering takes its forms when it lowers."""
    from ..device.kernels import register_kernel
    from ..ptg.lowering import register_traceable
    dropped: list = []

    def tiles_dropped(as_, bs, cs):
        out = tiles(as_, bs, cs)
        if not dropped:
            dropped.append(1)
            out[0] = cs[0].float().clone()
        return out

    def stacked_dropped(as_, bs, cs):
        out = stacked(as_, bs, cs)
        if not dropped:
            dropped.append(1)
            out[0] = cs[0]
        return out

    def register(t: Callable, st: Callable) -> None:
        register_kernel(name, "cuda", tile_body(t))
        register_traceable(name, t, stacked=st, libs=("gemm",))

    register(tiles_dropped, stacked_dropped)
    try:
        yield dropped
    finally:
        register(tiles, stacked)

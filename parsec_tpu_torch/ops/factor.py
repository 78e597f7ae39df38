"""Tile operations of the dense factorizations (Cholesky, nopiv LU).

The JAX package leaves these to XLA's library calls inside its model
modules (``parsec_tpu/models/cholesky.py:86-91,151-167``,
``models/lu.py:105-136``); there is no TPU kernel behind them.  Here they
are the library calls the port allows beside K1, gathered so that both
models share them:

- :func:`potrf` — on the card, for tiles of order 32 to 512 in steps of
  32, the hand-written kernel of ``csrc/factor.cu``; otherwise
  ``torch.linalg.cholesky_ex(check_errors=False)``: no host sync (the
  plain ``cholesky`` checks ``info`` on the host and would stall the
  device module's manager thread at every POTRF).  On both routes a
  failed factorization comes back as a tile of NaNs, as
  ``jnp.linalg.cholesky`` returns it.
- :func:`getrf_nopiv` — on the card ``torch.linalg.lu_factor_ex(pivot=
  False, check_errors=False)``, batched and free of host syncs; PyTorch
  refuses ``pivot=False`` on the CPU, so a CPU tensor takes
  :func:`getrf_nopiv_plain`, the JAX traceable's fp32 rank-1 loop.
- :func:`tri_inverse` / :func:`tri_inverse_tiles` — the inverse of a
  triangular tile, the JAX traceables' form; the product with it runs on
  K1.  A lower, non-unit tile on the card in the hand kernel's range
  takes ``csrc/factor.cu``'s inverse kernel; every other (the LU's upper
  and unit inverses, CPU tensors, larger tiles) one identity solve
  (``torch.linalg.solve_triangular``).  A tile shared by a group (a
  broadcast view, or the same tile listed again) is inverted once.
- :func:`tile_body` / :func:`host_body` — a batched list form as the
  per-task device body and as the host chore.
- :func:`tile_error` — how far a factor lies from its reference, tile
  by tile: the check of the card runs and of the card tests; and
  :func:`one_update_dropped`, the fault its control runs inject.

Each takes a CUDA or a CPU tensor; any other device raises.  Every
result is row-major and contiguous (the solvers return column-major
batches), as K1 and the tile cache want it.  The route follows the
input alone (:func:`hand_route`): no knob chooses it, and a hand launch
that fails raises.  :data:`launches_by_route` counts the POTRF and
inverse launches by ``(operation, route)``, ``route`` ``"hand"`` or
``"library"``.  Inside a lowered step's trace (:mod:`..prof.spans`),
:func:`potrf`, :func:`getrf_nopiv` and the inverses each record one
span, ``lib.potrf``, ``lib.getrf`` or ``lib.trsm``, with the tiles it
factors or inverts (``batch``), their order (``nb``) and, but for
``lib.getrf``, the ``route``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
import time
from collections import Counter
from typing import Any, Callable, Iterator

import torch

from ..data.data import ACCESS_WRITE
from ..prof import spans as _spans

_now = time.perf_counter_ns


def _lib_span(r: Any, name: str, t0: int, batch: int, nb: int,
              route: str | None = None) -> None:
    """A tile call's span (``t0`` to now) in the lowered step's trace, if
    one is active."""
    tid = _spans.active_trace()
    if tid:
        args = ("batch", batch, "nb", nb)
        if route is not None:
            args += ("route", route)
        r.record(name, tid, t0, _now(), None, args)


def _batch(t: torch.Tensor) -> int:
    return math.prod(t.shape[:-2])


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"factor: no route for device {t.device}")
    return t.device.type


#: the order of the largest tile the hand kernels take (a cluster of 16
#: CTAs of 32 rows); every order from 32 to it in steps of 32
HAND_MAX_N = 512

#: POTRF and inverse launches by ``(operation, route)``: ``("potrf" |
#: "trsm", "hand" | "library")``
launches_by_route: Counter = Counter()
_route_lock = threading.Lock()


def _count(op: str, route: str) -> None:
    with _route_lock:
        launches_by_route[op, route] += 1


def hand_route(t: torch.Tensor, upper: bool = False,
               unit: bool = False) -> bool:
    """Whether tiles ``t`` (``[..., n, n]``) take the hand kernels of
    ``csrc/factor.cu``: on the card, lower and non-unit, of an order
    ``n`` from 32 to :data:`HAND_MAX_N` in steps of 32.  Any dtype, read
    as fp32."""
    n = t.shape[-1]
    return (t.device.type == "cuda" and not upper and not unit
            and n % 32 == 0 and 32 <= n <= HAND_MAX_N)


@functools.cache
def _entries() -> tuple:
    """The two C entry points, built at first use, their signatures set
    once."""
    from ._build import load
    lib = load("factor")
    fns = (lib.parsec_potrf_tiles, lib.parsec_trinv_tiles)
    for fn in fns:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    return fns


def _hand(which: int, t: torch.Tensor) -> torch.Tensor:
    """One launch of the POTRF (``which`` 0) or the inverse kernel (1)
    over tiles ``t``, each read where it lies if its rows are 16-byte
    aligned runs of adjacent elements (a store row, a view with a wider
    pitch), else from a contiguous copy; a fresh contiguous fp32 result
    of ``t``'s shape."""
    n = t.shape[-1]
    x = t.float().reshape(-1, n, n)
    if (x.stride(-1) != 1 or x.stride(-2) < n or x.stride(-2) % 4
            or x.data_ptr() % 16 or (x.shape[0] > 1 and x.stride(0) % 4)):
        x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(), n,
            x.shape[0])
    with torch.cuda.device(x.device):
        rc = _entries()[which](*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"factor: {('potrf', 'trinv')[which]} kernel "
                           f"launch failed (cudaError {rc}) at batch="
                           f"{x.shape[0]} n={n}")
    return out.view(t.shape)


def potrf(t: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``t`` (``[..., n, n]``, its lower triangle
    read) in fp32; a tile of NaNs where a factorization failed."""
    _device_kind(t)
    r = _spans.recorder
    t0 = _now() if r is not None else 0
    if hand_route(t):
        out, route = _hand(0, t), "hand"
    else:
        L, info = torch.linalg.cholesky_ex(t.float(), check_errors=False)
        out = L.masked_fill((info != 0)[..., None, None],
                            float("nan")).contiguous()
        route = "library"
    _count("potrf", route)
    if r is not None:
        _lib_span(r, "lib.potrf", t0, _batch(t), t.shape[-1], route)
    return out


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
    r = _spans.recorder
    t0 = _now() if r is not None else 0
    if _device_kind(t) == "cpu":
        lu = getrf_nopiv_plain(t)
    else:
        lu, _, _ = torch.linalg.lu_factor_ex(t.float(), pivot=False,
                                             check_errors=False)
        lu = lu.contiguous()
    if r is not None:
        _lib_span(r, "lib.getrf", t0, _batch(t), t.shape[-1])
    return lu


def tri_inverse(ts: torch.Tensor, upper: bool,
                unit: bool = False) -> torch.Tensor:
    """Inverses of the triangular tiles ``ts`` (``[..., n, n]``; only the
    ``upper`` or lower triangle is read, its diagonal taken as ones with
    ``unit``), in fp32.  A stack broadcast along its leading axis (one
    tile shared by a group) is inverted once and broadcast back."""
    _device_kind(ts)
    r = _spans.recorder
    t0 = _now() if r is not None else 0
    if ts.dim() == 3 and ts.shape[0] > 1 and ts.stride(0) == 0:
        inv, route = _tri_inverse(ts[:1], upper, unit)
        inv, batch = inv.expand(ts.shape), 1
    else:
        (inv, route), batch = _tri_inverse(ts, upper, unit), _batch(ts)
    if r is not None:
        _lib_span(r, "lib.trsm", t0, batch, ts.shape[-1], route)
    return inv


def _tri_inverse(ts: torch.Tensor, upper: bool,
                 unit: bool) -> tuple[torch.Tensor, str]:
    """:func:`tri_inverse` of every tile of ``ts`` in one launch or one
    solve, and the route it took."""
    if hand_route(ts, upper, unit):
        inv, route = _hand(1, ts), "hand"
    else:
        n = ts.shape[-1]
        eye = torch.eye(n, dtype=torch.float32, device=ts.device).expand(
            ts.shape)
        inv = torch.linalg.solve_triangular(
            ts.float(), eye, upper=upper, unitriangular=unit).contiguous()
        route = "library"
    _count("trsm", route)
    return inv, route


def tri_inverse_tiles(ts: list[torch.Tensor], upper: bool,
                      unit: bool = False) -> list[torch.Tensor]:
    """:func:`tri_inverse` of each tile of a list, each distinct tile
    once (one batched solve); the inverses come back in list order,
    contiguous, a tile listed twice getting the same inverse."""
    _device_kind(ts[0])
    r = _spans.recorder
    t0 = _now() if r is not None else 0
    first: dict[int, int] = {}
    uniq = []
    for t in ts:
        if t.data_ptr() not in first:
            first[t.data_ptr()] = len(uniq)
            uniq.append(t)
    inv, route = _tri_inverse(torch.stack(uniq), upper, unit)
    if r is not None:
        _lib_span(r, "lib.trsm", t0, len(uniq), ts[0].shape[-1], route)
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


#: host chore runs of the factorizations, by task class: on the card a
#: ``devices="auto"`` pool must leave it untouched (the rule of no
#: fallback that would hide the card)
host_runs: Counter = Counter()
_host_runs_lock = threading.Lock()


def host_body(apply: Callable) -> Callable:
    """The host chore ``(es, task, g, l)`` over the same list form: on
    the host tiles every operation takes its CPU route.  Each run counts
    in :data:`host_runs`."""
    def body(es: Any, task: Any, g: Any, l: Any) -> None:
        with _host_runs_lock:
            host_runs[task.task_class.name] += 1
        _run(apply, task)
    return body


def attach_chores(tc: Any, name: str, apply: Callable,
                  devices: str) -> None:
    """A factorization class's chores: the CUDA chore by name
    (``"cuda"``), the host chore over ``apply`` (``"cpu"``), or both,
    CUDA first (``"auto"``): with a CUDA device registered every task
    takes it, and the host chore runs only with none."""
    if devices in ("cuda", "auto"):
        tc.body(device="cuda", dyld=name)
    if devices in ("cpu", "auto"):
        tc.body(host_body(apply))


def check_devices(who: str, devices: str) -> None:
    if devices not in ("cuda", "cpu", "auto"):
        raise ValueError(f"{who}: devices must be 'cuda', 'cpu' or 'auto', "
                         f"got {devices!r}")


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
def one_update_dropped(name: str) -> Iterator[list]:
    """Register the trailing update ``name`` (its forms over ``(as_, bs,
    cs)``) again so that the first C tile it is given passes through
    unchanged: one GEMM task's update is dropped, the fault that
    :func:`tile_error`'s gate must catch.  Every form the registry holds
    for ``name`` is wrapped: ``apply``, also registered as the CUDA body,
    and its ``rows`` hook (the group's first C row keeps its value,
    whether the hook writes into the C rows or returns new tiles) or its
    ``stacked`` form, so that the faulty run takes the path the program
    takes.  Yields the list that records the drop; on leaving, the
    traceable's forms and the CUDA body found are back.  Register it
    before a pool is lowered: the lowering takes its forms when it
    lowers."""
    from ..device.kernels import find_incarnation, register_kernel
    from ..ptg.lowering import find_traceable, register_traceable
    prev = find_traceable(name)
    body = find_incarnation(name, torch.device("cuda"))
    dropped: list = []

    def tiles_dropped(as_, bs, cs):
        out = prev.apply(as_, bs, cs)
        if not dropped:
            dropped.append(1)
            out[0] = cs[0].float().clone()
        return out

    def stacked_dropped(as_, bs, cs):
        out = prev.stacked(as_, bs, cs)
        if not dropped:
            dropped.append(1)
            out[0] = cs[0]
        return out

    def rows_dropped(*flows, out=None):
        # C is the last flow, ``(store, index)``; its first row's tile
        # before the update is the group's first result
        c_st, c_ix = flows[-1]
        kept = None if dropped else c_st[int(c_ix.rows[0])].clone()
        res = prev.rows(*flows) if out is None \
            else prev.rows(*flows, out=out)
        if kept is not None:
            dropped.append(1)
            if res is None:             # written into the C rows
                o_st, o_ix = out[0]
                o_st[int(o_ix.rows[0])].copy_(kept)
            else:
                res[0] = kept
        return res

    def install(apply, stacked, rows):
        register_traceable(name, apply, bilinear=prev.bilinear,
                           chain_combine=prev.chain_combine,
                           stacked=stacked, inplace=prev.inplace, rows=rows,
                           rows_into=prev.rows_into, libs=prev.libs)

    register_kernel(name, "cuda", tile_body(tiles_dropped))
    install(tiles_dropped, None if prev.stacked is None else stacked_dropped,
            None if prev.rows is None else rows_dropped)
    try:
        yield dropped
    finally:
        register_kernel(name, "cuda", body)
        install(prev.apply, prev.stacked, prev.rows)

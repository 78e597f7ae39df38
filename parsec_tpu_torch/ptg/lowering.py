"""Taskpool lowering: a regular PTG taskpool as one plan over tile stores.

Port of ``parsec_tpu/ptg/lowering.py``, the compiled incarnation of a
taskpool: the same taskpool object that runs through the dynamic
scheduler is analysed whole (classes, flows, guarded deps, kernel names)
and run as a plan over *stores*, one tensor per referenced collection on
the card.

1. **Analysis**: each class's execution space is enumerated, guards are
   evaluated concretely and the task DAG is built.
2. **Stores**: every referenced collection becomes one stacked tensor
   ``[n_tiles, *tile]`` (tiles must be uniform; ragged tiles raise
   :class:`LoweringError`), or the whole ``[lm, ln]`` matrix when a pass
   proves the accesses form the identity tile grid.
3. **Chain collapse**: a class whose RW flow accumulates ``acc + lhs @
   rhs`` along one parameter, with a *bilinear* traceable, becomes one
   contraction: on dense stores one call of the kernel on the whole
   matrices (one K1 launch), else the traceable's ``chain_combine`` over
   gathered ``[M, K, ta, tk]`` / ``[K, N, tk, tb]`` tile stacks.  Both
   honour the ``gemm_precision`` knob, which K1's wrappers read at call
   time (``ops/gemm.py``).
4. **Wavefront batching**: every flow value is resolved to a store row,
   tasks are grouped per (topological level, class, source signature),
   and each group is ONE batched call of the class's traceable over rows
   gathered from the stores.  Hazards that in-place rows would break
   raise :class:`LoweringError`, and ``"auto"`` then takes the unrolled
   pass.
5. **Unrolled**: any other regular DAG runs task by task in topological
   order.

Kernels take part through *traceables* registered beside their dynamic
bodies (``register_traceable``, keyed by the ``dyld=`` name), or scoped to
one taskpool through its ``local_traceables``.

How eager PyTorch keeps the JAX step's semantics:

- **Purity.**  ``step_fn(stores)`` returns a new dict and leaves its input
  as it was, so a step can run again on the same stores.  Each pass
  clones, at step entry, the stores it writes (the dense chain writes a
  new tensor instead), then updates the clones in place.
- **Level-atomic snapshots.**  A level's groups all compute before any of
  its scatters lands.  A contiguous gather is a *view* of a store, and an
  ``"in"`` scatter forwards a group's input; so before the scatters run,
  every pending value that shares storage with a store is cloned, and no
  write of the level can reach a value another write still has to store.
- **Batching in place of ``vmap``.**  A traceable may carry a stacked
  form over a leading group axis; without one, its list form runs on the
  group's rows and the outputs are stacked.  The unrolled pass, and a
  group of one task, call the list form on one-element lists.  The
  unrolled pass clones what it reads from a store, since a later task
  may overwrite the row while the value is still forwarded.

Entry point: :func:`lower_taskpool` ``(tp, device="cuda")``.  On a
machine with no card, ``device="cuda"`` raises; the tests lower with
``device="cpu"``.

Left out, each still in ``ROADMAP.md``: open stores (see
:class:`_Stores`); ``lowering_cache``,
``LoweringCache``, ``structural_fingerprint``, the persistent compile
cache and ``warm()`` (PyTorch has no compile step to cache);
``lowering_scan_min`` folding of identical levels into a ``lax.scan``
(the levels run in a Python loop; CUDA-graph capture of the step is later
work); megakernel regions (``lower_regions``, ``warm_cache``, the
CLI); mesh SPMD and multi-rank lowering, which raise
``NotImplementedError``.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..data.data import ACCESS_RW, ACCESS_WRITE

__all__ = ["LoweringError", "LoweredTaskpool", "Traceable",
           "find_traceable", "lower_taskpool", "register_traceable"]


class LoweringError(RuntimeError):
    """Raised when a taskpool cannot be lowered (irregular structure, a
    body with no traceable, ragged tiles...).  Callers run the dynamic
    runtime instead: lowering is an optimization, never a requirement."""


# ---------------------------------------------------------------------------
# traceable-kernel registry (the batched side of ``dyld=``)
# ---------------------------------------------------------------------------

class Traceable:
    """A batched incarnation of a task body.

    ``apply(*flow_lists)`` receives, for each non-CTL flow in flow order,
    the list of that flow's values over B tasks (same shapes and dtypes),
    or None where the flow has no value for these tasks, and returns, for
    each writable flow, the list of its new values (one written flow: its
    list; several: a tuple of lists).  It is ONE call over the batch (for
    GEMM, one kernel launch), and every new value has storage of its own,
    so the device module's tile cache frees a tile's memory when it
    evicts it.

    ``stacked(*flow_values)``, optional, is the same function over a
    leading group axis: each argument is a tensor ``[G, ...]`` (a tile
    shared by the whole group arrives as a broadcast view) or None; it
    returns one tensor ``[G, ...]`` per writable flow (a tuple for
    several).  The wavefront pass prefers it for groups of two or more.

    ``bilinear=True`` declares tile-matmul semantics ``acc' = acc + lhs @
    rhs`` (fp32 accumulate) over the class's two READ flows, in
    declaration order, and its RW flow, enabling the chain-collapse pass;
    ``chain_combine(lhs [M,K,ta,tk], rhs [K,N,tk,tb], acc0 [M,N,ta,tb])``
    computes the collapsed chain (by default on K1, :func:`ops.gemm.
    gemm_chain`).

    ``inplace(*flow_lists)``, optional, is ``apply`` writing each writable
    flow's new values into the tiles it was given and returning them.
    Only the device module's fused dispatch calls it, on tiles it owns,
    and only for a class whose every written version has one consumer
    (the decode ATTN class's ACC chain); the lowering's steps keep
    ``apply``, whose results never share a store's memory.
    """

    __slots__ = ("apply", "bilinear", "chain_combine", "stacked", "inplace")

    def __init__(self, apply: Callable, bilinear: bool = False,
                 chain_combine: Callable | None = None,
                 stacked: Callable | None = None,
                 inplace: Callable | None = None) -> None:
        self.apply = apply
        self.bilinear = bilinear
        self.chain_combine = chain_combine or (
            _default_bilinear_chain if bilinear else None)
        self.stacked = stacked
        self.inplace = inplace


def _default_bilinear_chain(lhs: torch.Tensor, rhs: torch.Tensor,
                            acc0: torch.Tensor) -> torch.Tensor:
    """``acc0[m,n] + sum_k lhs[m,k] @ rhs[k,n]`` over tile stacks, on K1."""
    from ..ops.gemm import gemm_chain
    return gemm_chain(lhs, rhs, acc0)


_lock = threading.Lock()
_traceables: dict[str, Traceable] = {}


def register_traceable(name: str, apply: Callable, *, bilinear: bool = False,
                       chain_combine: Callable | None = None,
                       stacked: Callable | None = None,
                       inplace: Callable | None = None) -> Traceable:
    t = Traceable(apply, bilinear=bilinear, chain_combine=chain_combine,
                  stacked=stacked, inplace=inplace)
    with _lock:
        _traceables[name] = t
    return t


def find_traceable(name: str) -> Traceable | None:
    with _lock:
        return _traceables.get(name)


def _results(out: Any, nw: int) -> tuple:
    """A traceable's return value as one entry per writable flow."""
    return (out,) if nw == 1 else tuple(out)


def _call_one(kernel: Traceable, nw: int, args: list) -> tuple:
    """One task's new writable values: the list form on one-element
    lists."""
    out = kernel.apply(*(None if a is None else [a] for a in args))
    return tuple(v[0] for v in _results(out, nw))


def _call_group(kernel: Traceable, nw: int, args: list) -> tuple:
    """A group's new writable values, each ``[G, ...]``: the stacked form,
    or the list form on the group's rows with the outputs stacked."""
    if kernel.stacked is not None:
        return _results(kernel.stacked(*args), nw)
    cols = [None if a is None else list(a.unbind(0)) for a in args]
    return tuple(torch.stack(v) for v in
                 _results(kernel.apply(*cols), nw))


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

class _ClassInfo:
    __slots__ = ("tc", "tasks", "kernel", "data_flows", "writable_flows")

    def __init__(self, tc, tasks, kernel):
        self.tc = tc
        self.tasks = tasks              # list[dict] locals, enumeration order
        self.kernel = kernel            # Traceable | None
        self.data_flows = [f for f in tc.flows if not f.is_ctl]
        self.writable_flows = [f for f in self.data_flows
                               if f.access in (ACCESS_RW, ACCESS_WRITE)]


def _class_kernel(tc, local: dict | None = None) -> Traceable | None:
    for chore in tc.chores:
        if chore.dyld is not None:
            t = (local or {}).get(chore.dyld) or find_traceable(chore.dyld)
            if t is not None:
                return t
    return None


def _analyze(tp) -> dict[str, _ClassInfo]:
    # taskpools may carry build-scoped traceables (per-instance constants
    # like stencil weights) without touching the process-wide registry
    local = getattr(tp, "local_traceables", None)
    infos: dict[str, _ClassInfo] = {}
    for tc in tp.task_classes:
        tcb = tp._tc_builders[tc.name]
        tasks = list(tcb._enumerate_space())
        kernel = _class_kernel(tc, local)
        if kernel is None and any(not f.is_ctl for f in tc.flows):
            raise LoweringError(
                f"task class {tc.name} has data flows but no traceable "
                f"kernel incarnation (register_traceable under its dyld name)")
        for f in tc.flows:
            for d in (*f.deps_in, *f.deps_out):
                if d.dtt is not None:
                    raise LoweringError(
                        f"{tc.name}.{f.name}: typed dep edges "
                        f"([type=...]) reshape on the dynamic path")
            for d in f.deps_in:
                if d.target_class is None and d.data_ref is None \
                        and not d.null:
                    # NEW arrow: the lowering allocates the scratch, a
                    # zeros tile of the declared type, so the type must be
                    # statically known
                    if d.dtt is None and f.dtt is None:
                        raise LoweringError(
                            f"{tc.name}.{f.name}: NEW input without a "
                            f"declared tile type (pass dtt=)")
        infos[tc.name] = _ClassInfo(tc, tasks, kernel)
    return infos


def _collection_keys(dc) -> list[tuple]:
    from ..data_dist.collection import enumerate_keys
    try:
        return enumerate_keys(dc)
    except TypeError as e:
        raise LoweringError(str(e))


def _norm_key(key) -> tuple:
    return key if isinstance(key, tuple) else (key,)


def _value(dc, key: tuple) -> torch.Tensor:
    return dc.data_of(*key).newest_copy().value


class _Stores:
    """One tensor per referenced collection, on one rank.

    Layout per collection is chosen by the passes: ``stacked``
    (``[n_tiles, *tile]``, rows in the collection's key order; supports
    any gather) or ``dense`` (the whole matrix ``[lm, ln]``, chosen when a
    pass proves its accesses form the identity tile grid, so the kernel
    reads the operand in its natural layout with no gather).  NEW arrows
    get synthetic zero-initialized scratch stores.  A collection must
    enumerate its keys: the JAX package's *open* stores, extended as a
    plan references keys (only its LLM region lowering uses them), are
    not ported."""

    def __init__(self) -> None:
        self.dcs: dict[str, Any] = {}
        self.rows: dict[str, dict[tuple, int]] = {}
        self.written: set[str] = set()
        self.layout: dict[str, str] = {}
        self.nrows: dict[str, int] = {}
        self.shape: dict[str, tuple] = {}   # uniform tile shape per store
        self.dtype: dict[str, torch.dtype] = {}
        self.scratch: set[str] = set()      # synthetic NEW-flow stores

    def _ensure(self, dc) -> None:
        name = dc.name
        if name in self.dcs:
            return
        keys = _collection_keys(dc)
        if not keys:
            raise LoweringError(f"collection {name} has no keys to lay "
                                f"out (open key spaces are not ported)")
        shapes = {dc.tile_shape(*k) if hasattr(dc, "tile_shape")
                  else tuple(_value(dc, k).shape) for k in keys}
        if len(shapes) != 1:
            raise LoweringError(
                f"collection {name} has ragged tiles {shapes}; "
                f"lowering needs uniform tile shapes")
        self.dcs[name] = dc
        self.layout[name] = "stacked"
        self.rows[name] = {k: i for i, k in enumerate(keys)}
        self.nrows[name] = len(keys)
        self.shape[name] = tuple(next(iter(shapes)))
        dtype = getattr(dc, "dtype", None)
        self.dtype[name] = (dtype if isinstance(dtype, torch.dtype)
                            else _value(dc, keys[0]).dtype)

    def row(self, dc, key: tuple) -> int:
        self._ensure(dc)
        name = dc.name
        r = self.rows[name].get(key)
        if r is None:
            raise LoweringError(f"{name}: key {key} outside the store")
        return r

    def scratch_row(self, cname: str, fname: str, key: tuple,
                    shape: tuple, dtype: torch.dtype) -> tuple[str, int]:
        """A row in the synthetic zero-initialized store backing a NEW
        arrow: an RW flow whose value never lands in a collection still
        needs a store-resident home so successors can gather it."""
        name = f"_scratch_{cname}_{fname}"
        if name not in self.rows:
            self.rows[name] = {}
            self.nrows[name] = 0
            self.layout[name] = "scratch"
            self.shape[name] = tuple(shape)
            self.dtype[name] = dtype
            self.scratch.add(name)
        r = self.rows[name].get(key)
        if r is None:
            r = self.nrows[name]
            self.rows[name][key] = r
            self.nrows[name] = r + 1
        return name, r

    def is_dense_grid(self, dc, I: np.ndarray) -> bool:
        """Whether index grid ``I`` is exactly the identity tile grid of the
        whole collection: ``I[i, j] == row of tile (i, j)``, every tile
        covered.  Pure check; commit with ``set_dense``."""
        name = dc.name
        if not (hasattr(dc, "mt") and hasattr(dc, "nt")):
            return False
        if I.shape != (dc.mt, dc.nt):
            return False
        if len(self.rows[name]) != dc.mt * dc.nt:
            return False
        expect = np.array([[self.rows[name][(m, n)] for n in range(dc.nt)]
                           for m in range(dc.mt)], I.dtype)
        return bool(np.array_equal(I, expect))

    def set_dense(self, dc) -> None:
        self.layout[dc.name] = "dense"

    def materialize(self, device: torch.device) -> dict[str, torch.Tensor]:
        """The stores on ``device``: each built as one host tensor (a stack
        of its tiles in row order, or the dense matrix) and moved with one
        copy; scratch stores start as zeros on the device."""
        out = {}
        for name, dc in self.dcs.items():
            if self.layout[name] == "dense":
                out[name] = dc.to_tensor().to(device)
                continue
            tiles: list[Any] = [None] * self.nrows[name]
            for k, i in self.rows[name].items():
                tiles[i] = _value(dc, k).to("cpu")
            out[name] = torch.stack(tiles).to(device)
        for name in self.scratch:
            out[name] = torch.zeros((self.nrows[name],) + self.shape[name],
                                    dtype=self.dtype[name], device=device)
        return out

    def writeback(self, values: dict[str, torch.Tensor]) -> None:
        """Each written store comes back to the host in one copy; every
        tile then becomes a host tensor of its own on its collection's
        newest copy, whose version is bumped."""
        for name in self.written:
            dc = self.dcs[name]
            arr = values[name].to("cpu")
            dense = self.layout[name] == "dense"
            for key, i in self.rows[name].items():
                copy = dc.data_of(*key).newest_copy()
                if dense:
                    m, n = key
                    tile = arr[m * dc.mb:(m + 1) * dc.mb,
                               n * dc.nb:(n + 1) * dc.nb]
                else:
                    tile = arr[i]
                copy.value = tile.clone(memory_format=torch.contiguous_format)
                copy.version += 1


class _Index:
    """Store rows as an index: a slice when they are consecutive (a view
    on read, a slab on write), else a long tensor, kept per device."""

    __slots__ = ("rows", "sel", "_dev")

    def __init__(self, rows: np.ndarray) -> None:
        self.rows = rows
        r0 = int(rows[0])
        self.sel = (slice(r0, r0 + len(rows))
                    if (np.diff(rows) == 1).all() else None)
        self._dev: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> Any:
        if self.sel is not None:
            return self.sel
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = torch.as_tensor(
                self.rows, dtype=torch.long, device=device)
        return t


# ---------------------------------------------------------------------------
# pass 1: bilinear chain collapse
# ---------------------------------------------------------------------------

def _active_in_deps(flow, locals_):
    return [d for d in flow.deps_in if d.active(locals_)]


def _active_out_deps(flow, locals_):
    return [d for d in flow.deps_out if d.active(locals_)]


def _key_param_deps(tasks: list[dict], keys: list[tuple],
                    params: list[str]) -> set[str]:
    """Which params influence ``key``, decided concretely: q matters iff
    two tasks differing only in q have different keys."""
    deps: set[str] = set()
    for q in params:
        rest = [p for p in params if p != q]
        seen: dict[tuple, Any] = {}
        for loc, key in zip(tasks, keys):
            r = tuple(loc[p] for p in rest)
            if r in seen and seen[r] != key:
                deps.add(q)
                break
            seen.setdefault(r, key)
    return deps


def _try_chain_collapse(tp, infos, stores: _Stores):
    """Detect ``ACC(p..., k)``: init-from-store at k=lo, accumulate lhs·rhs
    along k, write-to-store at k=hi, and emit one contraction."""
    if len(infos) != 1:
        return None
    (info,) = infos.values()
    tc, kernel, tasks = info.tc, info.kernel, info.tasks
    if kernel is None or not kernel.bilinear or not tasks:
        return None
    if len(info.data_flows) != 3 or len(info.writable_flows) != 1:
        return None
    acc = info.writable_flows[0]
    lhs, rhs = [f for f in info.data_flows if f is not acc]
    params = tc.params

    # -- identify the chain parameter from any interior pred edge ------------
    chain = None
    for loc in tasks:
        for d in _active_in_deps(acc, loc):
            if d.target_class == tc.name and d.target_flow == acc.name:
                pred = d.target_params(loc)
                if not isinstance(pred, dict):   # range arrow: not a chain
                    return None
                diff = [p for p in params if pred[p] != loc[p]]
                if len(diff) == 1 and loc[diff[0]] - pred[diff[0]] == 1:
                    chain = diff[0]
                break
        if chain:
            break
    if chain is None:
        return None

    kvals = sorted({loc[chain] for loc in tasks})
    if kvals != list(range(kvals[0], kvals[-1] + 1)):
        return None
    klo, khi = kvals[0], kvals[-1]

    # -- verify the chain structure concretely on every task -----------------
    lhs_keys, rhs_keys, acc_keys = [], [], []
    for loc in tasks:
        li = _active_in_deps(lhs, loc)
        ri = _active_in_deps(rhs, loc)
        ai = _active_in_deps(acc, loc)
        ao = _active_out_deps(acc, loc)
        if len(li) != 1 or li[0].data_ref is None:
            return None
        if len(ri) != 1 or ri[0].data_ref is None:
            return None
        if _active_out_deps(lhs, loc) or _active_out_deps(rhs, loc):
            return None
        if len(ai) != 1:
            return None
        if loc[chain] == klo:
            if ai[0].data_ref is None:
                return None
        else:
            d = ai[0]
            if (d.target_class != tc.name or d.target_flow != acc.name):
                return None
            pred = d.target_params(loc)
            if not isinstance(pred, dict):
                return None
            if any(pred[p] != (loc[p] - (p == chain)) for p in params):
                return None
        succ = [d for d in ao if d.target_class == tc.name
                and d.target_flow == acc.name]
        data_out = [d for d in ao if d.data_ref is not None]
        if loc[chain] < khi:
            if len(succ) != 1 or data_out:
                return None
            nxt = succ[0].target_params(loc)
            if not isinstance(nxt, dict):
                return None
            if any(nxt[p] != (loc[p] + (p == chain)) for p in params):
                return None
        else:
            if succ or len(data_out) != 1:
                return None
        lhs_keys.append((li[0].data_ref(loc)))
        rhs_keys.append((ri[0].data_ref(loc)))
        if loc[chain] == klo:
            acc_keys.append(ai[0].data_ref(loc))
        elif loc[chain] == khi:
            acc_keys.append(data_out[0].data_ref(loc))
        else:
            acc_keys.append(None)

    # -- factorization: lhs depends on (Pl, chain), rhs on (Pr, chain) -------
    lk = [_norm_key(k) for _, k in lhs_keys]
    rk = [_norm_key(k) for _, k in rhs_keys]
    free = [p for p in params if p != chain]
    ldeps = _key_param_deps(tasks, lk, params) - {chain}
    rdeps = _key_param_deps(tasks, rk, params) - {chain}
    if ldeps & rdeps or (ldeps | rdeps) != set(free):
        return None
    pl = sorted(ldeps, key=params.index)
    pr = sorted(rdeps, key=params.index)

    mvals = sorted({tuple(loc[p] for p in pl) for loc in tasks})
    nvals = sorted({tuple(loc[p] for p in pr) for loc in tasks})
    if len(tasks) != len(mvals) * len(nvals) * len(kvals):
        return None    # not a dense product space

    lhs_dc = lhs_keys[0][0]
    rhs_dc = rhs_keys[0][0]
    acc_dc = next(k for k in acc_keys if k is not None)[0]
    # every edge of a flow must read one single collection: a guarded
    # multi-collection input cannot collapse onto one store gather
    if any(dc is not lhs_dc for dc, _ in lhs_keys):
        return None
    if any(dc is not rhs_dc for dc, _ in rhs_keys):
        return None
    if any(k is not None and k[0] is not acc_dc for k in acc_keys):
        return None
    mi = {v: i for i, v in enumerate(mvals)}
    ni = {v: i for i, v in enumerate(nvals)}
    ki = {v: i for i, v in enumerate(kvals)}
    IA = np.zeros((len(mvals), len(kvals)), np.int64)
    IB = np.zeros((len(kvals), len(nvals)), np.int64)
    IC = np.full((len(mvals), len(nvals)), -1, np.int64)
    for loc, lkey, rkey, akey in zip(tasks, lk, rk, acc_keys):
        m = mi[tuple(loc[p] for p in pl)]
        n = ni[tuple(loc[p] for p in pr)]
        k = ki[loc[chain]]
        IA[m, k] = stores.row(lhs_dc, lkey)
        IB[k, n] = stores.row(rhs_dc, rkey)
        if akey is not None:
            row = stores.row(acc_dc, _norm_key(akey[1]))
            if IC[m, n] not in (-1, row):
                return None    # init and final writeback rows must agree
            IC[m, n] = row
    if (IC < 0).any():
        return None
    stores.written.add(acc_dc.name)

    combine = kernel.chain_combine
    an, bn, cn = lhs_dc.name, rhs_dc.name, acc_dc.name

    # -- layout selection: identity tile grids lower to dense operands -------
    # The step is then exactly ``C = body(A, B, C)`` on the whole matrices:
    # one kernel call, no gather or relayout.
    if (len({an, bn, cn}) == 3
            and stores.is_dense_grid(lhs_dc, IA)
            and stores.is_dense_grid(rhs_dc, IB)
            and stores.is_dense_grid(acc_dc, IC)):
        for dc in (lhs_dc, rhs_dc, acc_dc):
            stores.set_dense(dc)
        # the body takes its flows in declaration order, wherever the RW
        # flow is declared
        arg_names = [{id(lhs): an, id(rhs): bn, id(acc): cn}[id(f)]
                     for f in info.data_flows]

        def step_fn(st: dict) -> dict:
            st = dict(st)
            st[cn] = _call_one(kernel, 1, [st[nm] for nm in arg_names])[0]
            return st

        return step_fn

    ia, ib, ic = torch.from_numpy(IA), torch.from_numpy(IB), \
        torch.from_numpy(IC)
    dev_idx: dict[torch.device, tuple] = {}

    def step_fn(st: dict) -> dict:
        dev = st[cn].device
        if dev not in dev_idx:
            dev_idx[dev] = tuple(t.to(dev) for t in (ia, ib, ic))
        ja, jb, jc = dev_idx[dev]
        c = combine(st[an][ja], st[bn][jb], st[cn][jc])   # [M, N, ta, tb]
        st = dict(st)
        out = st[cn].clone()
        out[jc.reshape(-1)] = c.reshape(-1, *c.shape[2:]).to(out.dtype)
        st[cn] = out
        return st

    return step_fn


# ---------------------------------------------------------------------------
# pass 2: wavefront batching (one batched kernel call per (level, class))
# ---------------------------------------------------------------------------

def _wavefront_plan(tp, infos, stores: _Stores) -> tuple[list, dict]:
    """Resolve every data-flow value to a store row and hazard-check the
    in-place row reuse.

    *Every data-flow value lives in a store row*: a task's input names a
    collection tile directly (``data=``), a predecessor's flow value
    (recursively, an updated *version* of some tile), or a NEW arrow,
    backed by a zero-initialized scratch store.  Writable flows update
    their home row **in place**; successors gather from the same rows.
    Versions are tracked statically, and any interleaving where in-place
    reuse would clobber a still-needed version raises
    :class:`LoweringError` (→ unrolled pass / dynamic runtime).
    """
    order, levels = _task_graph(tp, infos)

    # value_of[(cname, key, flow_index)] = (store_name, row, version)
    #   version: ("init", L)    — row content as of the start of level L
    #            ("task", n, L) — written by node n at level L
    value_of: dict[tuple, tuple] = {}
    # writes[row] = [(level, node, is_scratch)]: is_scratch marks in-place
    # version storage (never a collection write in the source program)
    writes: dict[tuple[str, int], list[tuple[int, tuple, bool]]] = {}
    data_last: dict[tuple[str, int], int] = {}      # last collection write
    scratch_last: dict[tuple[str, int], int] = {}   # last in-place write
    reads: list[tuple[tuple[str, int], tuple, int]] = []

    plans = []
    for node in order:
        cname, i = node
        info = infos[cname]
        if not info.data_flows:
            continue                      # CTL-only class: shapes levels only
        tc, loc = info.tc, info.tasks[i]
        key = tc.make_key(loc)
        L = levels[node]
        writable_ids = {id(f) for f in info.writable_flows}
        # per flow: ("row", name, row) | ("none",) | ("new", shape, dtype)
        in_plan: list[tuple] = []
        in_vers: list[tuple | None] = []          # version read, per flow
        for f in info.data_flows:
            deps = _active_in_deps(f, loc)
            if len(deps) > 1:
                raise LoweringError(
                    f"{cname}{key} flow {f.name}: {len(deps)} active input "
                    f"deps — ambiguous source")
            if not deps or deps[0].null:
                in_plan.append(("none",))
                in_vers.append(None)
                continue
            d = deps[0]
            if d.data_ref is not None:
                dc, k = d.data_ref(loc)
                row = (dc.name, stores.row(dc, _norm_key(k)))
                ver = ("init", L)
            elif d.target_class is None:
                # NEW arrow: zeros of the declared type.  A writable flow
                # whose value never reaches a collection still needs a
                # store-resident home row so successors can gather it;
                # otherwise the zeros are made inline
                dtt = d.dtt or f.dtt
                shape, dtype = tuple(dtt.shape), dtt.dtype
                has_data_out = any(
                    dd.data_ref is not None
                    for dd in _active_out_deps(f, loc))
                if id(f) in writable_ids and not has_data_out:
                    row = stores.scratch_row(cname, f.name, key,
                                             shape, dtype)
                    ver = ("init", L)
                else:
                    in_plan.append(("new", shape, dtype))
                    in_vers.append(None)
                    continue
            else:
                ptc = tp.task_class(d.target_class)
                pkey = ptc.make_key(d.target_params(loc))
                pfi = next(ff.flow_index for ff in ptc.flows
                           if ff.name == d.target_flow)
                try:
                    pname, prow, ver = value_of[(d.target_class, pkey, pfi)]
                except KeyError:
                    raise LoweringError(
                        f"{cname}{key} flow {f.name}: predecessor value "
                        f"{d.target_class}{pkey}.{d.target_flow} has no "
                        f"store-resident home")
                row = (pname, prow)
            reads.append((row, ver, L))
            in_plan.append(("row",) + row)
            in_vers.append(ver)
        out_plan = []               # (primary|None, extras, writable) per flow
        for fj, f in enumerate(info.data_flows):
            drows = []
            for d in _active_out_deps(f, loc):
                if d.data_ref is not None:
                    dc, k = d.data_ref(loc)
                    drows.append((dc.name, stores.row(dc, _norm_key(k))))
                    stores.written.add(dc.name)
            if id(f) in writable_ids:
                if drows:
                    primary, extras = drows[0], drows[1:]
                    data_last[primary] = max(data_last.get(primary, -1), L)
                    writes.setdefault(primary, []).append((L, node, False))
                else:
                    ip = in_plan[fj]
                    if ip[0] != "row":
                        raise LoweringError(
                            f"{cname}{key} flow {f.name}: writable flow with "
                            f"neither a collection target nor a "
                            f"store-resident input — no home row")
                    primary, extras = (ip[1], ip[2]), []
                    scratch_last[primary] = max(
                        scratch_last.get(primary, -1), L)
                    writes.setdefault(primary, []).append((L, node, True))
                value_of[(cname, key, f.flow_index)] = (
                    primary[0], primary[1], ("task", node, L))
                for w in extras:
                    writes.setdefault(w, []).append((L, node, False))
                    data_last[w] = max(data_last.get(w, -1), L)
                out_plan.append((primary, extras, True))
            else:
                ip = in_plan[fj]
                if ip[0] == "row":
                    # pass-through: successors read the same row/version
                    value_of[(cname, key, f.flow_index)] = (
                        ip[1], ip[2], in_vers[fj])
                elif drows and ip[0] != "new":
                    raise LoweringError(
                        f"{cname}{key} flow {f.name}: collection write from "
                        f"a flow with no input value")
                for w in drows:
                    writes.setdefault(w, []).append((L, node, False))
                    data_last[w] = max(data_last.get(w, -1), L)
                out_plan.append((None, drows, False))
        plans.append((node, L, cname, key, in_plan, out_plan))

    # ---- static hazard checks (violations → unrolled fallback) -------------
    for w, ws in writes.items():
        seen_levels = set()
        for lw, _, _ in ws:
            if lw in seen_levels:
                raise LoweringError(
                    f"store row {w}: two writers in one wavefront")
            seen_levels.add(lw)
    for row, ver, L in reads:
        if ver[0] == "task":
            # the version must survive from its creation to this read: no
            # other write may land strictly between (snapshot semantics
            # make same-level writes safe)
            lo = ver[2]
            for lw, _, _ in writes.get(row, ()):
                if lo < lw < L:
                    raise LoweringError(
                        f"store row {row}: version created at level {lo} "
                        f"overwritten at {lw} before its read at {L}")
        else:
            # collection read snapshotted at level Ls (the reader's level
            # for direct reads; earlier for pass-through forwarding).  The
            # snapshot must survive until gathered at L, and an in-place
            # *scratch* version parked on the row before Ls must never be
            # visible: the source program still sees the pristine tile
            # there (earlier collection writes ARE visible: the unrolled /
            # dynamic ordering semantics)
            Ls = ver[1]
            for lw, _, scratch in writes.get(row, ()):
                if Ls <= lw < L:
                    raise LoweringError(
                        f"store row {row}: snapshot taken at level {Ls} "
                        f"overwritten at {lw} before its read at {L}")
                if scratch and lw < Ls:
                    raise LoweringError(
                        f"store row {row}: scratch version written at level "
                        f"{lw} would be visible to the collection read at "
                        f"{Ls}")
    dirty: list[tuple[str, int]] = []
    for w, sl in scratch_last.items():
        dl = data_last.get(w, -1)
        if dl < 0:
            # scratch-only row: restore at the end (synthetic NEW stores
            # are exempt — their post-run content is never observed)
            if w[0] not in stores.scratch:
                dirty.append(w)
        elif sl > dl:
            raise LoweringError(
                f"store row {w}: in-place write at level {sl} after the "
                f"final collection write at {dl}")
    dirty_by_name: dict[str, np.ndarray] = {}
    for name, grp in itertools.groupby(sorted(dirty), key=lambda w: w[0]):
        dirty_by_name[name] = np.array([r for _, r in grp], np.int64)

    # plans: [(node, level, cname, key, in_plan, out_plan)]
    return plans, dirty_by_name


def _group_plans(plans, infos) -> dict[int, list]:
    """Group per-task plans into ONE batched kernel call per (wavefront,
    class, source signature) and build the gather/scatter specs.  Returns
    ``{level: [(kernel, n_writable, gathers, scatters, G), ...]}``."""
    by_level: dict[int, dict[tuple, list]] = {}
    for node, L, cname, key, in_plan, out_plan in plans:
        sig = (cname,
               tuple(ip if ip[0] in ("none", "new") else ("row", ip[1])
                     for ip in in_plan),
               tuple((p[0] if p else None, tuple(n for n, _ in ex), w)
                     for p, ex, w in out_plan))
        by_level.setdefault(L, {}).setdefault(sig, []).append(
            (in_plan, out_plan))

    level_specs: dict[int, list] = {}
    for L in sorted(by_level):
        specs = []
        for sig, members in by_level[L].items():
            # a group's tasks are independent, so their order is free:
            # in store-row order, consecutive rows gather as views and
            # scatter as slabs (the topological order leaves them reversed)
            members.sort(key=lambda m: (
                tuple(ip[2] for ip in m[0] if ip[0] == "row"),
                tuple(p[1] for p, _, _ in m[1] if p is not None)))
            cname = sig[0]
            info = infos[cname]
            G = len(members)
            # per data flow: None | (name, kind, arg) with kind "const"
            # (one row feeds the whole group), "range" (consecutive rows:
            # a view), "gather" (an index copy), or "new" (zeros of a
            # static shape made inline)
            gathers = []
            for fj in range(len(info.data_flows)):
                ip0 = members[0][0][fj]
                if ip0[0] == "none":
                    gathers.append(None)
                    continue
                if ip0[0] == "new":
                    gathers.append(("", "new", (ip0[1], ip0[2])))
                    continue
                name = ip0[1]
                rows = np.array([m[0][fj][2] for m in members], np.int64)
                if (rows == rows[0]).all():
                    gathers.append((name, "const", int(rows[0])))
                else:
                    idx = _Index(rows)
                    gathers.append((name, "range" if idx.sel is not None
                                    else "gather", idx))
            wi = {f.flow_index: j for j, f in enumerate(info.writable_flows)}
            scatters = []   # (name, _Index, src_kind, src_idx)
            for fj, f in enumerate(info.data_flows):
                _, _, writable = members[0][1][fj]
                if writable:
                    n_tgt = 1 + len(members[0][1][fj][1])
                    for t in range(n_tgt):
                        name = (members[0][1][fj][0] if t == 0
                                else members[0][1][fj][1][t - 1])[0]
                        rows = np.array(
                            [(m[1][fj][0] if t == 0
                              else m[1][fj][1][t - 1])[1]
                             for m in members], np.int64)
                        scatters.append((name, _Index(rows), "out",
                                         wi[f.flow_index]))
                else:
                    for t in range(len(members[0][1][fj][1])):
                        name = members[0][1][fj][1][t][0]
                        rows = np.array([m[1][fj][1][t][1]
                                         for m in members], np.int64)
                        scatters.append((name, _Index(rows), "in", fj))
            specs.append((info.kernel, len(info.writable_flows), gathers,
                          scatters, G))
        level_specs[L] = specs
    return level_specs


def _build_wavefront(tp, infos, stores: _Stores) -> Callable:
    """One batched call per (level, class, source signature).  Within one
    wavefront all tasks are independent (levels are longest-path: every
    dep edge strictly crosses levels), so each level runs as *gather all →
    compute groups → scatter all*, and its result does not depend on the
    order of its groups."""
    plans, dirty_by_name = _wavefront_plan(tp, infos, stores)
    level_specs = _group_plans(plans, infos)
    targets = sorted({s[0] for specs in level_specs.values()
                      for *_, scatters, _G in specs for s in scatters})
    dirty = {name: _Index(rows) for name, rows in dirty_by_name.items()}
    levels = [level_specs[L] for L in sorted(level_specs)]

    def step_fn(st: dict) -> dict:
        st = dict(st)
        for name in targets:            # the step writes clones, in place
            st[name] = st[name].clone()
        saved = {name: st[name][idx.on(st[name].device)].clone()
                 for name, idx in dirty.items()}
        for specs in levels:
            _run_level(st, specs)
        for name, idx in dirty.items():
            st[name][idx.on(st[name].device)] = saved[name]
        return st

    step_fn.levels = len(levels)
    step_fn.groups = sum(len(specs) for specs in levels)
    return step_fn


def _run_level(st: dict, specs) -> None:
    """One wavefront on stores the step owns: every group computes, then
    every scatter lands (level-atomic)."""
    pend = []                            # (name, _Index, value, batched)
    for kernel, nw, gathers, scatters, G in specs:
        args, batched = [], []
        for gth in gathers:
            if gth is None:
                args.append(None)
                batched.append(False)
                continue
            name, kind, arg = gth
            if kind == "new":
                shape, dtype = arg
                dev = next(iter(st.values())).device
                args.append(torch.zeros(shape, dtype=dtype, device=dev))
                batched.append(False)
            elif kind == "const":
                args.append(st[name][arg])
                batched.append(False)
            else:
                args.append(st[name][arg.on(st[name].device)])
                batched.append(True)
        if nw == 0:
            res, out_batched = (), False  # nothing written: nothing to run
        elif G == 1 or not any(batched):
            res, out_batched = _call_one(kernel, nw, args), False
        else:
            full = [a if a is None or b else a.expand(G, *a.shape)
                    for a, b in zip(args, batched)]
            res, out_batched = _call_group(kernel, nw, full), True
        for name, idx, src_kind, src_idx in scatters:
            if src_kind == "out":
                v, b = res[src_idx], out_batched
            else:
                v, b = args[src_idx], batched[src_idx]
            pend.append((name, idx, v, b))
    # a pending value that is a view of a store (a forwarded input, or a
    # body that returns its input) is copied before any write lands
    store_ptrs = {t.untyped_storage().data_ptr() for t in st.values()}
    for name, idx, v, b in pend:
        if v.untyped_storage().data_ptr() in store_ptrs:
            v = v.clone()
        store = st[name]
        n = len(idx.rows)
        if not b:
            v = v.expand(n, *v.shape)
        store[idx.on(store.device)] = v


# ---------------------------------------------------------------------------
# pass 3: generic unrolled dataflow (topological order)
# ---------------------------------------------------------------------------

def _task_graph(tp, infos):
    """Concrete task DAG (CTL edges count): returns ``(order, levels)``, a
    Kahn topological order over ``(cname, i)`` nodes and each node's
    *wavefront level* (longest path from a source; an edge always crosses
    levels strictly, so same-level tasks are mutually independent)."""
    index: dict[tuple[str, tuple], tuple[str, int]] = {}
    for cname, info in infos.items():
        for i, loc in enumerate(info.tasks):
            index[(cname, info.tc.make_key(loc))] = (cname, i)
    indeg = {v: 0 for v in index.values()}
    succs: dict[tuple[str, int], list] = {v: [] for v in index.values()}
    for cname, info in infos.items():
        for i, loc in enumerate(info.tasks):
            for f in info.tc.flows:
                for d in f.deps_out:
                    if d.target_class is None or not d.active(loc):
                        continue
                    tgt_tc = tp.task_class(d.target_class)
                    for tgt_loc in d.each_target(loc):
                        tgt = index.get(
                            (d.target_class, tgt_tc.make_key(tgt_loc)))
                        if tgt is None:
                            if tgt_tc.in_space is not None \
                                    and not tgt_tc.in_space(tgt_loc):
                                continue   # out-of-space edge: the
                                # generated bounds check drops it
                            raise LoweringError(
                                f"{cname}{info.tc.make_key(loc)} -> missing "
                                f"successor {d.target_class}({tgt_loc})")
                        succs[(cname, i)].append(tgt)
                        indeg[tgt] += 1
    ready = [v for v, n in indeg.items() if n == 0]
    levels = {v: 0 for v in ready}
    out = []
    while ready:
        v = ready.pop()
        out.append(v)
        for s in succs[v]:
            levels[s] = max(levels.get(s, 0), levels[v] + 1)
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if len(out) != len(indeg):
        raise LoweringError("task graph has a cycle")
    return out, levels


def _build_unrolled(tp, infos, stores: _Stores) -> Callable:
    order, _ = _task_graph(tp, infos)

    # per task, its input plan and output plan (host side)
    plans = []
    for cname, i in order:
        info = infos[cname]
        tc, loc = info.tc, info.tasks[i]
        key = tc.make_key(loc)
        # per data flow: ("store", name, row) | ("val", ck) | ("none",)
        # | ("new", shape, dtype)
        in_plan = []
        for f in info.data_flows:
            deps = _active_in_deps(f, loc)
            if len(deps) > 1:
                raise LoweringError(
                    f"{cname}{key} flow {f.name}: expected at most one "
                    f"active input dep, got {len(deps)}")
            if not deps or deps[0].null:
                in_plan.append(("none",))
                continue
            d = deps[0]
            if d.data_ref is not None:
                dc, k = d.data_ref(loc)
                in_plan.append(("store", dc.name,
                                stores.row(dc, _norm_key(k))))
            elif d.target_class is None:
                dtt = d.dtt or f.dtt
                in_plan.append(("new", tuple(dtt.shape), dtt.dtype))
            else:
                ptc = tp.task_class(d.target_class)
                pkey = ptc.make_key(d.target_params(loc))
                pfi = next(ff.flow_index for ff in ptc.flows
                           if ff.name == d.target_flow)
                in_plan.append(("val", (d.target_class, pkey, pfi)))
        out_plan = []       # per data flow: list of store rows to scatter
        for f in info.data_flows:
            rows = []
            for d in _active_out_deps(f, loc):
                if d.data_ref is not None:
                    dc, k = d.data_ref(loc)
                    rows.append((dc.name, stores.row(dc, _norm_key(k))))
                    stores.written.add(dc.name)
            out_plan.append(rows)
        plans.append((cname, key, info, in_plan, out_plan))
    targets = sorted({name for *_, out_plan in plans
                      for rows in out_plan for name, _ in rows})

    def step_fn(st: dict) -> dict:
        st = dict(st)
        for name in targets:            # the step writes clones, in place
            st[name] = st[name].clone()
        dev = next(iter(st.values())).device
        vals: dict[tuple, Any] = {}
        for cname, key, info, in_plan, out_plan in plans:
            args = []
            for kind, *ref in in_plan:
                if kind == "store":
                    # a copy: a later task may overwrite the row while
                    # this value is still forwarded
                    name, row = ref
                    args.append(st[name][row].clone())
                elif kind == "none":
                    args.append(None)
                elif kind == "new":
                    args.append(torch.zeros(ref[0], dtype=ref[1],
                                            device=dev))
                else:
                    args.append(vals[ref[0]])
            nw = len(info.writable_flows)
            res = _call_one(info.kernel, nw, args) if nw else ()
            wi = {f.flow_index: j for j, f in enumerate(info.writable_flows)}
            for fj, (f, rows) in enumerate(zip(info.data_flows, out_plan)):
                v = res[wi[f.flow_index]] if f.flow_index in wi else args[fj]
                vals[(cname, key, f.flow_index)] = v
                for name, row in rows:
                    st[name][row] = v
        return st

    return step_fn


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

class LoweredTaskpool:
    """A compiled incarnation of a PTG taskpool.

    ``step_fn``: pure function ``{collection_name: store} -> same``, one
    full taskpool execution on the stores' device.  ``initial_stores()``
    builds the stores from the collections on ``device``.  ``execute()``
    runs one step eagerly and writes the tiles back to the source
    collections (the dynamic path's completion semantics), bumping each
    tile's version.
    """

    def __init__(self, tp, step_fn: Callable, stores: _Stores, mode: str,
                 device: torch.device) -> None:
        self.taskpool = tp
        self.step_fn = step_fn
        self._stores = stores
        self.mode = mode    # "chain-collapse" | "wavefront" | "unrolled"
        self.device = device
        # the wavefront plan's size: its levels, and its batched calls
        # (groups) over all levels; None for the other passes
        self.levels = getattr(step_fn, "levels", None)
        self.groups = getattr(step_fn, "groups", None)

    def initial_stores(self) -> dict[str, torch.Tensor]:
        return self._stores.materialize(self.device)

    @property
    def written_collections(self) -> set[str]:
        return set(self._stores.written)

    @property
    def layout(self) -> dict[str, str]:
        """Each store's layout: ``"stacked"``, ``"dense"`` or
        ``"scratch"``."""
        return dict(self._stores.layout)

    def execute(self) -> dict[str, torch.Tensor]:
        out = self.step_fn(self.initial_stores())
        self._stores.writeback(out)
        return out


def lower_taskpool(tp, context: Any = None, mesh: Any = None,
                   passes: str = "auto",
                   device: str | torch.device = "cuda") -> LoweredTaskpool:
    """Lower a regular PTG taskpool to one plan over stores on ``device``.

    ``passes``: ``"auto"`` tries chain-collapse → wavefront → unrolled
    (most specialized first); or force one of ``"chain-collapse"``,
    ``"wavefront"``, ``"unrolled"``.

    ``device="cuda"`` (the default) raises where no card is visible; the
    tests pass ``device="cpu"``.  ``mesh=``, or a context over more than
    one rank, raises ``NotImplementedError``: multi-rank lowering is not
    ported.  Raises :class:`LoweringError` when the structure is not
    lowerable; the caller then runs the dynamic scheduler instead (same
    taskpool object).
    """
    if mesh is not None or (context is not None
                            and getattr(context, "nb_ranks", 1) > 1):
        raise NotImplementedError("multi-rank lowering is not ported")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lower_taskpool: no CUDA device is visible; "
                           "pass device='cpu' to lower onto the host")
    if passes not in ("auto", "chain-collapse", "wavefront", "unrolled"):
        raise ValueError(f"unknown lowering pass {passes!r}")
    infos = _analyze(tp)

    if passes in ("auto", "chain-collapse"):
        stores = _Stores()
        step = _try_chain_collapse(tp, infos, stores)
        if step is not None:
            return LoweredTaskpool(tp, step, stores, "chain-collapse",
                                   device)
        if passes == "chain-collapse":
            raise LoweringError("taskpool does not chain-collapse")
    if passes in ("auto", "wavefront"):
        stores = _Stores()
        try:
            step = _build_wavefront(tp, infos, stores)
            return LoweredTaskpool(tp, step, stores, "wavefront", device)
        except LoweringError:
            if passes == "wavefront":
                raise
    stores = _Stores()
    step = _build_unrolled(tp, infos, stores)
    return LoweredTaskpool(tp, step, stores, "unrolled", device)

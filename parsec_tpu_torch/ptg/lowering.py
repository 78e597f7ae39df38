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

**The lowering cache.**  Each pass emits a *structural signature* beside
its step: store names and rows, kernels by identity, index arrays by
value (:func:`_freeze`).  PyTorch has no compile step, so
:data:`lowering_cache` (a :class:`LoweringCache`, FIFO of 128 entries,
the ``lowering_cache`` param) is an identity cache of the built step,
the closure with its index tensors: a structurally identical
re-lowering gets the first lowering's step object back, whose indices
are already on the device once it ran.  The analysis, the signature and
the new step's build still run on a hit, so a hit saves only the index
upload, and on the dense chain-collapse path (no index) nothing.  The
key adds the mode, the lowering device and :func:`_backend_signature`.  :meth:`LoweredTaskpool.warm` does only
what the card has to prepare: it loads (or builds) the kernel libraries
the plan's traceables name (``Traceable.libs``, :mod:`..ops._build`) and
puts the plan's index tensors on the device, executing nothing.
:func:`structural_fingerprint` is the cross-process summary the tuner
signs workloads with (:mod:`parsec_tpu_torch.tune.signature`); it gives
the JAX package's dict on the same pool.

**Open stores.**  A collection that cannot list its keys (the paged KV
cache), or an undeclared dict collection, gets a store that grows while
the plan is built, for each key its ``has_key`` oracle vouches for (see
:class:`_Stores`); so the LLM pools lower, and their lowered
fingerprints are the JAX package's.

**Megakernel regions** (:func:`lower_regions`): graphcheck's verified
graph is carved into convex regions of at most
``lowering_region_max_tasks`` tasks (:mod:`..analysis.regions`), each
lowered to one step over its local rows of a shared table on the
device, and scheduled as one task of a region pool
(:class:`RegionLoweredTaskpool`).  ``compile()`` prepares the regions
smallest first under ``lowering_compile_budget_s`` and sheds what the
budget cannot afford to the eager path (prepared at first run).
:func:`warm_cache` and ``python -m parsec_tpu_torch.ptg.lowering --warm
<workload>`` prepare a named workload's lowerings ahead of a run,
launching no kernel.

Left out, each still in ``ROADMAP.md``: the JAX package's persistent
compile cache (``_ensure_persistent_compile_cache``): it has no
counterpart, since the kernel libraries already persist in their build
directory (:mod:`..ops._build`); ``lowering_scan_min`` folding of
identical levels into a ``lax.scan`` (the levels run in a Python loop;
CUDA-graph capture of a step or a region step is later work); mesh SPMD
and multi-rank lowering, which raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ..core.params import params as _params
from ..data.data import ACCESS_RW, ACCESS_WRITE

__all__ = ["LoweredRegion", "LoweringCache", "LoweringError",
           "LoweredTaskpool", "RegionLoweredTaskpool", "Traceable",
           "find_traceable", "lower_regions", "lower_taskpool",
           "lowering_cache", "register_traceable", "structural_fingerprint",
           "warm_cache"]

_params.register(
    "lowering_cache", True,
    "memoize built lowered steps process-wide, keyed by the lowering's "
    "structural signature (task classes, store rows, kernels, device): a "
    "re-lowered identical taskpool reuses the step and its index tensors")
_params.register(
    "lowering_region_max_tasks", 256,
    "member cap per megakernel region (analysis.regions): regions are "
    "convex wavefront-level bands of the verified task graph, one "
    "prepared step each; smaller regions mean cheaper preparations under "
    "lowering_compile_budget_s and more runtime boundaries; 0 lowers "
    "each weakly-connected component whole")
# the autotuner's declared domain: region caps move in powers of two
_params.declare_knob("lowering_region_max_tasks", lo=16, hi=1024,
                     scale="log2")
_params.register(
    "lowering_compile_budget_s", 0.0,
    "wall-clock budget for staged region preparation (smallest region "
    "first): once it is spent, the remaining regions run eager (prepared "
    "at first run); cache hits are always free; 0.0 = unbudgeted")


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

    ``libs`` names the kernel libraries (``csrc/<name>.cu``) the body
    launches on a CUDA tensor, for :meth:`LoweredTaskpool.warm`.
    """

    __slots__ = ("apply", "bilinear", "chain_combine", "stacked", "inplace",
                 "libs")

    def __init__(self, apply: Callable, bilinear: bool = False,
                 chain_combine: Callable | None = None,
                 stacked: Callable | None = None,
                 inplace: Callable | None = None,
                 libs: tuple = ()) -> None:
        self.apply = apply
        self.bilinear = bilinear
        self.chain_combine = chain_combine or (
            _default_bilinear_chain if bilinear else None)
        self.stacked = stacked
        self.inplace = inplace
        self.libs = tuple(libs)


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
                       inplace: Callable | None = None,
                       libs: tuple = ()) -> Traceable:
    t = Traceable(apply, bilinear=bilinear, chain_combine=chain_combine,
                  stacked=stacked, inplace=inplace, libs=libs)
    with _lock:
        _traceables[name] = t
    return t


def find_traceable(name: str) -> Traceable | None:
    with _lock:
        return _traceables.get(name)


# ---------------------------------------------------------------------------
# the lowering cache
# ---------------------------------------------------------------------------

def _freeze(o: Any):
    """Hashable deep-freeze of a pass's emission payload.  Arrays freeze
    by value (shape, dtype and bytes; a blake2b digest past 4 KiB, so a
    task-sized plan does not pin megabytes in every signature), an
    :class:`_Index` by its rows, callables and kernels by IDENTITY: the
    key keeps them alive, and two distinct closures never false-hit."""
    if isinstance(o, _Index):
        o = o.rows
    if isinstance(o, np.ndarray):
        b = o.tobytes()
        if len(b) > 4096:
            b = hashlib.blake2b(b, digest_size=20).digest()
        return ("nd", o.shape, o.dtype.str, b)
    if isinstance(o, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in o.items()))
    if isinstance(o, (list, tuple)):
        return tuple(_freeze(v) for v in o)
    return o


class LoweringCache:
    """Process-global memo of built lowered steps, keyed by structure.

    Equal signature means the same step: a re-lowered structurally
    identical taskpool gets the already-built step, whose index tensors
    are on the device once it ran or was warmed.  Bounded FIFO (oldest evicted), so many
    distinct lowerings cannot grow it without bound."""

    MAX_ENTRIES = 128

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._built: dict = {}
        self.hits = 0
        self.misses = 0

    def peek(self, key) -> Any:
        """Probe without building (no hit/miss accounting)."""
        if key is None:
            return None
        with self._lock:
            return self._built.get(key)

    def get_or_build(self, key, build: Callable[[], Any]):
        if key is None:
            return build()
        with self._lock:
            f = self._built.get(key)
            if f is not None:
                self.hits += 1
                return f
        f = build()     # outside the lock: a build may take a while
        with self._lock:
            # a concurrent builder may have won the race: keep and return
            # ITS entry, so identity sharing holds across racing threads
            won = self._built.setdefault(key, f)
            if won is f:
                self.misses += 1
            else:
                self.hits += 1
            while len(self._built) > self.MAX_ENTRIES:
                self._built.pop(next(iter(self._built)))
        return won

    def clear(self) -> None:
        with self._lock:
            self._built.clear()
            self.hits = 0
            self.misses = 0


lowering_cache = LoweringCache()


def _backend_signature() -> tuple:
    """``(torch version, "cuda" | "cpu", device name)``: folded into every
    cache key, and the backend column of the tuning DB and the perf
    ledger, so a step or a vector made for one backend never serves
    another."""
    has_card = torch.cuda.is_available()
    kind = ""
    if has_card:
        try:
            kind = torch.cuda.get_device_name() or ""
        except Exception:       # noqa: BLE001 — a name is advisory
            kind = ""
    return (torch.__version__, "cuda" if has_card else "cpu", kind)


def structural_fingerprint(obj) -> dict:
    """Cross-process-stable structural summary of a taskpool (or of a
    :class:`LoweredTaskpool`): the tuner's signature seam.  It keeps the
    axes the in-process signatures discriminate on, by name: task classes
    (name, task count, kernel name, data and writable flow names), the
    wavefront shape (level count, widest level) and, for a lowered pool,
    its mode and each store's row count.  The kernel-name axis reads a
    ``name`` or ``fn.__name__`` attribute, which a :class:`Traceable` has
    not, so it is ``""`` for every class, as in the JAX package (whose
    dict this equals on the same pool)."""
    low = obj if isinstance(obj, LoweredTaskpool) else None
    tp = low.taskpool if low is not None else obj
    infos = _analyze(tp)
    classes = []
    total = 0
    for cname in sorted(infos):
        ci = infos[cname]
        k = ci.kernel
        kname = ""
        if k is not None:
            kname = (getattr(k, "name", None)
                     or getattr(getattr(k, "fn", None), "__name__", "")
                     or "")
        total += len(ci.tasks)
        classes.append([cname, len(ci.tasks), kname,
                        sorted(f.name for f in ci.data_flows),
                        sorted(f.name for f in ci.writable_flows)])
    fp: dict = {"classes": classes, "ntasks": total}
    try:
        _order, levels = _task_graph(tp, infos)
        if levels:
            widths: dict[int, int] = {}
            for lv in levels.values():
                widths[lv] = widths.get(lv, 0) + 1
            fp["wavefront"] = [1 + max(levels.values()),
                               max(widths.values())]
    except LoweringError:
        pass        # irregular graph: the class table still discriminates
    if low is not None:
        fp["mode"] = low.mode
        fp["stores"] = {name: int(low._stores.nrows.get(name, 0))
                        for name in sorted(low._stores.dcs)}
    return fp


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
        if getattr(tc, "stage_in_hook", None) is not None \
                or getattr(tc, "stage_out_hook", None) is not None:
            raise LoweringError(
                f"task class {tc.name}: custom stage hooks own data "
                f"placement — they run on the dynamic device path only")
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
    get synthetic zero-initialized scratch stores.

    **Open stores.**  A collection that cannot list its keys (the paged
    KV cache), or an undeclared dict collection (``open_key_space``) even
    when some of its keys exist (a seeded token chain), is *open*: its
    rows start with the keys it knows, and grow while the plan is built,
    for each key its ``has_key`` oracle vouches for (a tiled grid's
    out-of-bounds key stays an error).  Every row exists before any
    tensor is made, so a store never grows on the device, and never
    inside a step."""

    def __init__(self) -> None:
        self.dcs: dict[str, Any] = {}
        self.rows: dict[str, dict[tuple, int]] = {}
        self.written: set[str] = set()
        self.layout: dict[str, str] = {}
        self.nrows: dict[str, int] = {}
        self.shape: dict[str, tuple] = {}   # uniform tile shape per store
        self.dtype: dict[str, torch.dtype] = {}
        self.open: set[str] = set()         # lazily extended key spaces
        self.scratch: set[str] = set()      # synthetic NEW-flow stores

    def _ensure(self, dc) -> None:
        name = dc.name
        if name in self.dcs:
            return
        try:
            keys = _collection_keys(dc)
        except LoweringError:
            keys = []                   # not enumerable: an open key space
        if not keys or bool(getattr(dc, "open_key_space", False)):
            self.dcs[name] = dc
            self.rows[name] = {_norm_key(k): i for i, k in enumerate(keys)}
            self.nrows[name] = len(keys)
            self.layout[name] = "stacked"
            self.open.add(name)
            if keys:
                first = _value(dc, _norm_key(keys[0]))
                self.shape[name] = tuple(first.shape)
                self.dtype[name] = first.dtype
            return
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
        if r is not None:
            return r
        # an open store grows only for a key its collection vouches for
        if name in self.open and getattr(dc, "has_key",
                                         lambda *k: False)(*key):
            val = _value(dc, key)
            shape = self.shape.setdefault(name, tuple(val.shape))
            self.dtype.setdefault(name, val.dtype)
            if tuple(val.shape) != shape:
                raise LoweringError(
                    f"collection {name}: ragged tiles "
                    f"({tuple(val.shape)} vs {shape}); lowering needs "
                    f"uniform tile shapes")
            r = self.nrows[name]
            self.rows[name][key] = r
            self.nrows[name] = r + 1
            return r
        raise LoweringError(f"{name}: key {key} outside the store")

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
        """The stores on ``device``: each a stack of its tiles in row order
        (or the dense matrix), built on the host and moved with one copy
        when every tile is on the host, else stacked on ``device`` (a tile
        already there is not moved); scratch stores start as zeros on the
        device.  A store no plan referenced is left out."""
        out = {}
        for name, dc in self.dcs.items():
            if self.layout[name] == "dense":
                out[name] = dc.to_tensor().to(device)
                continue
            if not self.rows[name]:
                continue
            tiles: list[Any] = [None] * self.nrows[name]
            for k, i in self.rows[name].items():
                tiles[i] = _value(dc, k)
            if all(t.device.type == "cpu" for t in tiles):
                out[name] = torch.stack(tiles).to(device)
            else:
                out[name] = torch.stack([t.to(device) for t in tiles])
        for name in self.scratch:
            out[name] = torch.zeros((self.nrows[name],) + self.shape[name],
                                    dtype=self.dtype[name], device=device)
        return out

    def writeback(self, values: dict[str, torch.Tensor]) -> None:
        """Every tile of a written store becomes a tensor of its own on its
        collection's newest copy, whose version is bumped, on the device
        of the value it replaces: a host copy's tiles come back in one
        copy of the store, a copy already on the store's device stays
        there with no round trip."""
        for name in self.written:
            dc = self.dcs[name]
            src = values[name]
            moved: dict[torch.device, torch.Tensor] = {src.device: src}
            dense = self.layout[name] == "dense"
            for key, i in self.rows[name].items():
                copy = dc.data_of(*key).newest_copy()
                old = copy.value
                dev = (old.device if isinstance(old, torch.Tensor)
                       else torch.device("cpu"))
                arr = moved.get(dev)
                if arr is None:
                    arr = moved[dev] = src.to(dev)
                if dense:
                    m, n = key
                    tile = arr[m * dc.mb:(m + 1) * dc.mb,
                               n * dc.nb:(n + 1) * dc.nb]
                else:
                    tile = arr[i]
                copy.value = tile.clone(memory_format=torch.contiguous_format)
                copy.version += 1


class _Index:
    """Store rows as an index: a slice when they are one run of
    consecutive rows (a view on read, a slab on write), else a long
    tensor of any shape, kept per device (:meth:`LoweredTaskpool.warm`
    puts it there ahead of the first step)."""

    __slots__ = ("rows", "sel", "_dev")

    def __init__(self, rows: np.ndarray) -> None:
        self.rows = rows
        r0 = int(rows.flat[0])
        self.sel = (slice(r0, r0 + len(rows))
                    if rows.ndim == 1 and (np.diff(rows) == 1).all()
                    else None)
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

        return step_fn, ("chain-dense", kernel, tuple(arg_names), an, bn, cn)

    ia, ib, ic = _Index(IA), _Index(IB), _Index(IC.reshape(-1))
    m_n = IC.shape

    def step_fn(st: dict) -> dict:
        dev = st[cn].device
        ja, jb, jc = ia.on(dev), ib.on(dev), ic.on(dev)
        c = combine(st[an][ja], st[bn][jb],
                    st[cn][jc].reshape(*m_n, *st[cn].shape[1:]))
        st = dict(st)
        out = st[cn].clone()
        out[jc] = c.reshape(-1, *c.shape[2:]).to(out.dtype)
        st[cn] = out
        return st

    step_fn.indices = (ia, ib, ic)
    return step_fn, ("chain-gather", kernel, an, bn, cn,
                     _freeze(IA), _freeze(IB), _freeze(IC))


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


def _build_wavefront(tp, infos, stores: _Stores) -> tuple[Callable, tuple]:
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
    step_fn.indices = tuple(dirty.values()) + _level_indices(levels)
    sig = ("wavefront", _freeze(dirty_by_name), tuple(
        tuple((kernel, nw, _freeze(gathers), _freeze(scatters), G)
              for kernel, nw, gathers, scatters, G in specs)
        for specs in levels))
    return step_fn, sig


def _level_indices(levels: list) -> tuple:
    """Every index tensor a list of levels' groups gathers or scatters
    by (what :func:`_prepare` puts on the device)."""
    return tuple(
        x for specs in levels for _k, _nw, gathers, scatters, _G in specs
        for x in ([g[2] for g in gathers if g is not None]
                  + [sc[1] for sc in scatters])
        if isinstance(x, _Index))


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


def _build_unrolled(tp, infos, stores: _Stores) -> tuple[Callable, tuple]:
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

    sig = ("unrolled", tuple(
        (cname, key, info.kernel,
         tuple(f.flow_index for f in info.data_flows),
         tuple(f.flow_index for f in info.writable_flows),
         _freeze(in_plan), _freeze(out_plan))
        for cname, key, info, in_plan, out_plan in plans))
    return step_fn, sig


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

class LoweredTaskpool:
    """A compiled incarnation of a PTG taskpool.

    ``step_fn``: pure function ``{collection_name: store} -> same``, one
    full taskpool execution on the stores' device; shared through
    :data:`lowering_cache` with every structurally identical lowering.
    ``signature`` is the pass's structural signature (its cache key's
    last part).  ``initial_stores()`` builds the stores from the
    collections on ``device``.  ``execute()`` runs one step eagerly and
    writes the tiles back to the source collections (the dynamic path's
    completion semantics), bumping each tile's version.
    """

    def __init__(self, tp, step_fn: Callable, stores: _Stores, mode: str,
                 device: torch.device, signature: Any = None,
                 kernels: tuple = ()) -> None:
        self.taskpool = tp
        self.step_fn = step_fn
        self._stores = stores
        self.mode = mode    # "chain-collapse" | "wavefront" | "unrolled"
        self.device = device
        self.signature = signature
        self._kernels = kernels     # the plan's traceables (warm's libs)
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

    def warm(self) -> dict[str, float]:
        """Prepare the card for the first step and execute nothing: load
        (or build) the kernel libraries the plan's traceables name
        (``load_s``; none on the host, whose wrappers take the plain
        versions) and put the plan's index tensors on the device
        (``upload_s``).  Returns the seconds of each part."""
        load_s, upload_s = _prepare(self.step_fn, self._kernels,
                                    self.device)
        return {"load_s": round(load_s, 4), "upload_s": round(upload_s, 4)}

    def execute(self) -> dict[str, torch.Tensor]:
        out = self.step_fn(self.initial_stores())
        self._stores.writeback(out)
        return out


def _prepare(step: Callable, kernels: tuple,
             device: torch.device) -> tuple[float, float]:
    """What the card prepares for a step, executing nothing: the kernel
    libraries its traceables name, loaded (or built; none on the host,
    whose wrappers take the plain versions), then its index tensors on
    the device.  Returns the seconds of each part."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        from ..ops import _build
        for name in sorted({lib for k in kernels for lib in k.libs}):
            _build.load(name)
    t1 = time.perf_counter()
    for idx in getattr(step, "indices", ()):
        idx.on(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return t1 - t0, time.perf_counter() - t1


def _cached(mode: str, device: torch.device, step: Callable,
            sig: Any) -> Callable:
    """The built step of this structure: ``step`` on a miss, the step of
    the first identical lowering on a hit (``step``, already built, is
    then dropped)."""
    if not _params.get("lowering_cache"):
        return step
    key = (mode, str(device), _backend_signature(), sig)
    return lowering_cache.get_or_build(key, lambda: step)


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
    kernels = tuple({id(i.kernel): i.kernel for i in infos.values()
                     if i.kernel is not None}.values())

    def lowered(built, stores: _Stores, mode: str) -> LoweredTaskpool:
        step, sig = built
        return LoweredTaskpool(tp, _cached(mode, device, step, sig), stores,
                               mode, device, signature=sig, kernels=kernels)

    if passes in ("auto", "chain-collapse"):
        stores = _Stores()
        built = _try_chain_collapse(tp, infos, stores)
        if built is not None:
            return lowered(built, stores, "chain-collapse")
        if passes == "chain-collapse":
            raise LoweringError("taskpool does not chain-collapse")
    if passes in ("auto", "wavefront"):
        stores = _Stores()
        try:
            return lowered(_build_wavefront(tp, infos, stores), stores,
                           "wavefront")
        except LoweringError:
            if passes == "wavefront":
                raise
    stores = _Stores()
    return lowered(_build_unrolled(tp, infos, stores), stores, "unrolled")


# ---------------------------------------------------------------------------
# megakernel regions (MPK): one prepared step per verified subgraph,
# runtime scheduling only at region boundaries, under a compile budget
# ---------------------------------------------------------------------------

class LoweredRegion:
    """One convex subregion of a taskpool, lowered to one step.

    The step is a function over *region-local row slices*: the runtime
    boundary gathers the rows the region touches from the shared table
    on the device (``index_select``), calls the step, and scatters the
    written rows back (``index_copy_``): deps and scheduling live at this
    boundary alone, the MPK contract."""

    __slots__ = ("index", "ntasks", "level_lo", "level_hi", "step_fn",
                 "signature", "touched", "written", "shapes", "kernels",
                 "preds", "succs", "eager", "compiled", "compile_s",
                 "trace_s", "_exec", "_dev_rows")

    def __init__(self, index: int, ntasks: int, level_lo: int,
                 level_hi: int, step_fn: Callable | None, signature: Any,
                 touched: dict[str, np.ndarray],
                 written: dict[str, tuple[np.ndarray, np.ndarray]],
                 shapes: dict[str, tuple], kernels: tuple = ()) -> None:
        self.index = index
        self.ntasks = ntasks
        self.level_lo = level_lo
        self.level_hi = level_hi
        self.step_fn = step_fn          # None: CTL-only region (no data)
        self.signature = signature
        self.touched = touched          # store -> global rows gathered
        self.written = written          # store -> (global rows, local rows)
        self.shapes = shapes            # store -> (shape, dtype), local
        self.kernels = kernels          # the traceables its step calls
        self.preds: set[int] = set()    # region deps (task + row-conflict)
        self.succs: set[int] = set()
        self.eager = False              # budget-shed: prepared at first run
        self.compiled = False
        self.compile_s = 0.0
        self.trace_s = 0.0
        self._exec = None
        self._dev_rows: dict[tuple, torch.Tensor] = {}

    def rows_on(self, what: tuple, rows: np.ndarray,
                device: torch.device) -> torch.Tensor:
        """The boundary rows ``what`` as a long tensor on ``device``, made
        once."""
        t = self._dev_rows.get((what, device))
        if t is None:
            t = self._dev_rows[(what, device)] = torch.as_tensor(
                rows, dtype=torch.long, device=device)
        return t

    def __repr__(self) -> str:
        state = ("compiled" if self.compiled
                 else "eager" if self.eager else "cold")
        return (f"<LoweredRegion {self.index}: {self.ntasks} tasks, "
                f"levels {self.level_lo}..{self.level_hi}, {state}>")




class RegionLoweredTaskpool:
    """A taskpool lowered to a DAG of megakernel regions.

    **What "compile" means here.**  PyTorch has no program to compile: a
    region is *compiled* once it is prepared, which executes nothing.
    Its step is built through :data:`lowering_cache` (regions with the
    same signature and local shapes share one step, whose index tensors
    are then on the device already), the kernel libraries its
    traceables name are loaded (``Traceable.libs``, :mod:`..ops._build`),
    and its index tensors are put on the device.  ``compile_s`` is that
    preparation's wall (synchronized on a card); ``trace_s`` stays 0.0
    (the step is built by :func:`lower_regions`, there is no trace).  An
    *eager* region (shed by the budget) runs the same step, which then
    uploads its indices and loads its libraries at first run.  A region
    is never captured into a CUDA graph.

    ``compile(budget_s=)`` prepares region by region, smallest first,
    under the wall-clock budget; regions the budget cannot afford run
    eager.  ``taskpool()`` builds a PTG pool with ONE task per region
    (CTL edges mirroring the region DAG), so the runtime schedules
    regions like tasks: deps, priorities, worker concurrency.
    ``execute()`` materializes the shared row table on the device, runs
    the region pool on a Context and writes the tiles back.

    ``stats()`` has the JAX package's keys; ``xla_calls`` counts calls of
    a prepared region's step (one per compiled region run), and
    ``eager_runs`` the runs of a shed one.

    **Ordering on the card.**  Every region body issues on the table's
    stream, the current stream of the thread that materialized the
    table, so the region DAG, which orders the bodies on the host, also
    orders their scatters and gathers on the card.
    """

    def __init__(self, tp, stores: _Stores, regions: list[LoweredRegion],
                 dirty_by_name: dict[str, np.ndarray],
                 device: torch.device) -> None:
        self.source = tp            # the task-grained pool this lowers
        self.mode = "region"
        self.device = device
        self._stores = stores
        self.regions = regions
        self.dirty_by_name = dirty_by_name
        self._lock = threading.Lock()
        self._compile_done = False
        self._dirty_saved: dict[str, torch.Tensor] = {}
        self._finalized = True
        self._stream = None
        self.xla_calls = 0          # prepared-step calls (lifetime)
        self.eager_runs = 0

    # -- compile budget ------------------------------------------------------
    def _cache_key(self, reg: LoweredRegion):
        if not _params.get("lowering_cache"):
            return None
        shapes = tuple(sorted((nm, tuple(sh), str(dt))
                              for nm, (sh, dt) in reg.shapes.items()))
        return ("region", str(self.device), _backend_signature(), shapes,
                reg.signature)

    def compile(self, budget_s: float | None = None,
                note: Callable | None = None) -> dict:
        """Staged preparation, SMALLEST region first.

        ``budget_s`` defaults to the ``lowering_compile_budget_s`` param
        (0 = unbudgeted).  The budget is enforced *between* regions:
        before each one the spent wall clock plus a per-task cost
        estimate (measured from the regions already prepared) must fit,
        else the region is shed to the eager path.  Ascending order makes
        the estimate load-bearing: the cheap regions measure the rate
        that guards the expensive ones.  Cache hits are free and never
        shed, so a warm process prepares nothing.  ``note(**kw)``
        receives one progress record per region."""
        if budget_s is None:
            b = _params.get("lowering_compile_budget_s")
            budget_s = float(b) if b and b > 0 else None
        t_start = time.perf_counter()
        rate = 0.0                  # measured preparation seconds per task
        for reg in sorted(self.regions, key=lambda r: r.ntasks):
            if reg.step_fn is None or reg.compiled or reg._exec is not None:
                continue
            key = self._cache_key(reg)
            cached = lowering_cache.peek(key)
            if cached is not None:
                reg._exec = lowering_cache.get_or_build(key, lambda: cached)
                reg.compiled, reg.eager = True, False
                reg.compile_s = reg.trace_s = 0.0
                if note is not None:
                    note(region=reg.index, ntasks=reg.ntasks,
                         compile_s=0.0, cached=True)
                continue
            if budget_s is not None:
                remaining = budget_s - (time.perf_counter() - t_start)
                if remaining <= 0 or rate * reg.ntasks > remaining:
                    reg.eager = True
                    if note is not None:
                        note(region=reg.index, ntasks=reg.ntasks,
                             eager=True, budget_s=budget_s)
                    continue
            if note is not None:
                note(region=reg.index, ntasks=reg.ntasks, compiling=True)

            def build(reg=reg):
                t0 = time.perf_counter()
                for nm, rows in reg.touched.items():
                    reg.rows_on(("t", nm), rows, self.device)
                for nm, (grows, lrows) in reg.written.items():
                    reg.rows_on(("g", nm), grows, self.device)
                    reg.rows_on(("l", nm), lrows, self.device)
                _prepare(reg.step_fn, reg.kernels, self.device)
                reg.compile_s = time.perf_counter() - t0
                return reg.step_fn

            reg._exec = lowering_cache.get_or_build(key, build)
            reg.compiled, reg.eager = True, False
            if reg.ntasks:
                rate = max(rate, (reg.compile_s + reg.trace_s) / reg.ntasks)
            if note is not None:
                note(region=reg.index, ntasks=reg.ntasks,
                     compile_s=round(reg.compile_s, 4),
                     trace_s=round(reg.trace_s, 4))
        self._compile_done = True
        return self.stats()

    def stats(self) -> dict:
        data_regions = [r for r in self.regions if r.step_fn is not None]
        return {
            "regions": len(self.regions),
            "regions_compiled": sum(r.compiled for r in data_regions),
            "regions_eager": sum(r.eager for r in data_regions),
            "ntasks": sum(r.ntasks for r in self.regions),
            "trace_s": round(sum(r.trace_s for r in data_regions), 4),
            "compile_s": round(sum(r.compile_s for r in data_regions), 4),
            "xla_calls": self.xla_calls,
            "eager_runs": self.eager_runs,
        }

    # -- execution -----------------------------------------------------------
    def materialize_table(self) -> dict[str, torch.Tensor]:
        """The shared row table the regions gather from and scatter into:
        the stores' tensors on the lowering device (regions write
        disjoint rows, ordered by the region DAG).  Dirty rows (in-place
        value homes the source program never writes back) are
        snapshotted for the restore at finalize."""
        table = self._stores.materialize(self.device)
        self._dirty_saved = {
            nm: table[nm].index_select(0, torch.as_tensor(
                rows, dtype=torch.long, device=self.device))
            for nm, rows in self.dirty_by_name.items()}
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._finalized = False
        return table

    def run_region(self, r: int, table: dict[str, torch.Tensor]) -> None:
        """Execute region ``r`` against the shared table: gather the rows
        it touches, run its step (prepared, or eager), scatter the rows
        it writes back.  The region task's body: what a worker thread
        runs when the scheduler releases it."""
        reg = self.regions[r]
        if reg.step_fn is None:
            return
        with self._on_stream():
            self._run_region(reg, table)

    def _on_stream(self):
        """The table's stream, where every region body issues."""
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _run_region(self, reg: LoweredRegion,
                    table: dict[str, torch.Tensor]) -> None:
        dev = self.device
        inputs = {nm: table[nm].index_select(
                      0, reg.rows_on(("t", nm), rows, dev))
                  for nm, rows in reg.touched.items()}
        if reg._exec is not None:
            out = reg._exec(inputs)
            with self._lock:
                self.xla_calls += 1
        else:
            out = reg.step_fn(inputs)
            with self._lock:
                self.eager_runs += 1
        for nm, (grows, lrows) in reg.written.items():
            table[nm].index_copy_(
                0, reg.rows_on(("g", nm), grows, dev),
                out[nm].index_select(0, reg.rows_on(("l", nm), lrows, dev)))

    def taskpool(self, table: dict[str, torch.Tensor]):
        """The schedulable region pool: one REGION(r) task per region and
        the region DAG as CTL edges, a plain PTG pool, so graphcheck
        verifies it and the runtime (Context, RuntimeServer) schedules
        it like any other.  The port has no goal-counted (ranged) input
        deps, so a region's fan-in rides one CTL flow per predecessor
        slot: flow ``p<j>`` of REGION(s) waits on its j-th predecessor,
        which sends on its own flow ``p<j>``.  Completion finalizes the
        table back into the source collections."""
        from . import dsl
        preds = tuple(tuple(sorted(r.preds)) for r in self.regions)
        # slot_succ[q][j]: the regions whose j-th predecessor is q
        width = max((len(p) for p in preds), default=0)
        slot_succ = [[[] for _ in range(width)] for _ in self.regions]
        for s, ps in enumerate(preds):
            for j, q in enumerate(ps):
                slot_succ[q][j].append(s)
        slot_succ = tuple(tuple(tuple(x) for x in row) for row in slot_succ)
        p = dsl.PTGBuilder(f"{self.source.name}_regions",
                           NR=len(self.regions), RPRED=preds,
                           RSLOT=slot_succ)
        t = p.task("REGION", r=dsl.span(0, lambda g, l: g.NR - 1))
        for j in range(width):
            f = t.flow(f"p{j}", dsl.CTL)
            f.input(pred=("REGION", f"p{j}",
                          lambda g, l, j=j: {"r": g.RPRED[l.r][j]}),
                    guard=lambda g, l, j=j: j < len(g.RPRED[l.r]))
            f.output(succ=("REGION", f"p{j}",
                           lambda g, l, j=j: [{"r": s}
                                              for s in g.RSLOT[l.r][j]]),
                     guard=lambda g, l, j=j: bool(g.RSLOT[l.r][j]))
        # earlier wavefront bands first: the region-grain critical path
        t.priority(lambda g, l: -self.regions[l.r].level_lo)
        plan = self

        def body(es: Any, task: Any, g: Any, l: Any) -> None:
            plan.run_region(l.r, table)

        t.body(body)
        pool = p.build()
        pool.region_plan = self
        pool.add_completion_listener(lambda _tp: self.finalize(table))
        return pool

    def finalize(self, table: dict[str, torch.Tensor]) -> None:
        """Restore dirty rows (in-place homes the source program never
        writes back) and write the table's tiles into the collections
        with version bumps, the dynamic path's completion semantics.
        Idempotent: fires from the pool's completion listener and from
        explicit callers."""
        with self._lock:
            if self._finalized:
                return
            self._finalized = True
        with self._on_stream():
            for nm, rows in self.dirty_by_name.items():
                table[nm].index_copy_(0, torch.as_tensor(
                    rows, dtype=torch.long, device=self.device),
                    self._dirty_saved[nm])
            self._stores.writeback(table)

    def execute(self, context: Any = None, timeout: float = 300.0,
                budget_s: float | None = None) -> dict[str, torch.Tensor]:
        """Compile (under the budget), run the region pool to completion,
        write back.  With ``context=`` the pool rides a live runtime
        (worker threads run independent regions concurrently); a bare
        call drives a Context of its own with no worker thread."""
        if not self._compile_done:
            self.compile(budget_s=budget_s)
        table = self.materialize_table()
        pool = self.taskpool(table)
        if context is not None:
            context.add_taskpool(pool)
            pool.wait(timeout=timeout)
        else:
            from ..runtime import Context
            ctx = Context(nb_cores=0)
            try:
                ctx.add_taskpool(pool)
                ctx.wait(timeout=timeout)
            finally:
                ctx.fini()
        self.finalize(table)        # a no-op when the listener already ran
        return table


def _written_rows(out_plan) -> list[tuple[str, int]]:
    """Every (store, row) a task's out_plan writes: extras plus the
    writable primary.  ONE home for this extraction: the region
    anti-dependency ledger and the per-region written-set builder must
    agree on it, or the region DAG under-orders the write-backs."""
    rows: list[tuple[str, int]] = []
    for primary, extras, writable in out_plan:
        rows.extend(extras)
        if writable and primary is not None:
            rows.append(primary)
    return rows


def _localize(plan, lmap: dict[str, dict[int, int]]):
    """A task plan with its store rows renumbered region-local."""
    node, L, cname, key, in_plan, out_plan = plan
    ins = [(ip[0], ip[1], lmap[ip[1]][ip[2]]) if ip[0] == "row" else ip
           for ip in in_plan]
    outs = [((p[0], lmap[p[0]][p[1]]) if p is not None else None,
             [(nm, lmap[nm][r]) for nm, r in ex], w)
            for p, ex, w in out_plan]
    return node, L, cname, key, ins, outs


def _region_step(levels: list) -> Callable:
    """A region's step over its local slices, which the boundary gathered
    (the step owns them and updates them in place, level by level)."""

    def step_fn(st: dict) -> dict:
        st = dict(st)
        for specs in levels:
            _run_level(st, specs)
        return st

    step_fn.indices = _level_indices(levels)
    return step_fn


def lower_regions(tp, context: Any = None, max_tasks: int | None = None,
                  report: Any = None,
                  device: str | torch.device = "cuda"
                  ) -> RegionLoweredTaskpool:
    """Lower an irregular PTG taskpool to a DAG of megakernel regions.

    Region selection is driven by graphcheck's *verified* execution
    space: the pool is checked (``analysis.check_ptg``) and its concrete
    task graph carved into convex wavefront-level bands per
    weakly-connected component (``analysis.regions``), at most
    ``max_tasks`` tasks each (default: the ``lowering_region_max_tasks``
    param).  Each region lowers to one step over its local store-row
    slices through the same grouped wavefront emission as the whole-pool
    pass, so a step's size is O(wavefronts x classes), not O(tasks).
    Cross-region dataflow resolves through the shared row table; row
    conflicts that task edges alone would not order become extra
    region-DAG edges, so region scheduling never hides a WAR/WAW hazard
    the whole-pool pass proves ordered.

    ``device="cuda"`` (the default) raises where no card is visible; the
    tests pass ``device="cpu"``.  Raises :class:`LoweringError` (or
    ``analysis.GraphCheckError``) when the pool cannot be region-lowered,
    and on a context over more than one rank; callers fall back to
    :func:`lower_taskpool` or the dynamic runtime.
    """
    if context is not None and getattr(context, "nb_ranks", 1) > 1:
        raise LoweringError("region lowering is single-rank")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lower_regions: no CUDA device is visible; "
                           "pass device='cpu' to lower onto the host")
    from ..analysis import check_ptg
    if report is None:
        report = check_ptg(tp)
    if max_tasks is None:
        max_tasks = _params.get("lowering_region_max_tasks")
    try:
        regs = report.select_regions(max_tasks=max_tasks)
    except ValueError as e:
        # a truncated enumeration (analysis_max_tasks) cannot give sound
        # regions: surface it as this function's documented exception
        raise LoweringError(str(e))

    infos = _analyze(tp)
    stores = _Stores()
    plans, dirty_by_name = _wavefront_plan(tp, infos, stores)

    assign: dict[tuple, int] = {}
    for r in regs:
        for node in r.members:
            assign[node] = r.index

    plans_by_region: list[list] = [[] for _ in regs]
    # row-access ledger for conflict ordering: row -> [(region, level, w)]
    accesses: dict[tuple, list[tuple[int, int, bool]]] = {}
    for plan in plans:
        node, L, cname, key, in_plan, out_plan = plan
        try:
            ri = assign[(cname, key)]
        except KeyError:
            raise LoweringError(
                f"{cname}{key}: enumerated by the lowering but absent "
                f"from graphcheck's execution space")
        plans_by_region[ri].append(plan)
        for ip in in_plan:
            if ip[0] == "row":
                accesses.setdefault((ip[1], ip[2]), []).append(
                    (ri, L, False))
        for w in _written_rows(out_plan):
            accesses.setdefault(w, []).append((ri, L, True))

    # ---- region DAG: task edges + row-conflict ordering edges --------------
    preds = [set(r.preds) for r in regs]
    succs = [set(r.succs) for r in regs]

    def add_edge(a: int, b: int) -> None:
        if a != b:
            succs[a].add(b)
            preds[b].add(a)

    for acc in accesses.values():
        writes = [(ri, L) for ri, L, w in acc if w]
        if not writes:
            continue
        for wri, wl in writes:
            for ri, L, w in acc:
                if ri == wri:
                    continue
                if L > wl:
                    add_edge(wri, ri)       # write before later access
                elif L < wl:
                    add_edge(ri, wri)       # earlier access before write
                elif not w:
                    # same wavefront, different regions: the reader sees
                    # the PRE-level value, so it runs first
                    add_edge(ri, wri)
    # the combined region DAG must stay acyclic (anti-dependency edges
    # could close a cycle: then regions cannot honour the snapshots)
    indeg = [len(p) for p in preds]
    ready = [i for i, n in enumerate(indeg) if n == 0]
    seen = 0
    while ready:
        i = ready.pop()
        seen += 1
        for s in succs[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if seen != len(regs):
        raise LoweringError(
            "region ordering cycle: row-conflict anti-dependencies are "
            "not satisfiable at region granularity (dynamic path)")

    # ---- per-region emission: local row slices, grouped levels -------------
    regions: list[LoweredRegion] = []
    for r, rplans in zip(regs, plans_by_region):
        if not rplans:                      # CTL-only region: ordering only
            regions.append(LoweredRegion(
                r.index, r.ntasks, r.level_lo, r.level_hi,
                None, None, {}, {}, {}))
            continue
        touched_sets: dict[str, set[int]] = {}
        written_sets: dict[str, set[int]] = {}
        for _node, _L, _c, _k, in_plan, out_plan in rplans:
            for ip in in_plan:
                if ip[0] == "row":
                    touched_sets.setdefault(ip[1], set()).add(ip[2])
            for nm, row in _written_rows(out_plan):
                touched_sets.setdefault(nm, set()).add(row)
                written_sets.setdefault(nm, set()).add(row)
        touched = {nm: np.array(sorted(rs), np.int64)
                   for nm, rs in sorted(touched_sets.items())}
        lmap = {nm: {g: i for i, g in enumerate(arr.tolist())}
                for nm, arr in touched.items()}
        level_specs = _group_plans([_localize(pl, lmap) for pl in rplans],
                                   infos)
        levels = [level_specs[L] for L in sorted(level_specs)]
        step_fn = _region_step(levels)
        written = {}
        for nm, rs in sorted(written_sets.items()):
            grows = np.array(sorted(rs), np.int64)
            written[nm] = (grows,
                           np.array([lmap[nm][g] for g in grows.tolist()],
                                    np.int64))
        shapes = {nm: ((len(arr),) + stores.shape[nm], stores.dtype[nm])
                  for nm, arr in touched.items()}
        kernels = tuple({id(k): k for specs in levels
                         for k, *_ in specs if k is not None}.values())
        # the signature covers ONLY what the step depends on: the grouped
        # levels in region-LOCAL rows (the local shapes join it in the
        # cache key); folding in the global rows would give structurally
        # identical regions (the decode superpool's parallel per-sequence
        # chains) distinct keys and redundant preparations of one step
        sig = ("region", tuple(
            tuple((kernel, nw, _freeze(gathers), _freeze(scatters), G)
                  for kernel, nw, gathers, scatters, G in specs)
            for specs in levels))
        regions.append(LoweredRegion(
            r.index, r.ntasks, r.level_lo, r.level_hi,
            step_fn, sig, touched, written, shapes, kernels))
    for reg, p_, s_ in zip(regions, preds, succs):
        reg.preds, reg.succs = p_, s_
    return RegionLoweredTaskpool(tp, stores, regions, dirty_by_name, device)


# ---------------------------------------------------------------------------
# cache warming: prepare a workload's lowerings ahead of a run
# ---------------------------------------------------------------------------

def _warm_workload(workload: str, n: int | None, nb: int | None):
    """One named workload's taskpool at the given geometry, on zero
    tiles (warming executes nothing, so contents never matter)."""
    if workload == "gemm":
        from ..data_dist.matrix import TiledMatrix
        from ..models.tiled_gemm import tiled_gemm_ptg
        n, nb = n or 16384, nb or 512
        A = TiledMatrix("A", n, n, nb, nb, dtype=torch.bfloat16)
        B = TiledMatrix("B", n, n, nb, nb, dtype=torch.bfloat16)
        C = TiledMatrix("C", n, n, nb, nb, dtype=torch.float32)
        return tiled_gemm_ptg(A, B, C), dict(n=n, nb=nb)
    if workload == "cholesky":
        from ..data_dist.matrix import SymTwoDimBlockCyclic
        from ..models.cholesky import tiled_cholesky_ptg
        n, nb = n or 8192, nb or 512
        A = SymTwoDimBlockCyclic("A", n, n, nb, nb)
        return tiled_cholesky_ptg(A), dict(n=n, nb=nb)
    if workload == "lu":
        from ..data_dist.matrix import TiledMatrix
        from ..models.lu import tiled_lu_ptg
        n, nb = n or 8192, nb or 512
        A = TiledMatrix("A", n, n, nb, nb, dtype=torch.float32)
        return tiled_lu_ptg(A), dict(n=n, nb=nb)
    if workload == "stencil":
        from ..data_dist.matrix import VectorTwoDimCyclic
        from ..models.stencil import stencil_1d_ptg
        n, mb = n or (1 << 24), nb or (1 << 18)
        V = VectorTwoDimCyclic("V", lm=n, mb=mb)
        return stencil_1d_ptg(V, [1.0 / 9.0] * 9, 64), dict(n=n, mb=mb)
    from ..data.datatype import TileType
    from ..data_dist.collection import DictCollection
    from ..data_dist.paged_kv import PagedKVCollection
    from ..llm.model import ToyLM
    f32 = torch.float32
    model = ToyLM()
    if workload in ("llm_decode", "llm_decode_k"):
        # llm_decode: the one-step pool (a superpool of one step: the
        # ATTN -> OUT chain with its SAMPLE; the JAX package's one-step
        # builder is not ported); llm_decode_k: n sequences, nb steps
        from ..llm.decode import (decode_superpool_ptg,
                                  preallocate_decode_steps)
        one = workload == "llm_decode"
        nseqs = n or 8
        npages, ksteps = ((nb or 4), 1) if one else (3, nb or 8)
        kv = PagedKVCollection("KV", page_size=16,
                               num_heads=model.num_heads,
                               head_dim=model.head_dim)
        H, D = kv.num_heads, kv.head_dim
        Q = DictCollection("Q", dtt=TileType((3, H, D), f32))
        O = DictCollection("O", dtt=TileType((H, D), f32))
        TOK = DictCollection("TOK", dtt=TileType((3,), f32))
        EMB = DictCollection("EMB", dtt=TileType(
            tuple(model.q3_table().shape), f32))
        seqs = [f"s{i}" for i in range(nseqs)]
        for s in seqs:
            kv.alloc_seq(s)
            for _ in range(npages):
                kv.alloc_page(s)
            kv.note_appended(s, npages * kv.page_size - 1)
            preallocate_decode_steps(kv, s, ksteps)
            TOK.data_of(s, -1)          # the chain's seed tile
        tp = decode_superpool_ptg(kv, Q, O, TOK, EMB, seqs,
                                  [ksteps] * nseqs)
        geom = (dict(nseqs=nseqs, npages=npages) if one
                else dict(nseqs=nseqs, steps=ksteps))
        return tp, geom
    if workload == "llm_spec_k":
        # the batched speculative pool: n sequences, nb draft tokens a
        # stream (1 + nb positions, the serving path's pad)
        from ..llm.decode import (preallocate_decode_steps,
                                  seed_spec_batched, spec_batched_ptg)
        nseqs, kdraft = n or 8, nb or 8
        kv = PagedKVCollection("KV", page_size=16,
                               num_heads=model.num_heads,
                               head_dim=model.head_dim)
        H, D = kv.num_heads, kv.head_dim
        QS = DictCollection("QS", dtt=TileType((kdraft + 1, 3, H, D), f32))
        LIM = DictCollection("LIM", dtt=TileType((kdraft + 1,), f32))
        DTOKS = DictCollection("DTOKS", dtt=TileType((kdraft + 3,), f32))
        VOUT = DictCollection("VOUT", dtt=TileType((kdraft + 3,), f32))
        EMB = DictCollection("EMB", dtt=TileType(
            tuple(model.q3_table().shape), f32))
        seqs = [f"s{i}" for i in range(nseqs)]
        for s in seqs:
            kv.alloc_seq(s)
            for _ in range(3):
                kv.alloc_page(s)
            kv.note_appended(s, 3 * kv.page_size - 1)
            preallocate_decode_steps(kv, s, kdraft + 1)
            seed_spec_batched(model, kv, QS, LIM, DTOKS, s, 0,
                              list(range(1, kdraft + 1)), kdraft + 1)
        tp = spec_batched_ptg(kv, QS, LIM, DTOKS, VOUT, EMB, seqs,
                              [kdraft + 1] * nseqs, pad=kdraft + 1)
        return tp, dict(nseqs=nseqs, draft=kdraft)
    if workload == "llm_prefill_tail":
        # the prefix-cache admission shape: streams whose prompt matched
        # the radix tree prefill only their tail (n sequences, nb tail
        # pages each, past a 4-page shared prefix)
        from ..llm.decode import prefill_ptg
        nseqs, tail_pages = n or 8, nb or 2
        prefix_pages = 4
        kv = PagedKVCollection("KV", page_size=16)
        seqs = [f"s{i}" for i in range(nseqs)]
        tkeys = []
        for s in seqs:
            kv.alloc_seq(s)
            for _ in range(prefix_pages + tail_pages):
                kv.alloc_page(s)
            kv.note_appended(s, (prefix_pages + tail_pages)
                             * kv.page_size)
            tkeys += [(s, c) for c in range(prefix_pages,
                                            prefix_pages + tail_pages)]
        T = DictCollection("T", dtt=kv.default_dtt, keys=tkeys)
        tp = prefill_ptg(kv, T, seqs, starts=[prefix_pages] * nseqs)
        return tp, dict(nseqs=nseqs, tail_pages=tail_pages)
    raise ValueError(f"unknown warm workload {workload!r} (gemm, "
                     f"cholesky, lu, stencil, llm_decode, llm_decode_k, "
                     f"llm_spec_k, llm_prefill_tail)")


def warm_cache(workload: str, n: int | None = None, nb: int | None = None,
               modes: tuple = ("auto", "region"),
               budget_s: float | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Prepare one workload's lowerings ahead of a run, launching no
    kernel: ``auto`` (or a named pass) lowers the pool and calls
    :meth:`LoweredTaskpool.warm` (the kernel libraries loaded, the index
    tensors on the device); ``region`` lowers it to regions and calls
    :meth:`RegionLoweredTaskpool.compile` under ``budget_s``.  The
    prepared steps stay in :data:`lowering_cache`, so a later lowering
    of the same structure in this process prepares nothing.  Returns
    each mode's readings and wall."""
    tp, geom = _warm_workload(workload, n, nb)
    out: dict = {"workload": workload, **geom,
                 "backend": list(_backend_signature())}
    for mode in modes:
        t0 = time.perf_counter()
        try:
            if mode == "region":
                plan = lower_regions(tp, device=device)
                st = plan.compile(budget_s=budget_s)
                out["region"] = {k: st[k] for k in
                                 ("regions", "regions_compiled",
                                  "regions_eager", "trace_s", "compile_s")}
            else:
                low = lower_taskpool(tp, passes=mode, device=device)
                out[mode] = {"mode": low.mode, **low.warm()}
        except LoweringError as e:
            out[mode] = {"error": str(e)}
        out.setdefault("wall_s", {})[mode] = round(
            time.perf_counter() - t0, 3)
    return out


def _main(argv: list[str] | None = None) -> int:
    """``python -m parsec_tpu_torch.ptg.lowering --warm <workload> [--n
    --nb --nt --modes --budget --device]``: the cache-warming CLI."""
    import argparse
    import json
    ap = argparse.ArgumentParser(
        prog="python -m parsec_tpu_torch.ptg.lowering",
        description="lowering cache warmer: prepare a workload's lowered "
                    "steps (kernel libraries loaded, index tensors on "
                    "the device) before a run, launching no kernel")
    ap.add_argument("--warm", metavar="WORKLOAD", required=True,
                    help="gemm | cholesky | lu | stencil | llm_decode | "
                         "llm_decode_k | llm_spec_k | llm_prefill_tail")
    ap.add_argument("--n", type=int, default=None,
                    help="problem size (stencil: vector length; "
                    "llm_decode/llm_decode_k/llm_spec_k/"
                    "llm_prefill_tail: sequence count)")
    ap.add_argument("--nb", type=int, default=None,
                    help="tile size (stencil: segment size; llm_decode: "
                    "pages per sequence; llm_decode_k: steps per "
                    "superpool; llm_spec_k: draft tokens per stream; "
                    "llm_prefill_tail: tail pages)")
    ap.add_argument("--nt", type=int, default=None,
                    help="tile count (alternative to --n: n = nt * nb)")
    ap.add_argument("--modes", default="auto,region",
                    help="comma list of lowering modes to warm "
                    "(auto, wavefront, unrolled, chain-collapse, region)")
    ap.add_argument("--budget", type=float, default=None,
                    help="preparation budget seconds for the region mode "
                    "(default: the lowering_compile_budget_s param)")
    ap.add_argument("--device", default="cuda",
                    help="the lowering device (default cuda; cpu lowers "
                    "onto the host)")
    args = ap.parse_args(argv)
    n = args.n
    if n is None and args.nt is not None:
        n = args.nt * (args.nb or 512)
    out = warm_cache(args.warm, n=n, nb=args.nb,
                     modes=tuple(m.strip() for m in args.modes.split(",")
                                 if m.strip()),
                     budget_s=args.budget, device=args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    # under `python -m` runpy executes a FRESH copy of this module, whose
    # traceable registry the model modules never see: delegate to the
    # canonical module object so registration and lookup share state
    from parsec_tpu_torch.ptg.lowering import _main as _canonical_main
    raise SystemExit(_canonical_main())

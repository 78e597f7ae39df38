"""Compiled-DAG execution: the dynamic runtime's native inner loop.

Port of ``parsec_tpu/runtime/dagrun.py``.  The reference's per-task
dispatch cost is set by a C hot loop over pre-generated successor
iterators (``scheduling.c:562-575``); the dynamic path walks the same
protocol in Python.  Here a PTG taskpool whose execution space is
concretely enumerable is compiled, at enqueue time, into

- a flat task table (one :class:`~parsec_tpu_torch.runtime.task.Task`
  per instance, inputs pre-bound, priorities pre-evaluated), or, for a
  pure-CTL pool over rectangular spaces, index arrays of the locals
  (:class:`VecCompiledDag`), and
- a CSR successor graph handed to the native executor
  (:class:`parsec_tpu_torch.native.NativeDag`), which owns the indegree
  counters and the ready set.

Execution ping-pongs batches: the native side serves ready task ids,
Python runs the chore bodies, and one native call releases every
successor edge of the batch.  PTG bodies are called through the
``hook.ptg_body`` seam of :mod:`parsec_tpu_torch.ptg.dsl`, past the hook
wrapper.

Compilation is an optimization that falls back to the dynamic scheduler
(same taskpool object, same results) on any structural surprise: device
or recursive chores, a class's own ``prepare_input``/
``complete_execution``, the user-defined key, deps, startup or SIMCOST
(``_check_eligible``), ranged (counted) fan-ins, multi-chore classes,
multi-dep data flows, typed edges, non-enumerable spaces, a served pool
(``_serve_no_dag``), a pool on the wire of a multi-rank context (a
rank-private ``local_only`` pool still compiles), or no native tier.

PINS does not force the fallback: the executor fires batch-granular
``DAG_FETCH``/``DAG_COMPLETE`` spans (payload: the batch size) through the
dispatch table, a few index loads a batch of up to 1024 tasks, and the
per-task ``EXEC`` begin/end around the bodies only while PINS chains are
registered (``pins.enabled``, read once a batch).

"""

from __future__ import annotations

import ctypes
import itertools
import threading
import time
from typing import Any

import numpy as np

from ..core.backoff import Backoff
from ..core.params import params as _params
from ..prof import pins
from .task import HOOK_RETURN_AGAIN, HOOK_RETURN_DONE, Task

_params.register("runtime_dag_compile", True,
                 "compile enumerable single-rank PTG taskpools to the "
                 "native DAG executor at enqueue time")
# largest task count the compiled-DAG path materializes: the task table
# and the native Dag's int32 CSR arrays are built at enqueue, so a bigger
# pool runs on the dynamic scheduler (the JAX package's default limit)
_MAX_DAG_TASKS = 1 << 20

_BATCH = 1024

# PINS fast path (prof/pins.py): a disabled batch-span site is one index
# load and a falsy branch
_hooks = pins.hooks
_DAG_FETCH_BEGIN = int(pins.PinsEvent.DAG_FETCH_BEGIN)
_DAG_FETCH_END = int(pins.PinsEvent.DAG_FETCH_END)
_DAG_COMPLETE_BEGIN = int(pins.PinsEvent.DAG_COMPLETE_BEGIN)
_DAG_COMPLETE_END = int(pins.PinsEvent.DAG_COMPLETE_END)
_EB = pins.PinsEvent.EXEC_BEGIN
_EE = pins.PinsEvent.EXEC_END


class _Ineligible(Exception):
    """Structure outside the compiled-DAG subset; run dynamically."""


class _VecFallback(Exception):
    """Structure outside the *vectorized* compile subset; compile scalar."""


class _Poison:
    """Locals namespace that detects dependent parameter ranges."""

    def __getattr__(self, k):
        raise _VecFallback(k)

    def __getitem__(self, k):
        raise _VecFallback(k)


class _CompiledDagBase:
    """Shared skeleton: claim discipline + the fetch/execute/complete loop.

    Subclasses implement :meth:`_exec_batch`, returning ``(done, retry)``
    gid lists.  ``retry`` carries tasks whose hook returned
    ``HOOK_RETURN_AGAIN`` (the reschedule protocol, ``scheduling.py:134``):
    they are re-executed after the rest of the wavefront, with a backoff
    once a full pass makes no progress.
    """

    __slots__ = ("taskpool", "ntasks", "_ndag", "_buf", "_claimed", "_lock",
                 "_carry", "_noprog", "_backoff", "done")

    def __init__(self, taskpool, ndag) -> None:
        self.taskpool = taskpool
        self.ntasks = int(ndag.ntasks)
        self._ndag = ndag
        self._buf = (ctypes.c_int32 * _BATCH)()
        self._claimed = False
        self._lock = threading.Lock()
        self._carry: list[int] = []    # fetched-but-unexecuted (AGAIN/timeout)
        self._noprog = 0               # consecutive all-AGAIN passes
        self._backoff = None           # persists across yields
        self.done = False

    def claim(self) -> bool:
        """Exactly one driving thread may run the DAG."""
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    @property
    def pending(self) -> bool:
        """Still waiting for a driver (unclaimed and unfinished)."""
        return not self._claimed

    def run(self, es: Any, deadline: float | None = None) -> bool:
        """Drive the DAG; returns True when fully executed, False on a
        deadline expiry (the pool is unclaimed again and resumable — the
        dynamic path's between-tasks timeout check, at batch granularity)."""
        buf = self._buf
        fetch, complete = self._ndag.fetch, self._ndag.complete
        retry: list[int] = self._carry
        self._carry = []
        if self._backoff is None:
            self._backoff = Backoff()
        backoff = self._backoff
        while True:
            if deadline is not None and time.monotonic() > deadline:
                self._carry = retry
                with self._lock:
                    self._claimed = False
                return False
            h = _hooks[_DAG_FETCH_BEGIN]
            if h is not None:
                h(es, None)
            n = fetch(buf, _BATCH)
            ids = list(buf[:n]) if n else []
            h = _hooks[_DAG_FETCH_END]
            if h is not None:
                h(es, len(ids))
            if not ids and not retry:
                if self._ndag.remaining() == 0:
                    break
                raise RuntimeError(
                    f"compiled DAG stalled with "
                    f"{self._ndag.remaining()} tasks outstanding "
                    f"(cycle or missing successor in the task graph)")
            if retry:
                ids, retry = ids + retry, []
            done, retry = self._exec_batch(es, ids)
            if done:
                self._noprog = 0
                rem = -1
                h = _hooks[_DAG_COMPLETE_BEGIN]
                if h is not None:
                    h(es, len(done))
                for off in range(0, len(done), _BATCH):
                    chunk = done[off:off + _BATCH]
                    for j, gid in enumerate(chunk):
                        buf[j] = gid
                    rem = complete(buf, len(chunk))
                h = _hooks[_DAG_COMPLETE_END]
                if h is not None:
                    h(es, len(done))
                if rem == 0:
                    break
                backoff.reset()
            elif retry:
                # a full AGAIN pass made no progress: back off FIRST (so a
                # re-claiming waiter is paced by the growing backoff, never
                # a hot spin), then after a few such passes yield the
                # driving thread entirely — an AGAIN body may be waiting on
                # another taskpool's progress
                self._noprog += 1
                backoff.wait()
                if self._noprog >= 3:
                    self._noprog = 0
                    self._carry = retry
                    with self._lock:
                        self._claimed = False
                    return False
        self.done = True
        return True

    def _exec_batch(self, es: Any, ids: list) -> tuple[list, list]:
        raise NotImplementedError


class CompiledDag(_CompiledDagBase):
    """Scalar-compiled taskpool: one prebuilt Task (+ data plan) per gid."""

    __slots__ = ("_tasks", "_hooks", "_pres", "_posts")

    def __init__(self, taskpool, ndag, tasks, hooks, pres, posts) -> None:
        super().__init__(taskpool, ndag)
        self._tasks = tasks
        self._hooks = hooks
        self._pres = pres
        self._posts = posts

    def _exec_batch(self, es: Any, ids: list) -> tuple[list, list]:
        from .scheduling import apply_writeback_to_home
        tasks, hooks = self._tasks, self._hooks
        pres, posts = self._pres, self._posts
        DONE, AGAIN = HOOK_RETURN_DONE, HOOK_RETURN_AGAIN
        instr, fire = pins.enabled, pins.fire
        done: list[int] = []
        retry: list[int] = []
        for gid in ids:
            t = tasks[gid]
            pre = pres[gid]
            if pre is not None:
                data = t.data
                for fi, dtt in pre:
                    if data[fi] is None:
                        data[fi] = _scratch(dtt)
            if instr:
                fire(_EB, es, t)
                rc = hooks[gid](es, t)
                fire(_EE, es, t)
            else:
                rc = hooks[gid](es, t)
            if rc != DONE:
                if rc == AGAIN:
                    retry.append(gid)
                    continue
                raise RuntimeError(
                    f"compiled DAG: {t} returned hook rc={rc}; only "
                    f"synchronous DONE/AGAIN bodies are compiled (the "
                    f"dynamic path handles ASYNC)")
            post = posts[gid]
            if post is not None:
                data = t.data
                attach, wb = post
                for sfi, tgid, tfi in attach:
                    tasks[tgid].data[tfi] = data[sfi]
                for fi, dc, key in wb:
                    apply_writeback_to_home(dc, key, data[fi],
                                            owner=self.taskpool.taskpool_id)
            done.append(gid)
        return done, retry


def _scratch(dtt) -> Any:
    from ..data.data import scratch_copy
    return scratch_copy(dtt)    # same allocation policy as prepare_input


def _locals_ns_builder(names: tuple):
    """eval-compile ``lambda d, n: _NS(d=d, n=n)`` for one class's params —
    the jdf2c precompilation stance applied to locals construction: one
    call builds the body's ``l`` namespace AND (via its ``__dict__``) the
    task's locals dict, replacing a dict(zip) plus a namespace copy per
    task.  None when a param name can't appear in a lambda signature."""
    import keyword
    if any(not n.isidentifier() or keyword.iskeyword(n)
           or n.startswith("_") for n in names):
        return None
    from ..ptg.dsl import _NS
    if not names:
        return lambda: _NS()
    args = ", ".join(names)
    kw = ", ".join(f"{n}={n}" for n in names)
    return eval(f"lambda {args}: _NS({kw})", {"_NS": _NS})


class VecCompiledDag(_CompiledDagBase):
    """Vector-compiled pure-CTL taskpool: locals live in index arrays.

    The graph was built by array-evaluating every guard/target map once over
    the whole execution space (``_build_vector``); at run time, task locals
    are materialized per batch with one numpy gather per parameter — the
    per-task Python work is one namespace, one minimal Task, one direct
    body call (the PTG hook wrapper is bypassed through its ``ptg_body``
    seam; hooks without the seam take the generic path).
    """

    __slots__ = ("_cls_of", "_base", "_names", "_cols", "_hooks", "_tcs",
                 "_bodies", "_gns", "_mks")

    def __init__(self, taskpool, ndag, cls_of, base, names, cols, hooks,
                 tcs) -> None:
        super().__init__(taskpool, ndag)
        self._cls_of = cls_of      # int16 per gid (None when single class)
        self._base = base          # per class gid base
        self._names = names        # per class tuple of param names
        self._cols = cols          # per class list of per-param int arrays
        self._hooks = hooks        # per class chore hook
        self._tcs = tcs            # per class TaskClass
        self._bodies = [getattr(h, "ptg_body", None) for h in hooks]
        self._gns = [getattr(h, "ptg_gns", None) for h in hooks]
        self._mks = [_locals_ns_builder(nm) for nm in names]

    def _exec_batch(self, es: Any, ids_list: list) -> tuple[list, list]:
        cls_of = self._cls_of
        DONE, AGAIN = HOOK_RETURN_DONE, HOOK_RETURN_AGAIN
        new_task = Task.__new__
        tp = self.taskpool
        ids = np.asarray(ids_list, np.int32)
        if cls_of is None:
            groups = ((0, ids),)
        else:
            ci_arr = cls_of[ids]
            order = np.argsort(ci_arr, kind="stable")
            sids = ids[order]
            cs = ci_arr[order]
            cuts = [0, *(np.flatnonzero(np.diff(cs)) + 1), len(ids)]
            groups = tuple((int(cs[lo]), sids[lo:hi])
                           for lo, hi in zip(cuts[:-1], cuts[1:])
                           if hi > lo)
        done: list[int] = []
        retry: list[int] = []
        for ci, sel in groups:
            names = self._names[ci]
            hook = self._hooks[ci]
            body = self._bodies[ci]
            mk = self._mks[ci]
            tc = self._tcs[ci]
            rel = sel - self._base[ci]
            cols = [c[rel].tolist() for c in self._cols[ci]]
            gids = sel.tolist()
            rows = zip(*cols) if cols else ((),) * len(gids)
            # shared immutable flow slots: reads behave like the dynamic
            # path's all-None CTL slots; a (nonsensical) write to a CTL
            # flow raises instead of silently aliasing across tasks.
            # Kept inline (not a helper) for per-task cost; mirror any slot
            # change in _build's pure_ctl branch.
            empty = (None,) * len(tc.flows)
            nchores = (1 << len(tc.chores)) - 1
            instr, fire = pins.enabled, pins.fire
            if body is not None and mk is not None:
                # fast path: hook wrapper bypassed; `l` is built once and
                # its __dict__ doubles as task.locals (same key/value view)
                g = self._gns[ci]()
                for gid, row in zip(gids, rows):
                    lns = mk(*row)
                    t = new_task(Task)
                    t.taskpool = tp
                    t.task_class = tc
                    t.locals = lns.__dict__
                    t.priority = 0
                    t.status = "ready"
                    t.data = empty
                    t.repo_entries = empty
                    t.uid = gid
                    t.chore_mask = nchores
                    t.selected_device = None
                    if instr:
                        fire(_EB, es, t)
                        rc = body(es, t, g, lns)
                        fire(_EE, es, t)
                    else:
                        rc = body(es, t, g, lns)
                    if rc is not None and rc != DONE:
                        if rc == AGAIN:
                            retry.append(gid)
                            continue
                        raise RuntimeError(
                            f"compiled DAG: {tc.name} returned rc={rc}")
                    done.append(gid)
                continue
            for gid, row in zip(gids, rows):
                t = new_task(Task)
                t.taskpool = tp
                t.task_class = tc
                t.locals = dict(zip(names, row))
                t.priority = 0
                t.status = "ready"
                t.data = empty
                t.repo_entries = empty
                t.uid = gid
                t.chore_mask = nchores
                t.selected_device = None
                if instr:
                    fire(_EB, es, t)
                    rc = hook(es, t)
                    fire(_EE, es, t)
                else:
                    rc = hook(es, t)
                if rc != DONE:
                    if rc == AGAIN:
                        retry.append(gid)
                        continue
                    raise RuntimeError(
                        f"compiled DAG: {tc.name} returned rc={rc}")
                done.append(gid)
        return done, retry


def compile_taskpool_dag(tp, context) -> CompiledDag | None:
    """Compile ``tp`` for the native DAG executor, or None (run dynamic)."""
    if not _params.get("runtime_dag_compile"):
        return None
    # serving-layer opt-out (serve/server.py): a compiled pool is funneled
    # whole by one claiming driver, which would bypass the weighted-fair
    # scheduler's per-task tenant interleaving
    if getattr(tp, "_serve_no_dag", False):
        return None
    # multi-rank release goes through the remote deps, but a rank-private
    # pool is single-rank by construction and stays eligible
    if getattr(context, "nb_ranks", 1) > 1 and not tp.local_only:
        return None
    builders = getattr(tp, "_tc_builders", None)
    if builders is None:
        return None            # only enumerable PTG pools compile
    from .. import native
    if not (_params.get("runtime_native") and native.available()):
        return None
    try:
        try:
            return _build_vector(tp, builders)
        except _Ineligible:
            raise
        except Exception:
            # _VecFallback, or any guard/target that resists array
            # evaluation in a way the poison probe didn't catch — the
            # vector path is an optimization, never a requirement
            return _build(tp, builders)
    except _Ineligible:
        return None


def _build_vector(tp, builders):
    """Array-evaluate the whole PTG at once (pure-CTL, rectangular spaces).

    The DSL's guard/target expressions are ``(g, l)`` callables over
    namespaces; evaluated with *array-valued* locals they return boolean
    masks and target-index arrays for the entire execution space in one
    call — the same trick :mod:`parsec_tpu_torch.ptg.lowering` plays for the data
    path, applied to graph construction.  Anything that resists array
    evaluation (dependent ranges, range arrows, data flows, priorities)
    raises :class:`_VecFallback` into the scalar builder.
    """
    from .. import native
    classes = tp.task_classes
    _check_eligible(classes)
    for tc in classes:
        if any(not f.is_ctl for f in tc.flows):
            raise _VecFallback("data flows")
        if tc.priority is not None:
            raise _VecFallback("priority")

    # -- rectangular space detection + index arrays --------------------------
    poison = _Poison()
    base, names, cols, lows, sizes = [], [], [], [], []
    gid = 0
    for tc in classes:
        tcb = builders[tc.name]
        g = tcb._ptg._g_ns()
        lo, sz = [], []
        for pname, rngfn in tcb.param_ranges.items():
            r = rngfn(g, poison)        # raises _VecFallback when dependent
            if not isinstance(r, range) or r.step != 1:
                raise _VecFallback("non-unit range")
            lo.append(r.start)
            sz.append(max(len(r), 0))
        n = int(np.prod(sz)) if sz else 1
        base.append(gid)
        names.append(tuple(tcb.param_ranges))
        lows.append(lo)
        sizes.append(sz)
        if n == 0:
            cols.append([np.zeros(0, np.int64) for _ in sz])
        else:
            grid = np.indices(sz).reshape(len(sz), -1)
            cols.append([grid[i] + lo[i] for i in range(len(sz))])
        gid += n
        if gid > _MAX_DAG_TASKS:
            raise _Ineligible
    ntasks = gid
    if ntasks == 0:
        return None
    cls_index = {tc.name: ci for ci, tc in enumerate(classes)}

    def vec_eval(fn, ci, default=None):
        locd = dict(zip(names[ci], cols[ci]))
        n = cols[ci][0].shape[0] if cols[ci] else 1
        try:
            v = fn(locd)
        except _VecFallback:
            raise
        except Exception:
            raise _VecFallback("expression resists array evaluation")
        return v, n

    indeg = np.zeros(ntasks, np.int32)
    edges_src, edges_dst = [], []
    for ci, tc in enumerate(classes):
        n = cols[ci][0].shape[0] if cols[ci] else 1
        if n == 0:
            continue
        gids = np.arange(base[ci], base[ci] + n)
        for f in tc.flows:
            for d in f.deps_in:
                if d.target_class is None:
                    continue
                if d.guard is None:
                    indeg[gids] += 1
                    continue
                m, _ = vec_eval(d.guard, ci)
                m = np.broadcast_to(np.asarray(m, bool), (n,))
                indeg[gids] += m
            for d in f.deps_out:
                if d.target_class is None:
                    continue
                if d.guard is None:
                    m = np.ones(n, bool)
                else:
                    mv, _ = vec_eval(d.guard, ci)
                    m = np.broadcast_to(np.asarray(mv, bool), (n,)).copy()
                if not m.any():
                    continue
                tci = cls_index.get(d.target_class)
                if tci is None:
                    raise _Ineligible
                tv, _ = vec_eval(d.target_params, ci)
                if not isinstance(tv, dict):
                    raise _VecFallback("range arrow")
                tnames, tlo, tsz = names[tci], lows[tci], sizes[tci]
                rel = []
                valid = m.copy()
                for i, p in enumerate(tnames):
                    a = np.broadcast_to(np.asarray(tv[p]), (n,)) - tlo[i]
                    valid &= (a >= 0) & (a < tsz[i])
                    rel.append(a)
                if (m & ~valid).any():
                    raise _VecFallback("edge outside target space")
                if not valid.any():
                    continue
                rel = [a[valid] for a in rel]
                tgid = base[tci] + (
                    np.ravel_multi_index(rel, tsz) if rel
                    else np.zeros(int(valid.sum()), np.int64))
                edges_src.append(gids[valid])
                edges_dst.append(tgid)

    if edges_src:
        src = np.concatenate(edges_src)
        dst = np.concatenate(edges_dst)
        order = np.argsort(src, kind="stable")
        flat = dst[order].astype(np.int32)
        counts = np.bincount(src, minlength=ntasks).astype(np.int32)
    else:
        flat = np.zeros(0, np.int32)
        counts = np.zeros(ntasks, np.int32)
    succ_off = np.zeros(ntasks + 1, np.int32)
    np.cumsum(counts, out=succ_off[1:])

    ndag = native.NativeDag(indeg, succ_off, flat, None)
    cls_of = None
    if len(classes) > 1:
        cls_of = np.zeros(ntasks, np.int16)
        for ci in range(1, len(classes)):
            cls_of[base[ci]:] = ci
    hooks = [tc.chores[0].hook for tc in classes]
    return VecCompiledDag(tp, ndag, cls_of, base, names, cols, hooks,
                          list(classes))


def _check_eligible(classes) -> None:
    """Shared compile gate: synchronous single-CPU-chore classes only."""
    for tc in classes:
        if tc.prepare_input is not None or tc.complete_execution is not None:
            raise _Ineligible
        if (tc.make_key_fn is not None or tc.find_deps_fn is not None
                or tc.hash_struct is not None or tc.startup_fn is not None
                or tc.simcost is not None or tc.counted):
            raise _Ineligible   # UD overrides / SIM dates run dynamically
        if len(tc.chores) != 1:
            raise _Ineligible   # multi-incarnation selection is dynamic
        ch = tc.chores[0]
        if (ch.device_type != "cpu" or ch.hook is None
                or ch.evaluate is not None or not ch.enabled):
            raise _Ineligible
        for f in tc.flows:
            for d in (*f.deps_in, *f.deps_out):
                if d.dtt is not None:
                    raise _Ineligible   # typed edges reshape dynamically
            if f.dtt is not None and any(d.null for d in f.deps_in):
                raise _Ineligible   # NULL-vs-scratch needs per-task guards


def _build(tp, builders) -> CompiledDag | None:
    from .. import native
    classes = tp.task_classes
    _check_eligible(classes)

    # -- enumerate the execution space once (gid-number every instance) -----
    cls_index = {tc.name: ci for ci, tc in enumerate(classes)}
    flow_fi = [{f.name: f.flow_index for f in tc.flows} for tc in classes]
    locs_per_class: list[list[dict]] = []
    idx: dict[tuple, int] = {}
    gid = 0
    for ci, tc in enumerate(classes):
        locs = list(builders[tc.name]._enumerate_space())
        locs_per_class.append(locs)
        make_key = tc.make_key
        for loc in locs:
            idx[(ci, make_key(loc))] = gid
            gid += 1
        if gid > _MAX_DAG_TASKS:
            raise _Ineligible
    ntasks = gid
    if ntasks == 0:
        return None             # empty pools terminate through the tdm

    use_prio = any(tc.priority is not None for tc in classes)
    indeg = np.zeros(ntasks, np.int32)
    prio = np.zeros(ntasks, np.int64) if use_prio else None
    succs: list[list[int]] = [()] * ntasks          # type: ignore[list-item]
    tasks: list[Task] = [None] * ntasks             # type: ignore[list-item]
    hooks: list[Any] = [None] * ntasks
    pres: list[Any] = [None] * ntasks
    posts: list[Any] = [None] * ntasks

    gid = 0
    for ci, tc in enumerate(classes):
        hook = tc.chores[0].hook
        flows = tc.flows
        data_flows = [f for f in flows if not f.is_ctl]
        scratch_plan = [(f.flow_index, f.dtt) for f in data_flows
                        if f.dtt is not None] or None
        prio_fn = tc.priority
        mask_fn = tc.input_dep_mask
        pure_ctl = not data_flows
        new_task = Task.__new__
        empty = (None,) * len(flows)
        nchores = (1 << len(tc.chores)) - 1
        for loc in locs_per_class[ci]:
            p = prio_fn(loc) if prio_fn is not None else 0
            if pure_ctl:
                # minimal instance: bodies of CTL-only classes touch locals
                # (and es/globals) but never flow data / repos / devices;
                # shared immutable slots make reads behave and writes raise.
                # Mirror any slot change in VecCompiledDag._exec_batch.
                t = new_task(Task)
                t.taskpool = tp
                t.task_class = tc
                t.locals = loc
                t.priority = p
                t.status = "ready"
                t.data = empty
                t.repo_entries = empty
                t.uid = gid
                t.chore_mask = nchores
                t.selected_device = None
            else:
                t = Task(tp, tc, loc, priority=p)
                t.status = "ready"
            tasks[gid] = t
            hooks[gid] = hook
            pres[gid] = scratch_plan
            indeg[gid] = mask_fn(loc).bit_count()
            if use_prio:
                prio[gid] = p
            succ: list[int] = []
            attach: list[tuple] = []
            wb: list[tuple] = []
            for f in flows:
                is_ctl = f.is_ctl
                for d in f.deps_out:
                    if d.guard is not None and not d.guard(loc):
                        continue
                    if d.target_class is None:
                        if not is_ctl and d.data_ref is not None:
                            dc, key = d.data_ref(loc)
                            wb.append((f.flow_index, dc, key))
                        continue
                    tci = cls_index.get(d.target_class)
                    if tci is None:
                        raise _Ineligible
                    tkey = classes[tci].make_key
                    for tloc in d.each_target(loc):
                        tgid = idx.get((tci, tkey(tloc)))
                        if tgid is None:
                            raise _Ineligible   # edge out of space: dynamic
                        succ.append(tgid)
                        if not is_ctl:
                            tfi = flow_fi[tci].get(d.target_flow)
                            if tfi is None:
                                raise _Ineligible
                            attach.append((f.flow_index, tgid, tfi))
            if succ:
                succs[gid] = succ
            if attach or wb:
                posts[gid] = (attach, wb)
            # pre-bind collection reads (resolve_data_inputs semantics:
            # reads snapshot the home copy object; write-backs mutate the
            # same DataCopy in place, so early binding observes the final
            # ordering the flow edges impose)
            for f in data_flows:
                act = [d for d in f.deps_in if d.active(loc)]
                if len(act) > 1:
                    raise _Ineligible
                if act and act[0].data_ref is not None:
                    dc, key = act[0].data_ref(loc)
                    copy = dc.data_of(*key).newest_copy()
                    if copy is None:
                        raise _Ineligible
                    if copy.device_index != 0:
                        # a device copy newer than home means accelerator
                        # state is in play; enqueue-time binding would
                        # freeze it — run such pools dynamically
                        raise _Ineligible
                    t.data[f.flow_index] = copy
            gid += 1

    counts = np.fromiter((len(s) for s in succs), np.int32, ntasks)
    succ_off = np.zeros(ntasks + 1, np.int32)
    np.cumsum(counts, out=succ_off[1:])
    flat = np.fromiter(itertools.chain.from_iterable(succs), np.int32,
                       int(succ_off[-1]))
    ndag = native.NativeDag(indeg, succ_off, flat, prio)
    return CompiledDag(tp, ndag, tasks, hooks, pres, posts)

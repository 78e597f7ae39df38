"""The scheduling loop: execute / complete / release-deps.

Port of ``parsec_tpu/runtime/scheduling.py`` (the reference's
``scheduling.c``): per-worker select -> ``prepare_input`` -> chore
execution -> completion -> ``release_deps`` walking successor edges and
handing newly-ready tasks to the scheduler, with the highest-priority
released task kept as the stream's ``next_task``.  Device chores return
``HOOK_RETURN_ASYNC`` and complete through :func:`complete_execution`
from the device manager.

On several ranks, a successor whose affinity lies on another rank, or a
write-back whose home tile does, is not released here: it accumulates
into a remote-deps record that the context's comm engine activates
(``remote_dep_accumulate`` / ``remote_dep_activate``, the remote branch of
``parsec_release_dep_fct``).

PINS events fire at the JAX package's points (SELECT, SELECT_STEAL,
PREPARE_INPUT, EXEC, COMPLETE_EXEC, SCHEDULE, RELEASE_DEPS) through the
dispatch table bound once at import: a disabled site is one index load
and a falsy branch.

A typed edge hands its consumer a lazy shared repack
(:mod:`parsec_tpu_torch.data.reshape`): the release stores the future as
the input, and ``prepare_input`` resolves it on the consumer's thread.  A
pool whose classes carry a ``simcost`` tracks the simulated critical path
(``Taskpool.largest_simulation_date``).

Left out: the paranoid write-back checks.
"""

from __future__ import annotations

import threading
from typing import Any

from ..core.future import DataCopyFuture
from ..core.params import params as _params
from ..data.reshape import (reshape_for_edge, reshape_for_writeback,
                            resolve_copy)
from ..prof import pins
from ..prof.pins import PinsEvent
from .task import (HOOK_RETURN_AGAIN, HOOK_RETURN_ASYNC, HOOK_RETURN_DISABLE,
                   HOOK_RETURN_DONE, HOOK_RETURN_ERROR, HOOK_RETURN_NEXT,
                   Task, TaskClass)

# the runtime lint's contract (analysis/runtimelint.py): the simulation
# dates move under the pool's _sim_lock (the JAX module's paranoid
# write-back marks are not ported)
_LOCK_PROTECTED = {
    "Taskpool._sim_ready": "_sim_lock",
    "Taskpool.largest_simulation_date": "_sim_lock",
}
_LOCK_ORDER = ()

_params.register(
    "runtime_keep_highest_priority_task", True,
    "hold the best released task as the stream's next task")

# PINS fast path: the dispatch table's identity is stable (slots swap in
# place), so a disabled site is one index load and a falsy branch
_hooks = pins.hooks
_SELECT_BEGIN = int(PinsEvent.SELECT_BEGIN)
_SELECT_END = int(PinsEvent.SELECT_END)
_SELECT_STEAL = int(PinsEvent.SELECT_STEAL)
_PREPARE_INPUT_BEGIN = int(PinsEvent.PREPARE_INPUT_BEGIN)
_PREPARE_INPUT_END = int(PinsEvent.PREPARE_INPUT_END)
_EXEC_BEGIN = int(PinsEvent.EXEC_BEGIN)
_EXEC_END = int(PinsEvent.EXEC_END)
_COMPLETE_EXEC_BEGIN = int(PinsEvent.COMPLETE_EXEC_BEGIN)
_COMPLETE_EXEC_END = int(PinsEvent.COMPLETE_EXEC_END)
_SCHEDULE_BEGIN = int(PinsEvent.SCHEDULE_BEGIN)
_SCHEDULE_END = int(PinsEvent.SCHEDULE_END)
_RELEASE_DEPS_BEGIN = int(PinsEvent.RELEASE_DEPS_BEGIN)
_RELEASE_DEPS_END = int(PinsEvent.RELEASE_DEPS_END)


class ExecutionStream:
    """One worker's execution context (cf. ``parsec_execution_stream_t``)."""

    __slots__ = ("th_id", "virtual_process", "context", "next_task",
                 "sched_private", "owner_ident")

    def __init__(self, th_id: int, virtual_process: Any, context: Any) -> None:
        self.th_id = th_id
        self.virtual_process = virtual_process
        self.context = context
        self.next_task: Task | None = None
        self.sched_private: Any = None
        self.owner_ident: int = -1   # thread id that owns next_task


class VirtualProcess:
    """A partition of streams that steal only from each other."""

    __slots__ = ("vp_id", "context", "execution_streams", "sched_private")

    def __init__(self, vp_id: int, context: Any) -> None:
        self.vp_id = vp_id
        self.context = context
        self.execution_streams: list[ExecutionStream] = []
        self.sched_private: Any = None


def schedule_tasks(es: ExecutionStream, tasks: list[Task],
                   distance: int = 0) -> None:
    """Hand ready tasks to the scheduler module."""
    if not tasks:
        return
    h = _hooks[_SCHEDULE_BEGIN]
    if h is not None:
        h(es, tasks)
    # next_task is a single-owner slot: only the thread running this
    # stream's loop may fill it (a device manager completing a task on
    # behalf of another stream goes through the scheduler).  A scheduler
    # with strict_order (the serving layer's fair shim) takes every task:
    # a released successor must not jump other tenants' queues
    if _params.get("runtime_keep_highest_priority_task") \
            and not getattr(es.context.scheduler, "strict_order", False) \
            and es.owner_ident == threading.get_ident() \
            and es.next_task is None and es.context.started:
        tasks.sort(key=lambda t: t.priority)
        es.next_task = tasks.pop()
    if tasks:
        es.context.scheduler.schedule(es, tasks, distance)
    h = _hooks[_SCHEDULE_END]
    if h is not None:
        h(es, tasks)


def select_task(es: ExecutionStream) -> tuple[Task | None, int]:
    if es.next_task is not None:
        t, es.next_task = es.next_task, None
        return t, 0
    h = _hooks[_SELECT_BEGIN]
    if h is not None:
        h(es, None)
    t, distance = es.context.scheduler.select(es)
    h = _hooks[_SELECT_END]
    if h is not None:
        h(es, t)
    if t is not None and 0 < distance < 99:
        # work pulled from another stream's queue: a steal (99 is the
        # schedulers' shared system-queue sentinel, not a steal)
        h = _hooks[_SELECT_STEAL]
        if h is not None:
            h(es, (t, distance))
    return t, distance


def execute_task(es: ExecutionStream, task: Task) -> int:
    """Walk the class's chores honouring the task's chore mask and the
    evaluate/hook return protocol.  A device chore returns once it has
    handed the task to the device manager, so its EXEC span is that
    hand-off on the host (and, for the thread that becomes the manager,
    the batches it then drives)."""
    h = _hooks[_EXEC_BEGIN]
    if h is not None:
        h(es, task)
    try:
        for i, chore in enumerate(task.task_class.chores):
            if not (task.chore_mask & (1 << i)) or not chore.enabled:
                continue
            if chore.evaluate is not None \
                    and chore.evaluate(es, task) == HOOK_RETURN_NEXT:
                continue
            rc = chore.hook(es, task)
            if rc == HOOK_RETURN_NEXT:
                task.chore_mask &= ~(1 << i)
                continue
            if rc == HOOK_RETURN_DISABLE:
                chore.enabled = False
                task.chore_mask &= ~(1 << i)
                continue
            return rc
        return HOOK_RETURN_ERROR
    finally:
        h = _hooks[_EXEC_END]
        if h is not None:
            h(es, task)


def task_progress(es: ExecutionStream, task: Task, distance: int) -> int:
    """One task through its lifecycle."""
    h = _hooks[_PREPARE_INPUT_BEGIN]
    if h is not None:
        h(es, task)
    prepare_input(es, task)
    h = _hooks[_PREPARE_INPUT_END]
    if h is not None:
        h(es, task)
    rc = execute_task(es, task)
    if rc == HOOK_RETURN_DONE:
        complete_execution(es, task)
    elif rc == HOOK_RETURN_ASYNC:
        pass  # a device manager owns completion now
    elif rc == HOOK_RETURN_AGAIN:
        task.status = "rescheduled"
        schedule_tasks(es, [task], distance + 1)
    else:
        raise RuntimeError(f"task {task} failed: no runnable chore (rc={rc})")
    return rc


def resolve_data_inputs(task: Task) -> None:
    """Bind flows read directly from a data collection to their current
    copies, at task creation: a ``<- A(k)`` read observes the collection
    as of the moment the task came into existence.  A class with its own
    ``prepare_input`` owns this (DTD binds at insertion)."""
    if task.task_class.prepare_input is not None:
        return
    for f in task.task_class.flows:
        if f.is_ctl or task.data[f.flow_index] is not None:
            continue
        for d in f.deps_in:
            if d.target_class is None and d.active(task.locals):
                if d.data_ref is None:
                    break
                dc, key = d.data_ref(task.locals)
                copy = dc.data_of(*key).newest_copy()
                if copy is None:
                    raise RuntimeError(
                        f"{task}: flow {f.name} has no valid copy")
                # a typed collection read: a lazy shared repack
                task.data[f.flow_index] = reshape_for_edge(copy, None, d)
                break


def prepare_input(es: ExecutionStream, task: Task) -> None:
    """Generic data lookup: predecessor flows already carry their copies;
    collection reads were bound at creation (re-run here as a safety net);
    WRITE-only / NEW flows allocate scratch.  A class's own
    ``prepare_input`` replaces all of this."""
    if task.task_class.prepare_input is not None:
        task.task_class.prepare_input(es, task)
        return
    resolve_data_inputs(task)
    # the first consumer to prepare runs a pending repack on its thread
    for i, v in enumerate(task.data):
        if isinstance(v, DataCopyFuture):
            task.data[i] = resolve_copy(v)
    for f in task.task_class.flows:
        if f.is_ctl or task.data[f.flow_index] is not None:
            continue
        if any(d.null and d.active(task.locals) for d in f.deps_in):
            continue
        if f.dtt is not None:
            from ..data.data import scratch_copy
            task.data[f.flow_index] = scratch_copy(f.dtt)


def _find_input_dep(succ_tc: TaskClass, flow_name: str, src_class: str,
                    succ_locals: dict) -> tuple[int, int]:
    for f in succ_tc.flows:
        if f.name != flow_name:
            continue
        for di, d in enumerate(f.deps_in):
            if d.target_class == src_class and d.active(succ_locals):
                return f.flow_index, di
        raise LookupError(
            f"{succ_tc.name}.{flow_name}: no active input dep from {src_class}")
    raise KeyError(f"{succ_tc.name} has no flow {flow_name}")


def complete_execution(es: ExecutionStream, task: Task) -> None:
    """Outputs -> repo/collection, successor release, input-repo
    consumption, task retirement.  A class's own ``complete_execution``
    runs first (DTD releases its instance successors there)."""
    h = _hooks[_COMPLETE_EXEC_BEGIN]
    if h is not None:
        h(es, task)
    tc = task.task_class
    tp = task.taskpool
    if tc.complete_execution is not None:
        tc.complete_execution(es, task)
    if tp.sim_enabled:
        # exec date = the latest predecessor's date + this task's cost
        with tp._sim_lock:
            start = tp._sim_ready.pop((tc.name, task.key), 0.0)
            task.sim_exec_date = start + (
                float(tc.simcost(task.locals)) if tc.simcost else 0.0)
            if task.sim_exec_date > tp.largest_simulation_date:
                tp.largest_simulation_date = task.sim_exec_date
    release_deps(es, task)
    for ref in task.repo_entries:
        if ref is not None:
            entry, src_flow = ref
            entry.consume(src_flow)
    task.status = "done"
    h = _hooks[_COMPLETE_EXEC_END]
    if h is not None:
        h(es, task)
    task.taskpool.tdm.taskpool_addto_nb_tasks(-1)


def release_deps(es: ExecutionStream, task: Task) -> None:
    """Walk active out-deps: write-back edges update the collection;
    successor edges update dep trackers; the ready set goes to the
    scheduler in one call.  Edges to another rank accumulate into one
    remote-deps record, activated through the comm engine after the
    walk."""
    h = _hooks[_RELEASE_DEPS_BEGIN]
    if h is not None:
        h(es, task)
    tc = task.task_class
    tp = task.taskpool
    ctx = tp.context
    entry = None
    nconsumers = 0
    pending: list[tuple] = []
    remote = None
    multi = ctx.nb_ranks > 1   # one rank asks no owner

    def visitor(t: Task, flow, dep) -> None:
        nonlocal entry, nconsumers, remote
        out_copy = None if flow.is_ctl else t.data[flow.flow_index]
        if dep.target_class is None:
            home = _rank_of_data(dep, t.locals) if multi else None
            if home is not None and home != ctx.my_rank:
                # the home tile lives on another rank: ship the version
                remote = ctx.remote_dep_accumulate(remote, t, flow, dep,
                                                   None, None, home)
                return
            if out_copy is not None and dep.data_ref is not None:
                dc, key = dep.data_ref(t.locals)
                apply_writeback_to_home(
                    dc, key, reshape_for_writeback(out_copy, dep, dc, key))
            return
        succ_tc = tp.task_class(dep.target_class)
        for succ_locals in dep.each_target(t.locals):
            if succ_tc.in_space is not None \
                    and not succ_tc.in_space(succ_locals):
                continue   # out-of-space edge: the generated bounds check
            rank = _rank_of_task(succ_tc, succ_locals) if multi else None
            if rank is not None and rank != ctx.my_rank:
                remote = ctx.remote_dep_accumulate(remote, t, flow, dep,
                                                   succ_tc, succ_locals, rank)
                continue
            if tp.sim_enabled:
                # simulated dates are rank-local: only successors that run
                # here record a ready date
                skey = (succ_tc.name, succ_tc.make_key(succ_locals))
                with tp._sim_lock:
                    if t.sim_exec_date > tp._sim_ready.get(skey, 0.0):
                        tp._sim_ready[skey] = t.sim_exec_date
            fi, di = _find_input_dep(succ_tc, dep.target_flow, tc.name,
                                     succ_locals)
            repo_ref = None
            send = out_copy
            if out_copy is not None:
                if entry is None:
                    entry = tc.repo.lookup_and_create(t.key)
                entry.set_output(flow.flow_index, out_copy)
                repo_ref = (entry, flow.flow_index)
                nconsumers += 1
                # a typed edge: the consumer gets a lazy shared repack
                send = reshape_for_edge(out_copy, dep,
                                        succ_tc.flows[fi].deps_in[di])
            pending.append((succ_tc, succ_locals, fi, di, send, repo_ref))

    tc.iterate_successors(task, visitor)
    if entry is not None:
        entry.addto_usage_limit(nconsumers)
    if remote is not None:
        ctx.remote_dep_activate(es, task, remote)
    ready = ctx.deps.release_many(tp, pending) if pending else None
    h = _hooks[_RELEASE_DEPS_END]
    if h is not None:
        h(es, task)
    if ready:
        schedule_tasks(es, ready, 0)


def apply_writeback_to_home(dc: Any, key: tuple, out_copy: Any) -> None:
    """Apply a final version to a collection's home (device-0) copy.  The
    value is shared, not copied: a device tensor stays on its device until
    the device module writes its own copy back (``flush_cache``)."""
    home = dc.data_of(*key).get_copy(0)
    if home is None or home is out_copy:
        return
    home.value = out_copy.value
    home.version = max(home.version, out_copy.version) + 1


def _rank_of_task(tc: TaskClass, locals_: dict) -> int | None:
    """The rank a task runs on (None for a class with no affinity)."""
    if tc.affinity is None:
        return None
    dc, key = tc.affinity(locals_)
    return dc.rank_of(*(key if isinstance(key, tuple) else (key,)))


def _rank_of_data(dep: Any, locals_: dict) -> int | None:
    """The rank holding a write-back's home tile (None for an edge with no
    home)."""
    if dep.data_ref is None:
        return None
    dc, key = dep.data_ref(locals_)
    return dc.rank_of(*key)

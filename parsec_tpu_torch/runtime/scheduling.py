"""The scheduling loop: execute / complete / release-deps.

Port of ``parsec_tpu/runtime/scheduling.py`` (the reference's
``scheduling.c``): per-worker select -> ``prepare_input`` -> chore
execution -> completion -> ``release_deps`` walking successor edges and
handing newly-ready tasks to the scheduler, with the highest-priority
released task kept as the stream's ``next_task``.  Device chores return
``HOOK_RETURN_ASYNC`` and complete through :func:`complete_execution`
from the device manager.

Left out: PINS hooks, typed-edge reshape, remote (cross-rank) deps, the
simulation cost model and the paranoid write-back checks.
"""

from __future__ import annotations

import threading
from typing import Any

from ..core.params import params as _params
from .task import (HOOK_RETURN_AGAIN, HOOK_RETURN_ASYNC, HOOK_RETURN_DISABLE,
                   HOOK_RETURN_DONE, HOOK_RETURN_ERROR, HOOK_RETURN_NEXT,
                   Task, TaskClass)

_params.register(
    "runtime_keep_highest_priority_task", True,
    "hold the best released task as the stream's next task")


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
    # next_task is a single-owner slot: only the thread running this
    # stream's loop may fill it (a device manager completing a task on
    # behalf of another stream goes through the scheduler)
    if _params.get("runtime_keep_highest_priority_task") \
            and es.owner_ident == threading.get_ident() \
            and es.next_task is None and es.context.started:
        tasks.sort(key=lambda t: t.priority)
        es.next_task = tasks.pop()
    if tasks:
        es.context.scheduler.schedule(es, tasks, distance)


def select_task(es: ExecutionStream) -> tuple[Task | None, int]:
    if es.next_task is not None:
        t, es.next_task = es.next_task, None
        return t, 0
    return es.context.scheduler.select(es)


def execute_task(es: ExecutionStream, task: Task) -> int:
    """Walk the class's chores honouring the task's chore mask and the
    evaluate/hook return protocol."""
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


def task_progress(es: ExecutionStream, task: Task, distance: int) -> int:
    """One task through its lifecycle."""
    prepare_input(es, task)
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
    as of the moment the task came into existence."""
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
                task.data[f.flow_index] = copy
                break


def prepare_input(es: ExecutionStream, task: Task) -> None:
    """Generic data lookup: predecessor flows already carry their copies;
    collection reads were bound at creation (re-run here as a safety net);
    WRITE-only / NEW flows allocate scratch."""
    resolve_data_inputs(task)
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
    consumption, task retirement."""
    release_deps(es, task)
    for ref in task.repo_entries:
        if ref is not None:
            entry, src_flow = ref
            entry.consume(src_flow)
    task.status = "done"
    task.taskpool.tdm.taskpool_addto_nb_tasks(-1)


def release_deps(es: ExecutionStream, task: Task) -> None:
    """Walk active out-deps: write-back edges update the collection;
    successor edges update dep trackers; the ready set goes to the
    scheduler in one call."""
    tc = task.task_class
    tp = task.taskpool
    entry = None
    nconsumers = 0
    pending: list[tuple] = []

    def visitor(t: Task, flow, dep) -> None:
        nonlocal entry, nconsumers
        out_copy = None if flow.is_ctl else t.data[flow.flow_index]
        if dep.target_class is None:
            if out_copy is not None and dep.data_ref is not None:
                dc, key = dep.data_ref(t.locals)
                apply_writeback_to_home(dc, key, out_copy)
            return
        succ_tc = tp.task_class(dep.target_class)
        for succ_locals in dep.each_target(t.locals):
            if succ_tc.in_space is not None \
                    and not succ_tc.in_space(succ_locals):
                continue   # out-of-space edge: the generated bounds check
            fi, di = _find_input_dep(succ_tc, dep.target_flow, tc.name,
                                     succ_locals)
            repo_ref = None
            if out_copy is not None:
                if entry is None:
                    entry = tc.repo.lookup_and_create(t.key)
                entry.set_output(flow.flow_index, out_copy)
                repo_ref = (entry, flow.flow_index)
                nconsumers += 1
            pending.append((succ_tc, succ_locals, fi, di, out_copy, repo_ref))

    tc.iterate_successors(task, visitor)
    if entry is not None:
        entry.addto_usage_limit(nconsumers)
    if pending:
        schedule_tasks(es, tp.context.deps.release_many(tp, pending), 0)


def apply_writeback_to_home(dc: Any, key: tuple, out_copy: Any) -> None:
    """Apply a final version to a collection's home (device-0) copy.  The
    value is shared, not copied: a device tensor stays on its device until
    the device module writes its own copy back (``flush_cache``)."""
    home = dc.data_of(*key).get_copy(0)
    if home is None or home is out_copy:
        return
    home.value = out_copy.value
    home.version = max(home.version, out_copy.version) + 1

"""Dependency tracking: hashed per-task IN-dep bookkeeping.

Port of ``parsec_tpu/runtime/deps.py`` (the reference's
``parsec_hash_find_deps`` / ``parsec_update_deps_with_mask``): tasks that
are not ready yet exist only as a tracker in a hash table keyed by
(taskpool, class, task key).  Each arriving dep sets a bit in the
satisfied mask; when it equals the required mask (the class's active
input-dep guards for those locals), the task is instantiated with its
inputs attached and handed back to be scheduled.

Left out: the dense index-array tier, the native C++ dep table and the
goal-counted mode of ranged deps — this copy keeps the hashed tier, which
every task class can take.
"""

from __future__ import annotations

from typing import Any

from ..core.hash_table import ConcurrentHashTable
from .task import Task, TaskClass


class _DepTracker:
    __slots__ = ("required_mask", "satisfied_mask", "inputs", "repo_refs")

    def __init__(self, required_mask: int, nflows: int) -> None:
        self.required_mask = required_mask
        self.satisfied_mask = 0
        self.inputs: list[Any] = [None] * nflows
        self.repo_refs: list[Any] = [None] * nflows


class DependencyTracking:
    """One instance per context."""

    def __init__(self) -> None:
        self._table = ConcurrentHashTable()

    def release_dep(self, taskpool: Any, tc: TaskClass, locals_: dict,
                    flow_index: int, dep_index: int,
                    data_copy: Any, repo_ref: Any = None) -> Task | None:
        """Record one satisfied input dep; return the now-ready Task or None.
        ``repo_ref`` is (repo_entry, src_flow_index), consumed at
        completion."""
        key = (taskpool.taskpool_id, tc.task_class_id, tc.make_key(locals_))
        bit = 1 << tc.dep_bit(flow_index, dep_index)
        with self._table.locked(key):
            trk = self._table.get(key)
            if trk is None:
                trk = _DepTracker(tc.input_dep_mask(locals_), len(tc.flows))
                self._table.insert(key, trk)
            if trk.satisfied_mask & bit:
                raise RuntimeError(
                    f"dep {tc.name}{key} bit {bit} satisfied twice")
            trk.satisfied_mask |= bit
            if data_copy is not None:
                trk.inputs[flow_index] = data_copy
                trk.repo_refs[flow_index] = repo_ref
            ready = trk.satisfied_mask == trk.required_mask
            if ready:
                self._table.remove(key)
        if not ready:
            return None
        prio = tc.priority(locals_) if tc.priority is not None else 0
        task = Task(taskpool, tc, dict(locals_), priority=prio)
        task.data = list(trk.inputs)
        task.repo_entries = list(trk.repo_refs)
        task.status = "ready"
        from .scheduling import resolve_data_inputs
        resolve_data_inputs(task)   # snapshot collection reads at creation
        return task

    def release_many(self, taskpool: Any, records: list[tuple]) -> list[Task]:
        """Release one completing task's successor deps: ``records`` holds
        ``(tc, locals_, flow_index, dep_index, data_copy, repo_ref)``."""
        ready = []
        for tc, locals_, fi, di, data_copy, repo_ref in records:
            t = self.release_dep(taskpool, tc, locals_, fi, di, data_copy,
                                 repo_ref)
            if t is not None:
                ready.append(t)
        return ready

    def purge_taskpool(self, taskpool_id: int) -> None:
        """Drop trackers a finished (or aborted) taskpool left behind."""
        for key, _ in list(self._table.items()):
            if key[0] == taskpool_id:
                self._table.remove(key)

    def __len__(self) -> int:
        return len(self._table)

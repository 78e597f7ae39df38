"""Taskpools: DAG containers with a lifecycle.

Port of ``parsec_tpu/runtime/taskpool.py`` (the reference's
``parsec_taskpool_t``): a taskpool owns task classes and their data
repos, a termination-detection monitor (the only path to ``nb_tasks``),
startup enumeration and completion callbacks.  Left out: the process-wide
taskpool registry, sequential composition (``compose``), per-pool
termdet selection, region plans and the simulation date.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Sequence

from ..data.datarepo import DataRepo
from .task import Task, TaskClass
from .termdet import LocalTermDet

_taskpool_ids = itertools.count(1)


class Taskpool:
    def __init__(self, name: str = "",
                 task_classes: Sequence[TaskClass] = ()) -> None:
        self.taskpool_id = next(_taskpool_ids)
        self.name = name or f"taskpool{self.taskpool_id}"
        self.context: Any = None
        self.tdm: LocalTermDet | None = None
        self.task_classes: list[TaskClass] = []
        self.task_classes_by_name: dict[str, TaskClass] = {}
        for tc in task_classes:
            self.add_task_class(tc)
        self.on_complete: Callable[["Taskpool"], None] | None = None
        self._done = threading.Event()

    def add_task_class(self, tc: TaskClass) -> TaskClass:
        tc.task_class_id = len(self.task_classes)
        self.task_classes.append(tc)
        self.task_classes_by_name[tc.name] = tc
        tc.repo = DataRepo(len(tc.flows), name=f"{self.name}.{tc.name}")
        return tc

    def task_class(self, name: str) -> TaskClass:
        return self.task_classes_by_name[name]

    def startup(self, context: Any) -> list[Task]:
        """Initially-ready tasks; DSLs override."""
        return []

    def nb_local_tasks(self) -> int:
        """Total local task count (-1 = unknown)."""
        return -1

    def terminated(self) -> None:
        self._done.set()
        if self.on_complete is not None:
            self.on_complete(self)
        if self.context is not None:
            self.context._taskpool_terminated(self)

    def wait(self, timeout: float | None = None) -> None:
        """Block until this taskpool completes, driving progress from the
        calling thread when the context has no workers."""
        if self.context is not None:
            self.context._drive_until(self._done.is_set, timeout)
        elif not self._done.wait(timeout):
            raise TimeoutError(f"taskpool {self.name} did not complete")

    def test(self) -> bool:
        return self._done.is_set()

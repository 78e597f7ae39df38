"""Taskpools: DAG containers with a lifecycle.

Port of ``parsec_tpu/runtime/taskpool.py`` (the reference's
``parsec_taskpool_t``): a taskpool owns task classes and their data
repos, a termination-detection monitor (the only path to ``nb_tasks``),
startup enumeration and completion listeners
(:meth:`Taskpool.add_completion_listener`), with the single
``on_complete`` slot, fired first, that a recursive call chains onto
(:mod:`.recursive`).  On several ranks a pool
carries the rank-agreed ``comm_id`` its context gives it at enqueue (None
for a rank-private ``local_only`` pool).  ``termdet_name`` picks the
pool's own termination detector (the JDF ``%option termdet``), and a pool
whose classes carry a ``simcost`` tracks ``largest_simulation_date``.

A live pool is in the process-wide registry from construction to
termination (:func:`taskpool_lookup`; a serving process enqueues a fresh
pool an iteration, so a retired pool leaves it).  ``on_enqueue`` runs at
enqueue, before startup: a pool that inserts its tasks then (the
redistribution's DTD pool) composes like any other.
:class:`CompoundTaskpool` (:func:`compose`) runs its members one after
another, each enqueued when its predecessor terminates.  Left out: region
plans (the port's region pools keep theirs on the lowered object).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Sequence

from ..core.hash_table import ConcurrentHashTable
from ..data.datarepo import DataRepo
from .task import Task, TaskClass
from .termdet import TermDetMonitor

_taskpool_ids = itertools.count(1)
_registry = ConcurrentHashTable()


def taskpool_lookup(tp_id: int) -> "Taskpool | None":
    """The live pool of that id (None once it terminated)."""
    return _registry.get(tp_id)


class Taskpool:
    def __init__(self, name: str = "",
                 task_classes: Sequence[TaskClass] = ()) -> None:
        self.taskpool_id = next(_taskpool_ids)
        self.name = name or f"taskpool{self.taskpool_id}"
        self.context: Any = None
        self.tdm: TermDetMonitor | None = None
        # wire identity, set at enqueue (None: never on the wire)
        self.comm_id: int | None = None
        self.local_only = False
        # run at enqueue, before startup (a DTD pool inserts its tasks)
        self.on_enqueue: Callable[["Taskpool"], None] | None = None
        # fired at termination before the listeners (recursive_call
        # chains its drain onto it)
        self.on_complete: Callable[["Taskpool"], None] | None = None
        # this pool's termination detector by name (None: the termdet
        # param's)
        self.termdet_name: str | None = None
        # the simulated cost model: on when a class carries a simcost
        self.sim_enabled = False
        self._sim_ready: dict = {}      # (class, key) -> latest pred date
        self._sim_lock = threading.Lock()
        self.largest_simulation_date = 0.0
        self.task_classes: list[TaskClass] = []
        self.task_classes_by_name: dict[str, TaskClass] = {}
        for tc in task_classes:
            self.add_task_class(tc)
        self._done = threading.Event()
        self._completion_listeners: list[Callable[["Taskpool"], None]] = []
        self._listeners_lock = threading.Lock()
        _registry.insert(self.taskpool_id, self)

    def add_task_class(self, tc: TaskClass) -> TaskClass:
        tc.task_class_id = len(self.task_classes)
        self.task_classes.append(tc)
        self.task_classes_by_name[tc.name] = tc
        tc.repo = DataRepo(len(tc.flows), name=f"{self.name}.{tc.name}")
        if tc.simcost is not None:
            self.sim_enabled = True
        return tc

    def task_class(self, name: str) -> TaskClass:
        return self.task_classes_by_name[name]

    def startup(self, context: Any) -> list[Task]:
        """Initially-ready tasks; DSLs override."""
        return []

    def nb_local_tasks(self) -> int:
        """Total local task count (-1 = unknown)."""
        return -1

    def add_completion_listener(self, cb: Callable[["Taskpool"], None]
                                ) -> None:
        """Register a termination observer.  Fires exactly once;
        immediately when the pool already terminated (the add/terminate
        race is closed under ``_listeners_lock``)."""
        with self._listeners_lock:
            if not self._done.is_set():
                self._completion_listeners.append(cb)
                return
        cb(self)

    def terminated(self) -> None:
        with self._listeners_lock:
            self._done.set()
            listeners = self._completion_listeners
            self._completion_listeners = []
        if self.on_complete is not None:
            self.on_complete(self)
        for cb in listeners:
            cb(self)
        if self.context is not None:
            self.context._taskpool_terminated(self)
        _registry.remove(self.taskpool_id)

    def wait(self, timeout: float | None = None) -> None:
        """Block until this taskpool completes, driving progress from the
        calling thread when the context has no workers."""
        if self.context is not None:
            self.context._drive_until(self._done.is_set, timeout)
        elif not self._done.wait(timeout):
            raise TimeoutError(f"taskpool {self.name} did not complete")

    def test(self) -> bool:
        return self._done.is_set()


class CompoundTaskpool(Taskpool):
    """Sequential composition (``compound.c``): each member is enqueued
    when its predecessor terminates; the compound terminates after the
    last."""

    def __init__(self, members: Sequence[Taskpool]) -> None:
        super().__init__(name="compound")
        self.members = list(members)
        self._idx = 0

    def startup(self, context: Any) -> list[Task]:
        self.tdm.taskpool_addto_nb_pa(+1)   # alive until the last member
        self._start_next(context)
        return []

    def _start_next(self, context: Any) -> None:
        if self._idx >= len(self.members):
            self.tdm.taskpool_addto_nb_pa(-1)
            return
        member = self.members[self._idx]
        self._idx += 1
        prev_cb = member.on_complete

        def chain(tp: Taskpool) -> None:
            if prev_cb is not None:
                prev_cb(tp)
            self._start_next(context)

        member.on_complete = chain
        context.add_taskpool(member)


def compose(*taskpools: Taskpool) -> CompoundTaskpool:
    return CompoundTaskpool(taskpools)

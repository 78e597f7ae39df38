"""Scheduler implementations: LFQ, the default.

Port of the ``lfq`` module of ``parsec_tpu/sched/modules.py`` (the
reference's ``sched/lfq``, the component that wins the priority query):
per-stream bounded sharded deques spilling to a per-VP overflow queue,
with sibling stealing.  The other ten modules (ap, spq, ip, gd, rnd, ll,
llp, pbq, ltq, lhq) and the MCA component repository wait for a later
slice; :func:`open_scheduler` raises for any name but ``lfq``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Sequence

from ..core.hbbuffer import StealDeque
from ..core.params import params as _params
from .api import SchedulerModule

_params.register("sched_lfq_buffer_size", 256,
                 "per-stream sharded-deque capacity for lfq (spills to the "
                 "per-VP system queue beyond this)")


def _task_priority(t: Any) -> int:
    return t.priority


class _VPQueues:
    def __init__(self) -> None:
        self.system: deque = deque()
        self.lock = threading.Lock()


class LFQModule(SchedulerModule):
    """Sharded ready queues: the per-stream :class:`StealDeque` is the
    primary push target; a lock is taken only on steal, overflow spill or
    the priority scan."""

    name = "lfq"

    def install(self, context: Any) -> None:
        for vp in context.virtual_processes:
            vp.sched_private = _VPQueues()
        self._cap = _params.get("sched_lfq_buffer_size")

    def flow_init(self, es: Any) -> None:
        vpq = es.virtual_process.sched_private

        def overflow(items: list, distance: int) -> None:
            with vpq.lock:
                vpq.system.extend(items)

        es.sched_private = StealDeque(self._cap, parent_push=overflow)

    def schedule(self, es: Any, tasks: Sequence[Any], distance: int = 0) -> None:
        sp = es.sched_private
        if sp is None or distance > 0:
            vpq = es.virtual_process.sched_private
            with vpq.lock:
                vpq.system.extend(tasks)
            return
        sp.push_all(list(tasks), distance)

    def select(self, es: Any) -> tuple[Any | None, int]:
        sp = es.sched_private
        if sp is not None:
            t = sp.try_pop_best(priority=_task_priority)
            if t is not None:
                return t, 0
        for sib in es.virtual_process.execution_streams:
            if sib is es or sib.sched_private is None:
                continue
            t = sib.sched_private.steal()
            if t is not None:
                return t, 1
        vpq = es.virtual_process.sched_private
        with vpq.lock:
            if vpq.system:
                return vpq.system.popleft(), 99
        return None, 0

    def remove(self, context: Any) -> None:
        for vp in context.virtual_processes:
            vp.sched_private = None
            for es in vp.execution_streams:
                es.sched_private = None

    def pending_tasks(self, context: Any) -> int:
        n = 0
        for vp in context.virtual_processes:
            if vp.sched_private is not None:
                n += len(vp.sched_private.system)
            for es in vp.execution_streams:
                if es.sched_private is not None:
                    n += len(es.sched_private)
        return n


_MODULES = {LFQModule.name: LFQModule}


def open_scheduler(name: str) -> SchedulerModule:
    """A fresh scheduler module by name (the MCA ``--mca sched`` choice)."""
    try:
        return _MODULES[name]()
    except KeyError:
        raise LookupError(
            f"no scheduler '{name}' in parsec_tpu_torch (ported: "
            f"{sorted(_MODULES)})") from None

"""Scheduler module interface.

Port of ``parsec_tpu/sched/api.py`` (the reference's ``sched.h``): a
scheduler module exposes ``install / flow_init / schedule / select /
remove``.  ``schedule(es, tasks, distance)`` hints how far from the
submitting stream the tasks should land; ``select`` returns the distance
the task came from (0 = own queue, 1..98 = stolen, 99 = shared system
queue).  ``pending_tasks`` and ``queue_depths`` are read by the live
properties and the flight recorder's stall dump; they take no lock that
a wedged worker could hold for long.
"""

from __future__ import annotations

from typing import Any, Sequence


class SchedulerModule:
    name = "base"

    def install(self, context: Any) -> None:
        """Global structures; called once per context."""

    def flow_init(self, es: Any) -> None:
        """Per-execution-stream structures."""

    def schedule(self, es: Any, tasks: Sequence[Any], distance: int = 0) -> None:
        raise NotImplementedError

    def select(self, es: Any) -> tuple[Any | None, int]:
        raise NotImplementedError

    def remove(self, context: Any) -> None:
        """Tear down."""

    def pending_tasks(self, context: Any) -> int:
        return -1

    def queue_depths(self, context: Any) -> dict[str, int]:
        """Best-effort per-queue depth map for the stall dump; modules
        with per-stream queues override it, the base reports the shared
        total."""
        return {"shared": self.pending_tasks(context)}

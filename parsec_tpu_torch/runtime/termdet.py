"""Termination detection: the local detector.

Port of ``parsec_tpu/runtime/termdet.py`` (the reference's
``termdet/local``): a taskpool holds a monitor through which every update
to ``nb_tasks`` / ``nb_pending_actions`` flows; the detector walks
NOT_READY -> BUSY -> TERMINATED and fires the taskpool's termination
callback exactly once.  Left out: the user-trigger detector, the
distributed four-counter wave (no comm layer yet) and
``taskpool_addto_nb_pa``, which only DTD, comm and recursive bodies call
(``nb_pending_actions`` stays 0).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

STATE_NOT_READY = 0
STATE_BUSY = 1
STATE_TERMINATED = 3


class LocalTermDet:
    """Single-process counter detector."""

    name = "local"

    def __init__(self) -> None:
        self.state = STATE_NOT_READY
        self._lock = threading.Lock()
        self._on_terminated: Callable[[], None] | None = None
        self.nb_tasks = 0
        self.nb_pending_actions = 0

    def monitor_taskpool(self, taskpool: Any,
                         on_terminated: Callable[[], None]) -> None:
        self._on_terminated = on_terminated
        self.taskpool = taskpool

    def ready(self) -> None:
        """All initial tasks registered; detection may now conclude."""
        with self._lock:
            if self.state == STATE_NOT_READY:
                self.state = STATE_BUSY
            fire = self._check_idle_locked()
        if fire:
            self._on_terminated()

    def taskpool_addto_nb_tasks(self, delta: int) -> int:
        with self._lock:
            self.nb_tasks += delta
            if self.nb_tasks < 0:
                raise RuntimeError("nb_tasks went negative")
            fire = self._check_idle_locked()
            n = self.nb_tasks
        if fire:
            self._on_terminated()
        return n

    def _check_idle_locked(self) -> bool:
        if (self.state == STATE_BUSY and self.nb_tasks == 0
                and self.nb_pending_actions == 0):
            self.state = STATE_TERMINATED
            return True
        return False

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": {STATE_NOT_READY: "NOT_READY",
                              STATE_BUSY: "BUSY",
                              STATE_TERMINATED: "TERMINATED"}[self.state],
                    "nb_tasks": self.nb_tasks,
                    "nb_pending_actions": self.nb_pending_actions}

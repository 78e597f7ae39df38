"""Termination detection: the monitor base, the local detector, the registry.

Port of ``parsec_tpu/runtime/termdet.py`` (the reference's
``termdet/local``): a taskpool holds a monitor through which every update
to ``nb_tasks`` / ``nb_pending_actions`` flows; the detector walks
NOT_READY -> BUSY (-> IDLE) -> TERMINATED and fires the taskpool's
termination callback exactly once.  ``nb_pending_actions`` moves through
:meth:`TermDetMonitor.taskpool_addto_nb_pa`: DTD holds one pending action
from its startup until ``close()``, and the comm layer one for each
activation in flight until its consumer acknowledges it.

:meth:`TermDetMonitor.on_comm_sent` / :meth:`~TermDetMonitor.on_comm_recv`
are the hooks the remote-dep engine calls for every activation message;
they count nothing here.  The distributed four-counter detector
(:mod:`parsec_tpu_torch.comm.termdet_fourcounter`) overrides them and the
idle check, and registers itself under ``fourcounter``.
:func:`open_termdet` opens a detector by name (the ``termdet`` param);
the registry stands in for the JAX package's MCA component query.

Left out: the user-trigger detector.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from ..core.params import params as _params

_params.register("termdet", "",
                 "termination detector of new taskpools (empty: local; "
                 "fourcounter for multi-rank pools)")

STATE_NOT_READY = 0
STATE_BUSY = 1
STATE_IDLE = 2
STATE_TERMINATED = 3


class TermDetMonitor:
    """Base monitor attached to a taskpool (cf. ``parsec_termdet_module_t``);
    terminates when both counters reach zero after :meth:`ready`."""

    name = "base"

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
            self._terminate()

    def taskpool_addto_nb_tasks(self, delta: int) -> int:
        with self._lock:
            self.nb_tasks += delta
            if self.nb_tasks < 0:
                raise RuntimeError("nb_tasks went negative")
            fire = self._check_idle_locked()
            n = self.nb_tasks
        if fire:
            self._terminate()
        return n

    def taskpool_addto_nb_pa(self, delta: int) -> int:
        with self._lock:
            self.nb_pending_actions += delta
            if self.nb_pending_actions < 0:
                raise RuntimeError("nb_pending_actions went negative")
            fire = self._check_idle_locked()
            n = self.nb_pending_actions
        if fire:
            self._terminate()
        return n

    def _check_idle_locked(self) -> bool:
        if (self.state == STATE_BUSY and self.nb_tasks == 0
                and self.nb_pending_actions == 0):
            self.state = STATE_TERMINATED
            return True
        return False

    # activation-message counters: only distributed detectors count
    def on_comm_sent(self) -> None:
        pass

    def on_comm_recv(self) -> None:
        pass

    def _terminate(self) -> None:
        if self._on_terminated is not None:
            self._on_terminated()

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": ("NOT_READY", "BUSY", "IDLE",
                              "TERMINATED")[self.state],
                    "nb_tasks": self.nb_tasks,
                    "nb_pending_actions": self.nb_pending_actions}


class LocalTermDet(TermDetMonitor):
    """Single-process counter detector (``termdet/local``)."""

    name = "local"


_DETECTORS: dict[str, Callable[[Any], TermDetMonitor]] = {
    "local": lambda context: LocalTermDet()}


def register_termdet(name: str,
                     factory: Callable[[Any], TermDetMonitor]) -> None:
    """Make ``factory(context)`` the detector opened by ``name``."""
    _DETECTORS[name] = factory


def open_termdet(name: str, context: Any = None) -> TermDetMonitor:
    """A fresh detector of the registered ``name``."""
    factory = _DETECTORS.get(name)
    if factory is None:
        raise ValueError(f"unknown termination detector {name!r}; "
                         f"registered: {sorted(_DETECTORS)} (the "
                         f"fourcounter detector registers when "
                         f"parsec_tpu_torch.comm is imported)")
    return factory(context)

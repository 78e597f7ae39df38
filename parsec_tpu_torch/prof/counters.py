"""Software-defined counters and the live properties dictionary.

Port of ``parsec_tpu/prof/counters.py``:

- **SDE counters** (the reference's ``papi_sde.c``): named process-wide
  counters and gauges: tasks enabled and retired, which the
  :class:`SdePinsModule` (the ``sde`` PINS component) feeds from PINS
  events, and the comm engine's gauges
  (:class:`~parsec_tpu_torch.comm.remote_dep.RemoteDepEngine` registers
  ``comm::rank<r>::*``).
- **Properties dictionary** (``dictionary.c``): (namespace, property,
  getter) triples read on demand by :meth:`PropertiesDictionary.snapshot`,
  and streamed to a JSON file on an interval by
  :meth:`PropertiesDictionary.stream_to` (atomically replaced, so
  :func:`read_live_snapshot` may read it mid-run).  A context publishes
  its gauges under ``rank<r>`` and, with the ``props_stream`` param,
  streams them; ``python -m parsec_tpu_torch.prof.dashboard <file>``
  renders that file.

A gauge or property getter runs on the thread that snapshots, never on a
hot path; the port's getters read host counters only and never wait on
the card.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

from ..core.mca import Component, component
from . import pins
from .pins import PinsEvent


class SdeCounters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, Callable[[], float]] = {}

    def inc(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = fn

    def unregister_gauge(self, name: str) -> None:
        with self._lock:
            self._gauges.pop(name, None)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            out: dict[str, float] = dict(self._counters)
            gauges = list(self._gauges.items())
        for name, fn in gauges:
            try:
                out[name] = fn()
            except Exception:       # noqa: BLE001 — a gauge never fails a read
                out[name] = float("nan")
        return out

    def get(self, name: str) -> float:
        return self.snapshot().get(name, 0)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


sde = SdeCounters()

TASKS_ENABLED = "parsec::tasks_enabled"
TASKS_RETIRED = "parsec::tasks_retired"


class SdePinsModule:
    """Feeds the task counters from the PINS chains: SCHEDULE_BEGIN adds
    the tasks handed to the scheduler, COMPLETE_EXEC_END one retired
    task."""

    def __init__(self) -> None:
        self._cbs: list[tuple[PinsEvent, Any]] = []

    def install(self) -> None:
        def on_sched(es, tasks):
            sde.inc(TASKS_ENABLED, len(tasks) if isinstance(tasks, list)
                    else 1)

        def on_done(es, task):
            sde.inc(TASKS_RETIRED)

        self._cbs = [(PinsEvent.SCHEDULE_BEGIN, on_sched),
                     (PinsEvent.COMPLETE_EXEC_END, on_done)]
        for ev, cb in self._cbs:
            pins.register(ev, cb)

    def uninstall(self) -> None:
        for ev, cb in self._cbs:
            pins.unregister(ev, cb)
        self._cbs.clear()


@component
class SdeComponent(Component):
    type_name = "pins"
    name = "sde"

    def open(self, context: Any = None) -> SdePinsModule:
        m = SdePinsModule()
        m.install()
        return m

    def close(self, module: SdePinsModule) -> None:
        module.uninstall()


class PropertiesDictionary:
    """(namespace, property) -> getter registry, read by snapshot."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._props: dict[tuple[str, str], Callable[[], Any]] = {}

    def register(self, namespace: str, name: str,
                 fn: Callable[[], Any]) -> None:
        with self._lock:
            self._props[(namespace, name)] = fn

    def unregister(self, namespace: str, name: str) -> None:
        with self._lock:
            self._props.pop((namespace, name), None)

    def has(self, namespace: str, name: str) -> bool:
        with self._lock:
            return (namespace, name) in self._props

    def snapshot(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            items = list(self._props.items())
        out: dict[str, dict[str, Any]] = {}
        for (ns, name), fn in items:
            try:
                out.setdefault(ns, {})[name] = fn()
            except Exception as e:      # noqa: BLE001 — shown, not raised
                out.setdefault(ns, {})[name] = f"<error: {e}>"
        return out

    def stream_to(self, path: str,
                  interval: float = 0.5) -> Callable[[], None]:
        """Write JSON snapshots to ``path`` every ``interval`` seconds
        until the returned stop function is called (the live dashboard's
        feed); each write goes to ``path + ".tmp"`` and is renamed over
        ``path``."""
        stop = threading.Event()

        def run() -> None:
            while not stop.is_set():
                snap = {"ts": time.time(), "props": self.snapshot()}
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(snap, f, default=str)
                os.replace(tmp, path)
                stop.wait(interval)

        th = threading.Thread(target=run, daemon=True,
                              name="parsec-props-stream")
        th.start()

        def stopper() -> None:
            stop.set()
            th.join(timeout=5)

        return stopper


def read_live_snapshot(path: str) -> dict:
    """Read the latest streamed snapshot (the dashboard's half of the
    pair); the atomic rename makes this safe while the stream writes."""
    with open(path) as f:
        return json.load(f)


properties = PropertiesDictionary()

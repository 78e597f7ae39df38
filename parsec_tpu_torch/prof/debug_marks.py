"""debug_marks: a post-mortem ring of recent runtime events.

Port of ``parsec_tpu/prof/debug_marks.py`` (the reference's
``debug_marks.c``): a fixed-size circular buffer (``debug_marks_size``)
of cheap marks (select, exec, complete, release with task identity and
thread id) kept in memory, so that after a wedge :meth:`MarkRing.dump`
shows the last things every stream did.  A PINS module
(``debug_marks``): the marks ride the same chains the profiler uses.

Left out: the component's priority (the port opens PINS modules by
name).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from ..core.mca import Component, component
from ..core.params import params as _params
from . import pins
from .pins import PinsEvent

_params.register("debug_marks_size", 512,
                 "circular-buffer capacity of the debug-marks ring")


class MarkRing:
    def __init__(self, capacity: int) -> None:
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def mark(self, kind: str, what: str) -> None:
        with self._lock:
            self._ring.append((time.monotonic_ns(),
                               threading.get_ident() & 0xFFFF, kind, what))

    def snapshot(self) -> list[tuple]:
        with self._lock:
            return list(self._ring)

    def dump(self) -> str:
        lines = [f"{ts} t{tid:04x} {kind:<14} {what}"
                 for ts, tid, kind, what in self.snapshot()]
        return "\n".join(lines)


ring = MarkRing(512)    # re-sized from the param at each module install


class DebugMarksModule:
    EVENTS = {
        PinsEvent.SELECT_END: "select",
        PinsEvent.EXEC_BEGIN: "exec_begin",
        PinsEvent.EXEC_END: "exec_end",
        PinsEvent.COMPLETE_EXEC_END: "complete",
        PinsEvent.RELEASE_DEPS_BEGIN: "release_deps",
    }

    def __init__(self) -> None:
        self._cbs: list[tuple[PinsEvent, Any]] = []

    def install(self) -> None:
        global ring
        ring = MarkRing(_params.get("debug_marks_size"))
        for ev, kind in self.EVENTS.items():
            def mk(kind):
                def cb(es, payload):
                    # None payloads (e.g. empty select polls) would flood
                    # the ring and evict the post-mortem evidence
                    if payload is None:
                        return
                    ring.mark(kind, repr(payload))
                return cb
            cb = mk(kind)
            pins.register(ev, cb)
            self._cbs.append((ev, cb))

    def uninstall(self) -> None:
        for ev, cb in self._cbs:
            pins.unregister(ev, cb)
        self._cbs.clear()


@component
class DebugMarksComponent(Component):
    type_name = "pins"
    name = "debug_marks"

    def open(self, context: Any = None) -> DebugMarksModule:
        mod = DebugMarksModule()
        mod.install()
        return mod

    def close(self, module: DebugMarksModule) -> None:
        module.uninstall()

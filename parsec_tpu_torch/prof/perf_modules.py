"""PINS perf modules: steal accounting and periodic throughput logging.

Port of ``parsec_tpu/prof/perf_modules.py``:

- :class:`PrintStealsModule` (``print_steals``): counts, per execution
  stream, the selects that pulled work from beyond the stream's own
  queue (SELECT_STEAL) and their summed distance; writes the table
  through :func:`parsec_tpu_torch.core.output.inform` at uninstall and
  counts ``parsec::steals`` in the SDE registry.
- :class:`AlperfModule` (``alperf``): counts retired tasks from the PINS
  chain and logs tasks retired a second every ``pins_alperf_interval``
  seconds, also published as the ``alperf``/``tasks_per_s`` property.

Left out: the components' priority query (the port opens PINS modules
by name only).
"""

from __future__ import annotations

import threading
import time
from typing import Any

from ..core.mca import Component, component
from ..core.params import params as _params
from . import pins
from .counters import properties, sde
from .pins import PinsEvent

_params.register("pins_alperf_interval", 1.0,
                 "seconds between alperf throughput samples")


class PrintStealsModule:
    """Per-stream steal counters fed from SELECT_STEAL."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.steals: dict[int, int] = {}        # th_id -> count
        self.distance: dict[int, int] = {}      # th_id -> summed distance
        self._cb = None

    def install(self) -> None:
        def on_steal(es: Any, payload: Any) -> None:
            task, dist = payload
            th = es.th_id if es is not None else -1
            with self._lock:
                self.steals[th] = self.steals.get(th, 0) + 1
                self.distance[th] = self.distance.get(th, 0) + dist
            sde.inc("parsec::steals")

        pins.register(PinsEvent.SELECT_STEAL, on_steal)
        self._cb = on_steal

    def uninstall(self) -> None:
        if self._cb is not None:
            pins.unregister(PinsEvent.SELECT_STEAL, self._cb)
            self._cb = None
        from ..core.output import inform
        with self._lock:
            for th in sorted(self.steals):
                inform(f"print_steals: stream {th}: {self.steals[th]} steals"
                     f" (summed distance {self.distance[th]})")


@component
class PrintStealsComponent(Component):
    type_name = "pins"
    name = "print_steals"

    def open(self, context: Any = None) -> PrintStealsModule:
        m = PrintStealsModule()
        m.install()
        return m

    def close(self, module: PrintStealsModule) -> None:
        module.uninstall()


class AlperfModule:
    """Interval throughput sampler.  Counts retirements itself from the
    PINS chain (self-contained like the reference module — it must not
    depend on the SDE pins module being co-installed) and samples the
    rate on a wall-clock interval."""

    def __init__(self, interval: float | None = None) -> None:
        self.interval = interval or _params.get("pins_alperf_interval")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._retired = 0
        self._cb = None
        self.samples: list[tuple[float, float]] = []   # (ts, tasks/s)

    def install(self) -> None:
        def on_done(es: Any, task: Any) -> None:
            self._retired += 1      # GIL-atomic enough for a rate gauge

        pins.register(PinsEvent.COMPLETE_EXEC_END, on_done)
        self._cb = on_done

        def run() -> None:
            from ..core.output import inform
            last_t = time.monotonic()
            last_n = 0
            while not self._stop.wait(self.interval):
                now = time.monotonic()
                n = self._retired
                rate = (n - last_n) / max(now - last_t, 1e-9)
                self.samples.append((now, rate))
                inform(f"alperf: {rate:.1f} tasks/s "
                       f"({n} retired total)")
                last_t, last_n = now, n

        properties.register("alperf", "tasks_per_s",
                            lambda: self.samples[-1][1]
                            if self.samples else 0.0)
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="parsec-alperf")
        self._thread.start()

    def uninstall(self) -> None:
        self._stop.set()
        if self._cb is not None:
            pins.unregister(PinsEvent.COMPLETE_EXEC_END, self._cb)
            self._cb = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        properties.unregister("alperf", "tasks_per_s")


@component
class AlperfComponent(Component):
    type_name = "pins"
    name = "alperf"

    def open(self, context: Any = None) -> AlperfModule:
        m = AlperfModule()
        m.install()
        return m

    def close(self, module: AlperfModule) -> None:
        module.uninstall()

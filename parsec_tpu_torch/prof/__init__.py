"""Observability: PINS, counters, traces, spans, histograms, the recorder.

Port of ``parsec_tpu/prof`` (the reference's PINS, profiling and SDE,
and the JAX package's serving observability):

- :mod:`.pins`: instrumentation callback chains on runtime events, with
  identity-stable precompiled dispatch slots;
- :mod:`.counters`: SDE counters and gauges (``sde``) and the properties
  dictionary (``properties``);
- :mod:`.profiling`: dictionary-keyed binary traces (``trace_state`` is
  the process-wide instance) in the JAX package's ``PTPB`` format;
- :mod:`.task_profiler`: the PINS module that writes task events to the
  trace;
- :mod:`.iterators_checker`: the PINS module that checks each executed
  task's successor arrows (graphcheck's dynamic twin);
- :mod:`.flight_recorder`: the always-on per-thread event rings, the
  stall dump, the metrics snapshotter and the run reports
  (:func:`runtime_report`, :func:`export_run_report`);
- :mod:`.spans`: request-scoped trace contexts and the span recorder
  (``prof_spans``);
- :mod:`.histogram`: log-bucketed mergeable histograms and the
  per-tenant SLO plane behind ``RuntimeServer.metrics()``;
- :mod:`.tracemerge` (per-rank Chrome traces stitched with cross-rank
  flow arrows) and :mod:`.critpath` (additive critical-path attribution
  of spans), each with a ``python -m`` entry point;
- the trace tools: :mod:`.info` (statistics of PTPB traces),
  :mod:`.grapher` and :mod:`.dotmerge` (the executed DAG as DOT, merged
  across ranks), :mod:`.debug_marks`, :mod:`.perf_modules`
  (``print_steals``, ``alperf``) and :mod:`.dashboard` (the live
  properties stream).

The ``pins`` param names PINS modules (``task_profiler``, ``sde``,
``iterators_checker``, ``grapher``, ``debug_marks``, ``print_steals``,
``alperf``, comma-separated) that every
:class:`~parsec_tpu_torch.runtime.context.Context` of the process holds
open from its construction to its ``fini``: the first context opens
them, the last one closes them, so four rank threads share one module
each.  ``task_profiler`` also starts the trace; ``trace_state.dump(path)``
writes it after the run.

Left out: ``perfdb``, the performance database of the tuner, which
comes with the tuner (``ROADMAP.md`` §1 item 4).
"""

from __future__ import annotations

import threading

from ..core.mca import repository
from ..core.params import params as _params
from . import debug_marks as _debug_marks      # noqa: F401 — registers
from . import flight_recorder, histogram, pins, spans
from . import grapher as _grapher              # noqa: F401 — registers
from . import iterators_checker as _iterchk   # noqa: F401 — registers
from . import perf_modules as _perf_modules    # noqa: F401 — registers
from . import task_profiler as _task_profiler  # noqa: F401 — registers
from .counters import properties, sde
from .flight_recorder import export_run_report, runtime_report
from .histogram import LogHistogram, SLOPlane
from .pins import PinsEvent
from .profiling import Profiling
from .profiling import profiling as trace_state
from .spans import TraceContext, new_trace

__all__ = ["PinsEvent", "pins", "Profiling", "trace_state", "properties",
           "sde", "acquire_pins_modules", "release_pins_modules",
           "flight_recorder", "export_run_report", "runtime_report",
           "spans", "histogram", "LogHistogram", "SLOPlane",
           "TraceContext", "new_trace"]

_params.register("pins", "",
                 "PINS modules every context holds open, comma-separated "
                 "(task_profiler, sde, iterators_checker, grapher, "
                 "debug_marks, print_steals, alperf)")

_lock = threading.Lock()
# name -> [component, open module, holders]
_held: dict[str, list] = {}


def acquire_pins_modules(context=None) -> tuple[str, ...]:
    """Open (or take one more hold on) each module the ``pins`` param
    names; returns the names, for :func:`release_pins_modules`.  An
    unknown name raises ``LookupError`` before anything opens."""
    names = tuple(n.strip() for n in _params.get("pins").split(",")
                  if n.strip())
    comps = []
    for name in names:
        comp = repository.find("pins", name)
        if comp is None:
            raise LookupError(f"no PINS module {name!r} (the pins param)")
        comps.append(comp)
    with _lock:
        for name, comp in zip(names, comps):
            held = _held.get(name)
            if held is not None:
                held[2] += 1
                continue
            if name == "task_profiler" and not trace_state.enabled:
                trace_state.init()
            _held[name] = [comp, comp.open(context), 1]
    return names


def release_pins_modules(names: tuple[str, ...]) -> None:
    """Drop one hold on each module; the last hold closes it (the trace
    it wrote stays in ``trace_state``)."""
    with _lock:
        for name in names:
            held = _held.get(name)
            if held is None:
                continue
            held[2] -= 1
            if held[2] == 0:
                del _held[name]
                held[0].close(held[1])

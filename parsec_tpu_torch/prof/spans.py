"""Request-scoped tracing: trace contexts and the span recorder.

Port of ``parsec_tpu/prof/spans.py``.  The flight recorder answers "what
was the runtime doing"; this layer answers "where did THIS request's
latency go".  A :class:`TraceContext` (a 64-bit ``trace_id`` and a span
sequence) is minted at ``RuntimeServer.submit`` / ``submit_stream`` and
attached to tickets, streams and taskpools (``tp._trace``); while the
recorder is installed, every request decomposes into spans:

==================  =========================================================
span                covers
==================  =========================================================
serve.admission     submit() -> admission grant (backpressure wait)
queue_wait          pool enqueue -> its first task entering execution
schedule            scheduler hand-off batches (SCHEDULE_BEGIN/END)
exec                one task body (EXEC_BEGIN/END)
release             dep release + termdet accounting (RELEASE_DEPS_*)
comm.activate       one activation hop leaving / landing on a rank
comm.get            a rendezvous GET, request -> payload landed
comm.get_serve      the producer serving that GET (fragment window)
wire.ctrl           one CTRL frame landing (socket fabric)
serve.request       the whole submission, submit -> ticket resolution
==================  =========================================================

A task on the CUDA device module gets its ``exec`` span from the EXEC
pair the manager fires around its hand-off (``device/cuda.py``): host
time, not the kernel's time on the card.  No span waits on the card.

Cost:

- **disabled** (``prof_spans`` off, the default): the task-grain spans
  ride the PINS dispatch slots, so a hot site costs what it cost before,
  one index load and a falsy branch; the comm and serve sites branch
  once on :data:`recorder` (``r = spans.recorder; if r is not None``),
  with no allocation.
- **enabled**: one thread-local stack operation at begin, one list
  append at end; the capacity bound (``prof_spans_max``) drops the
  oldest half under a lock taken only at overflow.

Across ranks the 8-byte ``trace_id`` rides the activation tuple
(:func:`~parsec_tpu_torch.comm.remote_dep.pack_activation`), the CTRL
frame header's ``u2`` word and the first DATA fragment's codec meta; the
comm spans carry ``flow``/``flow_side`` args (``act:<src>:<seq>``,
``get:<requester>:<get_id>``) that :mod:`.tracemerge` stitches into
Chrome flow arrows across ranks.  Span names, args, the raw export and
the Chrome layout are the JAX package's, so a trace of either package
reads the same in the other's tools.

Left out: nothing of the module.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any

from ..core.params import params as _params
from . import pins
from .pins import PinsEvent

_params.register("prof_spans", False,
                 "install the request-scoped span recorder at Context "
                 "init (trace-context spans for every traced taskpool; "
                 "off = the hot paths keep their existing one-branch "
                 "disabled cost)")
_params.register("prof_spans_max", 65536,
                 "finished spans kept in memory before the oldest half "
                 "is dropped (the snapshotter's bounding discipline)")

_now = time.perf_counter_ns


class TraceContext:
    """One request's trace identity: a process-unique 64-bit trace id
    plus a span-sequence counter for ids minted under it.  The wire
    carries the 8-byte ``trace_id``; the span id stays rank-local."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int = 1) -> None:
        self.trace_id = int(trace_id) & 0xFFFFFFFFFFFFFFFF
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id:#x})"


_trace_seq = itertools.count(1)


def new_trace() -> TraceContext:
    """Mint a trace context unique across ranks/processes: the pid in
    the high bits de-collides concurrently minting processes, the
    monotonic sequence de-collides within one."""
    tid = ((os.getpid() & 0xFFFFFF) << 40) | (next(_trace_seq)
                                             & 0xFFFFFFFFFF)
    return TraceContext(tid)


class SpanRecorder:
    """Bounded store of finished spans.  ``record`` is one tuple build +
    one list append (GIL-atomic), the flight recorder's ring-write
    shape; the capacity bound drops the oldest half under a lock taken
    only at overflow."""

    __slots__ = ("max", "spans", "dropped", "_lock")

    def __init__(self, max_spans: int | None = None) -> None:
        self.max = max_spans if max_spans is not None \
            else int(_params.get("prof_spans_max"))
        self.spans: list[tuple] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def record(self, name: str, trace_id: int, t0: int, t1: int,
               tenant: str | None = None,
               args: "dict | str | None" = None) -> None:
        """``args`` may be a plain string as the cheap form — the hot
        task-span path passes the task-class name without building a
        dict; export maps it to ``{"task": <str>}``."""
        self.spans.append((name, trace_id, t0, t1, tenant, args,
                           threading.get_ident()))
        if len(self.spans) > self.max:
            with self._lock:
                if len(self.spans) > self.max:
                    drop = self.max // 2
                    del self.spans[:drop]
                    self.dropped += drop

    def by_trace(self, trace_id: int) -> list[tuple]:
        return [s for s in list(self.spans) if s[1] == trace_id]


# the module-global recorder slot the hot sites branch on: None = the
# one-branch disabled path (pinned allocation-free by the tests)
recorder: SpanRecorder | None = None


class _TaskSpans:
    """The PINS-driven task-grain spans: registered as ordinary PINS
    chains, so the DISABLED cost is the dispatch table's existing
    ``hooks[i] is None`` branch — no new hot-path site anywhere.  Only
    tasks of a TRACED pool (``tp._trace`` set) record; everything else
    pays one getattr at the end hook."""

    def __init__(self, rec: SpanRecorder) -> None:
        self.rec = rec
        self._tls = threading.local()
        self._pairs = [
            (PinsEvent.EXEC_BEGIN, self._exec_begin),
            (PinsEvent.EXEC_END, self._exec_end),
            (PinsEvent.RELEASE_DEPS_BEGIN, self._rel_begin),
            (PinsEvent.RELEASE_DEPS_END, self._rel_end),
            (PinsEvent.SCHEDULE_BEGIN, self._sched_begin),
            (PinsEvent.SCHEDULE_END, self._sched_end),
        ]

    def install(self) -> None:
        for ev, cb in self._pairs:
            pins.register(ev, cb)

    def uninstall(self) -> None:
        for ev, cb in self._pairs:
            pins.unregister(ev, cb)

    # every callback body is tuned for the enabled cost: default-arg
    # bindings for the clock, try/except thread-local fast paths, and
    # string args instead of per-span dicts

    # -- exec: one task body -> "exec" (+ the pool's first exec closes
    # its "queue_wait" span, enqueue -> first body entering execution)
    def _exec_begin(self, es: Any, task: Any, _now=_now) -> None:
        tls = self._tls
        try:
            stk = tls.x
        except AttributeError:
            stk = tls.x = []
        stk.append((getattr(task.taskpool, "_trace", None), _now()))

    def _exec_end(self, es: Any, task: Any, _now=_now) -> None:
        try:
            tr, t0 = self._tls.x.pop()
        except (AttributeError, IndexError):
            return
        if tr is None:
            return
        tp = task.taskpool
        if getattr(tp, "_trace_first_ns", None) is None:
            tp._trace_first_ns = t0
            enq = getattr(tp, "_trace_enq_ns", None)
            if enq is not None:
                self.rec.record("queue_wait", tr.trace_id, enq, t0)
        self.rec.record("exec", tr.trace_id, t0, _now(), None,
                        task.task_class.name)

    # -- release_deps: successor release + termdet accounting
    def _rel_begin(self, es: Any, task: Any, _now=_now) -> None:
        tls = self._tls
        try:
            stk = tls.r
        except AttributeError:
            stk = tls.r = []
        stk.append((getattr(task.taskpool, "_trace", None), _now()))

    def _rel_end(self, es: Any, task: Any, _now=_now) -> None:
        try:
            tr, t0 = self._tls.r.pop()
        except (AttributeError, IndexError):
            return
        if tr is not None:
            self.rec.record("release", tr.trace_id, t0, _now())

    # -- schedule: one scheduler hand-off batch (trace of the first
    # task's pool; captured at BEGIN — the END payload may be emptied
    # by the keep-hot pop)
    def _sched_begin(self, es: Any, tasks: Any, _now=_now) -> None:
        tr = None
        if type(tasks) is list and tasks:
            tr = getattr(tasks[0].taskpool, "_trace", None)
        tls = self._tls
        try:
            stk = tls.s
        except AttributeError:
            stk = tls.s = []
        stk.append((tr, _now()))

    def _sched_end(self, es: Any, tasks: Any, _now=_now) -> None:
        try:
            tr, t0 = self._tls.s.pop()
        except (AttributeError, IndexError):
            return
        if tr is not None:
            self.rec.record("schedule", tr.trace_id, t0, _now())


_task_spans: _TaskSpans | None = None


def install(max_spans: int | None = None,
            recorder_obj: SpanRecorder | None = None) -> SpanRecorder:
    """Install the span recorder + the PINS task-span chains.
    ``recorder_obj`` re-installs an EXISTING recorder (spans and
    capacity preserved), as a measurement of the disabled path restores
    a user-installed recorder."""
    global recorder, _task_spans
    if recorder is not None:
        return recorder
    recorder = recorder_obj if recorder_obj is not None \
        else SpanRecorder(max_spans)
    _task_spans = _TaskSpans(recorder)
    _task_spans.install()
    return recorder


def uninstall() -> None:
    global recorder, _task_spans
    if _task_spans is not None:
        _task_spans.uninstall()
        _task_spans = None
    recorder = None


def ensure_installed() -> SpanRecorder | None:
    """Idempotent Context-init entry point: installs when the
    ``prof_spans`` MCA param asks for it (default off)."""
    if recorder is None and _params.get("prof_spans"):
        install()
    return recorder


# ---------------------------------------------------------------------------
# Chrome export
# ---------------------------------------------------------------------------

def to_chrome_events(pid: int = 3) -> list[dict]:
    """Finished spans as Chrome ``ph:"X"`` events (one tid per recording
    thread); comm spans keep their ``flow``/``flow_side`` args so
    :mod:`tracemerge` can stitch arrows."""
    r = recorder
    if r is None:
        return []
    tids: dict[int, int] = {}
    events: list[dict] = []
    for name, trace_id, t0, t1, tenant, args, ident in list(r.spans):
        tid = tids.setdefault(ident, len(tids))
        a: dict[str, Any] = {"trace": format(trace_id, "x")}
        if tenant:
            a["tenant"] = tenant
        if args:
            if type(args) is str:       # the cheap hot-path form
                a["task"] = args
            else:
                a.update(args)
        events.append({"name": name, "cat": "span", "ph": "X",
                       "ts": t0 / 1e3,
                       "dur": max((t1 - t0) / 1e3, 0.001),
                       "pid": pid, "tid": tid, "args": a})
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
             "args": {"name": f"spans:{ident}"}}
            for ident, t in sorted(tids.items(), key=lambda kv: kv[1])]
    return meta + events


def export_spans(path: str, rank: int = 0) -> dict:
    """Write THIS rank's spans RAW (the recorder tuples, json-listed) —
    the lossless input :mod:`critpath` replays; Chrome export rounds
    sub-µs spans up, this keeps the ns clocks."""
    r = recorder
    doc = {"rank": rank,
           "spans": [list(s) for s in (list(r.spans) if r else [])],
           "dropped": r.dropped if r else 0}
    with open(path, "w") as f:
        json.dump(doc, f)
    return {"path": path, "spans": len(doc["spans"]), "rank": rank}


def export_chrome(path: str, rank: int = 0) -> dict:
    """Write THIS rank's spans as a standalone Chrome trace, anchored by
    a wall-clock sync event — ``perf_counter_ns`` clocks are per-process,
    so :mod:`tracemerge` aligns ranks through the ``parsec_clock_sync``
    anchor (``unix_ns`` - ``perf_ns`` offset) before stitching."""
    events: list[dict] = [
        {"name": "parsec_clock_sync", "ph": "i", "s": "g",
         "ts": _now() / 1e3, "pid": rank, "tid": 0,
         "args": {"unix_ns": time.time_ns(), "perf_ns": _now()}},
        {"name": "process_name", "ph": "M", "pid": rank,
         "args": {"name": f"rank{rank}"}},
    ]
    events += to_chrome_events(pid=rank)
    trace = {"traceEvents": events}
    with open(path, "w") as f:
        json.dump(trace, f)
    return {"path": path, "events": len(events), "rank": rank}

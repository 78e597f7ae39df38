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
lowered.step        one ``step_fn`` call of a lowered pool, call -> return
                    (args ``mode``); each call is one trace of its own
lowered.clone       the wavefront step's clones of the stores it writes and
                    its saved and restored rows; the gathering chain's
                    clone of its result store (``bytes``)
lowered.level       one wavefront level (``level``, ``groups``)
lowered.gather      one group's gathers and NEW zeros (``task``, ``G``,
                    ``bytes``)
lowered.call        one group's kernel call, also a group that runs
                    nothing (``task``, ``G``)
lowered.scatter     one level's scatters, with the clones of pending values
                    that share a store's memory (``bytes``)
k1.prep             K1's host work before its upload: checks, tile
                    pointers, pinned buffer, tensor maps (``variant``,
                    ``form``, ``batch``, ``m``, ``n``, ``k``)
k1.launch           K1's pinned host-to-device copy and its launch (same)
lib.potrf           a tile factor, Cholesky (``batch``, ``nb``, ``route``:
                    ``hand``, ``csrc/factor.cu``, or ``library``)
lib.trsm            a triangular inverse (same)
lib.getrf           a library tile factor, LU without pivoting (``batch``,
                    ``nb``)
==================  =========================================================

The ``lowered.*``, ``k1.*`` and ``lib.*`` spans are recorded only inside
a lowered step's trace (:func:`active_trace` is not 0): the step makes
its trace the thread's active one for the kernel wrappers under it.  The
``bytes`` of the gather, scatter and clone spans are the payload bytes
of the tensors they copy (an index gather's result, the rows a scatter
writes, a clone), counted once each; the wavefront plan states the same
totals a step as ``LoweredTaskpool.bytes_moved``.

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
  oldest half under a lock taken only at overflow.  A lowered step
  records a few spans a level and a K1 launch (about 700 a Cholesky step
  of 94 levels), each two clock reads, an argument tuple and a record.

**One clock.**  Spans keep ``perf_counter_ns``.  A recorder takes one
anchor when it is made: the tightest of several back-to-back pairs of
``time.time_ns()`` and ``perf_counter_ns()`` (:func:`clock_anchor`), as
``anchor`` ``(unix_ns, perf_ns)``; :meth:`SpanRecorder.to_wall` puts a
span on the wall clock, which ``torch.profiler``'s events are on, and
:func:`export_chrome` writes the same anchor.

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
_ident = threading.get_ident


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


def clock_anchor(pairs: int = 16) -> tuple[int, int]:
    """``(unix_ns, perf_ns)`` read together: of ``pairs`` back-to-back
    reads ``perf, time_ns, perf``, the one whose two ``perf`` reads lie
    closest, with the middle of those two."""
    best = None
    for _ in range(pairs):
        p0 = _now()
        u = time.time_ns()
        p1 = _now()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, u, (p0 + p1) // 2)
    return best[1], best[2]


class SpanRecorder:
    """Bounded store of finished spans.  ``record`` is one tuple build +
    one list append (GIL-atomic), the flight recorder's ring-write
    shape; the capacity bound drops the oldest half under a lock taken
    only at overflow.  ``anchor`` is the recorder's one clock anchor
    (:func:`clock_anchor`), taken when it is made."""

    __slots__ = ("max", "spans", "dropped", "anchor", "_lock")

    def __init__(self, max_spans: int | None = None) -> None:
        self.max = max_spans if max_spans is not None \
            else int(_params.get("prof_spans_max"))
        self.spans: list[tuple] = []
        self.dropped = 0
        self.anchor = clock_anchor()
        self._lock = threading.Lock()

    def to_wall(self, perf_ns: int) -> int:
        """A span's ``perf_counter_ns`` time on the wall clock
        (``time.time_ns``), through :attr:`anchor`."""
        return perf_ns + self.anchor[0] - self.anchor[1]

    def record(self, name: str, trace_id: int, t0: int, t1: int,
               tenant: str | None = None,
               args: "dict | str | tuple | None" = None) -> None:
        """``args`` may be a plain string as the cheap form — the hot
        task-span path passes the task-class name without building a
        dict; export maps it to ``{"task": <str>}``.  A flat tuple
        ``(key, value, key, value, ...)`` of strings and numbers is the
        form of the spans recorded by the hundred a step: the collector
        stops tracking such a record in its young generations, where a
        dict would keep the record tracked into the oldest one, whose
        full collections then pause for the whole heap (:func:`args_dict`
        reads any form)."""
        spans = self.spans
        spans.append((name, trace_id, t0, t1, tenant, args, _ident()))
        if len(spans) > self.max:
            with self._lock:
                if len(self.spans) > self.max:
                    drop = self.max // 2
                    del self.spans[:drop]
                    self.dropped += drop

    def by_trace(self, trace_id: int) -> list[tuple]:
        return [s for s in list(self.spans) if s[1] == trace_id]


def args_dict(args: "dict | str | tuple | list | None") -> dict:
    """A span's ``args`` in any recorded form as a dict (a flat tuple
    comes back from a raw export as a list)."""
    if not args:
        return {}
    if type(args) is str:               # the cheap hot-path form
        return {"task": args}
    if type(args) in (tuple, list):     # the flat (key, value, ...) form
        return dict(zip(args[::2], args[1::2]))
    return dict(args)


# the module-global recorder slot the hot sites branch on: None = the
# one-branch disabled path (pinned allocation-free by the tests)
recorder: SpanRecorder | None = None

class _Active(threading.local):
    """The lowered step's trace on each thread (0: none), for the kernel
    wrappers under it."""

    tid = 0


_active = _Active()


def active_trace() -> int:
    """The trace id of the lowered step running on this thread, else 0."""
    return _active.tid


def enter_trace(trace_id: int) -> int:
    """Make ``trace_id`` this thread's active trace; returns the one it
    replaces, to be entered again on the way out."""
    prev = _active.tid
    _active.tid = trace_id
    return prev


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
            a.update(args_dict(args))
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
    anchor (``unix_ns`` - ``perf_ns`` offset) before stitching.  The
    anchor is the recorder's own (:attr:`SpanRecorder.anchor`)."""
    r = recorder
    unix_ns, perf_ns = r.anchor if r is not None else clock_anchor()
    events: list[dict] = [
        {"name": "parsec_clock_sync", "ph": "i", "s": "g",
         "ts": perf_ns / 1e3, "pid": rank, "tid": 0,
         "args": {"unix_ns": unix_ns, "perf_ns": perf_ns}},
        {"name": "process_name", "ph": "M", "pid": rank,
         "args": {"name": f"rank{rank}"}},
    ]
    events += to_chrome_events(pid=rank)
    trace = {"traceEvents": events}
    with open(path, "w") as f:
        json.dump(trace, f)
    return {"path": path, "events": len(events), "rank": rank}

"""The always-on runtime flight recorder and the unified metrics layer.

Port of ``parsec_tpu/prof/flight_recorder.py``, on by default as there:

- **Flight recorder**: every PINS fire site feeds a per-thread
  fixed-size ring of ``(event, timestamp_ns, task_id, payload_summary)``
  records through ``pins.recorder``.  Rings are thread-local (no site
  takes a lock), a ring keeps per-event counts and integer payload sums
  past wrap-around, an empty select or compiled-DAG fetch counts as a
  liveness tick instead of a record, and a thread name that comes back
  (a later context's ``parsec-es0``) folds the old ring's counts into
  the recorder's totals, so the counts stay cumulative.  Rank threads,
  the comm thread, the device manager and server workers each get their
  own ring; four rank threads of one process share the one recorder, so
  each event is counted once.
- **Stall dump**: :func:`stall_dump` writes every ring's last events,
  the scheduler's queue depths, in-flight comm operations, each
  device's ``debug_state`` and the registered sections (the server's
  per-tenant inflight counts and oldest trace) to stderr and to
  ``flightrec-<rank>.json`` under ``prof_flightrec_dir``.
  ``Context.wait()`` fires it once on a :class:`ContextWaitTimeout
  <parsec_tpu_torch.runtime.context.ContextWaitTimeout>`, and
  ``Context.fini()`` on a bounded drain that cannot complete.  Each
  section is read best-effort and the locks it takes are bounded, so a
  wedged run still yields what evidence is reachable; the dump never
  replaces the timeout, which is raised after it.
- **Metrics snapshotter**: a thread sampling the SDE counters and the
  live properties on ``prof_snapshot_interval``.
- **Unified export**: :func:`runtime_report` is the compact
  self-measurement (comm, serve, knobs, ``llm``, ``slo`` and critpath
  blocks, each present only when its part ran); :func:`export_run_report`
  merges the rings, the counter series, the spans and the binary
  :mod:`.profiling` streams into one Chrome trace and a JSON summary.

The recorder's cost: once it is installed every PINS slot is compiled
with it attached, including the device module's and the release sites;
``prof_flightrec_size=0`` leaves every slot on its one-branch disabled
path.  A callback never waits on the card.

The ``comm_pattern`` block (the static comm analysis,
``analysis/commcheck.py``, in its compact form) appears only in processes
that ran commcheck: it is read from ``sys.modules``, so a serving process
that never imported the analysis stack never loads it.  ``prof_flightrec_dir``
defaults to ``$PARSEC_TPU_ARTIFACT_DIR``, else the process's temporary
directory (``tempfile.gettempdir()``, which honours ``TMPDIR``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from typing import Any

from ..core.params import params as _params
from . import pins
from .pins import PinsEvent

_params.register("prof_flightrec_size", 256,
                 "per-worker flight-recorder ring capacity "
                 "(events kept per thread; 0 disables the recorder)")
_params.register("prof_flightrec_dir",
                 os.environ.get("PARSEC_TPU_ARTIFACT_DIR",
                                tempfile.gettempdir()),
                 "directory stall-dump artifacts (flightrec-<rank>.json) "
                 "are written to (default: $PARSEC_TPU_ARTIFACT_DIR, else "
                 "the temporary directory — never the CWD, which a repo "
                 "checkout may be); empty = stderr only")
_params.register("prof_stall_dump", True,
                 "dump flight-recorder state to stderr + artifact when a "
                 "Context.wait()/fini() drain times out")
_params.register("prof_snapshot_interval", 0.0,
                 "seconds between periodic metrics snapshots "
                 "(SDE counters + live properties; 0 disables the thread)")

_now = time.perf_counter_ns
_N_EVENTS = max(int(e) for e in PinsEvent) + 1
_SB, _SE = PinsEvent.SELECT_BEGIN, PinsEvent.SELECT_END
_DFB, _DFE = PinsEvent.DAG_FETCH_BEGIN, PinsEvent.DAG_FETCH_END


def _describe(p: Any) -> tuple[Any, Any]:
    """Cheap (task_id, payload_summary) extraction — no str() of live
    runtime objects on the hot path beyond small constant work."""
    if p is None:
        return None, None
    # a Task carries task_class (a TaskClass, which has .name); beware
    # Taskpool.task_class, which is a METHOD — hence the two-step probe
    tc = getattr(p, "task_class", None)
    tc_name = getattr(tc, "name", None) if tc is not None else None
    if tc_name is not None:
        return getattr(p, "uid", None), tc_name
    if type(p) is int or type(p) is float:
        return None, p
    if type(p) is list:
        return None, f"list[{len(p)}]"
    if type(p) is tuple:
        t0 = p[0] if p else None
        nm = getattr(getattr(t0, "task_class", None), "name", None)
        if nm is not None:
            return getattr(t0, "uid", None), f"{nm}{p[1:]!r}"
        return None, repr(p)[:80]
    name = getattr(p, "name", None)
    return None, (f"{type(p).__name__}({name})" if name
                  else type(p).__name__)


class _Ring:
    """One worker's fixed-size event ring.  Appends are single-writer
    (thread-local); snapshots from other threads are best-effort reads."""

    __slots__ = ("name", "size", "slots", "total", "counts", "vsums",
                 "idle", "idle_ns")

    def __init__(self, name: str, size: int) -> None:
        self.name = name
        self.size = size
        self.slots: list = [None] * size
        self.total = 0
        # per-event-type tallies survive ring wraparound: the self-
        # measurement the run report is built from
        self.counts = [0] * _N_EVENTS
        self.vsums = [0] * _N_EVENTS    # sum of integer payloads
        self.idle = 0                   # empty selects (liveness ticks)
        self.idle_ns = 0

    def events(self, last: int | None = None) -> list[dict]:
        n = min(self.total, self.size)
        start = self.total - n
        if last is not None and n > last:
            start = self.total - last
        out = []
        for i in range(start, self.total):
            rec = self.slots[i % self.size]
            if rec is None:
                continue        # racing writer; skip the torn slot
            ev, ts, tid, summ = rec
            out.append({"event": getattr(ev, "name", str(ev)),
                        "ts_ns": ts, "task": tid, "info": summ})
        return out


class FlightRecorder:
    """Process-global recorder: one ring per thread, registry by thread
    name (the latest thread under a recycled worker name wins, which
    bounds memory across many short-lived contexts)."""

    def __init__(self, size: int) -> None:
        self.size = size
        self._tls = threading.local()
        self._lock = threading.Lock()
        self.rings: dict[str, _Ring] = {}
        # tallies folded in from rings displaced by a recycled thread
        # name: aggregate() stays truly cumulative (a later context's
        # parsec-es0 must not erase the earlier one's retired count —
        # that would make runtime_report regress and rates() go negative)
        self._retired_counts = [0] * _N_EVENTS
        self._retired_vsums = [0] * _N_EVENTS
        self._retired_idle = 0

    def _new_ring(self) -> _Ring:
        r = _Ring(threading.current_thread().name, self.size)
        with self._lock:
            old = self.rings.get(r.name)
            if old is not None:
                for i in range(_N_EVENTS):
                    self._retired_counts[i] += old.counts[i]
                    self._retired_vsums[i] += old.vsums[i]
                self._retired_idle += old.idle
            self.rings[r.name] = r
        self._tls.ring = r
        return r

    def note(self, event: Any, payload: Any) -> None:
        """The ``pins.recorder`` hook: one branch + one ring write."""
        try:
            r = self._tls.ring
        except AttributeError:
            r = self._new_ring()
        if payload is None:
            if event is _SE:
                # an EMPTY select (SELECT_END with no task) would rotate
                # real history out of the ring; keep it as a liveness
                # tick instead — an idle-polling worker reads as idle,
                # not as a wall of SELECTs.  SELECT_BEGIN carries no
                # payload even on productive selects, so it is skipped
                # outright rather than miscounted as idleness.
                r.idle += 1
                r.idle_ns = _now()
                return
            if event is _SB or event is _DFB:
                return        # info-free begins: the END record suffices
        elif event is _DFE and payload == 0:
            # an empty compiled-DAG fetch: the AGAIN-spin analog of an
            # empty select — liveness tick, not ring spam (a wedged DAG
            # must not flush its own pre-stall history)
            r.idle += 1
            r.idle_ns = _now()
            return
        r.counts[event] += 1
        if type(payload) is int:
            r.vsums[event] += payload
        i = r.total
        tid, summ = _describe(payload)
        r.slots[i % r.size] = (event, _now(), tid, summ)
        r.total = i + 1

    def all_rings(self) -> list[_Ring]:
        with self._lock:
            return list(self.rings.values())

    def snapshot(self, last: int | None = None) -> dict[str, dict]:
        """Per-worker ring contents, oldest-first (best-effort under
        concurrent appends)."""
        out = {}
        now = _now()
        for r in self.all_rings():
            out[r.name] = {
                "total": r.total,
                "idle_selects": r.idle,
                "idle_age_ms": (round((now - r.idle_ns) / 1e6, 1)
                                if r.idle else None),
                "events": r.events(last),
            }
        return out

    def aggregate(self) -> tuple[list[int], list[int]]:
        with self._lock:
            counts = list(self._retired_counts)
            vsums = list(self._retired_vsums)
        for r in self.all_rings():
            for i, c in enumerate(r.counts):
                counts[i] += c
            for i, v in enumerate(r.vsums):
                vsums[i] += v
        return counts, vsums


recorder: FlightRecorder | None = None


def install(size: int | None = None) -> FlightRecorder:
    """(Re)install the recorder as the PINS fire hook."""
    global recorder
    if size is None:
        size = _params.get("prof_flightrec_size")
    recorder = FlightRecorder(max(int(size), 1))
    pins.recorder = recorder.note
    return recorder


def uninstall() -> None:
    global recorder
    pins.recorder = None
    recorder = None


def ensure_installed() -> FlightRecorder | None:
    """Idempotent always-on entry point (every Context calls this):
    installs the recorder unless ``prof_flightrec_size`` is 0."""
    if recorder is None and _params.get("prof_flightrec_size") > 0:
        install()
    return recorder


# ---------------------------------------------------------------------------
# periodic metrics snapshotter
# ---------------------------------------------------------------------------

class MetricsSnapshotter:
    """Samples SDE counters + the live properties dictionary on an
    interval into a bounded in-memory series.  Refcounted: the thread
    runs while any context holds a start(); contexts release on
    teardown."""

    MAX_SAMPLES = 2048

    def __init__(self) -> None:
        self.series: list[dict] = []
        self._lock = threading.Lock()
        self._stop: threading.Event | None = None
        self._users = 0

    def sample(self) -> dict:
        from .counters import properties, sde
        s: dict[str, Any] = {"ts": time.time(), "t_ns": _now(),
                             "sde": sde.snapshot(), "props": {}}
        for ns, d in properties.snapshot().items():
            s["props"][ns] = {k: v for k, v in d.items() if k != "sde"}
        if recorder is not None:
            counts, vsums = recorder.aggregate()
            s["tasks_retired"] = (counts[PinsEvent.COMPLETE_EXEC_END]
                                  + vsums[PinsEvent.DAG_COMPLETE_END])
        with self._lock:
            self.series.append(s)
            if len(self.series) > self.MAX_SAMPLES:
                # keep the tail: recent history matters most for a stall
                del self.series[:self.MAX_SAMPLES // 2]
        return s

    def start(self, interval: float) -> None:
        with self._lock:
            self._users += 1
            if self._stop is not None:
                return
            stop = threading.Event()
            self._stop = stop

        def run() -> None:
            while not stop.wait(interval):
                try:
                    self.sample()
                except Exception:
                    pass        # sampling must never kill a run

        threading.Thread(target=run, daemon=True,
                         name="parsec-prof-snap").start()

    def release(self) -> None:
        with self._lock:
            self._users -= 1
            if self._users <= 0 and self._stop is not None:
                self._stop.set()
                self._stop = None
                self._users = 0

    def rates(self) -> list[dict]:
        """tasks-retired/sec derived from consecutive samples."""
        with self._lock:
            series = list(self.series)
        out = []
        for a, b in zip(series, series[1:]):
            if "tasks_retired" not in a or "tasks_retired" not in b:
                continue
            dt = (b["t_ns"] - a["t_ns"]) / 1e9
            if dt <= 0:
                continue
            out.append({"ts": b["ts"],
                        "tasks_per_s": round(
                            (b["tasks_retired"] - a["tasks_retired"]) / dt,
                            2)})
        return out


snapshotter = MetricsSnapshotter()


# ---------------------------------------------------------------------------
# stall dump
# ---------------------------------------------------------------------------

# extra evidence providers for the stall report (the serving layer
# registers per-tenant inflight counts + oldest live trace ids here, so
# a wedged serve run names WHOSE request is stuck): name -> zero-arg fn
_stall_sections: dict[str, Any] = {}
_sections_lock = threading.Lock()


def register_stall_section(name: str, fn: Any) -> None:
    with _sections_lock:
        _stall_sections[name] = fn


def unregister_stall_section(name: str) -> None:
    with _sections_lock:
        _stall_sections.pop(name, None)


def _best_effort(fn, default=None):
    try:
        return fn()
    except Exception as e:                       # noqa: BLE001 — evidence
        return {"error": f"{type(e).__name__}: {e}"} \
            if default is None else default


def build_stall_report(context: Any = None, reason: str = "",
                       last: int = 32) -> dict:
    """Gather the full diagnosis snapshot.  Every section is best-effort:
    a wedged runtime must still yield whatever evidence is reachable."""
    from .counters import properties, sde
    report: dict[str, Any] = {
        "reason": reason,
        "ts": time.time(),
        "rank": getattr(context, "my_rank", 0) if context is not None else 0,
        "workers": _best_effort(
            lambda: recorder.snapshot(last) if recorder is not None
            else {"flightrec": "disabled"}),
        "sde": _best_effort(sde.snapshot),
        "props": _best_effort(properties.snapshot),
        "snapshots": len(snapshotter.series),
    }
    if context is not None:
        report["sched_pending"] = _best_effort(
            lambda: context.scheduler.pending_tasks(context))
        report["queue_depths"] = _best_effort(
            lambda: context.scheduler.queue_depths(context))
        report["active_taskpools"] = _best_effort(lambda: [
            {"name": tp.name,
             "nb_tasks": tp.tdm.nb_tasks if tp.tdm is not None else None,
             "compiled_dag": getattr(tp, "_compiled_dag", None) is not None}
            for tp in list(context._active_taskpools)])
        ce = context.comm_engine
        if ce is not None and hasattr(ce, "debug_state"):
            report["comm"] = _best_effort(ce.debug_state)

    def devices():
        from ..device.device import registry
        return [d.debug_state() for d in registry.devices
                if hasattr(d, "debug_state")]
    report["devices"] = _best_effort(devices, default=[])
    with _sections_lock:
        sections = list(_stall_sections.items())
    for name, fn in sections:
        report.setdefault("sections", {})[name] = _best_effort(fn)
    return report


def stall_dump(context: Any = None, reason: str = "", last: int = 32,
               file: Any = None) -> dict:
    """Serialize the stall report to stderr (compact) and to the
    ``flightrec-<rank>.json`` artifact.  Returns the report dict."""
    report = build_stall_report(context, reason, last)
    out = file or sys.stderr
    w = out.write
    w(f"[flightrec] STALL DUMP rank {report['rank']}: {reason}\n")
    workers = report.get("workers") or {}
    if isinstance(workers, dict):
        now = _now()
        for name, r in sorted(workers.items()):
            if not isinstance(r, dict) or "events" not in r:
                continue
            evs = r["events"]
            if evs:
                e = evs[-1]
                age = (now - e["ts_ns"]) / 1e6
                lastline = (f"last={e['event']} task={e['task']} "
                            f"info={e['info']} {age:.0f}ms ago")
            else:
                lastline = "no events"
            w(f"[flightrec]   {name}: {r['total']} events, "
              f"{r['idle_selects']} idle selects, {lastline}\n")
    w(f"[flightrec]   sched_pending={report.get('sched_pending')} "
      f"queue_depths={report.get('queue_depths')}\n")
    w(f"[flightrec]   taskpools={report.get('active_taskpools')}\n")
    if "comm" in report:
        w(f"[flightrec]   comm={report['comm']}\n")
    for d in report.get("devices") or []:
        w(f"[flightrec]   device={d}\n")
    for name, sec in (report.get("sections") or {}).items():
        w(f"[flightrec]   {name}={sec}\n")
    path = None
    dirname = _params.get("prof_flightrec_dir")
    if dirname:
        path = os.path.join(dirname, f"flightrec-{report['rank']}.json")
        try:
            with open(path, "w") as f:
                json.dump(report, f, default=str)
            w(f"[flightrec]   artifact: {path}\n")
        except OSError as e:
            w(f"[flightrec]   artifact write failed: {e}\n")
    try:
        out.flush()
    except Exception:
        pass
    return report


# ---------------------------------------------------------------------------
# unified export
# ---------------------------------------------------------------------------

def runtime_report(max_workers: int = 6) -> dict:
    """Compact runtime self-measurement (cumulative since process start).

    ``tasks_retired`` is the TOTAL (dynamic + compiled-DAG), matching the
    snapshotter's counter track so the two halves of one run report can
    never contradict each other; the per-path components ride alongside.
    """
    rep: dict[str, Any] = {"tasks_retired": 0, "dynamic_tasks_retired": 0,
                           "dag_tasks_completed": 0,
                           "h2d_bytes": 0, "comm_activations_sent": 0,
                           "snapshots": len(snapshotter.series),
                           "workers": {}}
    # critical-path attribution over the span plane (prof/critpath.py):
    # present only when the span recorder is installed AND recorded —
    # every other run stays byte-compatible and pays nothing (the
    # attribution replays existing spans, no new hot-path sites).  The
    # span plane is independent of the flight recorder, so this block
    # precedes the flightrec-disabled early return.
    from . import spans as _spans_mod
    if _spans_mod.recorder is not None and _spans_mod.recorder.spans:
        def _critpath():
            from .critpath import summarize_recorder
            return summarize_recorder(compact=True)
        cp = _best_effort(_critpath, default={})
        if cp:
            rep["critpath"] = cp
    # the resolved knob vector: every declared tuning knob plus any param
    # resolved away from its default, so any report answers "under WHICH
    # configuration was this measured" (the provenance the tuning DB and
    # the perf ledger key on).  Nested, and before the flightrec-disabled
    # early return: a report always has it.
    def _knobs():
        snap = _params.snapshot()
        keep = set(_params.knob_space())
        for name in snap:
            p = _params.lookup(name)
            if p is not None and p.source != "default":
                keep.add(name)
        return {n: snap[n] for n in sorted(keep) if n in snap}
    rep["knobs"] = _best_effort(_knobs, default={})
    # statically derived comm patterns (analysis/commcheck.py): present
    # only in processes that ran check_comm (the sys.modules gate keeps
    # the analysis stack out of processes that never imported it); before
    # the flightrec-disabled early return, and in the compact form
    cmod = sys.modules.get("parsec_tpu_torch.analysis.commcheck")
    if cmod is not None:
        cpat = _best_effort(lambda: cmod.report_block(compact=True),
                            default={})
        if cpat:
            rep["comm_pattern"] = cpat
    r = recorder
    if r is None:
        rep["flightrec"] = "disabled"
        return rep
    counts, vsums = r.aggregate()
    rep["dynamic_tasks_retired"] = counts[PinsEvent.COMPLETE_EXEC_END]
    rep["dag_tasks_completed"] = vsums[PinsEvent.DAG_COMPLETE_END]
    rep["tasks_retired"] = (rep["dynamic_tasks_retired"]
                            + rep["dag_tasks_completed"])
    rep["h2d_bytes"] = vsums[PinsEvent.DEVICE_STAGE_IN]
    rep["comm_activations_sent"] = counts[PinsEvent.COMM_ACTIVATE_SEND]
    if counts[PinsEvent.COMM_ACTIVATE_SEND] \
            or counts[PinsEvent.COMM_GET_FRAG_SENT] \
            or counts[PinsEvent.COMM_GET_FRAG_RECV] \
            or counts[PinsEvent.COMM_GET_DONE]:
        # wire data-path tallies (present only when comm ran, so pure
        # single-rank runs stay byte-compatible): fragment counts and
        # byte sums come straight from the COMM_* PINS sites
        rep["comm"] = {
            "activations_sent": counts[PinsEvent.COMM_ACTIVATE_SEND],
            "acks_received": counts[PinsEvent.COMM_ACK_RECV],
            "frags_sent": counts[PinsEvent.COMM_GET_FRAG_SENT],
            "frag_bytes_sent": vsums[PinsEvent.COMM_GET_FRAG_SENT],
            "frags_received": counts[PinsEvent.COMM_GET_FRAG_RECV],
            "frag_bytes_received": vsums[PinsEvent.COMM_GET_FRAG_RECV],
            "gets_completed": counts[PinsEvent.COMM_GET_DONE],
            "get_bytes_landed": vsums[PinsEvent.COMM_GET_DONE],
            "prefetch_gets": counts[PinsEvent.COMM_GET_PREFETCH],
        }
    if counts[PinsEvent.SERVE_SUBMIT]:
        # serving-layer lifecycle tallies (serve/server.py): present only
        # when a RuntimeServer ran, so batch runs stay byte-compatible
        rep["serve"] = {
            "submitted": counts[PinsEvent.SERVE_SUBMIT],
            "admitted": counts[PinsEvent.SERVE_ADMIT],
            "rejected": counts[PinsEvent.SERVE_REJECT],
            "started": counts[PinsEvent.SERVE_START],
            "completed": counts[PinsEvent.SERVE_COMPLETE],
            "drains": counts[PinsEvent.SERVE_DRAIN],
        }
    # the per-tenant SLO plane (prof/histogram.py): quantile summaries
    # merged across every live plane — present only when a serving
    # workload recorded latency, so batch runs stay byte-compatible
    def _slo():
        from .histogram import merged_summary
        return merged_summary()
    slo = _best_effort(_slo, default={})
    if slo:
        rep["slo"] = slo
    # LLM serving-memory effectiveness: prefix-cache hits,
    # pages reused, tier residency, prefetch depth — aggregated across
    # live batchers.  Keyed off sys.modules so a run that never served
    # an LLM stream neither imports the subsystem nor grows its report.
    bmod = sys.modules.get("parsec_tpu_torch.llm.batcher")
    if bmod is not None:
        llm = _best_effort(bmod.aggregate_report, default={})
        if llm:
            rep["llm"] = llm
    now = _now()

    def activity(ring: _Ring) -> int:
        rec = ring.slots[(ring.total - 1) % ring.size] if ring.total else None
        return max(rec[1] if rec is not None else 0, ring.idle_ns)

    rings = sorted(r.all_rings(), key=activity, reverse=True)
    for ring in rings[:max_workers]:
        evs = ring.events(1)
        last = evs[-1] if evs else None
        rep["workers"][ring.name] = {
            "n": ring.total,
            "idle": ring.idle,
            "last": last["event"] if last else None,
            "age_ms": (round((now - last["ts_ns"]) / 1e6, 1)
                       if last else None),
        }
    return rep


def export_run_report(chrome_path: str | None = None) -> dict:
    """Merge the flight-recorder rings, the metrics snapshot series, and
    the binary :mod:`profiling` streams into ONE Chrome trace plus a JSON
    summary.

    Returns ``{"chrome_trace": <trace-event dict>, "summary": <dict>}``;
    writes the trace JSON to ``chrome_path`` when given.  Profiling
    streams ride as pid 0 (exactly :meth:`Profiling.to_chrome_trace`),
    flight-recorder rings as instant events under pid 1, counter series
    as ``ph: "C"`` counter tracks under pid 2 — all on the shared
    ``perf_counter_ns`` clock, so spans and ring events line up.
    """
    from .profiling import profiling
    trace = profiling.to_chrome_trace()
    events = trace["traceEvents"]
    rings = recorder.snapshot() if recorder is not None else {}
    for tid, (name, r) in enumerate(sorted(rings.items())):
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": f"flightrec:{name}"}})
        for ev in r["events"]:
            events.append({"name": ev["event"], "cat": "flightrec",
                           "ph": "i", "s": "t", "ts": ev["ts_ns"] / 1e3,
                           "pid": 1, "tid": tid,
                           "args": {"task": ev["task"],
                                    "info": str(ev["info"])}})
    with snapshotter._lock:
        series = list(snapshotter.series)
    for s in series:
        ts = s["t_ns"] / 1e3
        if "tasks_retired" in s:
            events.append({"name": "tasks_retired", "ph": "C", "ts": ts,
                           "pid": 2,
                           "args": {"value": s["tasks_retired"]}})
        for ns, props in s.get("props", {}).items():
            v = props.get("sched_pending")
            if isinstance(v, (int, float)):
                events.append({"name": f"{ns}::sched_pending", "ph": "C",
                               "ts": ts, "pid": 2, "args": {"value": v}})
        for k, v in s.get("sde", {}).items():
            # comm wire/fragment gauges ride as counter tracks so byte
            # flow lines up against the ring events 
            if k.startswith("comm::") and isinstance(v, (int, float)):
                events.append({"name": k, "ph": "C", "ts": ts, "pid": 2,
                               "args": {"value": v}})
    from . import spans as _spans
    if _spans.recorder is not None:
        # request-scoped spans ride as pid 3 — same perf_counter_ns
        # clock, so a request's exec/comm spans line up against the
        # ring events and counter tracks 
        events.extend(_spans.to_chrome_events(pid=3))
    summary = runtime_report()
    summary["profiling_streams"] = len(profiling.streams)
    summary["trace_events"] = len(events)
    if _spans.recorder is not None:
        summary["spans"] = len(_spans.recorder.spans)
    summary["tasks_per_s"] = snapshotter.rates()[-3:]
    if chrome_path is not None:
        with open(chrome_path, "w") as f:
            json.dump(trace, f, default=str)
    return {"chrome_trace": trace, "summary": summary}

"""Critical-path attribution: where did this request's wall-clock go.

Port of ``parsec_tpu/prof/critpath.py``.  It replays a run's
:class:`~parsec_tpu_torch.prof.spans.SpanRecorder` output, plus the
taskpool DAG where :mod:`~parsec_tpu_torch.analysis.graphcheck` kept the
concrete graph, into a per-request / per-DAG critical path, splitting
wall-clock into additive buckets::

    exec > release > queue > comm.activate > comm.get > idle

Every elementary time segment inside a request's window is charged to
the single highest-priority bucket covering it (a boundary sweep), so
``sum(buckets) + idle == window`` holds exactly.  On top of the sweep:

- **per task class**: exec time split by task-class name;
- **per edge class**: comm spans keyed ``<span-name>:<pow2-size-tier>``
  (``comm.get:4mib``), each with ``overlap_lost_ms``, the part of its
  flight time not hidden behind task execution;
- **overlap efficiency**: ``|exec ∪ ∩ get ∪| / |get ∪|``;
- **DAG critical path**: the longest-cost chain over graphcheck's
  retained ``(class, key) -> successors`` graph, weighted by measured
  per-class exec means.

On the CUDA device module a task's ``exec`` span is the host's hand-off
(see :mod:`.spans`), so the ``exec`` bucket is host time; the card's
busy share comes from a profiler trace, not from here.

Everything here runs at analysis time over existing spans and adds no
hot-path site.  Surfaces: ``python -m parsec_tpu_torch.prof.critpath
<chrome-trace-or-spans.json>`` (``--self-test``, ``--json``,
``--compact``), the ``critpath`` block of ``runtime_report()`` and of
``RuntimeServer.metrics()``, a :mod:`.dashboard` panel, and cross-rank
attribution over :mod:`.tracemerge`'s stitched trace.  The report's
layout is the JAX package's.  Left out: nothing of the module.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Any, Iterable

from . import spans as _spans

# bucket priority: when spans overlap, the segment is charged to the
# FIRST matching bucket in this order (a worker executing a body while
# a GET is in flight is doing useful work — that's the overlap the
# engine exists to measure, not idle double-counting)
_ORDER = ("exec", "release", "queue", "comm.activate", "comm.get")

_BUCKET = {
    "exec": "exec",
    "release": "release",
    "queue_wait": "queue",
    "serve.admission": "queue",
    "schedule": "queue",
    "comm.activate": "comm.activate",
    "wire.ctrl": "comm.activate",
    "serve.submit": "comm.activate",
    "serve.tokens": "comm.activate",
    "comm.get": "comm.get",
    "comm.get_serve": "comm.get",
}

# span names that are communication EDGES (get an edge class + an
# overlap_lost attribution); serve.* control-plane hops included so a
# sharded stream's SUBMIT/TOKENS crossings show up as edge classes
_EDGE_NAMES = ("comm.get", "comm.get_serve", "comm.activate",
               "wire.ctrl", "serve.submit", "serve.tokens")


def _size_tier(nbytes: Any) -> str:
    """Pow-2 size tier label: 100 KB -> '128kib', None/0 -> '0b'."""
    try:
        n = int(nbytes)
    except (TypeError, ValueError):
        n = 0
    if n <= 0:
        return "0b"
    p = 1 << max(0, math.ceil(math.log2(n)))
    for unit, div in (("gib", 1 << 30), ("mib", 1 << 20), ("kib", 1 << 10)):
        if p >= div:
            return f"{p // div}{unit}"
    return f"{p}b"


def edge_class(name: str, args: Any) -> str:
    b = args.get("bytes") if isinstance(args, dict) else None
    return f"{name}:{_size_tier(b)}"


# ---------------------------------------------------------------------------
# span normal form: (name, trace_id, t0_ns, t1_ns, args_dict)
# ---------------------------------------------------------------------------

def normalize(raw: Iterable) -> list[tuple]:
    """Recorder tuples / exported lists -> the analysis normal form."""
    out = []
    for s in raw:
        name, trace, t0, t1 = s[0], int(s[1]), int(s[2]), int(s[3])
        args = s[5] if len(s) > 5 else None
        a = _spans.args_dict(args) \
            if isinstance(args, (str, dict, tuple, list)) else {}
        if len(s) > 4 and s[4]:
            a.setdefault("tenant", s[4])
        out.append((name, trace, t0, max(t0, t1), a))
    return out


def from_chrome(events: Iterable[dict]) -> list[tuple]:
    """Chrome ``ph:"X"`` span events (a single rank's export or a
    tracemerge-stitched multi-rank trace) -> normal form.  ``ts``/``dur``
    are microseconds per the trace format; times come back as ns."""
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in ("span", None):
            continue
        a = dict(ev.get("args") or {})
        tr = a.pop("trace", "0")
        try:
            trace = int(tr, 16) if isinstance(tr, str) else int(tr)
        except ValueError:
            trace = 0
        t0 = int(float(ev.get("ts", 0)) * 1e3)
        t1 = t0 + int(float(ev.get("dur", 0)) * 1e3)
        if "pid" in ev:
            a.setdefault("pid", ev["pid"])
        out.append((ev.get("name", "?"), trace, t0, t1, a))
    return out


def load(path: str) -> list[tuple]:
    """Load a chrome trace ({"traceEvents": [...]}) or a raw spans
    export ({"spans": [[...], ...]}) into the normal form."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "traceEvents" in doc:
        return from_chrome(doc["traceEvents"])
    if isinstance(doc, dict) and "spans" in doc:
        return normalize(doc["spans"])
    if isinstance(doc, list):
        return from_chrome(doc)
    raise ValueError(f"{path}: neither a chrome trace nor a spans export")


# ---------------------------------------------------------------------------
# interval machinery
# ---------------------------------------------------------------------------

def _sweep(intervals: list[tuple], lo: int, hi: int) -> dict:
    """Exact additive decomposition of ``[lo, hi)``: every elementary
    segment is charged to the single highest-priority active bucket;
    uncovered time is idle.  Returns ``{bucket: ns, "idle": ns}`` with
    ``sum(values) == hi - lo`` exactly."""
    evs = []
    for t0, t1, b in intervals:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 > t0:
            evs.append((t0, 1, b))
            evs.append((t1, -1, b))
    evs.sort(key=lambda e: e[0])
    out = {b: 0 for b in _ORDER}
    out["idle"] = 0
    active = {b: 0 for b in _ORDER}
    prev = lo
    for t, delta, b in evs:
        if t > prev:
            cur = next((bb for bb in _ORDER if active[bb]), "idle")
            out[cur] += t - prev
            prev = t
        active[b] += delta
    if hi > prev:
        out["idle"] += hi - prev
    return out


def _union(ivs: list[tuple]) -> list[list[int]]:
    out: list[list[int]] = []
    for t0, t1 in sorted(ivs):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _union_len(u: list[list[int]]) -> int:
    return sum(t1 - t0 for t0, t1 in u)


def _overlap_len(span: tuple, union: list[list[int]]) -> int:
    s, e = span
    tot = 0
    for t0, t1 in union:
        if t1 <= s:
            continue
        if t0 >= e:
            break
        tot += min(e, t1) - max(s, t0)
    return tot


def _inter_len(u1: list[list[int]], u2: list[list[int]]) -> int:
    return sum(_overlap_len((t0, t1), u2) for t0, t1 in u1)


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def attribute(norm_spans: list[tuple], graph: dict | None = None) -> dict:
    """The full report: global + per-request decomposition, per-task
    exec split, per-edge-class overlap_lost, overall overlap
    efficiency, and (when a graphcheck graph is handed over) the DAG
    critical path weighted by measured per-class exec means."""
    groups: dict[int, list[tuple]] = {}
    for name, trace, t0, t1, a in norm_spans:
        groups.setdefault(trace, []).append((name, t0, t1, a))

    tasks: dict[str, dict] = {}
    edges: dict[str, dict] = {}
    g_buckets = {b: 0 for b in (*_ORDER, "idle")}
    g_exec_iv: list[tuple] = []
    g_get_iv: list[tuple] = []
    requests: dict[str, dict] = {}
    nspans = len(norm_spans)

    for trace, sp in sorted(groups.items()):
        lo = min(s[1] for s in sp)
        hi = max(s[2] for s in sp)
        # serve.request is the request ENVELOPE — it widens the window
        # but is not itself a bucket (everything inside it is)
        core = [(t0, t1, _BUCKET[name]) for name, t0, t1, a in sp
                if name in _BUCKET]
        buckets = _sweep(core, lo, hi)
        exec_u = _union([(t0, t1) for name, t0, t1, a in sp
                         if name == "exec"])
        get_u = _union([(t0, t1) for name, t0, t1, a in sp
                        if name == "comm.get"])
        for name, t0, t1, a in sp:
            if name == "exec":
                cls = a.get("task", "?")
                d = tasks.setdefault(cls, {"count": 0, "total_ms": 0.0})
                d["count"] += 1
                d["total_ms"] += (t1 - t0) / 1e6
            if name in _EDGE_NAMES:
                cls = edge_class(name, a)
                d = edges.setdefault(cls, {"count": 0, "total_ms": 0.0,
                                           "overlap_lost_ms": 0.0})
                d["count"] += 1
                d["total_ms"] += (t1 - t0) / 1e6
                d["overlap_lost_ms"] += \
                    ((t1 - t0) - _overlap_len((t0, t1), exec_u)) / 1e6
        eff = _inter_len(exec_u, get_u) / _union_len(get_u) \
            if get_u else None
        for b, v in buckets.items():
            g_buckets[b] += v
        g_exec_iv += [(t0, t1) for t0, t1 in exec_u]
        g_get_iv += [(t0, t1) for t0, t1 in get_u]
        key = format(trace, "x") if trace else "untraced"
        requests[key] = {
            "spans": len(sp),
            "window_ms": (hi - lo) / 1e6,
            "buckets_ms": {b: v / 1e6 for b, v in buckets.items()},
            "overlap_efficiency": eff,
            "critical_path": sorted(
                ((b, v / 1e6) for b, v in buckets.items()
                 if b != "idle" and v > 0),
                key=lambda kv: -kv[1]),
        }

    g_exec_u, g_get_u = _union(g_exec_iv), _union(g_get_iv)
    g_eff = _inter_len(g_exec_u, g_get_u) / _union_len(g_get_u) \
        if g_get_u else None
    top_lost = sorted(((c, round(d["overlap_lost_ms"], 4))
                       for c, d in edges.items()
                       if d["overlap_lost_ms"] > 0),
                      key=lambda kv: -kv[1])[:3]
    report = {
        "spans": nspans,
        "traces": len(groups),
        "buckets_ms": {b: v / 1e6 for b, v in g_buckets.items()},
        "tasks": tasks,
        "edges": edges,
        "overlap_efficiency": g_eff,
        "overlap_lost_ms": round(sum(d["overlap_lost_ms"]
                                     for d in edges.values()), 4),
        "top_overlap_lost": top_lost,
        "requests": requests,
    }
    if graph:
        costs = class_costs_from(report)
        report["dag"] = dag_critical_path(graph, costs)
    return report


def class_costs_from(report: dict) -> dict:
    """Mean exec ms per task class — the DAG edge weights."""
    return {cls: d["total_ms"] / d["count"]
            for cls, d in report.get("tasks", {}).items() if d["count"]}


def dag_critical_path(graph: dict, class_costs: dict | None = None) -> dict:
    """Longest-cost chain over graphcheck's retained concrete graph
    (``(class, key) -> [successor nodes]``), each node weighted by its
    class's measured mean exec cost (1.0 for unmeasured classes).
    Cycle-safe: Kahn topological order; nodes on a cycle are dropped
    (and counted) rather than looping."""
    costs = class_costs or {}

    def c(n: Any) -> float:
        cls = n[0] if isinstance(n, tuple) and n else n
        return float(costs.get(cls, 1.0))

    nodes: set = set(graph)
    for succs in graph.values():
        nodes.update(succs)
    indeg = {n: 0 for n in nodes}
    for n, succs in graph.items():
        for s in succs:
            indeg[s] += 1
    ready = [n for n in nodes if indeg[n] == 0]
    topo = []
    while ready:
        n = ready.pop()
        topo.append(n)
        for s in graph.get(n, ()):
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    best: dict = {}
    for n in reversed(topo):
        bl, bn = 0.0, None
        for s in graph.get(n, ()):
            if s in best and best[s][0] > bl:
                bl, bn = best[s][0], s
        best[n] = (c(n) + bl, bn)
    if not best:
        return {"length": 0.0, "path": [], "nodes": 0, "cyclic": len(nodes)}
    start = max(best, key=lambda n: best[n][0])
    path = [start]
    while best[path[-1]][1] is not None:
        path.append(best[path[-1]][1])
    return {"length": round(best[start][0], 6),
            "path": [list(n) if isinstance(n, tuple) else n for n in path],
            "nodes": len(topo),
            "cyclic": len(nodes) - len(topo)}


def summarize_recorder(compact: bool = True) -> dict | None:
    """Attribute over the LIVE recorder (runtime_report / drained-server
    metrics seam).  None when no recorder is installed — callers keep
    the conditional-block discipline."""
    r = _spans.recorder
    if r is None or not r.spans:
        return None
    rep = attribute(normalize(list(r.spans)))
    if not compact:
        return rep
    return {k: rep[k] for k in ("spans", "traces", "buckets_ms",
                                "overlap_efficiency", "overlap_lost_ms",
                                "top_overlap_lost")}


# ---------------------------------------------------------------------------
# rendering (CLI + dashboard panel share it)
# ---------------------------------------------------------------------------

def render(report: dict, per_request: bool = True) -> str:
    L = [f"critpath: {report['spans']} spans across "
         f"{report['traces']} trace(s)"]
    bk = report["buckets_ms"]
    tot = sum(bk.values()) or 1.0
    L.append("  " + " | ".join(
        f"{b} {bk[b]:.2f}ms ({100 * bk[b] / tot:.0f}%)"
        for b in (*_ORDER, "idle") if bk.get(b, 0) > 0) or "  (empty)")
    eff = report.get("overlap_efficiency")
    if eff is not None:
        L.append(f"  overlap efficiency: {eff:.3f}   "
                 f"overlap_lost: {report['overlap_lost_ms']:.2f}ms")
    if report.get("top_overlap_lost"):
        L.append("  top overlap_lost edge classes:")
        for cls, ms in report["top_overlap_lost"]:
            d = report["edges"][cls]
            L.append(f"    {cls:<28} {ms:9.3f}ms  "
                     f"({d['count']} spans, {d['total_ms']:.2f}ms total)")
    if report.get("tasks"):
        top = sorted(report["tasks"].items(),
                     key=lambda kv: -kv[1]["total_ms"])[:5]
        L.append("  exec by task class: " + ", ".join(
            f"{c}={d['total_ms']:.2f}ms/{d['count']}" for c, d in top))
    if report.get("dag"):
        dag = report["dag"]
        L.append(f"  DAG critical path: length {dag['length']:.3f} over "
                 f"{len(dag['path'])} of {dag['nodes']} nodes")
    if per_request:
        for key, rq in sorted(report["requests"].items()):
            top = rq["critical_path"][:3]
            L.append(f"  trace {key}: window {rq['window_ms']:.2f}ms, "
                     + ", ".join(f"{b} {ms:.2f}ms" for b, ms in top)
                     + (f", eff {rq['overlap_efficiency']:.3f}"
                        if rq["overlap_efficiency"] is not None else ""))
    return "\n".join(L)


# ---------------------------------------------------------------------------
# self-test
# ---------------------------------------------------------------------------

def self_test() -> int:
    MS = 1_000_000
    # -- synthetic request: queue 2ms, exec 8ms, a 4MiB GET [8,20]ms
    # overlapping the first exec's tail, exec [20,28]ms, release 1ms
    sp = normalize([
        ("queue_wait", 0xA, 0, 2 * MS, None, None, 1),
        ("exec", 0xA, 2 * MS, 10 * MS, None, "GEMM", 1),
        ("comm.get", 0xA, 8 * MS, 20 * MS, None,
         {"flow": "get:0:1", "flow_side": "recv", "bytes": 4 << 20}, 2),
        ("exec", 0xA, 20 * MS, 28 * MS, None, "GEMM", 1),
        ("release", 0xA, 28 * MS, 29 * MS, None, None, 1),
    ])
    rep = attribute(sp)
    bk = rep["requests"]["a"]["buckets_ms"]
    # the sweep is an accounting identity: buckets + idle == window
    assert abs(sum(bk.values()) - rep["requests"]["a"]["window_ms"]) < 1e-9
    assert bk["queue"] == 2.0 and bk["exec"] == 16.0, bk
    assert bk["comm.get"] == 10.0, bk      # [10,20): the unhidden part
    assert bk["release"] == 1.0 and bk["idle"] == 0.0, bk
    ec = "comm.get:4mib"
    assert ec in rep["edges"], rep["edges"]
    # 12ms flight, [8,10) hidden behind exec -> 10ms lost
    assert abs(rep["edges"][ec]["overlap_lost_ms"] - 10.0) < 1e-9
    assert abs(rep["overlap_efficiency"] - 2.0 / 12.0) < 1e-9
    assert rep["top_overlap_lost"][0][0] == ec
    # -- chrome round-trip preserves the attribution
    evs = [{"name": n, "cat": "span", "ph": "X", "ts": t0 / 1e3,
            "dur": (t1 - t0) / 1e3, "pid": 0, "tid": 0,
            "args": {"trace": format(tr, "x"), **a}}
           for n, tr, t0, t1, a in sp]
    rep2 = attribute(from_chrome(evs))
    assert abs(rep2["overlap_efficiency"] - rep["overlap_efficiency"]) \
        < 1e-6, rep2["overlap_efficiency"]
    assert rep2["buckets_ms"] == rep["buckets_ms"]
    # -- untraced spans group under their own key, separately
    rep3 = attribute(sp + normalize([
        ("comm.get", 0, 100 * MS, 104 * MS, None, {"bytes": 1 << 10}, 3)]))
    assert "untraced" in rep3["requests"] and "a" in rep3["requests"]
    assert rep3["edges"]["comm.get:1kib"]["overlap_lost_ms"] == 4.0
    # -- DAG diamond: A(1) -> {B(5), C(2)} -> D(1) => A,B,D length 7
    g = {("A", 1): [("B", 2), ("C", 3)],
         ("B", 2): [("D", 4)], ("C", 3): [("D", 4)], ("D", 4): []}
    dag = dag_critical_path(g, {"A": 1.0, "B": 5.0, "C": 2.0, "D": 1.0})
    assert dag["length"] == 7.0, dag
    assert [n[0] for n in dag["path"]] == ["A", "B", "D"], dag
    assert dag["cyclic"] == 0
    # cycle-safety: a 2-cycle doesn't hang, acyclic part still attributed
    dag2 = dag_critical_path({("X", 1): [("Y", 2)], ("Y", 2): [("X", 1)],
                              ("Z", 3): []})
    assert dag2["cyclic"] == 2 and dag2["nodes"] == 1, dag2
    print("critpath self-test: ok (additive sweep, overlap_lost, chrome "
          "round-trip, DAG diamond, cycle-safe)")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-test" in argv:
        return self_test()
    as_json = "--json" in argv
    if as_json:
        argv.remove("--json")
    compact = "--compact" in argv
    if compact:
        argv.remove("--compact")
    paths = [a for a in argv if not a.startswith("-")]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    sp: list[tuple] = []
    for p in paths:
        sp += load(p)
    if not sp:
        print("critpath: no spans in input", file=sys.stderr)
        return 1
    rep = attribute(sp)
    if as_json:
        print(json.dumps(rep, default=str))
    else:
        print(render(rep, per_request=not compact))
    return 0


if __name__ == "__main__":
    sys.exit(main())

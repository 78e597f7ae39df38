#!/usr/bin/env python3
"""The lowered step's own spans on the card: what they count, where the
device's time and the idle go, what the recorder costs, and the step's
host walk with solves in flight.

For each cell named (``BENCHMARK.json``'s, built by ``portbench``'s kinds
from the seed, warmed up as a run of the benchmark is), on one NVIDIA
card, four phases:

1. ``spans``: the benchmark's traced sub-window (``trace_seconds`` of
   whole solves under ``torch.profiler``, device activity only) with the
   program's span recorder on (:func:`portbench.spantrace.traced`): span
   counts a solve against the plan's and K1's launches, the device ms a
   solve by launching span, K1's by-name time against the time under
   ``k1.launch``, the movement kernels by name (``movement_ms``'s
   patterns) against the gather, scatter and clone spans, the library's
   operations, the idle gaps by span, and the per-layer numbers of
   :data:`portbench.spantrace.PER_LAYER`, and the garbage collector's
   pauses in the window.
2. ``cost``: traced windows with the recorder off (``portbench.trace``,
   as the benchmark runs them) and on, in turns (off, on, on, off, ...),
   ``--cost-runs`` each: ``enqueue_ms_mean`` and ``idle_share`` (and,
   with the recorder on, the per-layer numbers); then untraced windows of
   ``--untraced-seconds``, off and on in turns: the host's enqueue a
   solve and the latency's p95.  Each untraced window also reports the
   Python garbage collector's pauses in it (``gc.callbacks``), and the
   phase the host's cost of recording one span (a span with the
   lowering's arguments, into a recorder of its own).
3. ``inflight`` (kinds with a wavefront plan): no profiler, windows of a
   closed loop and of a loop that keeps ``--depth`` solves in flight, in
   turns (closed, queued, queued, closed), twice with the recorder off
   and twice on: the enqueue a solve, and with the recorder on each span
   name's host ms a solve, inclusive and its own.
4. ``inflight_traced``: one traced window of the queued loop: where its
   idle falls and in which runtime calls the host waits, by span.

Usage (on the card; ``--device cpu --size 256 64`` rehearses it on the
host at a small size, where the device numbers mean nothing)::

    python3 scripts/lowered_spans.py [--cells gemm16k.lowered,potrf16k.lowered]
        [--seed N] [--out chiprun_out/lowered_spans]

Prints one JSON line a cell and phase, and writes each whole to
``<out>/<cell>.<phase>.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from collections import Counter, deque
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K1 = "gemm_update_kernel"
TURNS = (False, True, True, False, False, True, True, False)


def _ms(ns: float, n: int) -> float:
    return ns / 1e6 / max(1, n)


def _top(counter: Counter, n: int, solves: int, k: int = 20) -> list:
    return [[str(key), _ms(v, solves)] for key, v in counter.most_common(k)]


def spans_phase(problem, device, seconds, spantrace, gemm_update,
                patterns, loop) -> dict:
    k0 = dict(gemm_update.launches_by_variant)
    pauses = GcPauses()

    def run(p, d, s):
        with pauses:
            return loop.run(p, d, seconds=s)

    t = spantrace.traced(problem, device, seconds, run=run)
    n = max(1, t.solves)
    k1 = {v: (gemm_update.launches_by_variant[v] - k0[v]) / n for v in k0}
    by_op = t.device_ns_by_span_op
    k1_by_span = Counter()
    moving_by_span = Counter()
    lib_ops = Counter()
    for (span, op), ns in by_op.items():
        if K1 in op:
            k1_by_span[span] += ns
        if any(p in op for p in patterns):
            moving_by_span[span] += ns
        if span.startswith(spantrace.LIB_PREFIX):
            lib_ops[op] += ns
    k1_named = sum(v for op, v in t.device_ns.items() if K1 in op)
    moving_named = sum(v for op, v in t.device_ns.items()
                       if any(p in op for p in patterns))
    spans_moving = sum(t.device_ns_by_span[s] for s in spantrace.MOVERS)
    gaps = sum(t.gaps_s.values())
    return {
        "solves": t.solves, "window_s": t.window_s,
        "idle_share": 100.0 * (1 - t.busy_s / t.window_s),
        "enqueue_ms_mean": 1e3 * statistics.fmean(t.enqueue_s),
        "span_counts_per_solve": {k: v / n
                                  for k, v in sorted(t.span_counts.items())},
        "k1_launches_per_solve": {v: c for v, c in k1.items() if c},
        "plan": {"levels": getattr(problem.lowered, "levels", None),
                 "groups": getattr(problem.lowered, "groups", None),
                 "bytes_moved": getattr(problem.lowered, "bytes_moved",
                                        None)},
        "per_layer": {name: f(t) for name, f in spantrace.PER_LAYER.items()},
        "clone_ms": spantrace.clone_ms(t),
        "k1_ms_by_name": _ms(k1_named, n),
        "k1_ms_by_span": _top(k1_by_span, 10, n),
        "movement_ms_by_name": _ms(moving_named, n),
        "movement_ms_by_span": _top(moving_by_span, 10, n),
        "gather_scatter_clone_ms": _ms(spans_moving, n),
        "lib_ops_ms": _top(lib_ops, 20, n),
        "device_ms_by_span": _top(t.device_ns_by_span, 30, n),
        "host_ms_by_span": _top(t.host_ns_by_span, 30, n),
        "self_ms_by_span": _top(t.self_ns_by_span, 30, n),
        "longest_ms_by_span": sorted(
            ([name, ns / 1e6, args] for name, (ns, args)
             in t.longest_by_span.items()), key=lambda x: -x[1]),
        "runtime_ms_by_span": _top(t.runtime_ns_by_span, 20, n),
        "device_ms_by_span_op": _top(by_op, 40, n),
        "idle_ms_per_solve": 1e3 * gaps / n,
        "step_gap_ms_by_namer": _top(t.step_gap_ns_by_namer, 3, n),
        "breakdown": t.breakdown(12),
        **pauses.report(t.solves),
    }


class GcPauses:
    """The garbage collector's pauses while installed in ``gc.callbacks``."""

    def __init__(self) -> None:
        self.ns, self.worst, self.count, self._t = 0, 0, 0, None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter_ns()
        elif self._t is not None:
            d = time.perf_counter_ns() - self._t
            self.ns, self.count = self.ns + d, self.count + 1
            self.worst, self._t = max(self.worst, d), None

    def __enter__(self) -> "GcPauses":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)

    def report(self, solves: int) -> dict:
        return {"gc_ms_per_solve": _ms(self.ns, solves),
                "gc_worst_ms": self.worst / 1e6, "gc_pauses": self.count}


def record_ns(spans, n: int = 200_000) -> dict:
    """The host's nanoseconds for one clock read, and to record one span
    of the lowering's shape (two clock reads, its argument tuple, the
    record) into a recorder of its own."""
    rec = spans.SpanRecorder(max_spans=10 ** 7)
    now = time.perf_counter_ns
    t = now()
    for _ in range(n):
        now()
    clock = (now() - t) / n
    t = now()
    for _ in range(n):
        t0 = now()
        rec.record("lowered.gather", 1, t0, now(), None,
                   ("task", "GEMM", "G", 3, "bytes", 1))
    return {"clock_read": clock, "span": (now() - t) / n}


def cost_phase(problem, device, runs, seconds, untraced_s, spantrace,
               ptrace, loop, spans, percentile) -> dict:
    traced, untraced = [], []
    for on in TURNS[:2 * runs]:
        t = (spantrace.traced if on else ptrace.traced)(
            problem, device, seconds)
        row = {"recorder": on, "solves": t.solves,
               "enqueue_ms_mean": 1e3 * statistics.fmean(t.enqueue_s),
               "idle_share": 100.0 * (1 - t.busy_s / t.window_s)}
        if on:
            row["per_layer"] = {name: f(t) for name, f
                                in spantrace.PER_LAYER.items()}
            row["step_gap_ms_by_namer"] = _top(t.step_gap_ns_by_namer, 3,
                                               t.solves)
        traced.append(row)
    for on in TURNS[:2 * runs]:
        if on:
            spans.install(max_spans=10 ** 7)
        try:
            with GcPauses() as pauses:
                w = loop.run(problem, device, seconds=untraced_s)
        finally:
            if on:
                spans.uninstall()
        untraced.append({"recorder": on, "solves": w.solves,
                         "solves_per_s": w.solves / w.seconds,
                         "enqueue_ms_mean": 1e3 * statistics.fmean(
                             w.enqueue_s),
                         "enqueue_ms_median": 1e3 * statistics.median(
                             w.enqueue_s),
                         "latency_ms_p95": percentile(w.latency_ms, 95),
                         **pauses.report(w.solves)})
    summary = {}
    for name, rows in (("traced", traced), ("untraced", untraced)):
        for on in (False, True):
            mine = [r for r in rows if r["recorder"] is on]
            for key in mine[0]:
                if key not in ("recorder", "solves", "per_layer",
                               "step_gap_ms_by_namer"):
                    summary[f"{name}.{'on' if on else 'off'}.{key}"] = \
                        [r[key] for r in mine]
    return {"summary": summary, "record_ns": record_ns(spans),
            "traced": traced, "untraced": untraced}


def queued(problem, device, seconds: float, depth: int, loop):
    """The loop with ``depth`` solves in flight: each solve is submitted
    once the one ``depth`` before it has completed (its result kept until
    then), so the host may run up to ``depth`` solves ahead of the card."""
    step, stores = problem.step, problem.stores
    win = loop.Window()
    pending: deque = deque()
    loop.synchronize(device)
    win.started_ns = time.time_ns()
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        res = problem.result(step(stores))
        win.enqueue_s.append(time.perf_counter() - t0)
        done = loop._mark(device)
        done.record()
        pending.append((res, done))
        win.solves += 1
        if len(pending) >= depth:
            pending.popleft()[1].synchronize()
        if time.perf_counter() - t_start >= seconds:
            break
    loop.synchronize(device)
    pending.clear()
    win.seconds = time.perf_counter() - t_start
    win.ended_ns = time.time_ns()
    return win


def inflight_phase(problem, device, seconds, depth, spantrace, loop,
                   spans) -> dict:
    rows = []
    for on in (False, False, True, True):
        for mode in ("closed", "queued", "queued", "closed")[::1 if on
                                                                else -1]:
            rec = spans.install(max_spans=10 ** 7) if on else None
            try:
                w = (queued(problem, device, seconds, depth, loop)
                     if mode == "queued"
                     else loop.run(problem, device, seconds=seconds))
            finally:
                if on:
                    spans.uninstall()
            row = {"mode": mode, "recorder": on, "solves": w.solves,
                   "enqueue_ms_mean": 1e3 * statistics.fmean(w.enqueue_s),
                   "enqueue_ms_median": 1e3 * statistics.median(
                       w.enqueue_s)}
            if on:
                shift = rec.anchor[0] - rec.anchor[1]
                t = spantrace.SpanTrace(solves=w.solves)
                spantrace.read_spans(
                    [], [(s[0], s[2] + shift, s[3] + shift, s[5])
                         for s in rec.spans], w.started_ns, w.ended_ns, t)
                row["host_ms_by_span"] = t.per_solve_ms(t.host_ns_by_span)
                row["self_ms_by_span"] = t.per_solve_ms(t.self_ns_by_span)
            rows.append(row)
    enqueue = {f"{m}.{'on' if on else 'off'}": [
        r["enqueue_ms_mean"] for r in rows
        if r["mode"] == m and r["recorder"] is on]
        for m in ("closed", "queued") for on in (False, True)}
    growth = {}
    for key in ("host_ms_by_span", "self_ms_by_span"):
        q = [r[key] for r in rows if r["mode"] == "queued" and key in r]
        c = [r[key] for r in rows if r["mode"] == "closed" and key in r]
        names = set().union(*q, *c)
        growth[key] = sorted(
            ((nm, statistics.fmean(x.get(nm, 0.0) for x in q)
              - statistics.fmean(x.get(nm, 0.0) for x in c))
             for nm in names), key=lambda kv: -abs(kv[1]))
    return {"depth": depth, "enqueue_ms_mean": enqueue, "rows": rows,
            "growth_ms_per_solve": growth}


def inflight_traced_phase(problem, device, seconds, depth, spantrace,
                          loop) -> dict:
    t = spantrace.traced(problem, device, seconds,
                         run=lambda p, d, s: queued(p, d, s, depth, loop))
    n = max(1, t.solves)
    return {"depth": depth, "solves": t.solves,
            "idle_share": 100.0 * (1 - t.busy_s / t.window_s),
            "enqueue_ms_mean": 1e3 * statistics.fmean(t.enqueue_s),
            "host_ms_by_span": _top(t.host_ns_by_span, 20, n),
            "self_ms_by_span": _top(t.self_ns_by_span, 20, n),
            "runtime_ms_by_span": _top(t.runtime_ns_by_span, 25, n),
            "breakdown": t.breakdown(12)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="gemm16k.lowered,potrf16k.lowered")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--cost-runs", type=int, default=4)
    ap.add_argument("--untraced-seconds", type=float, default=3.0)
    ap.add_argument("--inflight-seconds", type=float, default=3.0)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, nargs=2, metavar=("N", "NB"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "lowered_spans"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from parsec_tpu_torch.ops.gemm import gemm_update
    from parsec_tpu_torch.prof import spans
    from portbench import harness, loop, spantrace, spec
    from portbench import trace as ptrace
    from portbench.roofline import percentile

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: these phases measure the card",
              file=sys.stderr)
        return 1
    harness.set_cache_dirs()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    patterns = json.loads((spec.PKG / "metrics" / "movement_ms.json")
                          .read_text())["patterns"]
    bench = spec.load()
    card = harness.card_info() if device.type == "cuda" else {}
    for cell_name in args.cells.split(","):
        cell = spec.cell(bench, cell_name)
        cfg = spec.config(bench, cell["config"])
        if args.size:
            cfg = {**cfg, "N": args.size[0], "nb": args.size[1]}
        traffic = spec.traffic(cell["traffic"])
        kind = spec.kind(cfg["kind"])
        problem = kind.build(cfg, args.seed, device)
        loop.run(problem, device, solves=traffic["warmup_solves"])
        loop.synchronize(device)
        secs = traffic["trace_seconds"]
        phases = [("spans", lambda: spans_phase(
            problem, device, secs, spantrace, gemm_update, patterns, loop)),
            ("cost", lambda: cost_phase(
                problem, device, args.cost_runs, secs,
                args.untraced_seconds, spantrace, ptrace, loop, spans,
                percentile))]
        if getattr(problem.lowered, "levels", None):
            phases += [("inflight", lambda: inflight_phase(
                problem, device, args.inflight_seconds, args.depth,
                spantrace, loop, spans)),
                ("inflight_traced", lambda: inflight_traced_phase(
                    problem, device, secs, args.depth, spantrace, loop))]
        for phase, fn in phases:
            t0 = time.perf_counter()
            res = {"cell": cell_name, "phase": phase, "seed": args.seed,
                   **fn(), "phase_s": time.perf_counter() - t0,
                   "card": card}
            (out_dir / f"{cell_name}.{phase}.json").write_text(
                json.dumps(res, indent=1))
            brief = {k: v for k, v in res.items()
                     if k not in ("device_ms_by_span_op", "breakdown",
                                  "runtime_ms_by_span", "rows", "traced",
                                  "untraced", "self_ms_by_span")}
            print(json.dumps(brief), flush=True)
        problem.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

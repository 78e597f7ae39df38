"""The traced sub-window read through the program's own spans.

:func:`traced` runs the loop under ``torch.profiler`` as
:func:`portbench.trace.traced` does, recording device activity only, with
the program's span recorder (``parsec_tpu_torch.prof.spans``) installed
around the window, or the one already installed; it uninstalls only what
it installed.  The spans are taken on the wall clock, the profiler's,
through the recorder's clock anchor (a program whose recorder has none
gets one taken here, the same way).  Beside what :mod:`.trace` reads, it
takes:

- each device operation's nanoseconds by the innermost program span open
  at the start of the CUDA runtime call that launched it (the profiler's
  correlation ids pair the two), ``none`` where no span was open;
- each idle gap named ``<innermost program span> > <next device op>``
  where the host was in no runtime call at its middle and a span was open
  there; ``host > ...`` where none was, and the runtime call's name where
  the host was in one, as :mod:`.trace` names them;
- each span name's host nanoseconds (all of its spans) and its own (less
  the spans nested in it), its count, its longest span with that span's
  arguments, and the bytes its spans carry;
- the host's nanoseconds in each CUDA runtime call, by the span open where
  the call started;
- the device's idle nanoseconds inside ``lowered.step`` spans: the idle
  the program's own host work leaves, as against the caller's turnaround
  between solves.

With a program that records no span every field of :mod:`.trace` reads as
it does there, and the per-layer numbers of :data:`PER_LAYER` read None.
"""

from __future__ import annotations

import bisect
import time
from collections import Counter
from dataclasses import dataclass, field

import torch

from . import loop
from .roofline import device_busy, idle_gaps
from .trace import Trace, _host_at

#: the library's tile calls' spans (``lib.potrf``, ``lib.trsm``, ...)
LIB_PREFIX = "lib."
#: the spans that carry the lowering's moved bytes
MOVERS = ("lowered.gather", "lowered.scatter", "lowered.clone")


@dataclass
class SpanTrace(Trace):
    device_ns_by_span: Counter = field(default_factory=Counter)
    device_ns_by_span_op: Counter = field(default_factory=Counter)
    host_ns_by_span: Counter = field(default_factory=Counter)
    self_ns_by_span: Counter = field(default_factory=Counter)
    runtime_ns_by_span: Counter = field(default_factory=Counter)
    span_counts: Counter = field(default_factory=Counter)
    # the longest span of each name: (ns, its arguments)
    longest_by_span: dict = field(default_factory=dict)
    bytes_by_span: Counter = field(default_factory=Counter)
    step_idle_ns: int = 0
    # idle ns of the gaps whose middle lies inside a ``lowered.step``, by
    # what names them: "span", "runtime" (a CUDA call) or "host"
    step_gap_ns_by_namer: Counter = field(default_factory=Counter)

    def per_solve_ms(self, counter: Counter) -> dict:
        n = max(1, self.solves)
        return {k: v / 1e6 / n for k, v in counter.most_common()}


def innermost(spans) -> list[tuple[int, int, str]]:
    """Disjoint ``(start, end, name)`` pieces covering the union of
    ``spans`` (``(start, end, name)``, nested or disjoint), each named by
    the innermost span open there.  A span that outlives the span it
    started in is cut at that span's end."""
    pieces: list[tuple[int, int, str]] = []
    stack: list[list] = []          # [end, name], innermost last
    t = 0                           # pieces are emitted up to t

    def close(upto: float) -> None:
        nonlocal t
        while stack and stack[-1][0] <= upto:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close(a)
        if stack and a > t:
            pieces.append((t, a, stack[-1][1]))
        t = a
        stack.append([min(b, stack[-1][0]) if stack else b, name])
    close(float("inf"))
    return pieces


class _Lookup:
    """The innermost span open at a moment, from :func:`innermost`'s
    pieces."""

    def __init__(self, pieces) -> None:
        self.pieces = pieces
        self.starts = [p[0] for p in pieces]

    def __call__(self, t: int) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.pieces[i][1]:
            return self.pieces[i][2]
        return None


def _overlap(a: int, b: int, union: list[tuple[int, int]]) -> int:
    """Nanoseconds of ``[a, b]`` inside the disjoint sorted ``union``."""
    i = max(0, bisect.bisect_right([u[0] for u in union], a) - 1)
    total = 0
    for lo, hi in union[i:]:
        if lo >= b:
            break
        total += max(0, min(b, hi) - max(a, lo))
    return total


def _union(spans) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _args(args) -> dict:
    """A span's arguments as a dict, from any form the recorder keeps: a
    dict, a flat ``(key, value, ...)`` tuple, or a string (a task's
    class)."""
    if isinstance(args, dict):
        return args
    if isinstance(args, (tuple, list)):
        return dict(zip(args[::2], args[1::2]))
    return {"task": args} if isinstance(args, str) else {}


def read_spans(events, spans, w0: int, w1: int, out: SpanTrace) -> None:
    """Fill ``out`` from profiler events ``(on_device, name, start_ns,
    end_ns, correlation_id)`` and program spans ``(name, start_ns,
    end_ns, args)`` on the same clock, inside the window ``[w0, w1]``."""
    dev, host = [], []
    for on_device, name, a, b, corr in events:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        (dev if on_device else host).append((a, b, name, corr))
    dev.sort()
    host.sort()
    intervals = [(a, b) for a, b, _, _ in dev]
    for a, b, name, _ in dev:
        out.device_ns[name] += b - a
    out.device_events = len(intervals)
    out.busy_s = device_busy(intervals) / 1e9

    inside = [(max(a, w0), min(b, w1), name, args)
              for name, a, b, args in spans if min(b, w1) > max(a, w0)]
    pieces = innermost([(a, b, name) for a, b, name, _ in inside])
    span_at = _Lookup(pieces)
    for a, b, name, args in inside:
        out.host_ns_by_span[name] += b - a
        out.span_counts[name] += 1
        if b - a > out.longest_by_span.get(name, (-1,))[0]:
            out.longest_by_span[name] = (b - a, _args(args))
        moved = _args(args).get("bytes")
        if moved is not None:
            out.bytes_by_span[name] += moved
    for a, b, name in pieces:
        out.self_ns_by_span[name] += b - a

    for a, b, name, _ in host:
        out.runtime_ns_by_span[(span_at(a) or "none", name)] += b - a
    # a device operation by the span open where its runtime call started
    # (the earliest host event of its correlation id: the driver's own
    # events under a launch, module loading say, share the launch's id)
    launched: dict[int, int] = {}
    for a, _, _, corr in host:
        if corr:
            launched.setdefault(corr, a)
    for a, b, name, corr in dev:
        t = launched.get(corr)
        owner = (span_at(t) if t is not None else None) or "none"
        out.device_ns_by_span[owner] += b - a
        out.device_ns_by_span_op[(owner, name)] += b - a

    hosted = [(n, a, b) for a, b, n, _ in host]
    starts = [a for a, _, _, _ in host]
    dstarts = [a for a, _ in intervals]
    edges = [(w0, intervals[0][0]), *idle_gaps(intervals),
             (max(b for _, b in intervals), w1)] if intervals else []
    steps = _union([(a, b) for a, b, name, _ in inside
                    if name == "lowered.step"])
    for g0, g1 in edges:
        if g1 <= g0:
            continue
        j = bisect.bisect_left(dstarts, g1)
        after = dev[j][2] if j < len(dev) else "the window's end"
        mid = (g0 + g1) // 2
        doing = _host_at(mid, hosted, starts)
        namer = "runtime"
        if doing == "host":
            owner = span_at(mid)
            namer = "host" if owner is None else "span"
            doing = owner or doing
        out.gaps_s[f"{doing} > {after[:60]}"] += (g1 - g0) / 1e9
        out.step_idle_ns += _overlap(g0, g1, steps)
        if _overlap(mid, mid + 1, steps):
            out.step_gap_ns_by_namer[namer] += g1 - g0


def _anchor(rec) -> tuple[int, int]:
    """The recorder's clock anchor, or, for a program whose recorder has
    none, one taken here: the tightest of 16 back-to-back pairs."""
    anchor = getattr(rec, "anchor", None)
    if anchor is not None:
        return anchor
    best = None
    for _ in range(16):
        p0 = time.perf_counter_ns()
        u = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, u, (p0 + p1) // 2)
    return best[1], best[2]


def traced(problem, device: torch.device, seconds: float,
           run=None) -> SpanTrace:
    """Run the loop for ``seconds`` under the profiler with the program's
    span recorder installed, and read both.  ``run(problem, device,
    seconds)`` replaces the loop (:func:`portbench.loop.run`)."""
    from parsec_tpu_torch.prof import spans
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = run or (lambda p, d, s: loop.run(p, d, seconds=s))
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" \
        else [ProfilerActivity.CPU]
    mine = spans.recorder is None
    rec = spans.install() if mine else spans.recorder
    unix_ns, perf_ns = _anchor(rec)
    first = len(rec.spans)
    try:
        with profile(activities=acts) as prof:
            win = run(problem, device, seconds)
    finally:
        if mine:
            spans.uninstall()
    events = [(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns(),
               e.start_ns() + e.duration_ns(), e.correlation_id())
              for e in prof.profiler.kineto_results.events()]
    shift = unix_ns - perf_ns
    recorded = [(s[0], s[2] + shift, s[3] + shift, s[5])
                for s in list(rec.spans)[first:]]
    out = SpanTrace(solves=win.solves,
                    window_s=(win.ended_ns - win.started_ns) / 1e9,
                    enqueue_s=win.enqueue_s)
    read_spans(events, recorded, win.started_ns, win.ended_ns, out)
    return out


# ---------------------------------------------------------------------------
# the per-layer numbers a solve, each None where its spans are missing
# ---------------------------------------------------------------------------

def _device_ms(t: SpanTrace, names) -> float | None:
    if not t.solves or not any(t.span_counts[n] for n in names):
        return None
    return sum(t.device_ns_by_span[n] for n in names) / 1e6 / t.solves


def gather_ms(t: SpanTrace) -> float | None:
    """Device ms a solve of the operations launched in ``lowered.gather``."""
    return _device_ms(t, ["lowered.gather"])


def scatter_ms(t: SpanTrace) -> float | None:
    """Device ms a solve of the operations launched in
    ``lowered.scatter``."""
    return _device_ms(t, ["lowered.scatter"])


def clone_ms(t: SpanTrace) -> float | None:
    """Device ms a solve of the operations launched in ``lowered.clone``."""
    return _device_ms(t, ["lowered.clone"])


def moved_gb(t: SpanTrace) -> float | None:
    """GB a solve that the gather, scatter and clone spans carry."""
    if not t.solves or not any(t.span_counts[n] for n in MOVERS):
        return None
    return sum(t.bytes_by_span[n] for n in MOVERS) / 1e9 / t.solves


def library_ms(t: SpanTrace) -> float | None:
    """Device ms a solve of the operations launched in ``lib.*``."""
    return _device_ms(t, [n for n in t.span_counts
                          if n.startswith(LIB_PREFIX)])


def k1_prep_ms(t: SpanTrace) -> float | None:
    """Host ms a solve inside ``k1.prep``."""
    if not t.solves or not t.span_counts["k1.prep"]:
        return None
    return t.host_ns_by_span["k1.prep"] / 1e6 / t.solves


def step_idle_ms(t: SpanTrace) -> float | None:
    """Device-idle ms a solve while the host is inside ``lowered.step``."""
    if not t.solves or not t.span_counts["lowered.step"]:
        return None
    return t.step_idle_ns / 1e6 / t.solves


PER_LAYER = {f.__name__: f for f in (gather_ms, scatter_ms, moved_gb,
                                     library_ms, k1_prep_ms, step_idle_ms)}

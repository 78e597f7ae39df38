"""The traced sub-window: whole solves under ``torch.profiler``.

The loop runs again for the traffic file's ``trace_seconds`` under the
profiler, recording device activity only (recording every host operation
too would lengthen the host's walk of a Cholesky step by about two thirds
and so inflate the very idle time it measures).  The profiler's clock is
the wall clock, so the window is the loop's own: from just before the
first submission to just after the last wait.  From the profiler's events
this takes:

- the device's busy time: the union of every device operation's interval
  (kernels, copies, sets) inside the window (:func:`.roofline.device_busy`);
- each device operation's nanoseconds, by name;
- each idle gap, named by the CUDA runtime call the host was in at its
  middle (``host`` where it was in none) and the device operation that
  ended it.
"""

from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass, field

import torch

from . import loop
from .roofline import device_busy, idle_gaps

NAME_CHARS = 100


@dataclass
class Trace:
    solves: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ns: Counter = field(default_factory=Counter)
    device_events: int = 0
    gaps_s: Counter = field(default_factory=Counter)
    enqueue_s: list = field(default_factory=list)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle gaps by
        what the host was doing, each as ``[name, seconds]``."""
        ops = [[n[:NAME_CHARS], ns / 1e9]
               for n, ns in self.device_ns.most_common(top)]
        gaps = [[n[:NAME_CHARS], s] for n, s in self.gaps_s.most_common(top)]
        return {"device_ops": ops, "idle_gaps": gaps}


def _host_at(t: int, host: list, starts: list) -> str:
    """The host event (a CUDA runtime call) that started last before
    ``t`` (ns) if it still runs then, else ``host``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and host[i][2] >= t:
        return host[i][0]
    return "host"


def read_events(events, w0: int, w1: int, out: "Trace") -> None:
    """Fill ``out`` from profiler events ``(on_device, name, start_ns,
    end_ns)`` inside the window ``[w0, w1]``."""
    dev, host = [], []
    for on_device, name, a, b in events:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        (dev if on_device else host).append((a, b, name))
    dev.sort()
    spans = [(a, b) for a, b, _ in dev]
    for a, b, name in dev:
        out.device_ns[name] += b - a
    out.device_events = len(spans)
    out.busy_s = device_busy(spans) / 1e9
    host.sort()
    hosted = [(n, a, b) for a, b, n in host]
    starts = [a for a, _, _ in host]
    dstarts = [a for a, _ in spans]
    edges = [(w0, spans[0][0]), *idle_gaps(spans), (max(b for _, b in spans),
                                                    w1)] if spans else []
    for g0, g1 in edges:
        if g1 <= g0:
            continue
        j = bisect.bisect_left(dstarts, g1)
        after = dev[j][2] if j < len(dev) else "the window's end"
        doing = _host_at((g0 + g1) // 2, hosted, starts)
        out.gaps_s[f"{doing} > {after[:60]}"] += (g1 - g0) / 1e9


def traced(problem, device: torch.device, seconds: float) -> Trace:
    """Run the loop for ``seconds`` under the profiler and read it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" \
        else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        win = loop.run(problem, device, seconds=seconds)
    events = [(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns(),
               e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    out = Trace(solves=win.solves,
                window_s=(win.ended_ns - win.started_ns) / 1e9,
                enqueue_s=win.enqueue_s)
    read_events(events, win.started_ns, win.ended_ns, out)
    return out

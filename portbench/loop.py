"""The traffic loop: one caller, a closed loop of solves of the lowered
step.  Each solve is submitted (the host's ``step_fn`` call), then waited
on, then the next is submitted.  The window closes once its seconds have
passed and the last solve has completed, so the rate takes all of the work
and all of the time.

Each solve's enqueue (the ``step_fn`` call, from its call to its return)
is read on the host clock, and its latency on the device, between CUDA
events recorded before the call and after its return.  A sample of
``keep`` results, drawn from the run's seed, is kept for the comparison
with the reference.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import torch


class _HostMark:
    """A CUDA event's interface for a run on the host."""

    def __init__(self) -> None:
        self.t = 0.0

    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_HostMark") -> float:
        return (end.t - self.t) * 1e3


def _mark(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostMark()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """What one stretch of the loop measured."""

    solves: int = 0
    seconds: float = 0.0
    enqueue_s: list = field(default_factory=list)
    latency_ms: list = field(default_factory=list)
    kept: list = field(default_factory=list)      # (solve index, result)
    started_ns: int = 0     # the wall clock (``time.time_ns``) at the start
    ended_ns: int = 0       # and at the close


def run(problem, device: torch.device, *, seconds: float = 0.0,
        solves: int = 0, keep: int = 0,
        rng: random.Random | None = None) -> Window:
    """Submit solves of ``problem.step`` on ``problem.stores``, one at a
    time, until ``seconds`` have passed (or, with ``solves``, that many
    were made).  ``keep`` results are kept, by reservoir sampling with
    ``rng``.  The window's ends are also read on the wall clock, the
    profiler's, for the traced sub-window."""
    step, stores = problem.step, problem.stores
    win = Window()
    marks = []
    rng = rng or random.Random(0)

    synchronize(device)
    win.started_ns = time.time_ns()
    t_start = time.perf_counter()
    while True:
        start = _mark(device)
        start.record()
        t0 = time.perf_counter()
        out = step(stores)
        win.enqueue_s.append(time.perf_counter() - t0)
        done = _mark(device)
        done.record()
        marks.append((start, done))
        res = problem.result(out)
        del out
        done.synchronize()
        if len(win.kept) < keep:
            win.kept.append((win.solves, res))
        elif keep:
            j = rng.randrange(win.solves + 1)
            if j < keep:
                win.kept[j] = (win.solves, res)
        del res         # a result not kept is freed before the next solve
        win.solves += 1
        if (win.solves >= solves) if solves else \
                (time.perf_counter() - t_start >= seconds):
            break
    win.seconds = time.perf_counter() - t_start
    win.ended_ns = time.time_ns()
    win.latency_ms = [s.elapsed_time(e) for s, e in marks]
    return win

"""Weighted-fair scheduling shim above the scheduler module.

Port of ``parsec_tpu/serve/fair.py``: :class:`FairScheduler` wraps the
context's scheduler module and interposes only on tasks that belong to a
serve submission (``taskpool._serve_sub``, set by ``serve/server.py``):

- **across tenants**: weighted fair queueing — each tenant carries a
  virtual time advanced by ``1/weight`` per dispatched task; select
  serves the active tenant with the smallest virtual time;
- **within a tenant**: submission priority first (higher first), then
  earliest deadline, then task priority, then arrival order.

Other tasks delegate to the inner module, which ``select`` drains first.
``strict_order`` tells the scheduling loop to skip the keep-hot
``next_task`` bypass, so a released successor does not jump every other
tenant's queue.  Left out: ``queue_depths`` (the stall dump's).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Any, Sequence

from ..core.params import params as _params
from ..sched.api import SchedulerModule

_params.register("serve_fair_default_weight", 1.0,
                 "fair-share weight for tenants without an explicit one")

_INF = float("inf")


class _TenantState:
    __slots__ = ("name", "weight", "vtime", "heap")

    def __init__(self, name: str, weight: float) -> None:
        self.name = name
        self.weight = max(weight, 1e-9)
        self.vtime = 0.0
        self.heap: list = []


class FairScheduler(SchedulerModule):
    name = "serve_fair"
    strict_order = True

    def __init__(self, inner: SchedulerModule) -> None:
        self.inner = inner
        self._lock = threading.Lock()
        # only tenants with queued work live here (evicted when their
        # heap drains), so the select scan is bounded by backlogged
        # tenants; reactivation clamps vtime to the clock, losing nothing
        self._tenants: dict[str, _TenantState] = {}
        self._weights: dict[str, float] = {}
        self._seq = itertools.count()
        self._nfair = 0
        self._vclock = 0.0
        self.dispatched: dict[str, int] = {}

    def install(self, context: Any) -> None:
        self.inner.install(context)

    def flow_init(self, es: Any) -> None:
        self.inner.flow_init(es)

    def set_weight(self, tenant: str, weight: float) -> None:
        with self._lock:
            self._weights[tenant] = max(weight, 1e-9)
            ts = self._tenants.get(tenant)
            if ts is not None:
                ts.weight = self._weights[tenant]

    def _state_locked(self, tenant: str) -> _TenantState:
        ts = self._tenants.get(tenant)
        if ts is None:
            ts = _TenantState(tenant, self._weights.get(
                tenant, _params.get("serve_fair_default_weight")))
            self._tenants[tenant] = ts
        return ts

    def schedule(self, es: Any, tasks: Sequence[Any],
                 distance: int = 0) -> None:
        plain, fair = [], []
        for t in tasks:
            sub = getattr(t.taskpool, "_serve_sub", None)
            if sub is None:
                plain.append(t)
            else:
                fair.append((sub, t))
        if plain:
            self.inner.schedule(es, plain, distance)
        if fair:
            with self._lock:
                for sub, t in fair:
                    ts = self._state_locked(sub.tenant)
                    if not ts.heap:
                        # (re)activation: an idle tenant banks no credit
                        ts.vtime = max(ts.vtime, self._vclock)
                    heapq.heappush(ts.heap, (
                        (-sub.priority,
                         sub.deadline_at if sub.deadline_at is not None
                         else _INF,
                         -(t.priority or 0),
                         next(self._seq)),
                        t))
                self._nfair += len(fair)

    def select(self, es: Any) -> tuple[Any | None, int]:
        t, d = self.inner.select(es)
        if t is not None:
            return t, d
        if self._nfair:
            with self._lock:
                active = [ts for ts in self._tenants.values() if ts.heap]
                if active:
                    ts = min(active, key=lambda s: s.vtime)
                    _, task = heapq.heappop(ts.heap)
                    ts.vtime += 1.0 / ts.weight
                    self._vclock = max(self._vclock, ts.vtime)
                    self._nfair -= 1
                    self.dispatched[ts.name] = \
                        self.dispatched.get(ts.name, 0) + 1
                    if not ts.heap:
                        del self._tenants[ts.name]
                    return task, 0
        return None, 0

    def remove(self, context: Any) -> None:
        with self._lock:
            self._tenants.clear()
            self._nfair = 0
        self.inner.remove(context)

    def pending_tasks(self, context: Any) -> int:
        return self._nfair + self.inner.pending_tasks(context)

    def dispatch_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self.dispatched)

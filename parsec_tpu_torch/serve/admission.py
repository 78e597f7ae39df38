"""Admission control for the persistent serving layer.

Port of ``parsec_tpu/serve/admission.py``: an
:class:`AdmissionController` tracks in-flight submissions per tenant and
globally, and either blocks the submitting thread (backpressure) or
sheds with a typed :class:`AdmissionRejected` when a high-water mark is
hit.  The marks are MCA params.  Left out: the in-flight task budget
(``serve_max_inflight_tasks``, ``serve_default_task_cost``, a
submission's cost as its ``nb_local_tasks()``): it is off by default and
nothing the port serves turns it on, so every submission costs one.
"""

from __future__ import annotations

import threading
import time

from ..core.params import params as _params

_params.register("serve_max_inflight", 64,
                 "global high-water mark on admitted in-flight submissions "
                 "(0 = unlimited)")
_params.register("serve_max_tenant_inflight", 16,
                 "per-tenant high-water mark on admitted in-flight "
                 "submissions (0 = unlimited)")
_params.register("serve_admission_timeout", 30.0,
                 "seconds a blocking submit waits for admission before "
                 "shedding with AdmissionRejected")


class AdmissionRejected(RuntimeError):
    """A submission was shed at the door: a budget high-water mark held
    for the whole backpressure window, the server is draining, or the
    ticket was cancelled while queued."""


class DeadlineExceeded(AdmissionRejected):
    """A submission's deadline expired while it waited for admission."""


class TicketCancelled(AdmissionRejected):
    """The client cancelled the ticket while it waited for admission."""


class AdmissionController:
    """Counting semaphore family with per-tenant shares and typed sheds.
    Both budgets must fit for a submission to be admitted; ``0``
    disables a budget."""

    def __init__(self, max_inflight: int | None = None,
                 max_tenant_inflight: int | None = None) -> None:
        self.max_inflight = _params.get("serve_max_inflight") \
            if max_inflight is None else max_inflight
        self.max_tenant_inflight = _params.get("serve_max_tenant_inflight") \
            if max_tenant_inflight is None else max_tenant_inflight
        self._cond = threading.Condition()
        self._inflight = 0
        self._tenant_inflight: dict[str, int] = {}
        self._closed = False
        self.admitted = 0
        self.rejected = 0
        self.shed_deadline = 0
        self.blocked_waits = 0

    def _fits_locked(self, tenant: str) -> bool:
        if self.max_inflight and self._inflight >= self.max_inflight:
            return False
        if self.max_tenant_inflight and \
                self._tenant_inflight.get(tenant, 0) >= \
                self.max_tenant_inflight:
            return False
        return True

    def _take_locked(self, tenant: str) -> None:
        self._inflight += 1
        self._tenant_inflight[tenant] = \
            self._tenant_inflight.get(tenant, 0) + 1
        self.admitted += 1

    def admit(self, tenant: str, *, block: bool = True,
              deadline_at: float | None = None,
              timeout: float | None = None, cancelled=None) -> None:
        """Admit or raise.  ``deadline_at`` is a ``time.monotonic()``
        instant; expiry while blocked sheds with :class:`DeadlineExceeded`.
        ``cancelled`` is an optional zero-arg probe the wait loop polls."""
        with self._cond:
            if self._closed:
                self.rejected += 1
                raise AdmissionRejected("admission closed (server draining)")
            if deadline_at is not None and time.monotonic() >= deadline_at:
                self.shed_deadline += 1
                raise DeadlineExceeded(
                    f"deadline already expired at admission "
                    f"(tenant {tenant!r})")
            if self._fits_locked(tenant):
                self._take_locked(tenant)
                return
            if not block:
                self.rejected += 1
                raise AdmissionRejected(
                    f"admission budget exceeded for tenant {tenant!r} "
                    f"(inflight={self._inflight}/{self.max_inflight or '∞'},"
                    f" tenant={self._tenant_inflight.get(tenant, 0)}/"
                    f"{self.max_tenant_inflight or '∞'})")
            if timeout is None:
                timeout = _params.get("serve_admission_timeout")
            limit = time.monotonic() + timeout
            if deadline_at is not None:
                limit = min(limit, deadline_at)
            self.blocked_waits += 1
            while True:
                if self._closed:
                    self.rejected += 1
                    raise AdmissionRejected(
                        "admission closed (server draining)")
                if cancelled is not None and cancelled():
                    self.rejected += 1
                    raise TicketCancelled("ticket cancelled while queued")
                if deadline_at is not None and \
                        time.monotonic() >= deadline_at:
                    self.shed_deadline += 1
                    raise DeadlineExceeded(
                        f"deadline expired after waiting for admission "
                        f"(tenant {tenant!r})")
                if self._fits_locked(tenant):
                    self._take_locked(tenant)
                    return
                rem = limit - time.monotonic()
                if rem <= 0:
                    self.rejected += 1
                    raise AdmissionRejected(
                        f"admission wait timed out after {timeout}s "
                        f"(tenant {tenant!r})")
                self._cond.wait(rem)

    def release(self, tenant: str) -> None:
        with self._cond:
            self._inflight -= 1
            n = self._tenant_inflight.get(tenant, 0) - 1
            if n <= 0:
                self._tenant_inflight.pop(tenant, None)
            else:
                self._tenant_inflight[tenant] = n
            self._cond.notify_all()

    def kick(self) -> None:
        """Wake blocked submitters so they re-check cancel/close probes."""
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        """Stop admitting (drain): blocked submitters shed immediately."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def stats(self) -> dict:
        with self._cond:
            return {
                "inflight": self._inflight,
                "per_tenant_inflight": dict(self._tenant_inflight),
                "admitted": self.admitted,
                "rejected": self.rejected,
                "shed_deadline": self.shed_deadline,
                "blocked_waits": self.blocked_waits,
                "closed": self._closed,
            }

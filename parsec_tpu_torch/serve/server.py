"""The persistent runtime server: a long-lived hot Context serving
concurrent DAG submissions.

Port of ``parsec_tpu/serve/server.py``.  :class:`RuntimeServer` keeps
one Context's workers running and gives every client thread::

    server = RuntimeServer(nb_cores=2, tenant_weights={"pro": 4.0})
    ticket = server.submit(taskpool, tenant="pro", priority=1,
                           deadline=0.5)
    result = ticket.result(timeout=30)     # this submission only
    stream = server.submit_stream(prompt, max_new_tokens=64)
    tokens = stream.result(timeout=60)["tokens"]
    server.drain(timeout=60)               # stop admitting, finish, fini

- **Ticket**: per-submission completion promise, resolved by the pool's
  own termination detection, not a context drain.
- **Admission**: :class:`~parsec_tpu_torch.serve.admission
  .AdmissionController` budgets, blocking backpressure or typed shed.
- **Fairness**: :class:`~parsec_tpu_torch.serve.fair.FairScheduler` wraps
  the context's scheduler.
- **Streams**: :meth:`RuntimeServer.submit_stream` opens an LLM
  generation stream on the server's continuous batcher
  (:mod:`parsec_tpu_torch.llm.batcher`), which decodes on the card.

Left out: ``submit_lowered`` (the lowering itself is ported,
:func:`~parsec_tpu_torch.ptg.lowering.lower_taskpool`; the server's
entry for lowered pools and its lowering cache are not), the
task-budget admission cost (see :mod:`.admission`), spans, the serving
PINS events (``SERVE_*``; the port's PINS fires from the runtime the
server drives), the flight recorder's stall section, the SLO metrics plane
(``metrics()``) and the tuning-DB consult.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from ..core.future import Future
from ..core.params import params as _params
from ..runtime.context import Context, ContextWaitTimeout
from ..runtime.taskpool import Taskpool
from .admission import (AdmissionController, AdmissionRejected,
                        TicketCancelled)
from .fair import FairScheduler

_params.register("serve_num_cores", 2,
                 "worker threads a RuntimeServer's context runs with "
                 "(serving requires >= 1: clients block on tickets, not "
                 "on driving progress)")


class _Submission:
    """The per-submission record the fair scheduler keys on
    (``taskpool._serve_sub``)."""

    __slots__ = ("tenant", "priority", "deadline_at", "ticket",
                 "result_fn", "released")

    def __init__(self, tenant: str, priority: int,
                 deadline_at: float | None, ticket: "Ticket",
                 result_fn: Callable[[Taskpool], Any] | None) -> None:
        self.tenant = tenant
        self.priority = priority
        self.deadline_at = deadline_at
        self.ticket = ticket
        self.result_fn = result_fn
        self.released = False


class Ticket:
    """A submission's handle: state, timing, and a single-assignment
    result future.  States walk ``queued`` -> ``running`` -> ``done`` /
    ``failed``, or end early at ``rejected`` / ``cancelled``."""

    def __init__(self, server: "RuntimeServer", name: str, tenant: str,
                 priority: int, deadline_at: float | None) -> None:
        self._server = server
        self.name = name
        self.tenant = tenant
        self.priority = priority
        self.deadline_at = deadline_at
        self.state = "queued"
        self.deadline_missed = False
        self.submitted_at = time.monotonic()
        self.started_at: float | None = None
        self.completed_at: float | None = None
        self._future = Future()
        self._slock = threading.Lock()
        self._settled = False
        self._cancelled = False

    def result(self, timeout: float | None = None) -> Any:
        """Block for THIS submission's completion.  Raises the stored
        failure for failed/rejected/cancelled tickets; ``TimeoutError``
        on deadline."""
        kind, v = self._future.get(timeout)
        if kind == "err":
            raise v
        return v

    def done(self) -> bool:
        return self._future.is_ready()

    def cancel(self) -> bool:
        """Cancel while still queued for admission; ``False`` once the
        submission started (a live DAG cannot be unpicked) or ended."""
        with self._slock:
            if self._settled:
                return self.state == "cancelled"
            if self.state != "queued":
                return False
            self._cancelled = True
        self._server._adm.kick()
        return True

    @property
    def latency_s(self) -> float | None:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def _commit_start(self) -> bool:
        """queued -> running, serialized against :meth:`cancel`."""
        with self._slock:
            if self._cancelled or self._settled:
                return False
            self.state = "running"
            return True

    def _resolve(self, value: Any) -> bool:
        """True iff THIS call settled the ticket (exactly once)."""
        with self._slock:
            if self._settled:
                return False
            self._settled = True
            self.state = "done"
        self.completed_at = time.monotonic()
        if self.deadline_at is not None and \
                self.completed_at > self.deadline_at:
            self.deadline_missed = True
        self._future.set(("ok", value))
        return True

    def _fail(self, exc: BaseException, state: str = "failed") -> bool:
        with self._slock:
            if self._settled:
                return False
            self._settled = True
            self.state = state
        self.completed_at = time.monotonic()
        self._future.set(("err", exc))
        return True


class RuntimeServer:
    """A resident runtime accepting concurrent taskpool submissions.
    Construction starts the context's workers; the server is hot until
    :meth:`drain`.  Usable as a context manager (``__exit__`` drains)."""

    def __init__(self, nb_cores: int | None = None,
                 scheduler: str | None = None,
                 tenant_weights: dict[str, float] | None = None,
                 admission: AdmissionController | None = None) -> None:
        if nb_cores is None:
            nb_cores = _params.get("serve_num_cores")
        if nb_cores < 1:
            raise ValueError(
                "RuntimeServer needs worker threads (nb_cores >= 1): "
                "clients block on tickets, nobody drives a caller-driven "
                "context")
        self._ctx = Context(nb_cores=nb_cores, scheduler=scheduler)
        # interpose the fair shim before the workers pass the start
        # barrier; they resolve context.scheduler per select call
        self._fair = FairScheduler(self._ctx.scheduler)
        self._ctx.scheduler = self._fair
        for tenant, w in (tenant_weights or {}).items():
            self._fair.set_weight(tenant, w)
        self._adm = admission if admission is not None \
            else AdmissionController()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight: set[Ticket] = set()
        self._draining = False
        self._drained = threading.Event()
        self._poison: BaseException | None = None
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.per_tenant_completed: dict[str, int] = {}
        self._llm: Any = None        # lazy ContinuousBatcher (submit_stream)
        self._ctx.add_failure_listener(self._on_context_failure)
        self._ctx.start()

    # -- submission ------------------------------------------------------
    def submit(self, tp: Taskpool, *, tenant: str = "default",
               priority: int = 0, deadline: float | None = None,
               block: bool = True, compiled: bool = False,
               result_fn: Callable[[Taskpool], Any] | None = None
               ) -> Ticket:
        """Submit one taskpool; returns its :class:`Ticket`.

        ``priority`` ranks within the tenant (higher first);
        ``deadline`` is a relative budget in seconds — expiry while
        queued for admission sheds, expiry after start only flags
        ``ticket.deadline_missed``.  ``block`` picks backpressure vs
        immediate shed.  ``result_fn(tp)`` computes the ticket's value at
        completion (default: the taskpool).

        Served pools run the dynamic scheduler path by default, so the
        weighted-fair shim interleaves tenants task by task;
        ``compiled=True`` lets a host pool take the compiled-DAG
        executor (the least per-task cost, but the whole pool dispatches
        as one unit the fair shim cannot see into)."""
        deadline_at = None if deadline is None \
            else time.monotonic() + deadline
        ticket = Ticket(self, tp.name, tenant, priority, deadline_at)
        with self._lock:
            self.submitted += 1
            closed = self._draining or self._poison is not None
        try:
            if closed:
                raise AdmissionRejected(
                    "server is draining" if self._poison is None
                    else "server context is poisoned")
            self._adm.admit(tenant, block=block,
                            deadline_at=deadline_at,
                            cancelled=lambda: ticket._cancelled)
        except AdmissionRejected as e:
            with self._lock:
                self.rejected += 1
            ticket._fail(e, state="cancelled"
                         if isinstance(e, TicketCancelled) else "rejected")
            raise
        sub = _Submission(tenant, priority, deadline_at, ticket, result_fn)
        tp._serve_sub = sub
        if not compiled:
            tp._serve_no_dag = True     # dagrun.compile_taskpool_dag gate
        # check-and-register atomically: a drain that began while this
        # thread sat in admit() either sees the ticket in flight (and
        # waits for it) or sheds it here
        started = ticket._commit_start()
        with self._lock:
            closed = self._draining or self._poison is not None
            if started and not closed:
                self._inflight.add(ticket)
            else:
                self.rejected += 1
        if not started or closed:
            self._adm.release(tenant)
            e: AdmissionRejected = TicketCancelled(
                "ticket cancelled before start") if not started \
                else AdmissionRejected("server is draining")
            ticket._fail(e, state="cancelled" if not started
                         else "rejected")
            raise e
        ticket.started_at = time.monotonic()
        # listener BEFORE enqueue: a trivial pool may terminate inside
        # add_taskpool and must still resolve the ticket
        tp.add_completion_listener(self._on_pool_done)
        try:
            self._ctx.add_taskpool(tp)
        except BaseException as e:
            self._release_once(sub)
            with self._lock:
                self._inflight.discard(ticket)
                self.rejected += 1
                self._cond.notify_all()
            ticket._fail(e, state="rejected")
            raise
        return ticket

    def _release_once(self, sub: _Submission) -> bool:
        """Release a submission's admission budget exactly once."""
        with self._lock:
            if sub.released:
                return False
            sub.released = True
        self._adm.release(sub.tenant)
        return True

    def submit_stream(self, prompt_tokens, *, max_new_tokens: int = 16,
                      tenant: str = "default", priority: int = 0,
                      eos: int | None = None, fork_from=None):
        """Open an LLM generation stream on this server's continuous
        batcher (created at the first call; it decodes on the card and
        raises when there is none).  ``eos`` stops generation when
        sampled; ``fork_from`` names an earlier stream's ticket with the
        same prompt, whose prompt KV the new stream shares copy-on-write.
        Returns a :class:`~parsec_tpu_torch.llm.batcher.StreamTicket`."""
        with self._lock:
            if self._draining or self._poison is not None:
                raise AdmissionRejected(
                    "server is draining" if self._poison is None
                    else "server context is poisoned")
            if self._llm is None:
                from ..llm.batcher import ContinuousBatcher
                self._llm = ContinuousBatcher(self)
            llm = self._llm
        return llm.submit_stream(prompt_tokens,
                                 max_new_tokens=max_new_tokens,
                                 tenant=tenant, priority=priority,
                                 eos=eos, fork_from=fork_from)

    # -- completion / failure -------------------------------------------
    def _on_pool_done(self, tp: Taskpool) -> None:
        sub: _Submission = tp._serve_sub
        tp._serve_sub = None
        self._release_once(sub)
        ok = False
        try:
            value = sub.result_fn(tp) if sub.result_fn is not None else tp
        except BaseException as e:       # a result_fn bug fails ONE ticket
            settled = sub.ticket._fail(e)
        else:
            settled = ok = sub.ticket._resolve(value)
        with self._lock:
            self._inflight.discard(sub.ticket)
            if ok:
                self.completed += 1
                self.per_tenant_completed[sub.tenant] = \
                    self.per_tenant_completed.get(sub.tenant, 0) + 1
            elif settled:
                self.failed += 1
            self._cond.notify_all()

    def _on_context_failure(self, e: BaseException) -> None:
        """Context poison (a worker died): fail every in-flight ticket so
        no client blocks forever, and stop admitting."""
        self._adm.close()
        with self._lock:
            self._poison = e
            pending = list(self._inflight)
            self._inflight.clear()
            self._cond.notify_all()
        nfailed = 0
        for tk in pending:
            err = RuntimeError(
                f"runtime context failed while serving {tk.name!r}")
            err.__cause__ = e
            nfailed += tk._fail(err)
        with self._lock:
            self.failed += nfailed

    # -- lifecycle -------------------------------------------------------
    def drain(self, timeout: float | None = None) -> None:
        """Graceful shutdown: let the live streams finish, stop
        admitting, let in-flight submissions finish, then ``fini`` the
        context.  On ``timeout`` the remaining tickets fail with
        :class:`ContextWaitTimeout` and the context tears down
        abort-style — the server is down either way."""
        with self._lock:
            llm = self._llm
        if llm is not None:
            llm.stop(timeout=timeout)
        with self._lock:
            first = not self._draining
            self._draining = True
        if not first:
            if not self._drained.wait(timeout):
                raise ContextWaitTimeout(
                    "concurrent drain still in progress")
            return
        self._adm.close()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            ok = self._cond.wait_for(
                lambda: not self._inflight,
                None if deadline is None
                else max(0.0, deadline - time.monotonic()))
            leftover = [] if ok else list(self._inflight)
            self._inflight.clear()
        nfailed = 0
        for tk in leftover:
            nfailed += tk._fail(ContextWaitTimeout(
                f"server drain timed out with {tk.name!r} still in flight"))
        with self._lock:
            self.failed += nfailed
        rem = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        try:
            self._ctx.fini(timeout=rem)
        finally:
            self._drained.set()
        if leftover:
            raise ContextWaitTimeout(
                f"server drain timed out ({len(leftover)} submissions "
                f"still in flight)")

    def __enter__(self) -> "RuntimeServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        if exc[0] is None:
            self.drain()
            return
        # exception-path teardown: fail every in-flight ticket first, so
        # a client blocked in result() gets a prompt error
        self._on_context_failure(
            exc[1] if exc[1] is not None else RuntimeError("server aborted"))
        with self._lock:
            self._draining = True
            llm = self._llm
        if llm is not None:
            llm.stop(timeout=5.0)
        self._ctx.abort()
        self._drained.set()

    # -- introspection ---------------------------------------------------
    @property
    def context(self) -> Context:
        return self._ctx

    def stats(self) -> dict:
        with self._lock:
            llm = self._llm
        extra = {"llm": llm.stats()} if llm is not None else {}
        with self._lock:
            return {
                **extra,
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "inflight": len(self._inflight),
                "draining": self._draining,
                "poisoned": self._poison is not None,
                "per_tenant_completed": dict(self.per_tenant_completed),
                "fair_dispatched": self._fair.dispatch_counts(),
                "admission": self._adm.stats(),
            }

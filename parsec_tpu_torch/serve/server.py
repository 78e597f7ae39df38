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
- **Observability**: every stage fires a ``SERVE_*`` PINS event
  (SUBMIT, ADMIT, REJECT, START, COMPLETE, DRAIN), so the flight
  recorder and ``runtime_report()``'s ``serve`` block cover serving.
  Each ticket mints a trace (:func:`~parsec_tpu_torch.prof.spans
  .new_trace`) that rides its pool as ``tp._trace``, so the task-grain
  and wire spans of a request carry its id; with ``prof_spans`` on the
  server also records ``serve.admission`` and ``serve.request``.  The
  per-tenant SLO plane (:class:`~parsec_tpu_torch.prof.histogram
  .SLOPlane`) holds ``admission_wait_ms``, ``queue_wait_ms``,
  ``latency_ms`` and the ``admission_sheds`` counter (the batcher adds
  ``ttft_ms`` and ``tok_latency_ms``, and ``drain_ms`` lands under
  ``_server``); :meth:`RuntimeServer.metrics` reads it live.  A stall
  section names each tenant's inflight count and oldest trace in the
  flight recorder's stall dump.

Left out: ``submit_lowered`` (the lowering itself is ported,
:func:`~parsec_tpu_torch.ptg.lowering.lower_taskpool`; the server's
entry for lowered pools and its lowering cache are not), the
task-budget admission cost (see :mod:`.admission`), a caller's own
``context=`` and the tuning-DB consult.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable

from ..core.future import Future
from ..core.params import params as _params
from ..prof import flight_recorder as _flightrec
from ..prof import pins, spans as _spans
from ..prof.histogram import SLOPlane
from ..prof.pins import PinsEvent
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
        self.admitted_at: float | None = None
        self.started_at: float | None = None
        self.completed_at: float | None = None
        # the request's trace context: minted at submit, attached to the
        # taskpool, carried across ranks by the wire
        self.trace = _spans.new_trace()
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
        # the per-tenant SLO plane: queue wait, latency, admission here;
        # the batcher adds TTFT and inter-token latency
        self._slo = SLOPlane()
        self._drain_s: float | None = None
        # stall dumps name WHOSE request is stuck, through a weakref: the
        # global registry must never keep a leaked server alive
        self._stall_key = f"serve@{id(self):x}"
        ref = weakref.ref(self)

        def _section() -> dict:
            srv = ref()
            return srv._stall_section() if srv is not None else {}

        _flightrec.register_stall_section(self._stall_key, _section)
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
        pins.fire(PinsEvent.SERVE_SUBMIT, None, (tenant, tp.name))
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
            pins.fire(PinsEvent.SERVE_REJECT, None, (tenant, tp.name))
            with self._lock:
                self.rejected += 1
            if not isinstance(e, TicketCancelled):
                # a client's cancel is not a shed: the counter attributes
                # controller and drain pressure only
                self._slo.inc(tenant, "admission_sheds")
            ticket._fail(e, state="cancelled"
                         if isinstance(e, TicketCancelled) else "rejected")
            raise
        pins.fire(PinsEvent.SERVE_ADMIT, None, (tenant, tp.name))
        ticket.admitted_at = time.monotonic()
        wait_s = ticket.admitted_at - ticket.submitted_at
        self._slo.observe(tenant, "admission_wait_ms", wait_s * 1e3)
        r = _spans.recorder
        if r is not None:
            t1 = time.perf_counter_ns()
            r.record("serve.admission", ticket.trace.trace_id,
                     t1 - int(wait_s * 1e9), t1, tenant=tenant)
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
            if started:
                # shed by the drain window; not started is a client cancel
                self._slo.inc(tenant, "admission_sheds")
            pins.fire(PinsEvent.SERVE_REJECT, None, (tenant, tp.name))
            e: AdmissionRejected = TicketCancelled(
                "ticket cancelled before start") if not started \
                else AdmissionRejected("server is draining")
            ticket._fail(e, state="cancelled" if not started
                         else "rejected")
            raise e
        # START before enqueue, as the listener: a pool that terminates
        # inside add_taskpool still records SUBMIT, ADMIT, START, COMPLETE
        pins.fire(PinsEvent.SERVE_START, None, (tenant, tp.name))
        ticket.started_at = time.monotonic()
        # the request's trace rides the pool: the task-grain spans and
        # the wire key off tp._trace from here on
        tp._trace = ticket.trace
        if _spans.recorder is not None:
            tp._trace_enq_ns = time.perf_counter_ns()
        tp.add_completion_listener(self._on_pool_done)
        try:
            self._ctx.add_taskpool(tp)
        except BaseException as e:
            self._release_once(sub)
            with self._lock:
                self._inflight.discard(ticket)
                self.rejected += 1
                self._cond.notify_all()
            pins.fire(PinsEvent.SERVE_REJECT, None, (tenant, tp.name))
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
        if self._release_once(sub):
            # only the releasing call announces completion: a pool whose
            # enqueue already shed (and released) reports no COMPLETE
            pins.fire(PinsEvent.SERVE_COMPLETE, None, (sub.tenant, tp.name))
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
        tk = sub.ticket
        if ok and tk.completed_at is not None:
            # the request's samples: submit -> start, and end to end
            if tk.started_at is not None:
                self._slo.observe(sub.tenant, "queue_wait_ms",
                                  (tk.started_at - tk.submitted_at) * 1e3)
            lat = tk.completed_at - tk.submitted_at
            self._slo.observe(sub.tenant, "latency_ms", lat * 1e3)
            r = _spans.recorder
            if r is not None:
                t1 = time.perf_counter_ns()
                r.record("serve.request", tk.trace.trace_id,
                         t1 - int(lat * 1e9), t1, tenant=sub.tenant,
                         args={"pool": tp.name})

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
        t_drain0 = time.monotonic()
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
        pins.fire(PinsEvent.SERVE_DRAIN, None,
                  ("-", f"inflight={len(leftover)}"))
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
            self._drained.set()     # the server is down, success or not
            self._drain_s = time.monotonic() - t_drain0
            self._slo.observe("_server", "drain_ms", self._drain_s * 1e3)
            _flightrec.unregister_stall_section(self._stall_key)
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
        _flightrec.unregister_stall_section(self._stall_key)

    # -- introspection ---------------------------------------------------
    @property
    def context(self) -> Context:
        return self._ctx

    def metrics(self) -> dict:
        """The live per-tenant SLO snapshot: ``{"tenants": {tenant:
        {"<metric>_p50", "<metric>_p99", "<metric>_count", "<counter>"}},
        "inflight", "drain_s", "admission"}``, plus a compact
        ``critpath`` block while the span recorder holds spans.  Callable
        mid-run: histograms are read without a lock (a racing record at
        worst misses this snapshot)."""
        with self._lock:
            inflight = len(self._inflight)
        out = {
            "tenants": self._slo.summary(),
            "inflight": inflight,
            "drain_s": self._drain_s,
            "admission": self._adm.stats(),
        }
        if _spans.recorder is not None and _spans.recorder.spans:
            from ..prof.critpath import summarize_recorder
            cp = summarize_recorder(compact=True)
            if cp:
                out["critpath"] = cp
        return out

    def _stall_section(self) -> dict:
        """Per-tenant inflight counts and the oldest live request's trace
        id: the stall dump's block that names whose request is stuck."""
        with self._lock:
            tickets = list(self._inflight)
        now = time.monotonic()
        out: dict[str, dict] = {}
        for tk in tickets:
            d = out.setdefault(tk.tenant, {"inflight": 0,
                                           "oldest_trace_id": None,
                                           "oldest_age_s": -1.0,
                                           "oldest_pool": None})
            d["inflight"] += 1
            age = now - tk.submitted_at
            if age > d["oldest_age_s"]:
                d.update(oldest_trace_id=format(tk.trace.trace_id, "x"),
                         oldest_age_s=round(age, 3), oldest_pool=tk.name)
        return out

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

"""The runtime context: worker threads, scheduler, lifecycle.

Port of ``parsec_tpu/runtime/context.py`` (the reference's
``parsec_context_t`` with ``parsec_init`` / ``parsec_fini`` and the
enqueue/start/wait API): a context owns one virtual process of execution
streams (worker threads), the LFQ scheduler, the device registry and the
dependency-tracking table.  Workers park on a start barrier until
``start`` releases them.  ``nb_cores=0`` is caller-driven: the thread in
``wait()`` runs the scheduling loop itself (the master-thread funneled
mode the device manager favours).

A failure in a worker, in the caller-driven loop or in the device
manager poisons the context (:meth:`record_failure`), fires the failure
listeners (the serving layer fails its in-flight tickets from there) and
surfaces from ``wait()``; ``fini()`` re-raises a failure no caller has
seen yet.  :meth:`add_taskpool` is live: it may be called from any thread
while the workers run.

**Compiled incarnation.**  At enqueue, an enumerable single-rank PTG
pool of host chores is compiled to the native DAG executor
(:mod:`.dagrun`, the ``runtime_dag_compile`` param); such a pool skips
the scheduler.  One thread claims it and drives it: the waiter, or an
idle worker.  A deadline leaves it unclaimed and resumable; a body's
exception poisons the context and retires the pool's task count, so
``fini`` does not wait on it.

**Several ranks.**  ``Context(nb_ranks=N, my_rank=r)`` is rank r of N
(one context per rank; :func:`parsec_tpu_torch.comm.run_multirank` runs
them as threads of one process).  A pool enqueued on the wire takes the
next rank-agreed ``comm_id`` (every rank enqueues its pools in the same
order), so activation messages name it; a ``local_only`` pool takes none
and stays off the wire.  The comm engine a
:class:`~parsec_tpu_torch.comm.remote_dep.RemoteDepEngine` installs as
``comm_engine`` is enabled by :meth:`start`, progressed by the idle
worker of stream 0 (and by a busy one while fragments are in flight) or
by the caller-driven loop, and finalized by :meth:`fini`;
:meth:`comm_barrier` fences until the fabric is silent, and the release
path reaches it through :meth:`remote_dep_accumulate` /
:meth:`remote_dep_activate`.  The detector of a pool is its own
``termdet_name``, else the ``termdet`` param (``local`` when empty); a
rank-private pool always takes ``local``.

**Enqueue gate.**  Under the ``analysis_check`` param,
:meth:`add_taskpool` verifies a PTG pool with
:func:`~parsec_tpu_torch.analysis.graphcheck.check_taskpool` before any
side effect: a malformed graph raises
:class:`~parsec_tpu_torch.analysis.graphcheck.GraphCheckError` and leaves
the context as it was.  A DTD pool is empty at enqueue; it is checked at
``close()``.

**PINS.**  A context holds the PINS modules the ``pins`` param names
from its construction to :meth:`abort` (which :meth:`fini` calls)
(:func:`~parsec_tpu_torch.prof.acquire_pins_modules`), and fires
``TASKPOOL_INIT`` at enqueue and ``TASKPOOL_FINI`` at a pool's
termination.

**Observability.**  Construction installs the always-on flight
recorder (:mod:`~parsec_tpu_torch.prof.flight_recorder`, unless
``prof_flightrec_size`` is 0) and, under ``prof_spans``, the span
recorder, both before any worker runs.  A :meth:`wait` whose deadline
passes writes one stall dump (``prof_stall_dump``; stderr and
``flightrec-<rank>.json`` under ``prof_flightrec_dir``) and then raises
:class:`ContextWaitTimeout`; a :meth:`fini` whose bounded drain times
out dumps unless that wait already did, and tears down.  The report is
kept in ``last_stall_report``.  The context publishes its gauges
(``sched_pending``, ``active_taskpools``, ``nb_tasks``, ``sde``) under
the ``rank<r>`` namespace of the live properties, streams them to the
``props_stream`` file and starts the metrics snapshotter
(``prof_snapshot_interval``) at :meth:`start`.

**Tuned knobs.**  Construction consults the tuning DB's ambient
``context`` vector (:func:`parsec_tpu_torch.tune.apply_ambient`, under
``tune_db``) and applies it before anything reads those params;
``tuned_knobs`` holds what was applied (None on a miss).

Left out: multiple virtual processes and vpmaps, thread binding and
``wait_taskpool``.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable

from ..core.backoff import Backoff
from ..core.params import params as _params
from ..prof import (acquire_pins_modules, flight_recorder, pins,
                    release_pins_modules, spans)
from ..prof.counters import properties, sde
from ..prof.pins import PinsEvent
from ..sched import open_scheduler
from .dagrun import compile_taskpool_dag
from .deps import DependencyTracking
from .scheduling import (ExecutionStream, VirtualProcess, schedule_tasks,
                         select_task, task_progress)
from .taskpool import Taskpool
from .termdet import open_termdet

# the runtime lint's contract (analysis/runtimelint.py); ``_cond`` wraps
# ``_lock``, so holding either is holding both
_LOCK_PROTECTED = {
    "Context._active_taskpools": "_lock",
    "Context._tp_by_comm_id": "_lock",
    "Context._next_comm_id": "_lock",
    "Context._failure_listeners": "_lock",
    "Context._worker_error": "_lock",
    "Context._shutdown": "_lock",
}
_LOCK_ALIASES = {"_cond": "_lock"}
_LOCK_ORDER = ("_submit_lock", "_lock")

_params.register("runtime_num_cores", 0, "worker threads (0 = caller-driven)")
_params.register("sched", "lfq", "scheduler module to use")
# the autotuner's declared domain: the general-purpose scheduler modules
# (serve_fair is the shim a RuntimeServer interposes, never a move)
_params.declare_knob("sched", values=("lfq", "ap", "spq", "ip", "gd",
                                      "rnd", "ll", "llp", "pbq", "ltq",
                                      "lhq"))
_params.register("analysis_check", False,
                 "statically verify each PTG taskpool at enqueue "
                 "(analysis.graphcheck) and each DTD pool at close(): a "
                 "malformed graph raises GraphCheckError")
_params.register("props_stream", "",
                 "stream the live properties to this JSON file while a "
                 "context runs (python -m parsec_tpu_torch.prof.dashboard "
                 "renders it; empty = off)")
_params.register("props_stream_interval", 0.1,
                 "seconds between props_stream snapshots")


class ContextWaitTimeout(TimeoutError):
    """Deadline expiry of a bounded :meth:`Context.wait` / :meth:`fini`."""


class Context:
    def __init__(self, nb_cores: int | None = None,
                 scheduler: str | None = None, nb_ranks: int = 1,
                 my_rank: int = 0) -> None:
        from ..device.device import registry as device_registry
        # the flight recorder hooks every PINS slot, and a traced pool's
        # first task needs the span recorder, before any worker can fire
        flight_recorder.ensure_installed()
        spans.ensure_installed()
        # the persisted tuning vector (``tune_db``): the ambient
        # ``context`` consult applies a stored knob vector NOW, before the
        # core count and the scheduler below resolve the params it may
        # set; an operator's env value always wins, and a DB that fails
        # never fails a start
        try:
            from ..tune import apply_ambient
            self.tuned_knobs = apply_ambient("context")
        except Exception:               # noqa: BLE001 — advisory only
            self.tuned_knobs = None
        if nb_cores is None:
            nb_cores = _params.get("runtime_num_cores")
        if not 0 <= my_rank < nb_ranks:
            raise ValueError(f"rank {my_rank} outside [0, {nb_ranks})")
        self.nb_cores = nb_cores
        self.nb_ranks = nb_ranks
        self.my_rank = my_rank
        self.comm_engine: Any = None
        # rank-agreed wire ids: a monotonic counter (a live context
        # retires terminated pools, so a length-derived id would recycle);
        # the comm engine publishes pools here, and keeps terminated ones
        # (late wire messages still resolve)
        self._tp_by_comm_id: dict[int, Taskpool] = {}
        self._next_comm_id = 0
        self.started = False
        self._shutdown = False
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._active_taskpools: list[Taskpool] = []
        self._submit_lock = threading.RLock()
        self._worker_error: BaseException | None = None
        self._error_surfaced = False
        self._failure_listeners: list[Callable[[BaseException], None]] = []
        self.deps = DependencyTracking()
        self.devices = device_registry

        nworkers = max(nb_cores, 0)
        vp = VirtualProcess(0, self)
        self.virtual_processes = [vp]
        self.streams: list[ExecutionStream] = []
        for i in range(max(nworkers, 1)):
            es = ExecutionStream(i if nworkers else -1, vp, self)
            vp.execution_streams.append(es)
            self.streams.append(es)
        # the stream external (non-worker) threads submit and progress on
        self._submit_es = self.streams[0] if nworkers == 0 else \
            ExecutionStream(-1, vp, self)

        self.scheduler = open_scheduler(scheduler or _params.get("sched"))
        self.scheduler.install(self)
        for es in self.streams:
            self.scheduler.flow_init(es)

        # the last step that can fail, before any thread starts
        self._pins_modules = acquire_pins_modules(self)
        self.last_stall_report: dict | None = None
        self._props_stop: Callable[[], None] | None = None
        self._snap_started = False
        # live gauges under a namespace of their own (several contexts of
        # one rank may live at once), held weakly: the registry must not
        # keep a context that never reaches fini() alive
        base = ns = f"rank{my_rank}"
        i = 1
        while properties.has(ns, "sched_pending"):
            ns = f"{base}#{i}"
            i += 1
        self._props_ns = ns
        ref = weakref.ref(self)

        def gauge(fn: Callable[["Context"], Any]) -> Callable[[], Any]:
            def get():
                c = ref()
                return fn(c) if c is not None else 0
            return get

        properties.register(ns, "sched_pending",
                            gauge(lambda c: c.scheduler.pending_tasks(c)))
        properties.register(ns, "active_taskpools",
                            gauge(lambda c: len(c._active_taskpools)))
        properties.register(ns, "nb_tasks", gauge(lambda c: sum(
            tp.tdm.nb_tasks for tp in list(c._active_taskpools)
            if tp.tdm is not None)))
        properties.register(ns, "sde", sde.snapshot)

        self._threads: list[threading.Thread] = []
        self._start_barrier = threading.Event()
        for es in self.streams[:nworkers]:
            t = threading.Thread(target=self._worker_main, args=(es,),
                                 name=f"parsec-es{es.th_id}", daemon=True)
            self._threads.append(t)
            t.start()

    # ------------------------------------------------------------------ API
    def add_taskpool(self, tp: Taskpool, local_only: bool = False) -> None:
        """Enqueue a taskpool; thread-safe, and live while workers run.
        ``local_only`` marks a rank-private pool: no comm id, the local
        detector, so ranks may enqueue different numbers of them.  Under
        ``analysis_check`` a PTG pool is verified first, and a malformed
        one raises ``GraphCheckError`` before any side effect."""
        with self._submit_lock:
            if _params.get("analysis_check"):
                from ..ptg.dsl import PTGTaskpool
                if isinstance(tp, PTGTaskpool):
                    from ..analysis import check_taskpool
                    check_taskpool(tp, nb_ranks=self.nb_ranks,
                                   raise_on_error=True)
            tp.context = self
            tp.local_only = local_only = tp.local_only or local_only
            pins.fire(PinsEvent.TASKPOOL_INIT, None, tp)
            if tp.tdm is None:
                # rank-private forces local > the pool's own > the param
                name = "local" if local_only else \
                    (tp.termdet_name or _params.get("termdet") or "local")
                tp.tdm = open_termdet(name, self)
            tp.tdm.monitor_taskpool(tp, tp.terminated)
            with self._lock:
                self._active_taskpools.append(tp)
                if not local_only:
                    self._next_comm_id += 1
                    tp.comm_id = self._next_comm_id
            dag = compile_taskpool_dag(tp, self)
            if dag is not None:
                # count BEFORE publishing: an idle worker may claim and
                # finish the dag the instant it is visible, and its
                # -ntasks must not land on a zero counter
                tp.tdm.taskpool_addto_nb_tasks(dag.ntasks)
                tp.tdm.ready()
                tp._compiled_dag = dag
                self._publish(tp)
                with self._cond:
                    self._cond.notify_all()   # wake a mid-wait driver
                return
            n = tp.nb_local_tasks()
            if n >= 0:
                tp.tdm.taskpool_addto_nb_tasks(n)
            startup = tp.startup(self)
            tp.tdm.ready()
            self._publish(tp)
            if startup:
                schedule_tasks(self._submit_es, list(startup), 0)

    def _publish(self, tp: Taskpool) -> None:
        """Make a counted pool reachable by its comm id.  The comm engine
        publishes it under its own lock and replays the activations and
        wave tokens that arrived first: an activation released before the
        pool's tasks were counted would drive its counter negative."""
        if tp.comm_id is not None and self.comm_engine is not None:
            self.comm_engine.taskpool_registered(tp)

    def record_failure(self, e: BaseException) -> None:
        """Record a fatal background failure (first one wins) and wake
        every waiter."""
        with self._lock:
            if self._worker_error is None:
                self._worker_error = e
            self._cond.notify_all()
            listeners = list(self._failure_listeners)
        for cb in listeners:            # outside the lock: a listener may
            try:                        # fail tickets and take its locks
                cb(e)
            except Exception:           # noqa: BLE001 — never mask poison
                pass

    def add_failure_listener(
            self, cb: Callable[[BaseException], None]) -> None:
        """Observe context poison.  Fires immediately if the context is
        already poisoned."""
        with self._lock:
            err = self._worker_error
            if err is None:
                self._failure_listeners.append(cb)
                return
        cb(err)

    def start(self) -> None:
        with self._lock:
            self.started = True
        path = _params.get("props_stream")
        if path and self._props_stop is None:
            self._props_stop = properties.stream_to(
                path, _params.get("props_stream_interval"))
        interval = _params.get("prof_snapshot_interval")
        if interval > 0 and not self._snap_started:
            flight_recorder.snapshotter.start(interval)
            self._snap_started = True
        if self.comm_engine is not None:
            self.comm_engine.enable()
        self._start_barrier.set()
        with self._cond:
            self._cond.notify_all()

    def test(self) -> bool:
        with self._lock:
            return not self._active_taskpools

    def wait(self, timeout: float | None = None) -> None:
        """Block until every taskpool completes; raises the recorded
        failure if the context is poisoned.  At the deadline it writes
        the stall dump, then raises :class:`ContextWaitTimeout`."""
        try:
            self._drive_until(self.test, timeout)
        except ContextWaitTimeout:
            self._stall_dump(f"context wait timed out (timeout={timeout}s; "
                             f"{self._live_desc()})")
            raise

    def _stall_dump(self, reason: str) -> dict | None:
        if not _params.get("prof_stall_dump"):
            return None
        try:
            self.last_stall_report = flight_recorder.stall_dump(self, reason)
        except Exception:   # noqa: BLE001 — the dump never masks the timeout
            pass
        return self.last_stall_report

    def fini(self, timeout: float | None = None) -> None:
        """Drain (bounded by ``timeout``), stop the workers, release the
        scheduler.  A poisoned context skips the drain; a drain that
        times out writes the stall dump (unless a timed-out ``wait``
        already did) and tears down abort-style; a failure nobody has
        seen is re-raised after teardown."""
        if self._worker_error is None and not self.test():
            try:
                self._drive_until(self.test, timeout)
            except ContextWaitTimeout:
                # one diagnosis per stall: a caller whose wait() timed
                # out re-enters here with the expired deadline
                if self.last_stall_report is None:
                    self._stall_dump(
                        f"fini drain timed out (timeout={timeout}s)")
        self.abort()
        if self.comm_engine is not None:
            self.comm_engine.fini()
        if self._worker_error is not None and not self._error_surfaced:
            self._error_surfaced = True
            raise RuntimeError(
                "a background thread failed") from self._worker_error

    def abort(self) -> None:
        """Stop workers (and a comm thread) without draining."""
        with self._lock:
            self._shutdown = True
            self._cond.notify_all()
        self._start_barrier.set()
        for t in self._threads:
            t.join(timeout=5)
        if self.comm_engine is not None:
            self.comm_engine.stop_thread()
        self.scheduler.remove(self)
        held, self._pins_modules = self._pins_modules, ()
        release_pins_modules(held)
        self._props_teardown()

    def _props_teardown(self) -> None:
        if self._props_stop is not None:
            self._props_stop()
            self._props_stop = None
        if self._snap_started:
            flight_recorder.snapshotter.release()
            self._snap_started = False
        for name in ("sched_pending", "active_taskpools", "nb_tasks", "sde"):
            properties.unregister(self._props_ns, name)

    def __enter__(self) -> "Context":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.fini()
        else:
            self.abort()

    # ------------------------------------------------------- progress loops
    def _worker_main(self, es: ExecutionStream) -> None:
        es.owner_ident = threading.get_ident()
        self._start_barrier.wait()
        backoff = Backoff()
        while not self._shutdown:
            try:
                task, distance = select_task(es)
                ce = self.comm_engine
                if task is None:
                    # idle: claim a compiled-DAG pool if one waits
                    self._run_compiled_dags(es)
                    if ce is not None and es.th_id == 0:
                        ce.progress()
                    backoff.wait()
                    continue
                backoff.reset()
                task_progress(es, task, distance)
                # fragmented GETs in flight: a busy worker still advances
                # them between tasks (one int read when there are none)
                if ce is not None and es.th_id == 0 and ce.ce.frag_active:
                    ce.progress()
            except BaseException as e:   # surface to waiters, don't hang
                self.record_failure(e)
                return

    def _drive_until(self, predicate: Callable[[], bool],
                     timeout: float | None = None) -> None:
        """Progress from the calling thread until ``predicate`` holds.  A
        failure that escapes to the caller (other than the deadline) marks
        the recorded poison as surfaced."""
        try:
            self._drive_until_inner(predicate, timeout)
        except BaseException as e:
            if not isinstance(e, ContextWaitTimeout):
                self._error_surfaced = True
            raise

    def _drive_until_inner(self, predicate: Callable[[], bool],
                           timeout: float | None) -> None:
        if not self.started:
            self.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        if self._threads:
            while True:
                self._run_compiled_dags(deadline=deadline)
                with self._cond:
                    if self._worker_error is not None:
                        raise RuntimeError(
                            "a worker thread failed") from self._worker_error
                    if predicate():
                        return
                    rem = None if deadline is None else \
                        deadline - time.monotonic()
                    if rem is not None and rem <= 0:
                        raise ContextWaitTimeout(
                            f"context wait timed out ({self._live_desc()})")
                    # wake on termination, a worker error, or a freshly
                    # enqueued compiled pool that needs this driver
                    self._cond.wait_for(
                        lambda: predicate() or self._worker_error is not None
                        or self._has_pending_dag(), rem)
        self._run_compiled_dags(deadline=deadline)
        es = self._submit_es
        es.owner_ident = threading.get_ident()
        backoff = Backoff()
        while not predicate():
            if self._worker_error is not None:
                raise RuntimeError(
                    "a background thread failed") from self._worker_error
            if deadline is not None and time.monotonic() > deadline:
                raise ContextWaitTimeout(
                    f"context wait timed out ({self._live_desc()})")
            try:
                task, distance = select_task(es)
                ce = self.comm_engine
                if task is None:
                    # pools enqueued mid-drive
                    self._run_compiled_dags(deadline=deadline)
                    if ce is not None:
                        ce.progress()
                    if predicate():
                        return
                    backoff.wait()
                    continue
                backoff.reset()
                task_progress(es, task, distance)
                if ce is not None and ce.ce.frag_active:
                    ce.progress()
            except ContextWaitTimeout:
                raise    # deadline expiry is not a context poison
            except BaseException as e:
                # poison the context so a later fini() tears down instead
                # of re-draining a pool that can never complete
                self.record_failure(e)
                raise

    def _has_pending_dag(self) -> bool:
        """A compiled pool still waiting for a driver (a claimed pool's
        driver notifies on completion).  Binds each dag once: a driver
        may clear ``_compiled_dag`` concurrently."""
        return any(dag is not None and dag.pending
                   for dag in (getattr(tp, "_compiled_dag", None)
                               for tp in list(self._active_taskpools)))

    def _run_compiled_dags(self, es: ExecutionStream | None = None,
                           deadline: float | None = None) -> None:
        """Drive every compiled-DAG pool this thread can claim to its
        end.  A pool is funneled through one driver: Python bodies hold
        the GIL, so one driver loses nothing over the worker pool.  At a
        ``deadline`` the pool stays unclaimed and resumable, and
        :class:`ContextWaitTimeout` is raised; a failure is recorded
        before the pool's task count is retired."""
        with self._lock:
            pending = [tp for tp in self._active_taskpools
                       if getattr(tp, "_compiled_dag", None) is not None]
        for tp in pending:
            dag = getattr(tp, "_compiled_dag", None)
            if dag is None or not dag.claim():
                continue
            try:
                finished = dag.run(
                    es if es is not None else self._submit_es, deadline)
            except BaseException as e:
                # record BEFORE terminating the pool: a waiter woken by
                # the termination must see the error, not success
                self.record_failure(e)
                tp._compiled_dag = None
                tp.tdm.taskpool_addto_nb_tasks(-dag.ntasks)
                raise
            if not finished:
                # yielded: the deadline, or an all-AGAIN pass waiting on
                # another pool; the pool stays pending either way
                if deadline is not None and time.monotonic() > deadline:
                    raise ContextWaitTimeout(
                        f"context wait timed out ({self._live_desc()})")
                continue
            tp._compiled_dag = None
            tp.tdm.taskpool_addto_nb_tasks(-dag.ntasks)

    def _live_desc(self) -> str:
        with self._lock:
            pools = list(self._active_taskpools)
        return ", ".join(f"{tp.name}[nb_tasks={tp.tdm.snapshot()['nb_tasks']}]"
                         for tp in pools) or "no live taskpools"

    def _taskpool_terminated(self, tp: Taskpool) -> None:
        pins.fire(PinsEvent.TASKPOOL_FINI, None, tp)
        with self._lock:
            if tp in self._active_taskpools:
                self._active_taskpools.remove(tp)
            self._cond.notify_all()
        self.deps.purge_taskpool(tp.taskpool_id)

    # ------------------------------------------------------------ comm seams
    def comm_barrier(self) -> None:
        """Collective fence: progress until the fabric is globally silent.
        Needed before reading what a remote rank's write-back edge wrote
        under the local detector: local termination covers this rank's
        tasks and its own sends only."""
        if self.comm_engine is not None:
            self.comm_engine.quiesce()

    def remote_dep_accumulate(self, remote, task, flow, dep, succ_tc,
                              succ_locals, rank):
        if self.comm_engine is None:
            raise RuntimeError(
                f"rank {self.my_rank}: {task} has a successor on rank "
                f"{rank} but no comm engine is installed")
        return self.comm_engine.accumulate(remote, task, flow, dep, succ_tc,
                                           succ_locals, rank)

    def remote_dep_activate(self, es, task, remote) -> None:
        self.comm_engine.activate(es, task, remote)

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
manager poisons the context (:meth:`record_failure`) and surfaces from
``wait()``; ``fini()`` re-raises a failure no caller has seen yet.

Left out: the compiled-DAG incarnation, the comm engine and remote deps,
multiple virtual processes and vpmaps, thread binding, the flight
recorder and stall dump, live properties, tuned-knob consults and the
enqueue-time graph check.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from ..core.params import params as _params
from ..sched import open_scheduler
from .deps import DependencyTracking
from .scheduling import (ExecutionStream, VirtualProcess, schedule_tasks,
                         select_task, task_progress)
from .taskpool import Taskpool
from .termdet import LocalTermDet

_params.register("runtime_num_cores", 0, "worker threads (0 = caller-driven)")
_params.register("sched", "lfq", "scheduler module to use")


class ContextWaitTimeout(TimeoutError):
    """Deadline expiry of a bounded :meth:`Context.wait` / :meth:`fini`."""


class _Backoff:
    """Exponential backoff for idle workers (cf. ``utils/backoff.h``)."""

    def __init__(self, base_s: float = 1e-6, max_s: float = 2e-3) -> None:
        self.base_s, self.max_s, self._cur = base_s, max_s, 0.0

    def reset(self) -> None:
        self._cur = 0.0

    def wait(self) -> None:
        if self._cur == 0.0:
            self._cur = self.base_s
            return  # first miss: just yield
        time.sleep(self._cur)
        self._cur = min(self._cur * 2, self.max_s)


class Context:
    def __init__(self, nb_cores: int | None = None,
                 scheduler: str | None = None) -> None:
        from ..device.device import registry as device_registry
        if nb_cores is None:
            nb_cores = _params.get("runtime_num_cores")
        self.nb_cores = nb_cores
        self.nb_ranks = 1
        self.my_rank = 0
        self.started = False
        self._shutdown = False
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._active_taskpools: list[Taskpool] = []
        self._submit_lock = threading.RLock()
        self._worker_error: BaseException | None = None
        self._error_surfaced = False
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

        self._threads: list[threading.Thread] = []
        self._start_barrier = threading.Event()
        for es in self.streams[:nworkers]:
            t = threading.Thread(target=self._worker_main, args=(es,),
                                 name=f"parsec-es{es.th_id}", daemon=True)
            self._threads.append(t)
            t.start()

    # ------------------------------------------------------------------ API
    def add_taskpool(self, tp: Taskpool) -> None:
        """Enqueue a taskpool; thread-safe, and live while workers run."""
        with self._submit_lock:
            tp.context = self
            if tp.tdm is None:
                tp.tdm = LocalTermDet()
            tp.tdm.monitor_taskpool(tp, tp.terminated)
            with self._lock:
                self._active_taskpools.append(tp)
            n = tp.nb_local_tasks()
            if n >= 0:
                tp.tdm.taskpool_addto_nb_tasks(n)
            startup = tp.startup(self)
            tp.tdm.ready()
            if startup:
                schedule_tasks(self._submit_es, list(startup), 0)

    def record_failure(self, e: BaseException) -> None:
        """Record a fatal background failure (first one wins) and wake
        every waiter."""
        with self._lock:
            if self._worker_error is None:
                self._worker_error = e
            self._cond.notify_all()

    def start(self) -> None:
        with self._lock:
            self.started = True
        self._start_barrier.set()
        with self._cond:
            self._cond.notify_all()

    def test(self) -> bool:
        with self._lock:
            return not self._active_taskpools

    def wait(self, timeout: float | None = None) -> None:
        """Block until every taskpool completes; raises
        :class:`ContextWaitTimeout` at the deadline and the recorded
        failure if the context is poisoned."""
        self._drive_until(self.test, timeout)

    def fini(self, timeout: float | None = None) -> None:
        """Drain (bounded by ``timeout``), stop the workers, release the
        scheduler.  A poisoned context skips the drain; a failure nobody
        has seen is re-raised after teardown."""
        if self._worker_error is None and not self.test():
            try:
                self._drive_until(self.test, timeout)
            except ContextWaitTimeout:
                pass   # tear down abort-style below
        self.abort()
        if self._worker_error is not None and not self._error_surfaced:
            self._error_surfaced = True
            raise RuntimeError(
                "a background thread failed") from self._worker_error

    def abort(self) -> None:
        """Stop workers without draining."""
        with self._lock:
            self._shutdown = True
            self._cond.notify_all()
        self._start_barrier.set()
        for t in self._threads:
            t.join(timeout=5)
        self.scheduler.remove(self)

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
        backoff = _Backoff()
        while not self._shutdown:
            try:
                task, distance = select_task(es)
                if task is None:
                    backoff.wait()
                    continue
                backoff.reset()
                task_progress(es, task, distance)
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
            with self._cond:
                while True:
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
                    self._cond.wait_for(
                        lambda: predicate() or self._worker_error is not None,
                        rem)
        es = self._submit_es
        es.owner_ident = threading.get_ident()
        backoff = _Backoff()
        while not predicate():
            if self._worker_error is not None:
                raise RuntimeError(
                    "a background thread failed") from self._worker_error
            if deadline is not None and time.monotonic() > deadline:
                raise ContextWaitTimeout(
                    f"context wait timed out ({self._live_desc()})")
            try:
                task, distance = select_task(es)
                if task is None:
                    backoff.wait()
                    continue
                backoff.reset()
                task_progress(es, task, distance)
            except BaseException as e:
                # poison the context so a later fini() tears down instead
                # of re-draining a pool that can never complete
                self.record_failure(e)
                raise

    def _live_desc(self) -> str:
        with self._lock:
            pools = list(self._active_taskpools)
        return ", ".join(f"{tp.name}[nb_tasks={tp.tdm.snapshot()['nb_tasks']}]"
                         for tp in pools) or "no live taskpools"

    def _taskpool_terminated(self, tp: Taskpool) -> None:
        with self._lock:
            if tp in self._active_taskpools:
                self._active_taskpools.remove(tp)
            self._cond.notify_all()
        self.deps.purge_taskpool(tp.taskpool_id)

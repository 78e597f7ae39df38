"""Scheduler implementations: all eleven of the JAX package's modules.

Port of ``parsec_tpu/sched/modules.py`` (the reference's
``parsec/mca/sched/*``): **lfq** (the default) per-stream bounded
deques spilling to a per-VP overflow queue, with sibling stealing;
**ap** a global absolute-priority heap; **spq** priority then distance;
**ip** inverse priority; **gd** a global dequeue; **rnd** random;
**ll/llp** per-stream LIFOs with stealing (``ll`` on the native
:class:`~parsec_tpu_torch.native.NativeLifo` when the native tier is
up), ± priority; and the local-hierarchical family: **pbq** priority
local queues with proximity-ordered stealing, **ltq** local tree queues
whose steals migrate whole release batches, **lhq** with an
intermediate group rung per last-level cache.
:func:`open_scheduler` takes each name (the ``sched`` param).

Left out: the MCA component repository and its priority query (the port
opens a module by name, default ``lfq``), the ``serve_fair`` component
(the port's server wraps the context's scheduler itself) and
``queue_depths``, which only the stall dump reads.
"""

from __future__ import annotations

import heapq
import itertools
import random
import threading
from collections import deque
from typing import Any, Sequence

from ..core import topology as _topology
from ..core.hbbuffer import HBBuffer, StealDeque
from ..core.params import params as _params
from .api import SchedulerModule

_params.register("sched_lfq_buffer_size", 256,
                 "per-stream sharded-deque capacity for lfq (spills to the "
                 "per-VP system queue beyond this)")


def _task_priority(t: Any) -> int:
    return t.priority


class _VPQueues:
    def __init__(self) -> None:
        self.system: deque = deque()
        self.lock = threading.Lock()


class LFQModule(SchedulerModule):
    """Sharded ready queues: the per-stream :class:`StealDeque` is the
    primary push target; a lock is taken only on steal, overflow spill or
    the priority scan."""

    name = "lfq"

    def install(self, context: Any) -> None:
        for vp in context.virtual_processes:
            vp.sched_private = _VPQueues()
        self._cap = _params.get("sched_lfq_buffer_size")

    def flow_init(self, es: Any) -> None:
        vpq = es.virtual_process.sched_private

        def overflow(items: list, distance: int) -> None:
            with vpq.lock:
                vpq.system.extend(items)

        es.sched_private = StealDeque(self._cap, parent_push=overflow)

    def schedule(self, es: Any, tasks: Sequence[Any], distance: int = 0) -> None:
        sp = es.sched_private
        if sp is None or distance > 0:
            vpq = es.virtual_process.sched_private
            with vpq.lock:
                vpq.system.extend(tasks)
            return
        sp.push_all(list(tasks), distance)

    def select(self, es: Any) -> tuple[Any | None, int]:
        sp = es.sched_private
        if sp is not None:
            t = sp.try_pop_best(priority=_task_priority)
            if t is not None:
                return t, 0
        for sib in es.virtual_process.execution_streams:
            if sib is es or sib.sched_private is None:
                continue
            t = sib.sched_private.steal()
            if t is not None:
                return t, 1
        vpq = es.virtual_process.sched_private
        with vpq.lock:
            if vpq.system:
                return vpq.system.popleft(), 99
        return None, 0

    def remove(self, context: Any) -> None:
        for vp in context.virtual_processes:
            vp.sched_private = None
            for es in vp.execution_streams:
                es.sched_private = None

    def pending_tasks(self, context: Any) -> int:
        n = 0
        for vp in context.virtual_processes:
            if vp.sched_private is not None:
                n += len(vp.sched_private.system)
            for es in vp.execution_streams:
                if es.sched_private is not None:
                    n += len(es.sched_private)
        return n


# ---------------------------------------------------------------------------
# global single-queue family
# ---------------------------------------------------------------------------

class _GlobalHeapModule(SchedulerModule):
    """Shared helper: one process-global heap ordered by a key fn."""

    def install(self, context: Any) -> None:
        self._heap: list = []
        self._lock = threading.Lock()
        self._tie = itertools.count()

    def _key(self, task: Any, distance: int):
        raise NotImplementedError

    def schedule(self, es: Any, tasks: Sequence[Any], distance: int = 0) -> None:
        with self._lock:
            for t in tasks:
                heapq.heappush(self._heap,
                               (self._key(t, distance), next(self._tie), t))

    def select(self, es: Any) -> tuple[Any | None, int]:
        with self._lock:
            if not self._heap:
                return None, 0
            _, _, t = heapq.heappop(self._heap)
            return t, 0

    def remove(self, context: Any) -> None:
        self._heap = []

    def pending_tasks(self, context: Any) -> int:
        return len(self._heap)


class APModule(_GlobalHeapModule):
    """Absolute priority: highest priority first (cf. sched/ap)."""
    name = "ap"

    def _key(self, task: Any, distance: int):
        return (-task.priority,)


class SPQModule(_GlobalHeapModule):
    """Priority then distance (the documented tutorial scheduler, sched/spq)."""
    name = "spq"

    def _key(self, task: Any, distance: int):
        return (-task.priority, distance)


class IPModule(_GlobalHeapModule):
    """Inverse priority — lowest first (cf. sched/ip; a testing policy)."""
    name = "ip"

    def _key(self, task: Any, distance: int):
        return (task.priority,)


class GDModule(SchedulerModule):
    """Global dequeue (cf. sched/gd): hot tasks to the front."""
    name = "gd"

    def install(self, context: Any) -> None:
        self._dq = deque()
        self._lock = threading.Lock()

    def schedule(self, es: Any, tasks: Sequence[Any], distance: int = 0) -> None:
        with self._lock:
            if distance == 0:
                self._dq.extendleft(reversed(list(tasks)))
            else:
                self._dq.extend(tasks)

    def select(self, es: Any) -> tuple[Any | None, int]:
        with self._lock:
            if self._dq:
                return self._dq.popleft(), 0
        return None, 0

    def remove(self, context: Any) -> None:
        self._dq = deque()

    def pending_tasks(self, context: Any) -> int:
        return len(self._dq)


class RNDModule(SchedulerModule):
    """Random selection (cf. sched/rnd; a fairness fuzzer)."""
    name = "rnd"

    def install(self, context: Any) -> None:
        self._items: list = []
        self._lock = threading.Lock()
        self._rng = random.Random(0x9a53)

    def schedule(self, es: Any, tasks: Sequence[Any], distance: int = 0) -> None:
        with self._lock:
            self._items.extend(tasks)

    def select(self, es: Any) -> tuple[Any | None, int]:
        with self._lock:
            if not self._items:
                return None, 0
            i = self._rng.randrange(len(self._items))
            self._items[i], self._items[-1] = self._items[-1], self._items[i]
            return self._items.pop(), 0

    def remove(self, context: Any) -> None:
        self._items = []

    def pending_tasks(self, context: Any) -> int:
        return len(self._items)


# ---------------------------------------------------------------------------
# ll / llp — per-stream LIFOs with stealing (cf. sched/ll, sched/llp)
# ---------------------------------------------------------------------------

class LLModule(SchedulerModule):
    """Per-stream lock-free LIFOs with stealing.  When the native tier is
    up, the queue IS the C++ ABA-counted LIFO (the reference's ll is exactly
    its ``class/lifo.h``); tasks ride as uid handles through a side map.
    ``llp`` needs priority scans, so it stays on the Python deque.

    Steal order differs between tiers by design: the native LIFO can only
    pop from the top, so steals are LIFO (exactly the reference's ll, which
    steals via ``parsec_lifo_pop`` too); the Python tier steals FIFO from
    the victim's bottom for locality.  Both are valid ll semantics — the
    scheduler contract orders nothing across streams."""

    name = "ll"
    use_priority = False

    def install(self, context: Any) -> None:
        self._tasks: dict[int, Any] = {}
        self._native = None
        if not self.use_priority:
            from .. import native            # registers runtime_native
            if _params.get("runtime_native") and native.available():
                self._native = native

    def flow_init(self, es: Any) -> None:
        if self._native is not None:
            es.sched_private = self._native.NativeLifo()
        else:
            es.sched_private = (deque(), threading.Lock())

    def schedule(self, es: Any, tasks: Sequence[Any], distance: int = 0) -> None:
        target = es if es.sched_private is not None else \
            es.virtual_process.execution_streams[0]
        if self._native is not None:
            lifo = target.sched_private
            for t in tasks:
                self._tasks[t.uid] = t
                lifo.push(t.uid)
            return
        dq, lock = target.sched_private
        with lock:
            dq.extend(tasks)

    def select(self, es: Any) -> tuple[Any | None, int]:
        streams = es.virtual_process.execution_streams
        order = [es] + [s for s in streams if s is not es]
        for dist, s in enumerate(order):
            if s.sched_private is None:
                continue
            if self._native is not None:
                uid = s.sched_private.pop()
                if uid is None:
                    continue
                t = self._tasks.pop(uid, None)
                if t is None:
                    continue   # remove() raced us during teardown
                return t, min(dist, 1)
            dq, lock = s.sched_private
            with lock:
                if not dq:
                    continue
                if self.use_priority and s is es:
                    best = max(range(len(dq)), key=lambda i: dq[i].priority)
                    t = dq[best]
                    del dq[best]
                    return t, 0
                # own queue: LIFO; victim: FIFO steal
                return (dq.pop() if s is es else dq.popleft()), min(dist, 1)
        return None, 0

    def remove(self, context: Any) -> None:
        for vp in context.virtual_processes:
            for es in vp.execution_streams:
                es.sched_private = None
        self._tasks = {}

    def pending_tasks(self, context: Any) -> int:
        n = 0
        for vp in context.virtual_processes:
            for es in vp.execution_streams:
                if es.sched_private is None:
                    continue
                if self._native is not None:
                    n += len(es.sched_private)
                else:
                    n += len(es.sched_private[0])
        return n


class LLPModule(LLModule):
    name = "llp"
    use_priority = True


# ---------------------------------------------------------------------------
# the local-hierarchical family: pbq / ltq / lhq
# (cf. sched_local_queues_utils.h: per-stream hbbuffer "task_queue", an
#  ordered list of hierarch queues to steal from, and a shared system
#  dequeue.  hwloc proximity becomes th_id ring distance here — the GIL
#  flattens cache hierarchy, the *structure* is what is rebuilt.)
# ---------------------------------------------------------------------------

class PBQModule(SchedulerModule):
    """Priority-based local queues (``mca/sched/pbq``): per-stream bounded
    buffer with best-priority pop, nearest-neighbor steal order, shared
    system dequeue."""

    name = "pbq"

    def install(self, context: Any) -> None:
        self._order: dict[int, list] = {}   # id(es) -> cached steal order
        for vp in context.virtual_processes:
            vp.sched_private = _VPQueues()
            # reference queue_size = 4 * vp->nb_cores — per VP
            vp.sched_private.cap = max(4, 4 * len(vp.execution_streams))

    def flow_init(self, es: Any) -> None:
        vpq = es.virtual_process.sched_private

        def overflow(items: list, distance: int) -> None:
            with vpq.lock:
                vpq.system.extend(items)

        es.sched_private = HBBuffer(vpq.cap, parent_push=overflow)

    def _steal_order(self, es: Any) -> list:
        order = self._order.get(id(es))
        if order is None:
            sibs = es.virtual_process.execution_streams
            n = len(sibs)
            me = sibs.index(es)
            my_core = _topology.core_of_stream(es.th_id)
            idx = {id(s): i for i, s in enumerate(sibs)}
            # topology-near first (same LLC before cross-cache — the
            # hwloc distance matrix), ring distance as the tiebreak;
            # static per stream, so computed once and cached
            order = sorted(
                (s for s in sibs if s is not es),
                key=lambda s: (
                    _topology.distance(my_core,
                                       _topology.core_of_stream(s.th_id)),
                    min((idx[id(s)] - me) % n,
                        (me - idx[id(s)]) % n)))
            self._order[id(es)] = order
        return order

    def schedule(self, es: Any, tasks: Sequence[Any],
                 distance: int = 0) -> None:
        if es.sched_private is None or distance > 0:
            vpq = es.virtual_process.sched_private
            with vpq.lock:
                vpq.system.extend(tasks)
            return
        es.sched_private.push_all(list(tasks), distance)

    def select(self, es: Any) -> tuple[Any | None, int]:
        if es.sched_private is not None:
            t = es.sched_private.try_pop_best(priority=_task_priority)
            if t is not None:
                return t, 0
            for d, sib in enumerate(self._steal_order(es)):
                if sib.sched_private is None:
                    continue
                t = sib.sched_private.steal()
                if t is not None:
                    return t, min(1 + d, 98)   # 99 is the system sentinel
        vpq = es.virtual_process.sched_private
        with vpq.lock:
            if vpq.system:
                return vpq.system.popleft(), 99
        return None, 0

    def remove(self, context: Any) -> None:
        for vp in context.virtual_processes:
            vp.sched_private = None
            for es in vp.execution_streams:
                es.sched_private = None

    def pending_tasks(self, context: Any) -> int:
        n = 0
        for vp in context.virtual_processes:
            if vp.sched_private is not None:
                n += len(vp.sched_private.system)
            for es in vp.execution_streams:
                if es.sched_private is not None:
                    n += len(es.sched_private)
        return n


class _Bundle:
    """A released batch kept together — the maxheap node of ltq: the owner
    pops the best task off the top; a thief migrates the whole remainder
    (subtree stealing)."""

    __slots__ = ("tasks",)

    def __init__(self, tasks: list) -> None:
        self.tasks = sorted(tasks, key=lambda t: t.priority, reverse=True)

    @property
    def priority(self) -> int:
        return self.tasks[0].priority if self.tasks else -1


class LTQModule(PBQModule):
    """Local tree queues (``mca/sched/ltq``): releases travel as heaps —
    one steal migrates a whole subtree of related work, preserving the
    producer-consumer locality the tree encodes."""

    name = "ltq"

    def schedule(self, es: Any, tasks: Sequence[Any],
                 distance: int = 0) -> None:
        if not tasks:
            return
        super().schedule(es, [_Bundle(list(tasks))], distance)

    def select(self, es: Any) -> tuple[Any | None, int]:
        b, d = super().select(es)
        if b is None:
            return None, 0
        t = b.tasks.pop(0)
        if b.tasks and es.sched_private is not None:
            # remainder stays with whoever popped it (subtree migration)
            es.sched_private.push_all([b], 0)
        return t, d

    def pending_tasks(self, context: Any) -> int:
        n = 0
        for vp in context.virtual_processes:
            if vp.sched_private is not None:
                n += sum(len(b.tasks) for b in vp.sched_private.system)
            for es in vp.execution_streams:
                if es.sched_private is not None:
                    n += sum(len(b.tasks) for b in es.sched_private._items)
        return n


class LHQModule(PBQModule):
    """Local hierarchical queues (``mca/sched/lhq``): an intermediate
    *group* buffer between the per-stream buffers and the system queue —
    the hwloc-level ladder with two rungs (stream → group → VP)."""

    name = "lhq"

    def install(self, context: Any) -> None:
        super().install(context)
        self._group: dict[int, Any] = {}   # id(es) -> its group buffer
        for vp in context.virtual_processes:
            # one group buffer per last-level cache represented among this
            # VP's streams (the real hwloc rung; a VP whose streams all
            # share one LLC gets one group — no artificial split)
            vpq = vp.sched_private
            llcs = sorted({_topology.llc_group_of(
                _topology.core_of_stream(s.th_id))
                for s in vp.execution_streams})
            vpq.llc_index = {llc: i for i, llc in enumerate(llcs)}
            vpq.groups = []
            for _g in llcs:
                def spill(items: list, distance: int, vpq=vpq) -> None:
                    with vpq.lock:
                        vpq.system.extend(items)
                vpq.groups.append(HBBuffer(vpq.cap, parent_push=spill))

    def _group_of(self, es: Any):
        grp = self._group.get(id(es))
        if grp is None:
            vpq = es.virtual_process.sched_private
            g = vpq.llc_index[_topology.llc_group_of(
                _topology.core_of_stream(es.th_id))]
            grp = vpq.groups[g]
            self._group[id(es)] = grp
        return grp

    def flow_init(self, es: Any) -> None:
        vpq = es.virtual_process.sched_private

        def overflow(items: list, distance: int) -> None:
            self._group_of(es).push_all(items, distance)

        es.sched_private = HBBuffer(vpq.cap, parent_push=overflow)

    def select(self, es: Any) -> tuple[Any | None, int]:
        if es.sched_private is not None:
            t = es.sched_private.try_pop_best(priority=_task_priority)
            if t is not None:
                return t, 0
            my_grp = self._group_of(es)
            # the stream's OWN hierarchy: its buffer's spill target is not
            # another stream's queue, so this is distance 0 (not a steal)
            t = my_grp.try_pop_best(priority=_task_priority)
            if t is not None:
                return t, 0
            for d, sib in enumerate(self._steal_order(es)):
                if sib.sched_private is None:
                    continue
                t = sib.sched_private.steal()
                if t is not None:
                    return t, min(1 + d, 98)
            vpq = es.virtual_process.sched_private
            for grp in vpq.groups:
                if grp is my_grp:
                    continue    # already drained above; a re-pop is no steal
                t = grp.steal()
                if t is not None:
                    return t, 10
        vpq = es.virtual_process.sched_private
        with vpq.lock:
            if vpq.system:
                return vpq.system.popleft(), 99
        return None, 0

    def pending_tasks(self, context: Any) -> int:
        n = super().pending_tasks(context)
        for vp in context.virtual_processes:
            if getattr(vp.sched_private, "groups", None):
                n += sum(len(g) for g in vp.sched_private.groups)
        return n


_MODULES = {m.name: m for m in (
    LFQModule, APModule, SPQModule, IPModule, GDModule, RNDModule,
    LLModule, LLPModule, PBQModule, LTQModule, LHQModule)}


def open_scheduler(name: str) -> SchedulerModule:
    """A fresh scheduler module by name (the ``sched`` param's choice)."""
    try:
        return _MODULES[name]()
    except KeyError:
        raise LookupError(
            f"no scheduler '{name}' (known: {sorted(_MODULES)})") from None

"""The CUDA device module.

Port of ``parsec_tpu/device/tpu.py`` (itself a rebuild of the reference's
``device_gpu.c`` + ``device_cuda_module.c``) onto PyTorch's CUDA runtime:

- **Manager-thread protocol** (:meth:`CUDADevice.kernel_scheduler`): the
  first worker to find no manager becomes it and drains the device;
  others enqueue to ``pending`` and return ``HOOK_RETURN_ASYNC``.
- **Stage-in** (:meth:`CUDADevice.stage_in_many`): versioned, batched H2D
  of every missing tile of a batch, from pinned host memory with
  ``non_blocking=True`` on a copy stream that the compute stream waits
  on, into a byte-budget **LRU tile cache** sized from
  ``torch.cuda.mem_get_info``.
  Eviction is deferred: victims leave the LRU at once and are written
  back after the batch's launches are enqueued.
- **Queue-lookahead prefetch** stages queued tasks' tiles ahead of
  dispatch, so H2D overlaps the kernels still running.
- **Flooding and fused dispatch**: the manager pulls ready same-class
  tasks out of the scheduler into its batch, and a batch whose class has
  a registered batched body (:mod:`parsec_tpu_torch.ptg.lowering`) runs
  as ONE call on the lists of its tiles — for GEMM, one launch of the
  hand-written kernel, which reads each tile where it lies through an
  array of tile pointers and writes each result into a tile of its own
  (nothing is stacked, so an evicted tile frees its memory alone).
  Batches are not padded:
  the kernel takes any batch size, so the power-of-two padding the JAX
  module needs to bound its jit specializations has no purpose here.
- **In-flight window**: a ``torch.cuda.Event`` is recorded after each
  launch; past ``device_cuda_max_inflight`` the manager waits on the
  oldest.  A fault in a kernel surfaces there (or at the launch) and
  poisons the context through ``record_failure``.
- **Detached copies**: a datum may detach its device copy while the copy
  still sits in the LRU or the write-back queue (a recycled, copy-on-write
  or rolled-back KV page, ``data_dist/paged_kv.py``); stage-in then misses
  it, and write-back skips it, so it never overwrites the rewritten host
  copy.
- **Spill hooks and data-grain prefetch** (the KV tiers,
  ``data_dist/kv_tiers.py``): every write-back that leaves a datum on the
  host alone fires the subscribers of :func:`register_spill_hook`, from
  the deferred-eviction drain, outside the LRU lock (a subscriber's
  failure is counted in ``spill_hook_failures``).  For a collection with
  a tier map (``dc.tier``), a host copy that shares its device copy's
  tensor (the home copy after a write-back edge,
  ``runtime/scheduling.py``) is written back too, so an evicted page
  really leaves the card.  :meth:`CUDADevice.prefetch_data`
  stages host-resident datums back ahead of the tasks that read them:
  one async H2D on the copy stream, which the compute stream waits on.
  ``bytes_copied_in`` counts the bytes an H2D really moved (``bytes_in``
  also counts a landing that found the value already on the card).

``init_cuda_devices(device="cpu")`` wraps ``torch.device("cpu")`` in the
same module (the role of ``device_tpu_allow_cpu``), so stage-in, the
LRU, flooding and batching run in CPU-only tests; the task bodies then
take their kernels' plain PyTorch versions.

- **PINS events** at the JAX package's points, fired on the host by the
  manager with ``es=None`` (the enqueue with the enqueuing stream):
  ``DEVICE_ENQUEUE`` a task, ``DEVICE_BATCH_BEGIN``/``_END`` a batch
  (payload: its size), ``DEVICE_STAGE_IN`` each stage-in and prefetch
  that moved bytes (payload: the bytes it added to ``bytes_in``, so the
  payloads of a run sum to ``bytes_in``), ``DEVICE_EVICT`` each drain
  that wrote victims back, and ``DEVICE_STAGE_MIXED_VERSIONS`` when two
  tasks of one batch read two versions of one datum.  A task the manager
  pulls from the scheduler into its batch (flooding) fires the
  PREPARE_INPUT and EXEC pairs that a worker fires around a hand-off,
  so every task the device runs has one EXEC span; the JAX package
  fires none for its flooded tasks.  No site waits on the card.

Left out: the demote/salvage path after a failed dispatch
(``device/tpu.py:514-579``), which would run the stranded tasks on the
host: a failure here stops the run.  Until a later slice: user stage
hooks and the stall-dump ``debug_state``.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import Counter, OrderedDict, deque
from typing import Any, Callable

import torch

from ..core.params import params as _params
from ..data.data import (ACCESS_WRITE, COHERENCY_EXCLUSIVE, COHERENCY_INVALID,
                         COHERENCY_OWNED, COHERENCY_SHARED, DataCopy,
                         nbytes_of)
from ..prof import pins
from ..prof.pins import PinsEvent
from ..runtime.task import HOOK_RETURN_ASYNC
from .device import Device, registry

_params.register("device_cuda_memory_use", 90,
                 "percent of device memory the tile cache may use")
_params.register("device_cuda_max_inflight", 32,
                 "bound on launched-but-unconfirmed device dispatches")
_params.register("device_cuda_batch", True,
                 "stack same-class pending tasks into one batched launch")
_params.register("device_cuda_batch_max", 64,
                 "largest task batch a single batched launch may service")
_params.register("device_cuda_prefetch", 8,
                 "stage-in this many queued tasks ahead of dispatch "
                 "(H2D overlaps running kernels; 0 disables)")

# subscribers to device write-backs (the KV tier map), weakly held
_spill_hooks: list = []


def register_spill_hook(obj: Any) -> None:
    """Subscribe ``obj.note_spill(data, nbytes)`` to every write-back that
    leaves a datum on the host alone.  Held by weakref; dead subscribers
    are pruned at the next fire."""
    _spill_hooks.append(weakref.ref(obj))


def _fire_spill(data: Any, nbytes: int) -> int:
    """Tell every live subscriber; returns how many of them raised (the
    caller counts them: accounting never faults the write-back)."""
    dead = False
    failures = 0
    for ref in list(_spill_hooks):
        obj = ref()
        if obj is None:
            dead = True
            continue
        try:
            obj.note_spill(data, nbytes)
        except Exception:       # noqa: BLE001 — counted by the caller
            failures += 1
    if dead:
        _spill_hooks[:] = [r for r in _spill_hooks if r() is not None]
    return failures


class CUDADeviceTask:
    """Device task descriptor (cf. ``parsec_gpu_task_t``)."""

    __slots__ = ("task", "submit", "es", "stage_in", "stage_out")

    def __init__(self, es: Any, task: Any, submit: Callable) -> None:
        self.es = es
        self.task = task
        self.submit = submit
        # a class's user transfer hooks (DSL ``stage_hooks``), each
        # ``fn(device, task)`` in place of the default staging
        self.stage_in = getattr(task.task_class, "stage_in_hook", None)
        self.stage_out = getattr(task.task_class, "stage_out_hook", None)


def _flop_rating(kind: str) -> tuple[float, float]:
    """Peak GFLOPS (dense bf16 tensor core, fp32 outside the tensor cores)
    by device name: the scheduling input of best-device selection, as the
    reference's CUDA flop table.  The one card the port has run on is the
    H100 SXM (NVIDIA data sheet); any other gets a nominal rating."""
    kind = kind.lower()
    if "h100" in kind:
        return (989_000.0, 67_000.0)
    if kind == "cpu":
        return (1_000.0, 100.0)
    return (100_000.0, 10_000.0)


class CUDADevice(Device):
    """One card (or, for tests, the host CPU) driven through PyTorch."""

    def __init__(self, torch_device: Any) -> None:
        td = torch.device(torch_device)
        if td.type == "cuda" and td.index is None:
            td = torch.device("cuda", 0)
        if td.type not in ("cuda", "cpu"):
            raise ValueError(f"CUDADevice: unsupported device {td}")
        self.torch_device = td
        self.is_cuda = td.type == "cuda"
        super().__init__(f"cuda({td.index if self.is_cuda else 'cpu'})",
                         "cuda")
        self.kind = torch.cuda.get_device_name(td) if self.is_cuda else "cpu"
        self.gflops_fp16, self.gflops_fp32 = _flop_rating(self.kind)
        self.gflops_fp64 = self.gflops_fp32 / 2
        # manager-thread protocol state
        self._managing = False
        self._mutex_lock = threading.Lock()
        self._pending: deque[CUDADeviceTask] = deque()
        # LRU tile cache: data key -> DataCopy on this device
        self._lru_lock = threading.RLock()
        self._mem_lru: OrderedDict[Any, DataCopy] = OrderedDict()
        self._mem_bytes = 0
        self._mem_budget = self._memory_budget()
        # H2D copies run here, beside the kernels on the compute stream
        self._copy_stream = torch.cuda.Stream(td) if self.is_cuda else None
        # deferred evictions: victims leave the LRU at once and write back
        # after the batch's launches are enqueued
        self._evict_q: deque[DataCopy] = deque()
        self._evict_bytes = 0
        self.deferred_evictions = 0
        self.released = 0             # copies dropped by release_data
        # in-flight window of recorded events
        self._inflight: deque[Any] = deque()
        self._max_inflight = _params.get("device_cuda_max_inflight")
        # counters the bench reads
        self.kernel_launches = 0      # dispatches: per task, or per batch
        self.batched_dispatches = 0   # dispatches that serviced >1 task
        # per task class: tasks executed here, and the dispatches that ran
        # them (one per task, or one per fused batch)
        self.tasks_by_class: Counter[str] = Counter()
        self.dispatches_by_class: Counter[str] = Counter()
        self.cache_hits = 0
        self.cache_misses = 0
        self.bytes_copied_in = 0      # H2D bytes really moved
        self.prefetched = 0           # datums prefetch_data staged
        self.spill_hook_failures = 0  # subscribers that raised
        self.t_stage_in = 0.0
        self.t_pin = 0.0              # part of t_stage_in: pinning host tiles
        self.t_dispatch = 0.0
        self.t_complete = 0.0
        self.t_drain = 0.0
        self.t_manager = 0.0

    # ------------------------------------------------------------- memory
    def _memory_budget(self) -> int:
        """A share of the memory free when the device registers: what
        other users of the card already hold stays outside the cache.  One
        batch's new output tiles exist beside the tiles they replace until
        the launch is enqueued, so the budget leaves headroom."""
        pct = _params.get("device_cuda_memory_use") / 100.0
        if self.is_cuda:
            free, _total = torch.cuda.mem_get_info(self.torch_device)
        else:
            free = 16 << 30    # the host stand-in: a nominal card
        return int(free * pct)

    def _cache_insert(self, key: Any, copy: DataCopy, nbytes: int) -> None:
        with self._lru_lock:
            old = self._mem_lru.get(key)
            if old is not None:
                self._mem_bytes -= nbytes_of(old.value)
            self._mem_lru[key] = copy
            self._mem_lru.move_to_end(key)
            self._mem_bytes += nbytes
            while self._mem_bytes > self._mem_budget and len(self._mem_lru) > 1:
                if not self._evict_one_locked():
                    break

    def _evict_one_locked(self) -> bool:
        """Move the least-recently-used unpinned tile to the deferred
        write-back queue."""
        for k, c in self._mem_lru.items():
            if c.readers > 0:
                continue
            del self._mem_lru[k]
            nb = nbytes_of(c.value)
            self._mem_bytes -= nb
            self._evict_bytes += nb
            self._evict_q.append(c)
            return True
        return False

    def _drain_evictions(self) -> None:
        """Write back the queued victims (the w2r stage).  A victim that
        was re-staged meanwhile is back in the LRU: skip it."""
        t0 = time.perf_counter()
        victims = []
        with self._lru_lock:
            while self._evict_q:
                c = self._evict_q.popleft()
                self._evict_bytes -= nbytes_of(c.value)
                if self._mem_lru.get(c.original.key) is not c:
                    victims.append(c)
        if victims:
            pins.fire(PinsEvent.DEVICE_EVICT, None, len(victims))
        try:
            self._writeback_many(victims)
            self.deferred_evictions += len(victims)
        finally:
            self.t_drain += time.perf_counter() - t0

    def _writeback_many(self, copies: list[DataCopy]) -> None:
        """Push dirty device copies back to their host copies, then drop
        them.  Two phases: every D2H is started into pinned memory first,
        then one stream synchronize lands them all.

        A copy its datum has detached meanwhile (a recycled or privatized
        KV page, ``data_dist/paged_kv.py``) is skipped under the datum's
        lock: its host copy was rewritten and versioned past it, and must
        not be written over.  On a card, a clean copy of a tiered KV page
        (its collection has a tier map) whose tensor the host copy shares
        is written back too (keeping the host version), so the page leaves
        the card; any other datum's home copy keeps the card's tensor, with
        no D2H.  Every datum whose device copy this drops fires the spill
        hooks."""
        def shared(c: DataCopy) -> bool:
            # on the host stand-in a landed tile shares its host tensor:
            # it lies home already
            if not self.is_cuda or getattr(
                    getattr(c.original, "dc", None), "tier", None) is None:
                return False
            host = c.original.get_copy(0)
            return host is not None and host.value is c.value

        dirty = [c for c in copies
                 if c.coherency in (COHERENCY_OWNED, COHERENCY_EXCLUSIVE)
                 or shared(c)]
        hosts = []
        for c in dirty:
            v = c.value
            if v.device.type == "cpu":
                hosts.append(v)
                continue
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            hosts.append(h)
        if self.is_cuda and dirty:
            torch.cuda.current_stream(self.torch_device).synchronize()
        for c, h in zip(dirty, hosts):
            d = c.original
            with d._lock:
                if d.device_copies.get(self.device_index) is not c \
                        or c.coherency == COHERENCY_INVALID:
                    continue
                host = d.get_copy(0)
                if host is None:
                    host = d.attach_copy(DataCopy(d, 0, value=h, dtt=c.dtt))
                    host.version = c.version
                elif c.coherency == COHERENCY_SHARED:
                    host.value = h          # the same bytes, moved home
                else:
                    host.value = h
                    host.version = c.version
                host.coherency = COHERENCY_SHARED
            self.bytes_out += nbytes_of(h)
        spilled = []
        for c in copies:
            d = c.original
            with d._lock:
                if d.device_copies.get(self.device_index) is c:
                    del d.device_copies[self.device_index]
                    spilled.append((d, nbytes_of(c.value)))
            c.coherency = COHERENCY_INVALID
        if _spill_hooks:
            for d, nb in spilled:
                self.spill_hook_failures += _fire_spill(d, nb)

    def release_data(self, d: Any) -> None:
        """Drop ``d``'s copy on this device without a write-back: its
        LRU entry, and the copy itself (marked invalid, so a queued
        eviction skips it).  A recursive body's sub-tiles call it once
        their values are home (``SubtileCollection.release_copies``)."""
        with d._lock:
            c = d.device_copies.pop(self.device_index, None)
        if c is None:
            return
        with self._lru_lock:
            if self._mem_lru.get(d.key) is c:
                del self._mem_lru[d.key]
                self._mem_bytes -= nbytes_of(c.value)
        c.coherency = COHERENCY_INVALID
        self.released += 1

    def flush_cache(self) -> None:
        """Write every dirty tile back to its host copy (a taskpool's
        epilog)."""
        self._drain_evictions()
        with self._lru_lock:
            victims = list(self._mem_lru.values())
            self._mem_lru.clear()
            self._mem_bytes = 0
        self._writeback_many(victims)

    # ----------------------------------------------------------- stage-in
    def _land(self, v: torch.Tensor) -> torch.Tensor:
        """``v`` on this device: no copy if it is already here, else an
        async H2D on the copy stream (the caller's).  A pageable host tile
        goes through a pinned staging buffer from PyTorch's caching host
        allocator, which recycles the buffer once its H2D has run; the
        copy stream does not queue behind the kernels, so a few buffers
        serve the whole run.  A strided view (a sub-tile of a recursive
        body, ``SubtileCollection``) lands contiguous: the kernels take
        dense tiles."""
        if v.device == self.torch_device:
            return v if v.is_contiguous() else v.contiguous()
        if v.device.type == "cpu" and not v.is_pinned():
            t0 = time.perf_counter()
            v = torch.empty(v.shape, dtype=v.dtype,
                            pin_memory=True).copy_(v)
            self.t_pin += time.perf_counter() - t0
        self.bytes_copied_in += nbytes_of(v)
        return v.to(self.torch_device, non_blocking=True)

    def _land_all(self, srcs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Land every value; on a card the copies run on the copy stream
        and the compute stream waits for them before the next launch."""
        if not self.is_cuda:
            return [self._land(s) for s in srcs]
        compute = torch.cuda.current_stream(self.torch_device)
        with torch.cuda.stream(self._copy_stream):
            values = [self._land(s) for s in srcs]
        compute.wait_stream(self._copy_stream)
        for v in values:
            # allocated on the copy stream, read by kernels on the compute
            # stream: its memory is reused only after those kernels ran
            v.record_stream(compute)
        return values

    def stage_in_many(self, tasks: list[Any]) -> None:
        """Batched, versioned stage-in: resolve every task's misses first,
        then land each distinct missing tile once."""
        assigns: list[tuple[Any, int, Any]] = []   # (task, flow_idx, key)
        missing: dict[Any, DataCopy] = {}          # key -> source copy
        for task in tasks:
            for f in task.task_class.flows:
                copy = None if f.is_ctl else task.data[f.flow_index]
                if copy is None:
                    continue
                d = copy.original
                dev_copy = d.get_copy(self.device_index)
                if dev_copy is not None and dev_copy.version >= copy.version \
                        and dev_copy.coherency != COHERENCY_INVALID:
                    self.cache_hits += 1
                    task.data[f.flow_index] = dev_copy
                    self._cache_insert(d.key, dev_copy,
                                       nbytes_of(dev_copy.value))
                    continue
                self.cache_misses += 1
                prev = missing.get(d.key)
                if prev is None:
                    missing[d.key] = copy
                elif copy.version != prev.version:
                    # two tasks of one batch read two versions of one
                    # datum: the newest lands, and the event shows it
                    pins.fire(PinsEvent.DEVICE_STAGE_MIXED_VERSIONS, None,
                              (d.key, max(copy.version, prev.version),
                               min(copy.version, prev.version)))
                    if copy.version > prev.version:
                        missing[d.key] = copy
                assigns.append((task, f.flow_index, d.key))
        landed: dict[Any, DataCopy] = {}
        batch_nb = 0
        values = self._land_all([c.value for c in missing.values()])
        for (k, src), value in zip(missing.items(), values):
            d = src.original
            dev_copy = d.get_copy(self.device_index)
            if dev_copy is None:
                dev_copy = d.attach_copy(DataCopy(d, self.device_index,
                                                  value=value, dtt=src.dtt))
            else:
                dev_copy.value = value
            dev_copy.version = src.version
            dev_copy.coherency = COHERENCY_SHARED
            nb = nbytes_of(value)
            self.bytes_in += nb
            batch_nb += nb
            self._cache_insert(d.key, dev_copy, nb)
            landed[k] = dev_copy
        if missing:
            pins.fire(PinsEvent.DEVICE_STAGE_IN, None, batch_nb)
        for task, fi, k in assigns:
            task.data[fi] = landed[k]
        if not self.is_cuda:
            self._own_written(tasks)

    def prefetch_data(self, datas: list[Any]) -> int:
        """Data-grain prefetch: stage host-resident datums back into the
        tile cache ahead of the tasks that will read them (the KV tier map
        calls it one decode superpool ahead).  Advisory: a datum with a
        current copy here, or whose host copy already lies on the card, is
        skipped; the rest move in one batch of async H2D copies on the
        copy stream, which the compute stream waits on.  Unlike the queue
        lookahead it may evict, but one call stages at most half the
        budget.  A landed copy carries the version of the bytes that
        moved, and a copy written meanwhile is never overwritten.  Returns
        the number of datums staged."""
        cap = self._mem_budget // 2
        todo: list[tuple[Any, Any, int, torch.Tensor]] = []
        for d in datas:
            host = d.get_copy(0)
            if host is None or host.value is None \
                    or host.coherency == COHERENCY_INVALID \
                    or (self.is_cuda
                        and host.value.device == self.torch_device):
                continue
            dev = d.get_copy(self.device_index)
            if dev is not None and dev.version >= host.version \
                    and dev.coherency != COHERENCY_INVALID:
                continue
            nb = nbytes_of(host.value)
            if nb > cap:
                break                 # the half-budget sweep is full
            cap -= nb
            todo.append((d, host.dtt, host.version, host.value))
        if not todo:
            return 0
        t0 = time.perf_counter()
        values = self._land_all([v for *_, v in todo])
        staged = 0
        nb_total = 0
        for (d, dtt, snap_ver, _), value in zip(todo, values):
            with d._lock:
                dev = d.device_copies.get(self.device_index)
                if dev is not None and (
                        dev.coherency in (COHERENCY_OWNED,
                                          COHERENCY_EXCLUSIVE)
                        or (dev.version >= snap_ver
                            and dev.coherency != COHERENCY_INVALID)):
                    continue          # staged or written meanwhile
                if dev is None:
                    dev = DataCopy(d, self.device_index, value=value,
                                   dtt=dtt)
                    d.device_copies[self.device_index] = dev
                else:
                    dev.value = value
                dev.version = snap_ver
                dev.coherency = COHERENCY_SHARED
            nb = nbytes_of(value)
            self.bytes_in += nb
            nb_total += nb
            self._cache_insert(d.key, dev, nb)
            staged += 1
        if nb_total:
            pins.fire(PinsEvent.DEVICE_STAGE_IN, None, nb_total)
        self.prefetched += staged
        self.t_stage_in += time.perf_counter() - t0
        return staged

    def _own_written(self, tasks: list[Any]) -> None:
        """On the host stand-in a tile lands by sharing its host copy's
        tensor.  A tile a task writes gets a tensor of its own, as on a
        card, so a body that updates it in place (the decode ACC chain)
        cannot change a host copy that holds an older version."""
        for task in tasks:
            for f in task.task_class.flows:
                if f.is_ctl or not (f.access & ACCESS_WRITE):
                    continue
                c = task.data[f.flow_index]
                if c is None or c.device_index != self.device_index:
                    continue
                host = c.original.get_copy(0)
                if host is not None and host.value is c.value:
                    c.value = c.value.clone()

    def _prefetch_upcoming(self) -> None:
        """Stage queued tasks beyond the current batch: the H2D copies are
        asynchronous, so they overlap the launches still running.  Only
        while the cache has headroom: under pressure a lookahead would
        evict tiles the running batch still needs."""
        depth = _params.get("device_cuda_prefetch")
        if depth <= 0:
            return
        with self._lru_lock:
            if self._mem_bytes + self._evict_bytes > 0.8 * self._mem_budget:
                return
        with self._mutex_lock:
            upcoming = [d.task for d in list(self._pending)[:depth]]
        t0 = time.perf_counter()
        self.stage_in_many(upcoming)
        self.t_stage_in += time.perf_counter() - t0

    # ------------------------------------------------- the manager protocol
    def kernel_scheduler(self, es: Any, task: Any, submit: Callable) -> int:
        """Enqueue; the first thread in becomes the manager and drains
        the device (``parsec_device_kernel_scheduler``)."""
        pins.fire(PinsEvent.DEVICE_ENQUEUE, es, task)
        with self._mutex_lock:
            self._pending.append(CUDADeviceTask(es, task, submit))
            if self._managing:
                return HOOK_RETURN_ASYNC
            self._managing = True
        t_mgr = time.perf_counter()
        try:
            while True:
                with self._mutex_lock:
                    if not self._pending:
                        self._managing = False
                        self.t_manager += time.perf_counter() - t_mgr
                        return HOOK_RETURN_ASYNC
                    batch = self._take_batch_locked()
                if _params.get("device_cuda_batch"):
                    self._flood_from_scheduler(batch)
                self._prefetch_upcoming()
                self._run_batch(batch)
                self._drain_evictions()
        except BaseException as e:
            # release the managership so the error path strands nothing,
            # and poison the context: a kernel failure must stop the run
            with self._mutex_lock:
                self._managing = False
                self.t_manager += time.perf_counter() - t_mgr
            if isinstance(e, Exception):
                es.context.record_failure(e)
            raise

    def _take_batch_locked(self) -> list[CUDADeviceTask]:
        batch = [self._pending.popleft()]
        if _params.get("device_cuda_batch"):
            first = batch[0]
            while self._pending \
                    and self._pending[0].task.task_class is first.task.task_class \
                    and self._pending[0].submit is first.submit:
                batch.append(self._pending.popleft())
        return batch

    def _batched_body(self, tc: Any) -> Any:
        """The registered batched body of a class's device chore, if any."""
        from ..ptg.lowering import find_traceable
        dyld = next((c.dyld for c in tc.chores
                     if c.device_type == self.type and c.dyld), None)
        return None if dyld is None else find_traceable(dyld)

    def _flood_from_scheduler(self, batch: list[CUDADeviceTask]) -> None:
        """Pull ready same-class tasks straight from the scheduler into
        this batch (and put anything else back).  Only classes with a
        batched body are worth flooding."""
        from ..runtime.scheduling import prepare_input
        first = batch[0]
        tc = first.task.task_class
        if (getattr(tc, "stage_in_hook", None) is not None
                or getattr(tc, "stage_out_hook", None) is not None):
            return   # custom staging dispatches task by task
        if self._batched_body(tc) is None:
            return
        es = first.es
        sched = es.context.scheduler
        maxb = _params.get("device_cuda_batch_max")
        stash: list[tuple[Any, int]] = []
        while len(batch) < maxb:
            t, distance = sched.select(es)
            if t is None:
                break
            if t.task_class is tc and registry.best_device(t, self.type) is self:
                # the pairs a worker fires around this hand-off
                pins.fire(PinsEvent.PREPARE_INPUT_BEGIN, es, t)
                prepare_input(es, t)
                pins.fire(PinsEvent.PREPARE_INPUT_END, es, t)
                pins.fire(PinsEvent.EXEC_BEGIN, es, t)
                batch.append(CUDADeviceTask(es, t, first.submit))
                pins.fire(PinsEvent.EXEC_END, es, t)
            else:
                stash.append((t, distance))
        for t, distance in stash:
            sched.schedule(es, [t], distance)

    # ------------------------------------------------------------ pipeline
    def _run_batch(self, batch: list[CUDADeviceTask]) -> None:
        from ..runtime.scheduling import complete_execution
        pins.fire(PinsEvent.DEVICE_BATCH_BEGIN, None, len(batch))
        t0 = time.perf_counter()
        # user-hooked tasks stage one by one, the rest in one batch
        for dtask in batch:
            if dtask.stage_in is not None:
                dtask.stage_in(self, dtask.task)
        self.stage_in_many([d.task for d in batch if d.stage_in is None])
        t1 = time.perf_counter()
        self.t_stage_in += t1 - t0
        name = batch[0].task.task_class.name
        if len(batch) > 1 and self._run_batched(batch):
            self.dispatches_by_class[name] += 1
        else:
            for dtask in batch:
                dtask.submit(dtask.es, dtask.task, self)
                self.kernel_launches += 1
                self._note_inflight()
                self.executed_tasks += 1
                self._mark_written(dtask.task)
            self.dispatches_by_class[name] += len(batch)
        self.tasks_by_class[name] += len(batch)
        t2 = time.perf_counter()
        self.t_dispatch += t2 - t1
        for dtask in batch:
            if dtask.stage_out is not None:
                dtask.stage_out(self, dtask.task)
            complete_execution(dtask.es, dtask.task)
        self.t_complete += time.perf_counter() - t2
        pins.fire(PinsEvent.DEVICE_BATCH_END, None, len(batch))

    def _mark_written(self, task: Any) -> None:
        """Written flows become dirty device copies."""
        for f in task.task_class.flows:
            if f.is_ctl or not (f.access & ACCESS_WRITE):
                continue
            c = task.data[f.flow_index]
            if c is not None and c.device_index == self.device_index:
                c.coherency = COHERENCY_OWNED
                c.original.owner_device = self.device_index

    def _run_batched(self, batch: list[CUDADeviceTask]) -> bool:
        """Run a same-class batch as ONE call of its batched body on the
        lists of its tiles; False (per-task path) when the class has none
        or the batch's tiles differ in shape or dtype (ragged edge
        tiles)."""
        tc = batch[0].task.task_class
        if any(d.stage_in is not None or d.stage_out is not None
               for d in batch):
            return False   # custom stage hooks own data placement
        tr = self._batched_body(tc)
        if tr is None:
            return False
        data_flows = [f for f in tc.flows if not f.is_ctl]
        cols = []
        for f in data_flows:
            vals = [d.task.data[f.flow_index].value for d in batch]
            v0 = vals[0]
            if any(v.shape != v0.shape or v.dtype != v0.dtype
                   for v in vals[1:]):
                return False
            cols.append(vals)
        # the in-place form where the class has one: the batch's written
        # tiles are this device's own copies
        out = (tr.inplace or tr.apply)(*cols)
        written = [f for f in data_flows if f.access & ACCESS_WRITE]
        # one written flow returns its list of tiles; several, a tuple
        outs = (out,) if len(written) == 1 else tuple(out)
        if len(outs) != len(written) \
                or any(len(vals) != len(batch) for vals in outs):
            raise RuntimeError(f"batched body of {tc.name} returned "
                               f"{[len(v) for v in outs]} tiles for "
                               f"{len(written)} written flows of "
                               f"{len(batch)} tasks")
        self.kernel_launches += 1
        self._note_inflight()
        for w, vals in zip(written, outs):
            for dtask, v in zip(batch, vals):
                c = dtask.task.data[w.flow_index]
                c.value = v
                c.version += 1
        for dtask in batch:
            self.executed_tasks += 1
            self._mark_written(dtask.task)
        self.batched_dispatches += 1
        return True

    def _note_inflight(self) -> None:
        """Bound the launch depth: wait on the oldest recorded event once
        more than ``max_inflight`` dispatches are unconfirmed."""
        if not self.is_cuda:
            return   # host ops complete before they return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.torch_device))
        self._inflight.append(ev)
        while len(self._inflight) > self._max_inflight:
            self._inflight.popleft().synchronize()

    def sync(self) -> None:
        """Wait for every launched dispatch."""
        while self._inflight:
            self._inflight.popleft().synchronize()

    def debug_state(self) -> dict:
        """Stage-in and pipeline state for the flight recorder's stall
        dump.  Locks are taken with a bounded wait (a dump racing a
        wedged manager reports what it can reach) and nothing waits on
        the card: the in-flight window is counted, not queried."""
        state = {"name": self.name, "enabled": self.enabled,
                 "executed_tasks": self.executed_tasks,
                 "kernel_launches": self.kernel_launches,
                 "batched_dispatches": self.batched_dispatches,
                 "inflight_dispatches": len(self._inflight),
                 "cache_hits": self.cache_hits,
                 "cache_misses": self.cache_misses,
                 "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                 "stage_in_s": round(self.t_stage_in, 3),
                 "dispatch_s": round(self.t_dispatch, 3),
                 "complete_s": round(self.t_complete, 3),
                 "drain_s": round(self.t_drain, 3)}
        if self._mutex_lock.acquire(timeout=0.2):
            try:
                state["pending_tasks"] = len(self._pending)
                state["managing"] = self._managing
            finally:
                self._mutex_lock.release()
        else:
            state["pending_tasks"] = "<manager lock held>"
        if self._lru_lock.acquire(timeout=0.2):
            try:
                state["lru_tiles"] = len(self._mem_lru)
                state["lru_bytes"] = self._mem_bytes
                state["evict_queue"] = len(self._evict_q)
            finally:
                self._lru_lock.release()
        else:
            state["lru_tiles"] = "<lru lock held>"
        return state

    def stats(self) -> dict[str, float]:
        s = super().stats()
        s.update(kernel_launches=self.kernel_launches,
                 batched_dispatches=self.batched_dispatches,
                 cache_hits=self.cache_hits, cache_misses=self.cache_misses,
                 bytes_copied_in=self.bytes_copied_in,
                 prefetched=self.prefetched,
                 spill_hook_failures=self.spill_hook_failures,
                 deferred_evictions=self.deferred_evictions,
                 released=self.released,
                 t_stage_in=self.t_stage_in, t_pin=self.t_pin,
                 t_dispatch=self.t_dispatch,
                 t_complete=self.t_complete, t_drain=self.t_drain,
                 t_manager=self.t_manager,
                 tasks_by_class=dict(self.tasks_by_class),
                 dispatches_by_class=dict(self.dispatches_by_class))
        return s


def init_cuda_devices(device: Any = None) -> list[CUDADevice]:
    """Register the card as a ``"cuda"`` device and return it.

    With no argument (or ``"cuda"``/``"cuda:<i>"``) this registers
    ``cuda:0`` (or the given card) and raises when
    ``torch.cuda.is_available()`` is false — it never falls back to the
    host.  ``device="cpu"`` registers the module around the host CPU, the
    way the tests run the device path without a card.  Registering the
    same device twice returns the existing one.
    """
    want = torch.device(device) if device is not None else torch.device("cuda")
    if want.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_cuda_devices: no CUDA device is visible "
                "(torch.cuda.is_available() is False); pass device='cpu' "
                "to run the device module on the host")
        want = torch.device("cuda", 0 if want.index is None else want.index)
    elif want.type != "cpu":
        raise ValueError(f"init_cuda_devices: unsupported device {want}")
    for d in registry.by_type("cuda"):
        if d.torch_device == want:
            return [d]
    return [registry.add(CUDADevice(want))]

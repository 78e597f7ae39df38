"""DTD engine: runtime task insertion with discovered dependencies.

Port of ``parsec_tpu/dtd/insert.py`` (the reference's
``interfaces/dtd/insert_function.c``):

- ``insert_task(body, (tile, INOUT), (x, VALUE), ...)``, the analog of
  ``parsec_dtd_insert_task``: flags give each argument's role; data
  arguments thread through per-tile ``last_writer`` / ``last_users``
  accessor records to discover RAW / WAR / WAW edges at insert time.
- ``tile_of(dc, *key)`` / ``tile_of_array(tensor)``: the tile table.
- The sliding window: past ``dtd_window_size`` tasks in flight the
  inserting thread joins execution (no workers), waits (an outside
  thread with workers) or runs tasks on its own stream (a worker that
  inserts) until the count is down to ``dtd_threshold_size``.
- ``data_flush`` / ``data_flush_all``: a task after every accessor that
  copies the tile's newest version into its home (host) copy.

Tiles are tensors: host tiles on the CPU, device copies where the device
module put them.  A class inserted with ``cuda_kernel=`` carries only a
``DEV_CUDA`` chore, resolved by name through
:func:`~parsec_tpu_torch.device.kernels.find_incarnation` and
:func:`~parsec_tpu_torch.device.hooks.make_device_hook`; the device
module fuses ready tasks of one class into one batched launch (for
``"gemm"``, one K1 tile-list launch).  Its host ``body`` names the class
and never runs: with no CUDA device registered
(``init_cuda_devices()``, or ``init_cuda_devices(device="cpu")`` for the
host stand-in) its tasks fail with no runnable chore, and a kernel that
fails to build or launch raises and poisons the context, as the PTG
pools' ``devices="cuda"`` chores do.  A host body sees the tile's newest
version: a version that lives on a device is first copied into the host tile
(a real D2H, never an alias of the device tensor), and that device copy
is marked clean.  Bodies may mutate host tiles in place or return
replacement tensors for the written flows in order.  SCRATCH arguments
are tensors allocated per execution on the executing device, which is
the host: a class with SCRATCH arguments takes no ``cuda_kernel``.

**Across ranks** every rank runs the same insertion program (SPMD), and
a task's insertion seq names it on the wire.  The ``AFFINITY``
argument's tile decides the executing rank (rank 0 without one); a task
routed elsewhere is an inert *shell* in the local accessor chains, and
cross-rank dataflow moves as snapshot **pushes** over the comm engine's
DTD channel (:meth:`~parsec_tpu_torch.comm.remote_dep.RemoteDepEngine.
dtd_send`), keyed by (tile, writer's insertion seq; -1 for the tile's
value before any writer):

- a local reader after a shell writer, or of a remote tile no task has
  written, waits for that push (an :class:`_Arrival`, which may land
  before or after the reader's insertion) and runs on the pushed copy;
- a shell reader after a local writer is recorded on the writer, whose
  completion snapshots the written tile and ships it *before* releasing
  its successors (a later local writer cannot change a payload in
  flight: the WAR discipline), and a shell reader of a local tile no task
  has written gets the home value at once, once per rank;
- shells in ``last_users`` take no WAR edge from later local writers
  (their data was snapshotted).

A push may land early: a remote writer may run ahead of a local reader
of an older version.  So a local task that accesses a newer version of a
tile than the local tasks before it (one fed by a push, or a writer)
waits for all of them, across shells (:meth:`DTDTaskpool._join_group`),
and a pushed copy joins the tile's record only when a local task that
writes it starts: nothing of the newer version, in the record or in its
device copy, reaches the older reader.  A push of a tile on the card
snapshots the device tensor: one device-side copy in process, the D2H
over the socket tier.  ``data_flush`` runs on the rank of the tile's last
writer and ships the final version to its home rank when they differ.
Only collection-backed tiles cross ranks (a bare tensor has no
rank-stable name).  ``PUSHOUT``/``PULLIN`` are accepted and change
nothing, as in the JAX package.

:meth:`DTDTaskpool.validate` checks the structure discovered so far
(graphcheck's DTD prong: tile and rank bounds, accessor-chain
consistency); under the ``analysis_check`` param ``close()`` runs it
first, the first moment the graph is whole.  :meth:`DTDTaskpool.
release_task` fires the RELEASE_DEPS PINS pair around an instance's
release, as the JAX package does.

Nothing is left out.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from ..core.params import params as _params
from ..data.data import (ACCESS_READ, ACCESS_RW, ACCESS_WRITE,
                         COHERENCY_SHARED, DataCopy, data_create, nbytes_of)
from ..data.datatype import torch_dtype
from ..prof import pins
from ..prof.pins import PinsEvent
from ..runtime.scheduling import schedule_tasks
from ..runtime.task import DEV_CPU, DEV_CUDA, HOOK_RETURN_DONE, Chore, Flow
from ..runtime.task import Task, TaskClass
from ..runtime.taskpool import Taskpool

# the runtime lint's contract (analysis/runtimelint.py): each attribute
# mutates only under its lock, and nested acquisitions follow the order
_LOCK_PROTECTED = {
    "DTDTile.last_writer": "_lock",
    "DTDTile.last_users": "_lock",
    "DTDTaskpool._tiles": "_tlock",
    "DTDTaskpool._tiles_by_wire": "_tlock",
    "DTDTaskpool._pending_flush": "_tlock",
    "DTDTaskpool._arrivals": "_alock",
    "DTDTaskpool._insert_seq": "_insert_lock",
    "DTDTaskpool._inflight": "_icond",
    "DTDTask.successors": "_dlock",
    "DTDTask.push_records": "_dlock",
    "DTDTask.deps_pending": "_dlock",
    "DTDTask.completed": "_dlock",
}
_LOCK_ORDER = ("_insert_lock", "_tlock", "_lock", "_dlock", "_alock",
               "_icond")

# argument flags (cf. insert_function.h:53-70)
INPUT = ACCESS_READ
OUTPUT = ACCESS_WRITE
INOUT = ACCESS_RW
_MODE_MASK = 0x3

VALUE = 0x10        # pass by value (taken at insert time)
SCRATCH = 0x20      # per-execution scratch allocation
REF = 0x40          # pass the object reference untracked

AFFINITY = 0x100    # this argument's tile decides the executing rank
DONT_TRACK = 0x200  # do not thread dependencies through this argument
PUSHOUT = 0x400     # eagerly push the written tile back to its home
PULLIN = 0x800      # eagerly pull the tile to the executing device

_params.register("dtd_window_size", 2048,
                 "max in-flight inserted tasks before the inserter "
                 "joins execution (parsec_dtd_window_size)")
_params.register("dtd_threshold_size", 1024,
                 "in-flight level at which the inserter resumes "
                 "(parsec_dtd_threshold_size)")

_MAX_TASK_CLASSES = 25  # PARSEC_DTD_NB_TASK_CLASSES


class Scratch:
    """Scratch-argument descriptor: ``(Scratch(shape, dtype), SCRATCH)``."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype: Any = torch.float32) -> None:
        self.shape = tuple(shape) if not isinstance(shape, int) else (shape,)
        self.dtype = torch_dtype(dtype)


class DTDTile:
    """One trackable datum with its accessor chain (``parsec_dtd_tile_t``).

    A new reader depends on the last writer and joins ``last_users``; a
    new writer depends on the last writer (WAW) and every reader since
    (WAR), then resets the chain.  Across ranks the chain holds shells
    too.  The chain mutates under ``_lock``."""

    __slots__ = ("data", "dc", "key", "last_writer", "last_users", "_lock",
                 "flushed", "wire_key", "_pristine_sent", "_group_key",
                 "_group")

    def __init__(self, data: Any, dc: Any = None, key: tuple = ()) -> None:
        self.data = data              # the master Data record
        self.dc = dc                  # owning collection, if any
        self.key = key
        self.last_writer: tuple[DTDTask, int] | None = None
        self.last_users: list[tuple[DTDTask, int]] = []
        self._lock = threading.Lock()
        self.flushed = False
        # the rank-stable name on the wire (a collection's name and key)
        self.wire_key: tuple = ((dc.name,) + key if dc is not None
                                else ("arr",) + key)
        self._pristine_sent: set[int] = set()   # ranks sent the home value
        # across ranks: the local tasks that access the tile's current
        # local version, and that version's key (see _link_tile)
        self._group_key: tuple = ("home",)
        self._group: list[DTDTask] = []

    @property
    def rank(self) -> int:
        """The tile's home rank."""
        return self.dc.rank_of(*self.key) if self.dc is not None else 0

    def __repr__(self) -> str:
        return f"<DTDTile {self.key or self.data.key}>"


class _ArgSpec:
    __slots__ = ("obj", "flags", "mode", "flow_index")

    def __init__(self, obj: Any, flags: int) -> None:
        self.obj = obj
        self.flags = flags
        self.mode = flags & _MODE_MASK
        self.flow_index = -1   # set for data and scratch args


class DTDTask(Task):
    """A dynamically inserted task with per-instance discovered deps.
    ``deps_pending``, ``successors``, ``completed`` and ``push_records``
    change under ``_dlock``.  ``dtd_seq`` is the pool's insertion seq (the
    same on every rank); ``is_shell`` marks a task routed to another
    rank; ``push_records`` holds the (flow, rank) pushes its completion
    ships; ``arrived`` the flows that run on a pushed copy."""

    __slots__ = ("body", "args", "deps_pending", "successors", "completed",
                 "_dlock", "tiles", "dtd_seq", "is_shell", "rank",
                 "push_records", "arrived")

    def __init__(self, taskpool: Any, task_class: TaskClass, body: Callable,
                 args: list[_ArgSpec], priority: int = 0) -> None:
        super().__init__(taskpool, task_class, {"uid": 0}, priority=priority)
        self.locals = {"uid": self.uid}
        self.body = body
        self.args = args
        # +1 insertion guard, dropped once every dep is linked
        self.deps_pending = 1
        self.successors: list[DTDTask] = []
        self.completed = False
        self._dlock = threading.Lock()
        self.tiles: list[DTDTile | None] = [None] * len(task_class.flows)
        self.dtd_seq = -1
        self.is_shell = False
        self.rank = 0
        self.push_records: set[tuple[int, int]] = set()
        self.arrived: set[int] = set()

    def unpack_args(self) -> list[Any]:
        """``parsec_dtd_unpack_args``: argument values in insert order:
        data args as tensors, scratch as its tensor, VALUE/REF as given."""
        out = []
        for spec in self.args:
            if spec.flags & (VALUE | REF):
                out.append(spec.obj)
            elif spec.flags & SCRATCH:
                out.append(self.data[spec.flow_index])
            else:
                copy = self.data[spec.flow_index]
                out.append(copy.value if copy is not None else None)
        return out


def unpack_args(task: DTDTask) -> list[Any]:
    return task.unpack_args()


class _DTDTaskClass(TaskClass):
    """Dynamic task class (``parsec_dtd_create_task_class``): flows are
    positional slots; successors are per-instance records, so the
    class-level guarded-dep walk has nothing to do."""

    def make_key(self, locals_: dict) -> tuple:
        return (locals_["uid"],)

    def iterate_successors(self, task: Task, visitor: Callable) -> None:
        return


def _bring_home(copy: DataCopy) -> DataCopy:
    """The host copy of ``copy``'s datum, holding ``copy``'s version.  A
    newer device copy is copied into the host tile (D2H: ``copy_`` waits
    for the device's writes on the current stream) and both are marked
    clean, so the device module does not later write the device copy
    back over a newer host version."""
    if copy.device_index == 0:
        return copy
    d = copy.original
    with d._lock:
        home = d.get_copy(0)
        if home is None:
            home = d.attach_copy(DataCopy(d, 0, dtt=copy.dtt))
            home.version = -1
        if home.value is None:
            home.value = torch.empty(copy.value.shape,
                                     dtype=copy.value.dtype)
        if home.version < copy.version:
            home.value.copy_(copy.value)
            home.version = copy.version
        home.coherency = COHERENCY_SHARED
        copy.coherency = COHERENCY_SHARED
    return home


def _dtd_cpu_hook(es: Any, task: DTDTask) -> int:
    for spec in task.args:
        if spec.flow_index < 0:
            continue
        if spec.flags & SCRATCH:
            task.data[spec.flow_index] = torch.zeros(spec.obj.shape,
                                                     dtype=spec.obj.dtype)
        elif task.data[spec.flow_index] is not None:
            task.data[spec.flow_index] = _bring_home(
                task.data[spec.flow_index])
    result = task.body(*task.unpack_args())
    _apply_result(task, result)
    return HOOK_RETURN_DONE


def _dtd_prepare_input(es: Any, task: DTDTask) -> None:
    """DTD data lookup: each tracked flow takes its tile's newest version
    as the task starts (the accessor chains order it after every writer
    it depends on); scratch is allocated by the executing chore.  A flow
    fed by a push keeps the pushed copy, which a task that writes it
    installs in the tile's record now."""
    for spec in task.args:
        if spec.flow_index < 0 or spec.flags & SCRATCH:
            continue
        if spec.flow_index in task.arrived:
            if spec.mode & ACCESS_WRITE:
                _install(task.data[spec.flow_index])
            continue
        copy = task.tiles[spec.flow_index].data.newest_copy()
        if copy is None:
            raise RuntimeError(f"{task.tiles[spec.flow_index]}: no valid "
                               f"copy")
        task.data[spec.flow_index] = copy


def _apply_result(task: DTDTask, result: Any) -> None:
    """Functional-update write-back: a body returning a tensor (or a
    tuple of them) replaces the values of its written flows in order;
    ``None`` means the body mutated its host tiles in place."""
    if result is None:
        return
    written = [s for s in task.args
               if s.flow_index >= 0 and not (s.flags & SCRATCH)
               and (s.mode & ACCESS_WRITE)]
    results = result if isinstance(result, (tuple, list)) else (result,)
    if len(results) != len(written):
        raise ValueError(
            f"{task}: body returned {len(results)} values for "
            f"{len(written)} written flows")
    for spec, value in zip(written, results):
        task.data[spec.flow_index].value = value


def _dtd_flush_body(arr: Any, tile: DTDTile) -> None:
    """The flush task's body: its host hook has already brought the
    tile's newest version into the home copy."""
    tile.flushed = True


def _install(copy: DataCopy) -> None:
    """Make the pushed ``copy`` its tile's host copy, unless the record
    holds a newer one."""
    d = copy.original
    with d._lock:
        cur = d.get_copy(0)
        if cur is not copy and (cur is None or cur.version <= copy.version):
            d.attach_copy(copy)


class _Arrival:
    """One expected cross-rank payload, keyed by (tile wire key, writer's
    insertion seq; -1 for the pre-writer value).  Local tasks wait on it;
    the landing makes the payload one copy that every waiter shares and
    releases them.  Landing and waiting come in either order."""

    __slots__ = ("value", "version", "copy", "landed", "waiters")

    def __init__(self) -> None:
        self.value = None
        self.version = 0
        self.copy: DataCopy | None = None   # made once, at the first use
        self.landed = False
        self.waiters: list[tuple[DTDTask, int]] = []


class DTDTaskpool(Taskpool):
    """``parsec_dtd_taskpool_new``: a taskpool whose DAG is discovered
    from the insertion order of tasks touching shared tiles.  The tile
    table changes under ``_tlock``, the in-flight count under ``_icond``;
    ``_insert_lock`` serializes insertions (a body may insert) and is
    taken before any chain or task lock."""

    def __init__(self, name: str = "dtd") -> None:
        super().__init__(name=name)
        self._classes: dict[Any, _DTDTaskClass] = {}
        self._tiles: dict[tuple, DTDTile] = {}
        self._tlock = threading.Lock()
        # cross-rank state: tiles by wire key and flushes for tiles not
        # made here yet (under _tlock), arrivals (under _alock)
        self._insert_seq = 0
        self._tiles_by_wire: dict[tuple, DTDTile] = {}
        self._pending_flush: dict[tuple, tuple] = {}
        self._arrivals: dict[tuple, _Arrival] = {}
        self._alock = threading.Lock()
        self.local_tasks = 0        # tasks inserted to run on this rank
        self.pushes_received = 0    # pushes landed here (first landings)
        self.push_bytes_received = 0
        # RLock: a body run from inside the window backpressure may insert
        self._insert_lock = threading.RLock()
        self._inflight = 0
        self._icond = threading.Condition()
        self._armed = False
        self._closed = False
        self.window_size = _params.get("dtd_window_size")
        self.threshold_size = _params.get("dtd_threshold_size")

    # ------------------------------------------------------------- lifecycle
    def startup(self, context: Any) -> list[Task]:
        # hold one pending action until close(): the task count is unknown
        # until the application stops inserting.  A pool closed before it
        # was enqueued does not arm.
        if not self._closed:
            self.tdm.taskpool_addto_nb_pa(+1)
            self._armed = True
        return []

    def nb_local_tasks(self) -> int:
        return -1

    def close(self) -> None:
        """Declare insertion finished: drops the armed pending action so
        termination detection may conclude (needed when nobody calls
        :meth:`wait` on this pool).  Under ``analysis_check`` the pool is
        validated first (tasks may have run already: the check reads
        only)."""
        if not self._closed and _params.get("analysis_check", False):
            self.validate()
        self._closed = True
        if self._armed:
            self._armed = False
            self.tdm.taskpool_addto_nb_pa(-1)

    def validate(self, nb_ranks: int | None = None,
                 raise_on_error: bool = True) -> Any:
        """Statically verify the structure discovered so far (tile and
        rank bounds, accessor chains; graphcheck's DTD prong).  Returns the
        report; raises ``GraphCheckError`` on an error when
        ``raise_on_error``."""
        from ..analysis import check_dtd
        report = check_dtd(self, nb_ranks=nb_ranks)
        if raise_on_error:
            report.raise_if_failed()
        return report

    def wait(self, timeout: float | None = None) -> None:
        """``parsec_dtd_taskpool_wait``: no more insertions; drain."""
        self.close()
        super().wait(timeout)

    # ----------------------------------------------------------------- tiles
    def tile_of(self, dc: Any, *key) -> DTDTile:
        """``parsec_dtd_tile_of``: the unique tile record for ``dc(key)``."""
        k = (id(dc),) + key
        flush = None
        with self._tlock:
            t = self._tiles.get(k)
            if t is None:
                t = self._tiles[k] = DTDTile(dc.data_of(*key), dc=dc, key=key)
                self._tiles_by_wire[t.wire_key] = t
                flush = self._pending_flush.pop(t.wire_key, None)
        if flush is not None:
            self._apply_flush(t, *flush)
        return t

    def tile_of_array(self, array: torch.Tensor, key: Any = None) -> DTDTile:
        """Tile over a bare host tensor (no collection)."""
        k = ("arr", id(array) if key is None else key)
        with self._tlock:
            t = self._tiles.get(k)
            if t is None:
                t = self._tiles[k] = DTDTile(data_create(array, key=k))
            return t

    # -------------------------------------------------------------- classes
    def _class_for(self, body: Callable, specs: list[_ArgSpec],
                   name: str | None,
                   cuda_kernel: str | None) -> _DTDTaskClass:
        # access modes are part of the class identity: the same body
        # inserted with other roles must not reuse baked-in flows
        modes = tuple(s.flags & (_MODE_MASK | SCRATCH) for s in specs
                      if not (s.flags & (VALUE | REF)))
        ck = (body, modes, cuda_kernel)
        tc = self._classes.get(ck)
        if tc is not None:
            return tc
        if len(self._classes) >= _MAX_TASK_CLASSES:
            raise RuntimeError(
                f"too many DTD task classes (max {_MAX_TASK_CLASSES})")
        flows = []
        for fi, s in enumerate(s for s in specs
                               if not (s.flags & (VALUE | REF))):
            access = ACCESS_RW if s.flags & SCRATCH else s.mode
            flows.append(Flow(f"f{fi}", access))
        chores = []
        if cuda_kernel is not None:
            from ..device.hooks import make_device_hook
            from ..device.kernels import registered
            if (cuda_kernel, DEV_CUDA) not in registered():
                raise ValueError(
                    f"cuda_kernel={cuda_kernel!r}: no CUDA incarnation is "
                    f"registered under that name (import its ops module)")
            if any(s.flags & SCRATCH for s in specs):
                raise ValueError("SCRATCH arguments run on the host: a "
                                 "class with cuda_kernel= takes none")
            chores.append(Chore(
                DEV_CUDA, hook=make_device_hook(DEV_CUDA, None, cuda_kernel),
                dyld=cuda_kernel))
        else:
            chores.append(Chore(DEV_CPU, hook=_dtd_cpu_hook))
        tc = _DTDTaskClass(
            name or getattr(body, "__name__", "dtd_task"), params=["uid"],
            flows=flows, chores=chores, prepare_input=_dtd_prepare_input,
            complete_execution=lambda es, t: t.taskpool.release_task(es, t))
        self.add_task_class(tc)
        self._classes[ck] = tc
        return tc

    # --------------------------------------------------------------- insert
    def insert_task(self, body: Callable, *args: Any,
                    name: str | None = None, priority: int = 0,
                    cuda_kernel: str | None = None,
                    _rank: int | None = None) -> DTDTask:
        """``parsec_dtd_insert_task``.  Each argument is a bare value
        (taken as VALUE) or a tuple ``(obj, flags)``; a data argument is
        a :class:`DTDTile` or a host tensor (wrapped by
        :meth:`tile_of_array`).  ``cuda_kernel`` names the registered
        device body of the class, which then runs only on a CUDA device
        and never calls ``body``.  Across ranks the ``AFFINITY``
        argument's tile (``_rank``, when given) decides the executing
        rank; elsewhere the task is a shell."""
        if self.context is None:
            raise RuntimeError("taskpool not enqueued in a context")
        with self._insert_lock:
            task = self._insert_task_locked(body, args, name, priority,
                                            cuda_kernel, _rank)
        # backpressure OUTSIDE the insert lock: a blocked inserter must
        # not stop bodies (which may insert) from completing tasks
        if not task.is_shell:
            self._window_backpressure()
        return task

    def _insert_task_locked(self, body: Callable, args: tuple, name,
                            priority, cuda_kernel,
                            _rank) -> DTDTask:  # lint: holds(_insert_lock)
        multirank = self.context.nb_ranks > 1
        specs: list[_ArgSpec] = []
        for a in args:
            if isinstance(a, tuple) and len(a) == 2 and isinstance(a[1], int):
                obj, flags = a
            else:
                obj, flags = a, VALUE
            if not (flags & (VALUE | SCRATCH | REF)):
                if isinstance(obj, torch.Tensor):
                    obj = self.tile_of_array(obj)
                elif not isinstance(obj, DTDTile):
                    raise TypeError(
                        f"data argument must be a DTDTile or a tensor, "
                        f"got {type(obj).__name__}")
                if multirank and obj.dc is None:
                    raise ValueError(
                        "cross-rank DTD needs collection-backed tiles "
                        "(a bare tensor has no rank-stable name)")
            specs.append(_ArgSpec(obj, flags))
        tc = self._class_for(body, specs, name, cuda_kernel)
        task = DTDTask(self, tc, body, specs, priority=priority)
        self._insert_seq += 1
        task.dtd_seq = self._insert_seq
        if multirank:
            task.rank = _rank if _rank is not None else next(
                (s.obj.rank for s in specs
                 if s.flags & AFFINITY and isinstance(s.obj, DTDTile)), 0)
            task.is_shell = task.rank != self.context.my_rank
        if not task.is_shell:
            self.local_tasks += 1
            self.tdm.taskpool_addto_nb_tasks(+1)
            with self._icond:
                self._inflight += 1

        fi = 0
        for spec in specs:
            if spec.flags & (VALUE | REF):
                continue
            spec.flow_index = fi
            fi += 1
            if spec.flags & SCRATCH:
                continue
            tile: DTDTile = spec.obj
            task.tiles[spec.flow_index] = tile
            if not spec.flags & DONT_TRACK:
                self._link_tile(task, spec, tile)

        if task.is_shell:
            return task
        with task._dlock:
            task.deps_pending -= 1  # drop the insertion guard
            ready = task.deps_pending == 0
        if ready:
            task.status = "ready"
            schedule_tasks(self.context._submit_es, [task], 0)
        return task

    def _link_tile(self, task: DTDTask, spec: _ArgSpec,
                   tile: DTDTile) -> None:
        """The SET_LAST_ACCESSOR walk: RAW/WAR/WAW edges from the tile's
        earlier accessors to ``task``.  An edge to or from a shell becomes
        a push instead (the module docstring lists the four cases)."""
        me = self.context.my_rank
        needs_data = bool(spec.mode & ACCESS_READ)
        deps: list[DTDTask] = []
        arrival_key: tuple | None = None
        push_on: DTDTask | None = None
        pristine_to: int | None = None
        with tile._lock:
            lw = tile.last_writer
            if not task.is_shell:
                if needs_data:
                    if lw is not None and lw[0].is_shell:
                        arrival_key = (tile.wire_key, lw[0].dtd_seq)
                    elif lw is None and tile.dc is not None \
                            and tile.rank != me:
                        arrival_key = (tile.wire_key, -1)
                if lw is not None and not lw[0].is_shell:
                    deps.append(lw[0])              # RAW / WAW
            elif needs_data:
                if lw is not None and not lw[0].is_shell:
                    push_on = lw[0]       # pushed when the writer completes
                elif lw is None and tile.rank == me:
                    pristine_to = task.rank   # the home value, now
            if spec.mode == INPUT:
                tile.last_users.append((task, spec.flow_index))
            else:   # OUTPUT and INOUT both serialize against the chain
                if not task.is_shell:
                    deps.extend(u for u, _ in tile.last_users   # WAR
                                if u is not task and not u.is_shell)
                tile.last_users = []
                tile.last_writer = (task, spec.flow_index)
            if not task.is_shell and self.context.nb_ranks > 1:
                deps.extend(self._join_group(task, spec, tile, lw,
                                             arrival_key))
            if push_on is not None:
                with push_on._dlock:
                    if not push_on.completed:
                        push_on.push_records.add((lw[1], task.rank))
                        push_on = None    # its completion ships it
        if task.is_shell:
            if push_on is not None:       # the writer completed already
                self._send_push(tile, push_on, lw[1], task.rank)
            if pristine_to is not None:
                self._send_pristine(tile, pristine_to)
            return
        if arrival_key is not None:
            self._add_waiter(arrival_key, task, spec.flow_index)
        for pred in dict.fromkeys(deps):    # the chain and the group overlap
            self._link_dep(pred, task)

    @staticmethod
    def _join_group(task: DTDTask, spec: _ArgSpec, tile: DTDTile, lw,
                    arrival_key) -> list[DTDTask]:
        """Order a local task after every local task that accesses an
        older version of the tile, across shells (caller holds the
        tile's ``_lock``).  The chain alone does not: a shell writer
        resets it, so a local task after it, fed by its push, could run
        before a local reader of the version before it, and the push's
        copy, installed in the tile's record (or landed in its device
        copy), would reach that reader.  Readers of one version run
        together; a task that reads another version, or writes, waits
        for the group and starts the next one."""
        if arrival_key is not None:
            key = ("arrival",) + arrival_key
        elif lw is not None:
            key = ("task", lw[0].dtd_seq)
        else:
            key = ("home",)
        deps = []
        if spec.mode & ACCESS_WRITE or key != tile._group_key:
            deps = [t for t in tile._group if t is not task]
            tile._group = []
            tile._group_key = ("task", task.dtd_seq) \
                if spec.mode & ACCESS_WRITE else key
        tile._group.append(task)
        return deps

    def _link_dep(self, pred: DTDTask, succ: DTDTask) -> None:
        if pred is succ:
            return
        with pred._dlock:
            if not pred.completed:
                with succ._dlock:
                    succ.deps_pending += 1
                pred.successors.append(succ)

    # --------------------------------------------- cross-rank push protocol
    def _snapshot(self, value: Any) -> Any:
        """A payload of its own for the wire (a device-side copy in
        process, the D2H on the socket tier)."""
        return self.context.comm_engine.ce.snapshot_value(value)

    def _send_push(self, tile: DTDTile, writer: DTDTask, flow_index: int,
                   dst: int) -> None:
        """Ship ``writer``'s output of ``tile`` to ``dst``, keyed by the
        writer's insertion seq."""
        copy = writer.data[flow_index]
        self.context.comm_engine.dtd_send(self, dst, {
            "kind": "push", "tile": tile.wire_key, "writer": writer.dtd_seq,
            "value": self._snapshot(copy.value), "version": copy.version})

    def _send_pristine(self, tile: DTDTile, dst: int) -> None:
        """Push the pre-writer value of a tile this rank is home to."""
        if dst in tile._pristine_sent:
            return
        tile._pristine_sent.add(dst)
        home = tile.data.newest_copy()
        self.context.comm_engine.dtd_send(self, dst, {
            "kind": "push", "tile": tile.wire_key, "writer": -1,
            "value": self._snapshot(home.value), "version": home.version})

    @staticmethod
    def _arrival_copy(tile: DTDTile, arr: _Arrival) -> DataCopy:
        """The one copy of a landed payload (made at its first use; caller
        holds ``_alock``).  It stays out of the tile's record until a task
        that writes it starts."""
        if arr.copy is None:
            d = tile.data
            home = d.get_copy(0)
            arr.copy = DataCopy(d, 0, value=arr.value,
                                dtt=home.dtt if home is not None else None)
            arr.copy.version = arr.version
            arr.value = None
        return arr.copy

    def _add_waiter(self, key: tuple, task: DTDTask, flow_index: int) -> None:
        """Hold ``task``'s flow on an arrival, or give it the landed copy.
        The dep is raised before the waiter is visible: a push landing in
        between would otherwise release a half-linked task (the
        insertion guard is still held, so the retraction cannot reach
        zero)."""
        task.arrived.add(flow_index)
        with task._dlock:
            task.deps_pending += 1
        with self._alock:
            arr = self._arrivals.get(key)
            if arr is None:
                arr = self._arrivals[key] = _Arrival()
            if not arr.landed:
                arr.waiters.append((task, flow_index))
                return
            task.data[flow_index] = self._arrival_copy(
                task.tiles[flow_index], arr)
        with task._dlock:
            task.deps_pending -= 1

    def _land_arrival(self, key: tuple, value: Any, version: int) -> None:
        with self._alock:
            arr = self._arrivals.get(key)
            if arr is None:
                arr = self._arrivals[key] = _Arrival()
            if arr.landed:
                return   # a duplicate delivery
            arr.value, arr.version, arr.landed = value, version, True
            self.pushes_received += 1
            self.push_bytes_received += nbytes_of(value)
            waiters, arr.waiters = arr.waiters, []
            copy = self._arrival_copy(waiters[0][0].tiles[waiters[0][1]],
                                      arr) if waiters else None
        ready = []
        for t, fi in waiters:
            t.data[fi] = copy
            with t._dlock:
                t.deps_pending -= 1
                if t.deps_pending == 0:
                    t.status = "ready"
                    ready.append(t)
        if ready:
            schedule_tasks(self.context._submit_es, ready, 0)

    def _apply_flush(self, tile: DTDTile, value: Any, version: int) -> None:
        home = tile.data.get_copy(0)
        home.value = value
        home.version = max(home.version, version)
        tile.flushed = True

    def _on_dtd_message(self, rde: Any, src: int, msg: dict) -> None:
        """A cross-rank DTD message (from
        :meth:`~parsec_tpu_torch.comm.remote_dep.RemoteDepEngine._on_dtd`)."""
        wire = tuple(msg["tile"])
        if msg["kind"] == "push":
            self._land_arrival((wire, msg["writer"]), msg["value"],
                               msg["version"])
            return
        if msg["kind"] == "flush":
            with self._tlock:
                tile = self._tiles_by_wire.get(wire)
                if tile is None:
                    # the tile is not made here yet: applied at tile_of
                    self._pending_flush[wire] = (msg["value"],
                                                 msg["version"])
                    return
            self._apply_flush(tile, msg["value"], msg["version"])
            return
        raise ValueError(f"unknown DTD message kind {msg['kind']!r}")

    # ------------------------------------------------------------ completion
    def release_task(self, es: Any, task: DTDTask) -> None:
        """``complete_hook_of_dtd``: bump the written tiles' versions, ship
        the cross-rank pushes (snapshots taken before any successor is
        released: the WAR discipline), release the instance successors,
        open the window."""
        pins.fire(PinsEvent.RELEASE_DEPS_BEGIN, es, task)
        for spec in task.args:
            if spec.flow_index < 0 or spec.flags & SCRATCH:
                continue
            if spec.mode & ACCESS_WRITE:
                copy = task.data[spec.flow_index]
                if copy is not None:
                    copy.version += 1
        with task._dlock:
            task.completed = True
            succs, task.successors = task.successors, []
            pushes = sorted(task.push_records)
            task.push_records.clear()
        for fi, dst in pushes:
            self._send_push(task.tiles[fi], task, fi, dst)
        ready = []
        for succ in succs:
            with succ._dlock:
                succ.deps_pending -= 1
                if succ.deps_pending == 0:
                    succ.status = "ready"
                    ready.append(succ)
        pins.fire(PinsEvent.RELEASE_DEPS_END, es, task)
        if ready:
            schedule_tasks(es, ready, 0)
        with self._icond:
            self._inflight -= 1
            self._icond.notify_all()

    # --------------------------------------------------------------- window
    def _window_backpressure(self) -> None:
        """``parsec_execute_and_come_back``: above ``window_size`` tasks
        in flight the inserter runs tasks itself (no workers), waits (an
        outside thread with workers), or, being a worker that runs a
        body, executes and comes back on its own stream: parking it would
        strand its own unfinished task."""
        if self._inflight <= self.window_size:
            return
        ctx = self.context
        if not ctx.started:
            ctx.start()   # insertion demands progress
        if ctx._threads:
            ident = threading.get_ident()
            es = next((s for s in ctx.streams if s.owner_ident == ident),
                      None)
            if es is not None:
                from ..runtime.scheduling import select_task, task_progress
                while self._inflight > self.threshold_size:
                    t, distance = select_task(es)
                    if t is None:
                        return   # nothing runnable here; don't spin
                    task_progress(es, t, distance)
                return
            with self._icond:
                self._icond.wait_for(
                    lambda: self._inflight <= self.threshold_size)
        else:
            ctx._drive_until(lambda: self._inflight <= self.threshold_size)

    # ---------------------------------------------------------------- flush
    def data_flush(self, tile: DTDTile) -> None:
        """``parsec_dtd_data_flush``: a task after every current accessor
        of ``tile`` that leaves its final version in the home (host)
        copy.  One shared class serves every flush (the tile rides as an
        untracked REF arg), so flushes take no class slot each.  Across
        ranks the flush runs on the rank of the tile's last writer and
        ships the final version home when that is another rank."""
        if self.context is None or self.context.nb_ranks <= 1 \
                or tile.dc is None:
            self.insert_task(_dtd_flush_body, (tile, INPUT), (tile, REF),
                             name="dtd_flush")
            return
        with tile._lock:
            lw = tile.last_writer
        self.insert_task(self._flush_remote_body, (tile, INPUT), (tile, REF),
                         name="dtd_flush",
                         _rank=lw[0].rank if lw is not None else tile.rank)

    def _flush_remote_body(self, arr: Any, tile: DTDTile) -> None:
        if tile.rank == self.context.my_rank:
            _dtd_flush_body(arr, tile)
            return
        newest = tile.data.newest_copy()
        self.context.comm_engine.dtd_send(self, tile.rank, {
            "kind": "flush", "tile": tile.wire_key,
            "value": self._snapshot(newest.value),
            "version": newest.version})
        tile.flushed = True

    def data_flush_all(self) -> None:
        """``parsec_dtd_data_flush_all`` over every tile seen so far."""
        with self._tlock:
            tiles = list(self._tiles.values())
        for t in tiles:
            self.data_flush(t)

"""DTD engine: runtime task insertion with discovered dependencies.

Port of ``parsec_tpu/dtd/insert.py`` (the reference's
``interfaces/dtd/insert_function.c``), on one rank:

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

Left out: multi-rank DTD (shells, snapshot pushes, arrivals, the flush
to a remote owner and the ``AFFINITY``-routed rank, which wait for a comm
layer), ``validate()`` (graphcheck) and PINS events.
``AFFINITY``/``PUSHOUT``/``PULLIN`` are accepted and change nothing on
one rank, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from ..core.params import params as _params
from ..data.data import (ACCESS_READ, ACCESS_RW, ACCESS_WRITE,
                         COHERENCY_SHARED, DataCopy, data_create)
from ..data.datatype import torch_dtype
from ..runtime.scheduling import schedule_tasks
from ..runtime.task import DEV_CPU, DEV_CUDA, HOOK_RETURN_DONE, Chore, Flow
from ..runtime.task import Task, TaskClass
from ..runtime.taskpool import Taskpool

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
    (WAR), then resets the chain.  The chain mutates under ``_lock``."""

    __slots__ = ("data", "dc", "key", "last_writer", "last_users", "_lock",
                 "flushed")

    def __init__(self, data: Any, dc: Any = None, key: tuple = ()) -> None:
        self.data = data              # the master Data record
        self.dc = dc                  # owning collection, if any
        self.key = key
        self.last_writer: tuple[DTDTask, int] | None = None
        self.last_users: list[tuple[DTDTask, int]] = []
        self._lock = threading.Lock()
        self.flushed = False

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
    ``deps_pending``, ``successors`` and ``completed`` change under
    ``_dlock``."""

    __slots__ = ("body", "args", "deps_pending", "successors", "completed",
                 "_dlock", "tiles")

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
    it depends on); scratch is allocated by the executing chore."""
    for spec in task.args:
        if spec.flow_index < 0 or spec.flags & SCRATCH:
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
        :meth:`wait` on this pool)."""
        self._closed = True
        if self._armed:
            self._armed = False
            self.tdm.taskpool_addto_nb_pa(-1)

    def wait(self, timeout: float | None = None) -> None:
        """``parsec_dtd_taskpool_wait``: no more insertions; drain."""
        self.close()
        super().wait(timeout)

    # ----------------------------------------------------------------- tiles
    def tile_of(self, dc: Any, *key) -> DTDTile:
        """``parsec_dtd_tile_of``: the unique tile record for ``dc(key)``."""
        k = (id(dc),) + key
        with self._tlock:
            t = self._tiles.get(k)
            if t is None:
                t = self._tiles[k] = DTDTile(dc.data_of(*key), dc=dc, key=key)
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
                    cuda_kernel: str | None = None) -> DTDTask:
        """``parsec_dtd_insert_task``.  Each argument is a bare value
        (taken as VALUE) or a tuple ``(obj, flags)``; a data argument is
        a :class:`DTDTile` or a host tensor (wrapped by
        :meth:`tile_of_array`).  ``cuda_kernel`` names the registered
        device body of the class, which then runs only on a CUDA device
        and never calls ``body``."""
        if self.context is None:
            raise RuntimeError("taskpool not enqueued in a context")
        with self._insert_lock:
            task = self._insert_task_locked(body, args, name, priority,
                                            cuda_kernel)
        # backpressure OUTSIDE the insert lock: a blocked inserter must
        # not stop bodies (which may insert) from completing tasks
        self._window_backpressure()
        return task

    def _insert_task_locked(self, body: Callable, args: tuple, name,
                            priority, cuda_kernel) -> DTDTask:
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
            specs.append(_ArgSpec(obj, flags))
        tc = self._class_for(body, specs, name, cuda_kernel)
        task = DTDTask(self, tc, body, specs, priority=priority)
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
        earlier accessors to ``task``."""
        deps: list[DTDTask] = []
        with tile._lock:
            lw = tile.last_writer
            if lw is not None:
                deps.append(lw[0])                  # RAW / WAW
            if spec.mode == INPUT:
                tile.last_users.append((task, spec.flow_index))
            else:   # OUTPUT and INOUT both serialize against the chain
                deps.extend(u for u, _ in tile.last_users
                            if u is not task)        # WAR
                tile.last_users = []
                tile.last_writer = (task, spec.flow_index)
        for pred in deps:
            self._link_dep(pred, task)

    def _link_dep(self, pred: DTDTask, succ: DTDTask) -> None:
        if pred is succ:
            return
        with pred._dlock:
            if not pred.completed:
                with succ._dlock:
                    succ.deps_pending += 1
                pred.successors.append(succ)

    # ------------------------------------------------------------ completion
    def release_task(self, es: Any, task: DTDTask) -> None:
        """``complete_hook_of_dtd``: bump the written tiles' versions,
        release the instance successors, open the window."""
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
        ready = []
        for succ in succs:
            with succ._dlock:
                succ.deps_pending -= 1
                if succ.deps_pending == 0:
                    succ.status = "ready"
                    ready.append(succ)
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
        untracked REF arg), so flushes take no class slot each."""
        self.insert_task(_dtd_flush_body, (tile, INPUT), (tile, REF),
                         name="dtd_flush")

    def data_flush_all(self) -> None:
        """``parsec_dtd_data_flush_all`` over every tile seen so far."""
        with self._tlock:
            tiles = list(self._tiles.values())
        for t in tiles:
            self.data_flush(t)

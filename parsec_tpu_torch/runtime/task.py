"""Task classes, flows, dependencies, task instances.

Port of ``parsec_tpu/runtime/task.py`` (the reference's
``parsec_task_class_t`` / ``parsec_task_t``): a task class describes one
kind of task — its parameters, flows with guarded in/out deps, data
affinity, priority and a list of incarnations ("chores") binding bodies
to device types; a task is one instance with concrete locals.

A class may carry its own ``prepare_input`` and ``complete_execution``
(DTD binds data at insertion and releases through per-instance
records), and ``space_extents``: the static box of its execution space
that the index-array dep tier indexes.

A ranged input dep (``Dep.ranged``, the JDF ``<- ctl T(k, 0 .. NB)``
fan-in) makes its class *counted*: arrivals count toward
:meth:`TaskClass.input_dep_goal` instead of setting mask bits.  The
user-defined overrides (``make_key_fn``, ``find_deps_fn``,
``hash_struct`` through :class:`UDKey`, ``startup_fn``) and the
simulation cost (``simcost``) ride on the class.
"""

from __future__ import annotations

import itertools
from operator import itemgetter
from typing import Any, Callable, Sequence

# Hook return protocol (cf. runtime.h:139-147).
HOOK_RETURN_DONE = 0        # body executed to completion
HOOK_RETURN_ASYNC = -1      # body progresses asynchronously (device owns it)
HOOK_RETURN_AGAIN = -2      # reschedule the same chore later
HOOK_RETURN_NEXT = -3       # try the next chore / device
HOOK_RETURN_DISABLE = -4    # disable this chore for every task of the class
HOOK_RETURN_ERROR = -5

FLOW_CTL = "CTL"

DEV_CPU = "cpu"
DEV_CUDA = "cuda"
# a host callable that re-enters the runtime with a nested pool
# (runtime/recursive.py: PARSEC_DEV_RECURSIVE)
DEV_RECURSIVE = "recursive"

_task_counter = itertools.count()
_UNSET = object()   # lazy-attribute sentinel (space_extents)


class Dep:
    """One dependency edge endpoint on a flow (cf. ``parsec_dep_t``).

    Output dep: when ``guard(locals)`` holds, the flow's datum feeds task
    ``target_class`` instance ``target_params(locals)`` on flow
    ``target_flow``; ``target_class is None`` means the edge writes back
    to the data collection through ``data_ref``.  Input dep: the fields
    describe the predecessor symmetrically; ``target_class is None`` with
    a ``data_ref`` reads the collection.  With all targets None the dep is
    a NEW arrow (fresh tile of the flow's type) or, with ``null=True``, a
    NULL arrow.  ``wire`` is the sub-view a remote successor receives
    (slices, or a function of the locals); same-rank edges carry the
    whole tile.  A ``ranged`` input dep expects one arrival per instance
    of ``each_target`` (a counted fan-in).
    """

    __slots__ = ("guard", "target_class", "target_flow", "target_params",
                 "dtt", "data_ref", "null", "ranged", "wire")

    def __init__(self, guard: Callable[[dict], bool] | None = None,
                 target_class: str | None = None,
                 target_flow: str | None = None,
                 target_params: Callable[[dict], Any] | None = None,
                 dtt: Any = None,
                 data_ref: Callable[[dict], tuple] | None = None,
                 null: bool = False, ranged: bool = False,
                 wire: Any = None) -> None:
        self.guard = guard
        self.target_class = target_class
        self.target_flow = target_flow
        self.target_params = target_params
        self.dtt = dtt
        self.data_ref = data_ref
        self.null = null
        self.ranged = ranged
        self.wire = wire

    def wire_slices(self, locals_: dict) -> tuple | None:
        if self.wire is None:
            return None
        return self.wire(locals_) if callable(self.wire) else self.wire

    def active(self, locals_: dict) -> bool:
        return self.guard is None or bool(self.guard(locals_))

    def each_target(self, locals_: dict) -> tuple[dict, ...]:
        """Successor instances: one locals dict, or a sequence of them
        (the JDF range-arrow form)."""
        t = self.target_params(locals_)
        if isinstance(t, dict):
            return (t,)
        return tuple(t)


class Flow:
    """A named dataflow of a task class (cf. ``parsec_flow_t``)."""

    __slots__ = ("name", "access", "flow_index", "deps_in", "deps_out", "dtt")

    def __init__(self, name: str, access: Any, flow_index: int = -1,
                 deps_in: Sequence[Dep] = (), deps_out: Sequence[Dep] = (),
                 dtt: Any = None) -> None:
        self.name = name
        self.access = access            # ACCESS_* or FLOW_CTL
        self.flow_index = flow_index
        self.deps_in = list(deps_in)
        self.deps_out = list(deps_out)
        self.dtt = dtt

    @property
    def is_ctl(self) -> bool:
        return self.access == FLOW_CTL


class Chore:
    """One incarnation of a task class on a device type."""

    __slots__ = ("device_type", "hook", "evaluate", "dyld", "enabled")

    def __init__(self, device_type: str, hook: Callable | None = None,
                 evaluate: Callable | None = None,
                 dyld: str | None = None) -> None:
        self.device_type = device_type
        self.hook = hook          # (es, task) -> HOOK_RETURN_*
        self.evaluate = evaluate  # (es, task) -> DONE (use) / NEXT (skip)
        self.dyld = dyld          # kernel-registry name for device bodies
        self.enabled = True


class KeyHashStruct:
    """User key semantics (the JDF ``hash_struct`` property):
    ``key_hash(key) -> int``, ``key_equal(a, b) -> bool``,
    ``key_print(key) -> str``, applied through :class:`UDKey`."""

    __slots__ = ("key_hash", "key_equal", "key_print")

    def __init__(self, key_hash: Callable[[Any], int] | None = None,
                 key_equal: Callable[[Any, Any], bool] | None = None,
                 key_print: Callable[[Any], str] | None = None) -> None:
        self.key_hash = key_hash
        self.key_equal = key_equal
        self.key_print = key_print


class UDKey:
    """A task key carrying a :class:`KeyHashStruct`: the tracker and repo
    hash tables call the user's hash and equality."""

    __slots__ = ("key", "hs")

    def __init__(self, key: tuple, hs: KeyHashStruct) -> None:
        self.key = key
        self.hs = hs

    def __hash__(self) -> int:
        if self.hs.key_hash is not None:
            return int(self.hs.key_hash(self.key))
        return hash(self.key)

    def __eq__(self, other: Any) -> bool:
        ok = other.key if isinstance(other, UDKey) else other
        if self.hs.key_equal is not None:
            return bool(self.hs.key_equal(self.key, ok))
        return self.key == ok

    def __repr__(self) -> str:
        if self.hs.key_print is not None:
            return self.hs.key_print(self.key)
        return repr(self.key)


class TaskClass:
    """Static description of one task kind (cf. ``parsec_task_class_t``)."""

    def __init__(self, name: str, params: Sequence[str],
                 flows: Sequence[Flow], chores: Sequence[Chore],
                 task_class_id: int = -1,
                 affinity: Callable[[dict], tuple] | None = None,
                 priority: Callable[[dict], int] | None = None,
                 time_estimate: Callable[[Any, Any], float] | None = None,
                 prepare_input: Callable | None = None,
                 complete_execution: Callable | None = None,
                 make_key_fn: Callable[[dict], Any] | None = None,
                 find_deps_fn: Callable | None = None,
                 hash_struct: Any = None,
                 startup_fn: Callable | None = None,
                 simcost: Callable[[dict], float] | None = None) -> None:
        self.name = name
        self.params = list(params)
        self.flows = list(flows)
        for i, f in enumerate(self.flows):
            f.flow_index = i
        self.chores = list(chores)
        self.task_class_id = task_class_id
        self.affinity = affinity
        self.priority = priority
        self.time_estimate = time_estimate
        # (es, task) overrides of the generic data lookup and of the
        # successor walk (DTD's per-instance release)
        self.prepare_input = prepare_input
        self.complete_execution = complete_execution
        # user-defined overrides: key construction, tracker location, key
        # hashing, startup enumeration, and the simulated cost
        self.make_key_fn = make_key_fn
        self.find_deps_fn = find_deps_fn
        self.hash_struct = hash_struct
        self.startup_fn = startup_fn
        self.simcost = simcost
        # static execution-space box ((lo, stop) per param) for the
        # index-array dep tier, computed lazily at first use so globals
        # bound between build and execution count
        self.space_extents_fn: Callable[[], tuple | None] | None = None
        self._space_extents: Any = _UNSET
        # execution-space membership (locals -> bool), set by the PTG
        # builder: out-of-space successor edges are dropped at release
        self.in_space: Callable[[dict], bool] | None = None
        self.repo = None                  # DataRepo, attached by the taskpool
        # a ranged input dep counts arrivals toward a goal instead of
        # OR-ing mask bits (the dependencies_goal protocol)
        self.counted = any(d.ranged for f in self.flows for d in f.deps_in)
        if len(self.params) >= 2:
            self._keyget = itemgetter(*self.params)
        elif len(self.params) == 1:
            g = itemgetter(self.params[0])
            self._keyget = lambda d: (g(d),)
        else:
            self._keyget = lambda d: ()
        # (flow_index, dep_index) -> bit position of the IN-dep mask
        self._dep_bits: dict[tuple[int, int], int] = {}
        bit = 0
        for fi, f in enumerate(self.flows):
            for di in range(len(f.deps_in)):
                self._dep_bits[(fi, di)] = bit
                bit += 1

    def make_key(self, locals_: dict) -> tuple:
        """The task key: the params in order, or the user ``make_key_fn``'s
        key (a non-tuple is wrapped); a ``hash_struct`` wraps it in a
        :class:`UDKey`."""
        if self.make_key_fn is not None:
            k = self.make_key_fn(locals_)
            k = k if isinstance(k, tuple) else (k,)
        else:
            k = self._keyget(locals_)
        if self.hash_struct is not None:
            return (UDKey(k, self.hash_struct),)
        return k

    @property
    def space_extents(self) -> tuple | None:
        if self._space_extents is _UNSET:
            fn = self.space_extents_fn
            self._space_extents = fn() if fn is not None else None
        return self._space_extents

    def input_dep_mask(self, locals_: dict) -> int:
        """Bitmask of the task-predecessor input deps active for these
        locals (cf. ``parsec.c:1293``)."""
        mask = 0
        bit = 0
        for f in self.flows:
            for d in f.deps_in:
                if d.target_class is not None and d.active(locals_):
                    # an active ranged dep over an empty range expects no
                    # arrival and must not gate readiness
                    if not d.ranged or d.each_target(locals_):
                        mask |= 1 << bit
                bit += 1
        return mask

    def input_dep_goal(self, locals_: dict) -> int:
        """Expected arrivals of a counted class: one per active
        task-predecessor dep, one per target instance of a ranged dep."""
        goal = 0
        for f in self.flows:
            for d in f.deps_in:
                if d.target_class is None or not d.active(locals_):
                    continue
                goal += len(d.each_target(locals_)) if d.ranged else 1
        return goal

    def dep_bit(self, flow_index: int, dep_index: int) -> int:
        return self._dep_bits[(flow_index, dep_index)]

    def iterate_successors(self, task: "Task", visitor: Callable) -> None:
        """Visit every *active* out-dep edge: ``visitor(task, flow, dep)``."""
        for f in self.flows:
            for d in f.deps_out:
                if d.active(task.locals):
                    visitor(task, f, d)

    def __repr__(self) -> str:
        return f"<TaskClass {self.name}({', '.join(self.params)})>"


class Task:
    """One executable instance of a task class (cf. ``parsec_task_t``).
    A task a :class:`~parsec_tpu_torch.core.mempool.Mempool` hands out
    carries its owner in ``_mempool_owner``."""

    __slots__ = ("taskpool", "task_class", "locals", "priority", "data",
                 "repo_entries", "status", "chore_mask", "uid",
                 "selected_device", "sim_exec_date", "sched_vp",
                 "_mempool_owner")

    def __init__(self, taskpool: Any, task_class: TaskClass,
                 locals_: dict, priority: int = 0) -> None:
        self.taskpool = taskpool
        self.task_class = task_class
        self.locals = locals_
        self.priority = priority
        self.data: list[Any] = [None] * len(task_class.flows)
        # per-flow (repo_entry, src_flow_index) to consume after execution
        self.repo_entries: list[Any] = [None] * len(task_class.flows)
        self.status = "nascent"
        self.chore_mask = (1 << len(task_class.chores)) - 1
        self.uid = next(_task_counter)
        self.selected_device = None
        self.sim_exec_date = 0.0   # simulated completion date (simcost)
        # the virtual process it was scheduled on (several VPs only)
        self.sched_vp: int | None = None

    @property
    def key(self) -> tuple:
        return self.task_class.make_key(self.locals)

    def flow_data(self, name: str) -> Any:
        """The data copy bound to flow ``name`` (None if none is)."""
        for f in self.task_class.flows:
            if f.name == name:
                return self.data[f.flow_index]
        raise KeyError(name)

    def set_flow_data(self, name: str, value: Any) -> None:
        """Rebind flow ``name`` to another copy (a body that detaches its
        output from an input its neighbours still read)."""
        for f in self.task_class.flows:
            if f.name == name:
                self.data[f.flow_index] = value
                return
        raise KeyError(name)

    def __repr__(self) -> str:
        args = ", ".join(f"{p}={self.locals[p]}" for p in self.task_class.params)
        return f"<Task {self.task_class.name}({args})>"

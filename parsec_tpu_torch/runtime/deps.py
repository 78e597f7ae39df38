"""Dependency tracking: per-task IN-dep bookkeeping in three tiers.

Port of ``parsec_tpu/runtime/deps.py`` (the reference's
``parsec_default_find_deps`` / ``parsec_hash_find_deps`` /
``parsec_update_deps_with_mask``): tasks that are not ready yet exist
only as a tracker keyed by (taskpool, class, task key).  Each arriving
dep sets a bit in the satisfied mask; when it equals the required mask
(the class's active input-dep guards for those locals), the task is
instantiated with its inputs attached and handed back to be scheduled.
The trackers live in one of three tiers that share that protocol:

- **index-array** (``deps_storage=index-array``, the default): dense
  per-(taskpool, class) arrays over the class's static execution-space
  box, each with its own lock; :meth:`DependencyTracking.release_many`
  releases a batch of same-class records under one lock acquisition;
- **native**: the C++ dep table (:mod:`parsec_tpu_torch.native`), keyed
  by an exact 64-bit packing of the task identity (:func:`_pack_key64`),
  taken by classes the index tier does not hold when the key packs;
- **hashed**: a Python table for any other key.

Left out: the goal-counted mode of ranged deps and user-defined key and
dep-location functions (the port's task classes have none), and the
lock-contract table that the JAX package's runtime lint reads.
"""

from __future__ import annotations

import threading
from typing import Any

from ..core.hash_table import ConcurrentHashTable
from ..core.params import params as _params
from .task import Task, TaskClass

_params.register(
    "deps_storage", "index-array",
    "dep-tracker storage: 'index-array' (dense per-class arrays over "
    "static execution-space boxes, the default: other classes take the "
    "hashed tiers, and a batched release takes one lock per class "
    "group) or 'hash' (the native and Python hashed tiers only)")
# largest static-box volume (slots) the index-array tier backs densely:
# each slot holds a dep record, so a bigger box would allocate memory for
# tasks that may never exist; such classes take the hashed tiers
_INDEX_ARRAY_MAX_SLOTS = 1 << 22

# 64-bit key layout for the native dep table: [tpid:10][tcid:6][params:48].
# Packing is exact (injective) or refused: a key that does not pack takes
# the Python tracker for that task, never a lossy hash.
_TP_BITS, _TC_BITS, _PARAM_BITS = 10, 6, 48


def _pack_key64(tpid: int, tcid: int, key: tuple) -> int | None:
    if tpid >= (1 << _TP_BITS) or tcid >= (1 << _TC_BITS):
        return None
    v = 0
    p = len(key)
    if p:
        bits = _PARAM_BITS // p
        lim = 1 << bits
        for x in key:
            if type(x) is not int or x < 0 or x >= lim:
                return None
            v = (v << bits) | x
    return (tpid << (_TC_BITS + _PARAM_BITS)) | (tcid << _PARAM_BITS) | v


class _DepTracker:
    __slots__ = ("required_mask", "satisfied_mask", "inputs", "repo_refs")

    def __init__(self, required_mask: int, nflows: int) -> None:
        self.required_mask = required_mask
        self.satisfied_mask = 0
        self.inputs: list[Any] = [None] * nflows
        self.repo_refs: list[Any] = [None] * nflows


class _IndexArrayStore:
    """Dense per-(taskpool, class) tracker arrays over the static
    execution-space box (``parsec_default_find_deps``, ``parsec.c:1479``).
    Slot index = row-major linearization of (param - lo) over the box.
    Each (taskpool, class) array carries its own lock; the dict of arrays
    and the set of purged pools mutate under ``_lock`` only."""

    __slots__ = ("_arrays", "_lock", "_dead", "_fits", "allocated",
                 "releases")

    def __init__(self) -> None:
        self._arrays: dict[tuple, tuple] = {}   # akey -> (lock, list)
        self._lock = threading.Lock()
        # purged taskpool ids: a late release racing teardown must not
        # resurrect the array
        self._dead: set[int] = set()
        self._fits: dict[tuple, bool] = {}
        self.allocated = 0    # arrays created
        self.releases = 0     # dep records through this tier

    def fits(self, extents: tuple) -> bool:
        """Whether a static box is small enough to back densely."""
        ok = self._fits.get(extents)
        if ok is None:
            size = 1
            for lo, stop in extents:
                size *= max(stop - lo, 0)
            ok = self._fits[extents] = \
                size <= _INDEX_ARRAY_MAX_SLOTS
        return ok

    @staticmethod
    def slot(extents: tuple, tkey: tuple) -> int | None:
        if len(tkey) != len(extents):
            return None
        li = 0
        for (lo, stop), v in zip(extents, tkey):
            if type(v) is not int or v < lo or v >= stop:
                return None
            li = li * (stop - lo) + (v - lo)
        return li

    def array(self, taskpool: Any, tc: TaskClass) -> tuple | None:
        """(lock, slots) for one (taskpool, class), made at first use;
        None for a purged taskpool."""
        akey = (taskpool.taskpool_id, tc.task_class_id)
        with self._lock:
            if taskpool.taskpool_id in self._dead:
                return None
            entry = self._arrays.get(akey)
            if entry is None:
                size = 1
                for lo, stop in tc.space_extents:
                    size *= max(stop - lo, 0)
                entry = self._arrays[akey] = (threading.Lock(),
                                              [None] * size)
                self.allocated += 1
        return entry

    def purge(self, taskpool_id: int) -> None:
        with self._lock:
            self._dead.add(taskpool_id)
            for k in [k for k in self._arrays if k[0] == taskpool_id]:
                del self._arrays[k]


class DependencyTracking:
    """One instance per context.  The pure-CTL hot path with the native
    tier on touches no Python lock; data-carrying deps stash their input
    copies in a side dict (under ``_inputs_lock``) in the native tier."""

    def __init__(self) -> None:
        self._table = ConcurrentHashTable()
        self._native = None
        self._inputs: dict[int, list] = {}    # k64 -> inputs ++ repo_refs
        self._inputs_lock = threading.Lock()
        self._index_store = (_IndexArrayStore()
                             if _params.get("deps_storage") == "index-array"
                             else None)
        from .. import native                # registers runtime_native
        if _params.get("runtime_native") and native.available():
            self._native = native.NativeDepTable()

    def release_dep(self, taskpool: Any, tc: TaskClass, locals_: dict,
                    flow_index: int, dep_index: int,
                    data_copy: Any, repo_ref: Any = None) -> Task | None:
        """Record one satisfied input dep; return the now-ready Task or None.
        ``repo_ref`` is (repo_entry, src_flow_index), consumed at
        completion."""
        tkey = tc.make_key(locals_)
        bit = 1 << tc.dep_bit(flow_index, dep_index)
        if self._indexed_eligible(tc):
            li = _IndexArrayStore.slot(tc.space_extents, tkey)
            if li is not None:
                ready = self._release_indexed_batch(
                    taskpool, tc, [((tc, locals_, flow_index, dep_index,
                                     data_copy, repo_ref), li)])
                return ready[0] if ready else None
        if self._native is not None:
            k64 = _pack_key64(taskpool.taskpool_id, tc.task_class_id, tkey)
            if k64 is not None:
                return self._release_native(taskpool, tc, locals_, k64,
                                            bit, flow_index, data_copy,
                                            repo_ref)
        key = (taskpool.taskpool_id, tc.task_class_id, tkey)
        with self._table.locked(key):
            trk = self._table.get(key)
            if trk is None:
                trk = _DepTracker(tc.input_dep_mask(locals_), len(tc.flows))
                self._table.insert(key, trk)
            if trk.satisfied_mask & bit:
                raise RuntimeError(
                    f"dep {tc.name}{key} bit {bit} satisfied twice")
            trk.satisfied_mask |= bit
            if data_copy is not None:
                trk.inputs[flow_index] = data_copy
                trk.repo_refs[flow_index] = repo_ref
            ready = trk.satisfied_mask == trk.required_mask
            if ready:
                self._table.remove(key)
        if not ready:
            return None
        return self._make_ready(taskpool, tc, locals_, trk.inputs,
                                trk.repo_refs)

    def _indexed_eligible(self, tc: TaskClass) -> bool:
        """Whether a class's deps take the index-array tier: the ONE
        predicate both release paths share (a split would route one
        successor's records through two trackers and hang the pool)."""
        store = self._index_store
        return (store is not None and tc.space_extents is not None
                and store.fits(tc.space_extents))

    def release_many(self, taskpool: Any,
                     records: list[tuple]) -> list[Task]:
        """Batched release of one completing task's successor deps:
        ``records`` holds ``(tc, locals_, flow_index, dep_index,
        data_copy, repo_ref)``.  Records the index-array tier holds are
        grouped per class and released under ONE lock acquisition per
        group; the rest go record by record through :meth:`release_dep`.
        Returns every task that became ready."""
        ready: list[Task] = []
        if self._index_store is not None and len(records) > 1:
            by_class: dict[int, list] = {}
            tcs: dict[int, TaskClass] = {}
            rest: list[tuple] = []
            for rec in records:
                tc = rec[0]
                if self._indexed_eligible(tc):
                    li = _IndexArrayStore.slot(tc.space_extents,
                                               tc.make_key(rec[1]))
                    if li is not None:
                        cid = tc.task_class_id
                        by_class.setdefault(cid, []).append((rec, li))
                        tcs[cid] = tc
                        continue
                rest.append(rec)
            for cid, grp in by_class.items():
                ready.extend(self._release_indexed_batch(taskpool,
                                                         tcs[cid], grp))
            records = rest
        for tc, locals_, fi, di, data_copy, repo_ref in records:
            t = self.release_dep(taskpool, tc, locals_, fi, di, data_copy,
                                 repo_ref)
            if t is not None:
                ready.append(t)
        return ready

    def _release_indexed_batch(self, taskpool: Any, tc: TaskClass,
                               grp: list[tuple]) -> list[Task]:
        """The mask protocol on the index-array tier for a group of
        same-class records under one lock; returns the tasks that became
        ready."""
        store = self._index_store
        entry = store.array(taskpool, tc)
        if entry is None:
            return []        # taskpool already purged: late releases dropped
        lock, arr = entry
        done: list[tuple] = []
        with lock:
            # one dict read (atomic under the GIL): a purge that ran
            # between lookup and lock drops the records, since splitting
            # bits across an orphaned array would hang the pool
            cur = store._arrays.get((taskpool.taskpool_id,
                                     tc.task_class_id))
            if cur is None or cur[1] is not arr:
                return []
            store.releases += len(grp)
            for (_, locals_, fi, di, data_copy, repo_ref), li in grp:
                bit = 1 << tc.dep_bit(fi, di)
                trk = arr[li]
                if trk is None:
                    trk = arr[li] = _DepTracker(tc.input_dep_mask(locals_),
                                                len(tc.flows))
                if trk.satisfied_mask & bit:
                    raise RuntimeError(
                        f"dep {tc.name}[{li}] bit {bit} satisfied twice")
                trk.satisfied_mask |= bit
                if data_copy is not None:
                    trk.inputs[fi] = data_copy
                    trk.repo_refs[fi] = repo_ref
                if trk.satisfied_mask == trk.required_mask:
                    arr[li] = None
                    done.append((locals_, trk))
        return [self._make_ready(taskpool, tc, locals_, trk.inputs,
                                 trk.repo_refs)
                for locals_, trk in done]

    def _release_native(self, taskpool: Any, tc: TaskClass, locals_: dict,
                        k64: int, bit: int, flow_index: int,
                        data_copy: Any, repo_ref: Any) -> Task | None:
        # inputs are written BEFORE the native release: the releaser that
        # observes readiness sees every earlier writer's entry
        nf = len(tc.flows)
        if data_copy is not None:
            with self._inputs_lock:
                lst = self._inputs.get(k64)
                if lst is None:
                    lst = self._inputs[k64] = [None] * (2 * nf)
                lst[flow_index] = data_copy
                lst[nf + flow_index] = repo_ref
        if not self._native.release(k64, bit, tc.input_dep_mask(locals_)):
            return None
        with self._inputs_lock:
            lst = self._inputs.pop(k64, None)
        if lst is None:
            return self._make_ready(taskpool, tc, locals_,
                                    [None] * nf, [None] * nf)
        return self._make_ready(taskpool, tc, locals_, lst[:nf], lst[nf:])

    def _make_ready(self, taskpool: Any, tc: TaskClass, locals_: dict,
                    inputs: list, repo_refs: list) -> Task:
        prio = tc.priority(locals_) if tc.priority is not None else 0
        task = Task(taskpool, tc, dict(locals_), priority=prio)
        task.data = list(inputs)
        task.repo_entries = list(repo_refs)
        task.status = "ready"
        from .scheduling import resolve_data_inputs
        resolve_data_inputs(task)   # snapshot collection reads at creation
        return task

    def purge_taskpool(self, taskpool_id: int) -> None:
        """Reclaim tracker and input entries a finished (or aborted)
        taskpool left behind: the k64 space is context-wide."""
        shift = _TC_BITS + _PARAM_BITS
        with self._inputs_lock:
            for k in [k for k in self._inputs if (k >> shift) == taskpool_id]:
                del self._inputs[k]
        for key, _ in list(self._table.items()):
            if key[0] == taskpool_id:
                self._table.remove(key)
        if self._index_store is not None:
            self._index_store.purge(taskpool_id)

    @property
    def native_enabled(self) -> bool:
        return self._native is not None

    def __len__(self) -> int:
        n = len(self._table)
        if self._native is not None:
            n += len(self._native)
        return n

"""ptg_to_dtd: replay a PTG taskpool through the DTD interface.

Port of ``parsec_tpu/dtd/from_ptg.py`` (the reference's
``mca/pins/ptg_to_dtd``): the reference intercepts
a compiled PTG and re-executes it as runtime task insertion, using the PTG
as a test generator for the DTD engine — every hazard the guarded dep
graph encodes must be rediscovered by DTD's RAW/WAR/WAW chains.

The rebuild's form: concretely enumerate the PTG (same analysis the
lowering does), resolve each task flow to its *anchor tile* — the
collection datum the flow's dep chain starts or ends at — and insert one
DTD task per PTG task, in a topological order, with (tile, INPUT/INOUT/
OUTPUT) arguments derived from the flow accesses.  DTD's sequential-
consistency hazard tracking then reconstructs exactly the PTG's edges.

Scope: single rank; every flow must be a data flow anchored at a
collection (pure-CTL ordering has no data for DTD to track — such pools
raise).  Each task runs its class's host chore, so the PTG is built with
host bodies (``devices="cpu"``).  Nothing of the original is left out.
"""

from __future__ import annotations

from typing import Any

from ..data.data import ACCESS_READ, ACCESS_RW, ACCESS_WRITE
from .insert import INOUT, INPUT, OUTPUT, DTDTaskpool

__all__ = ["ptg_to_dtd"]


class PTGToDTDError(ValueError):
    pass


class _ShimCopy:
    """Quacks like a DataCopy for the PTG body (value + version)."""

    __slots__ = ("value", "version", "dtt")

    def __init__(self, value: Any) -> None:
        self.value = value
        self.version = 0
        self.dtt = None


def _enumerate(tp):
    builders = getattr(tp, "_tc_builders", None)
    if builders is None:
        raise PTGToDTDError("ptg_to_dtd needs an enumerable PTG taskpool")
    tasks = {}          # (cname, key) -> locals
    for tc in tp.task_classes:
        for f in tc.flows:
            if f.is_ctl:
                raise PTGToDTDError(
                    f"{tc.name}.{f.name}: pure-CTL ordering has no data "
                    f"for DTD hazard tracking to reconstruct")
        for loc in builders[tc.name]._enumerate_space():
            tasks[(tc.name, tc.make_key(loc))] = loc
    return tasks


def _topo(tp, tasks):
    indeg = {k: 0 for k in tasks}
    succs: dict[tuple, list] = {k: [] for k in tasks}
    for (cname, key), loc in tasks.items():
        tc = tp.task_class(cname)
        for f in tc.flows:
            for d in f.deps_out:
                if d.target_class is None or not d.active(loc):
                    continue
                ttc = tp.task_class(d.target_class)
                for tloc in d.each_target(loc):
                    tkey = (d.target_class, ttc.make_key(tloc))
                    if tkey not in tasks:
                        raise PTGToDTDError(
                            f"{cname}{key}: successor {tkey} outside the "
                            f"execution space")
                    succs[(cname, key)].append(tkey)
                    indeg[tkey] += 1
    ready = [k for k, n in indeg.items() if n == 0]
    order = []
    while ready:
        k = ready.pop()
        order.append(k)
        for s in succs[k]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if len(order) != len(tasks):
        raise PTGToDTDError("cycle in the PTG task graph")
    return order


def _anchor(tp, tasks, cname, key, flow_index, memo):
    """The collection datum a flow's dep chain is rooted at: walk input
    deps backward (then output deps forward for WRITE-only heads)."""
    mk = (cname, key, flow_index)
    if mk in memo:
        if memo[mk] is None:
            raise PTGToDTDError(f"cyclic anchor walk at {mk}")
        return memo[mk]
    memo[mk] = None
    loc = tasks[(cname, key)]
    tc = tp.task_class(cname)
    f = tc.flows[flow_index]
    for d in f.deps_in:
        if not d.active(loc):
            continue
        if d.data_ref is not None:
            memo[mk] = d.data_ref(loc)
            return memo[mk]
        ptc = tp.task_class(d.target_class)
        ploc = d.target_params(loc)
        pfi = next(ff.flow_index for ff in ptc.flows
                   if ff.name == d.target_flow)
        memo[mk] = _anchor(tp, tasks, d.target_class, ptc.make_key(ploc),
                           pfi, memo)
        return memo[mk]
    for d in f.deps_out:          # WRITE-only head: anchor at the sink
        if not d.active(loc):
            continue
        if d.data_ref is not None:
            memo[mk] = d.data_ref(loc)
            return memo[mk]
        stc = tp.task_class(d.target_class)
        sloc = next(iter(d.each_target(loc)))
        sfi = next(ff.flow_index for ff in stc.flows
                   if ff.name == d.target_flow)
        memo[mk] = _anchor(tp, tasks, d.target_class, stc.make_key(sloc),
                           sfi, memo)
        return memo[mk]
    raise PTGToDTDError(
        f"{cname}{key}.{f.name}: no dep chain anchors this flow at a "
        f"collection datum")


_MODE = {ACCESS_READ: INPUT, ACCESS_WRITE: OUTPUT, ACCESS_RW: INOUT}


def _replay_body(*args):
    """Shared DTD body: run one PTG task's CPU chore over DTD-managed
    arrays.  Trailing VALUE args carry (taskpool, task_class, locals,
    hook); the leading args are the flow arrays in flow order."""
    from ..runtime.task import Task
    *arrays, tp, tc, loc, hook = args
    shim = Task(tp, tc, dict(loc))
    for f, arr in zip(tc.flows, arrays):
        shim.data[f.flow_index] = _ShimCopy(arr)
    hook(None, shim)
    return tuple(shim.data[f.flow_index].value for f in tc.flows
                 if f.access in (ACCESS_WRITE, ACCESS_RW))


def ptg_to_dtd(tp, context) -> DTDTaskpool:
    """Execute PTG taskpool ``tp`` through DTD insertion on ``context``.

    Returns the (completed) DTD taskpool; collection data carries the same
    final values a direct PTG run would produce.
    """
    if getattr(context, "nb_ranks", 1) > 1:
        raise PTGToDTDError("ptg_to_dtd is single-rank (the reference "
                            "module predates DTD multirank too)")
    tasks = _enumerate(tp)
    order = _topo(tp, tasks)
    memo: dict = {}

    dtd = DTDTaskpool(name=f"{tp.name}_as_dtd")
    context.add_taskpool(dtd)

    from .insert import VALUE
    for cname, key in order:
        loc = tasks[(cname, key)]
        tc = tp.task_class(cname)
        chore = next(c for c in tc.chores if c.device_type == "cpu")
        args = []
        for f in tc.flows:
            dc, k = _anchor(tp, tasks, cname, key, f.flow_index, memo)
            if not isinstance(k, tuple):
                k = (k,)
            args.append((dtd.tile_of(dc, *k), _MODE[f.access]))
        # one shared body: per-task identity rides as VALUE args, so all
        # tasks of one PTG class share one DTD class (the 25-class cap)
        args.extend([(tp, VALUE), (tc, VALUE), (dict(loc), VALUE),
                     (chore.hook, VALUE)])
        dtd.insert_task(_replay_body, *args, name=f"{cname}{key}")

    for tile in list(dtd._tiles.values()):
        dtd.data_flush(tile)
    dtd.wait(timeout=120)
    return dtd

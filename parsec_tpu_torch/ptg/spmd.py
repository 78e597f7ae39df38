"""SPMD lowering: a distributed taskpool as one step over per-rank stores.

Port of the multi-rank half of ``parsec_tpu/ptg/lowering.py``
(``lower_taskpool(tp, mesh=...)``).  There, every stacked store is laid out
rank-major (the tiles rank r owns in rows ``[r*cap, (r+1)*cap)``), sharded
over the mesh's ``ranks`` axis, and GSPMD derives the collectives the
dynamic runtime's remote-dep protocol would make.  PyTorch derives
nothing, so this module writes that part out, over a
:class:`~.lowering.DeviceMesh` of one process:

- **Placement.**  A distributed store (``nodes > 1``) is one slab of
  ``cap`` rows a rank, on the rank's device.  A ``nodes == 1`` collection
  is replicated: one copy on each distinct device, shared by the ranks
  there, while the step only reads it.  A replicated store the step
  writes (the stencil's in-place chain over its snapshot ``V0``, a NEW
  arrow's scratch store) is *private*: one copy a rank, since the ranks'
  writes diverge.
- **The owner computes.**  A task runs on the rank that owns the
  distributed rows it writes; a task writing rows of two ranks raises
  :class:`LoweringError`, and one writing none runs on its affinity's
  rank (else rank 0).  Every group of a pass is split by rank.
- **A planned exchange.**  Before each level (each task, in the unrolled
  pass), a rank receives every row its tasks read that its own part does
  not hold current: a row of another rank's slab, or a private row
  another rank wrote last.  Each (source, destination, store) of a level
  is one ``index_select`` on the source's own part and one copy into the
  destination's receive rows; on one device the select writes them
  directly, across devices the copy is a peer copy.  A row a rank
  received is not sent to it again until it is written again: the
  dynamic protocol's one payload per remote rank.  The plan is made at
  lowering time, with its bytes by (source, destination).
- **Rank-local compute.**  Rank r's tensor of a store is its own part
  (its slab, or its copy) followed by its receive rows, laid out so when
  the stores are made; a step copies only the stores it writes.  A
  rank's tasks see only that tensor: their gather indices are local to
  it, their scatters land in the own part,
  and they run the kernels the single-rank passes run (K1 through
  ``gemm_chain`` and the factorization forms, K3 through the stencil's
  traceable).  A level's ranks run one after another; a rank writes only
  its own tensors, so the level stays atomic.
- **End of step.**  The rows a pass wrote in place only go back to the
  values they came in with, as in the single-rank passes, and a
  replicated collection the pool writes back is made equal on every rank
  again, each row from its last writer (``final_bytes``).

A mesh step takes and returns ``{name: (t_0, ..., t_{n-1})}``, rank r's
tensor of each store, own part then receive rows.
``DeviceMesh(["cuda:0"] * 4)`` is four ranks sharing the card, where the
exchange is a copy on the device.

The unrolled pass forwards values as well as rows: a value one rank made
and another reads is copied to the reader's device when the step runs,
and those bytes (the report's ``value_bytes``) are the last step's count,
not a plan.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable

import numpy as np
import torch

from .lowering import (LoweringError, _call_one, _chain_plan, _freeze,
                       _group_plans, _Index, _level_indices, _norm_key,
                       _run_level, _Stores, _unrolled_plans, _wavefront_plan)

__all__ = ["chain_collapse", "unrolled", "wavefront"]


def _sharded(stores: _Stores, name: str) -> bool:
    """Whether store ``name`` is one slab a rank (else replicated)."""
    return name in stores.dcs and name not in stores.replicated


class _Layout:
    """Where each store's rows live over the mesh's ranks; ``private``
    names the replicated stores that get one copy a rank."""

    def __init__(self, stores: _Stores, mesh: Any, private: set) -> None:
        self.stores = stores
        self.n = mesh.size
        self.devices = mesh.devices
        self.private = frozenset(private)

    def sharded(self, name: str) -> bool:
        return _sharded(self.stores, name)

    def own_len(self, name: str) -> int:
        """Rows of a rank's own part: its slab, or a whole copy."""
        nrows = self.stores.nrows[name]
        return nrows // self.n if self.sharded(name) else nrows

    def owner(self, name: str, row: int) -> int | None:
        return row // self.own_len(name) if self.sharded(name) else None

    def own_row(self, name: str, row: int, r: int) -> int:
        return row - r * self.own_len(name) if self.sharded(name) else row

    def row_bytes(self, name: str) -> int:
        st = self.stores
        return math.prod(st.shape[name]) * torch.empty(
            (), dtype=st.dtype[name]).element_size()

    def task_rank(self, rows: list, tc: Any, loc: dict) -> int:
        """The owner of the distributed rows a task writes; else its
        affinity's rank; else rank 0."""
        owners = {self.owner(name, row) for name, row in rows} - {None}
        if len(owners) > 1:
            raise LoweringError(
                f"{tc.name}{tc.make_key(loc)} writes rows of ranks "
                f"{sorted(owners)}: the owner computes, so a task writes "
                f"one rank's rows")
        if owners:
            return owners.pop()
        if tc.affinity is not None:
            dc, key = tc.affinity(loc)
            r = int(dc.rank_of(*_norm_key(key)))
            if 0 <= r < self.n:
                return r
        return 0


class _Exchange:
    """The exchange plan, built at lowering time in the step's order.

    A step's reads at ``t`` are declared first (:meth:`read`), then
    :meth:`commit` gives each row to receive a slot in the reader's
    receive rows (consecutive for one source and store, so each send is
    one copy), then :meth:`local` turns a read into its local row, then
    the writes at ``t`` are declared (:meth:`write`)."""

    def __init__(self, lay: _Layout) -> None:
        self.lay = lay
        self.last: dict[tuple, tuple] = {}    # (name, row) -> (t, rank)
        self.slot: dict[tuple, tuple] = {}    # (rank, name, row) -> (slot, t)
        self.nrecv: dict[tuple, int] = {}     # (rank, name) -> rows
        self.pending: dict[tuple, set] = {}   # (src, dst, name) -> rows
        self.sends: dict[Any, list] = {}      # t -> [(src, dst, name,
        #                                        _Index, slot0, count)]
        self.bytes: dict[tuple, int] = {}     # (src, dst) -> bytes
        self.rows = 0
        self.final: list = []                 # (src, dst, name, _Index)
        self.final_bytes = 0

    def _source(self, r: int, name: str, row: int) -> int | None:
        """The rank whose own part holds the row's current value, or None
        when rank r's does."""
        o = self.lay.owner(name, row)
        if o is not None:
            return None if o == r else o
        if name not in self.lay.private:
            return None                 # a read-only copy is never stale
        w = self.last.get((name, row))
        return None if w is None or w[1] == r else w[1]

    def read(self, r: int, name: str, row: int, t: Any) -> None:
        src = self._source(r, name, row)
        if src is None:
            return
        have = self.slot.get((r, name, row))
        if have is not None and have[1] > self.last.get((name, row),
                                                        (-1,))[0]:
            return                      # received since its last write
        self.pending.setdefault((src, r, name), set()).add(row)

    def commit(self, t: Any) -> None:
        lay = self.lay
        for (src, dst, name), rows in sorted(self.pending.items()):
            rows = sorted(rows)
            slot0 = self.nrecv.get((dst, name), 0)
            for i, row in enumerate(rows):
                self.slot[(dst, name, row)] = (slot0 + i, t)
            self.nrecv[(dst, name)] = slot0 + len(rows)
            src_rows = np.array([lay.own_row(name, row, src)
                                 for row in rows], np.int64)
            self.sends.setdefault(t, []).append(
                (src, dst, name, _Index(src_rows), slot0, len(rows)))
            nb = len(rows) * lay.row_bytes(name)
            self.bytes[(src, dst)] = self.bytes.get((src, dst), 0) + nb
            self.rows += len(rows)
        self.pending.clear()

    def local(self, r: int, name: str, row: int) -> int:
        """Rank r's local row of a read: in its own part, or past it in
        its receive rows."""
        if self._source(r, name, row) is None:
            return self.lay.own_row(name, row, r)
        return self.lay.own_len(name) + self.slot[(r, name, row)][0]

    def write(self, r: int, name: str, row: int, t: Any) -> None:
        self.last[(name, row)] = (t, r)

    def finish(self, written: set) -> None:
        """Plan the end-of-step copies that leave a private replicated
        collection the pool writes back equal on every rank."""
        by: dict[tuple, list] = {}
        for (name, row), (_, w) in sorted(self.last.items()):
            if name in written and name in self.lay.private:
                by.setdefault((w, name), []).append(row)
        for (w, name), rows in by.items():
            idx = _Index(np.array(rows, np.int64))
            for r in range(self.lay.n):
                if r != w:
                    self.final.append((w, r, name, idx))
                    self.final_bytes += len(rows) * self.lay.row_bytes(name)

    def report(self, groups_by_rank: list) -> dict:
        return {"bytes": dict(sorted(self.bytes.items())),
                "total_bytes": sum(self.bytes.values()),
                "rows": self.rows,
                "sends": sum(len(v) for v in self.sends.values()),
                "levels_with_sends": len(self.sends),
                "recv_rows": {f"{r}:{name}": k for (r, name), k
                              in sorted(self.nrecv.items())},
                "final_bytes": self.final_bytes,
                "groups_by_rank": list(groups_by_rank)}

    def placed(self) -> list:
        """Each send's source rows with its source rank's device, and each
        final copy's rows with both ranks' devices."""
        devs = self.lay.devices
        out = [(devs[s], idx) for sends in self.sends.values()
               for s, _d, _n, idx, _a, _k in sends]
        for w, r, _n, idx in self.final:
            out += [(devs[w], idx), (devs[r], idx)]
        return out


def _run_sends(sends: list, own: Callable, recv: Callable) -> None:
    """One level's exchange: for each (source, destination, store), the
    source's rows into the destination's receive rows."""
    for src, dst, name, idx, slot0, count in sends:
        s = own(src, name)
        d = recv(dst, name)[slot0:slot0 + count]
        rows = idx.on(s.device)
        if isinstance(rows, slice):
            d.copy_(s[rows], non_blocking=True)
        elif s.device == d.device:
            torch.index_select(s, 0, rows, out=d)
        else:
            d.copy_(s.index_select(0, rows), non_blocking=True)


def _run_final(final: list, own: Callable) -> None:
    for w, r, name, idx in final:
        s, d = own(w, name), own(r, name)
        rows_s = idx.on(s.device)
        v = s[rows_s]
        d[idx.on(d.device)] = v.to(d.device, non_blocking=True)


def _time_ms(fn: Callable, devices: tuple, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after one warm-up:
    CUDA events on one card, else the host's wall after a
    synchronize."""
    fn()
    kinds = {str(d) for d in devices}
    if len(kinds) == 1 and devices[0].type == "cuda":
        dev = devices[0]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        for _ in range(reps):
            fn()
        end.record(torch.cuda.current_stream(dev))
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


class _MeshStep:
    """A mesh step: ``__call__(stores) -> stores``, the exchange plan's
    ``report``, the index tensors each rank's device needs (``placed``),
    and the two measurements :class:`~.lowering.LoweredTaskpool` exposes
    (:meth:`timings`, :meth:`by_rank`).

    Rank r's tensor of a store is its own part followed by its receive
    rows (``nrecv``), laid out so when the stores are made
    (:meth:`~.lowering._Stores.materialize` with this step), and a step
    returns them so.  A step copies only the stores it writes
    (``targets``, own part); the sends land in the receive rows of the
    tensors it was given.  ``private`` names the replicated stores with
    one copy a rank."""

    def __init__(self, lay: _Layout, ex: _Exchange,
                 groups_by_rank: list) -> None:
        self.devices = lay.devices
        self.n = lay.n
        self.private = lay.private
        self.own_len = {name: lay.own_len(name)
                        for name in lay.stores.nrows}
        self.sends = ex.sends
        self.order = sorted(ex.sends)
        self.nrecv = dict(ex.nrecv)
        self.final = ex.final
        self.report = ex.report(groups_by_rank)
        self.placed = ex.placed()
        self._probe = None
        self._probed = None

    def _rank(self, r: int, fn: Callable, *args) -> None:
        """Run rank r's part of a level, reading the probe around it."""
        if self._probe is None:
            fn(*args)
            return
        before = self._probe()
        fn(*args)
        acc = self._probed[r]
        for k, v in self._probe().items():
            acc[k] = acc.get(k, 0) + v - before.get(k, 0)

    def by_rank(self, stores: dict, probe: Callable) -> tuple:
        self._probe, self._probed = probe, [{} for _ in range(self.n)]
        try:
            out = self(stores)
            return out, self._probed
        finally:
            self._probe = self._probed = None

    def recv_rows(self, r: int, name: str) -> int:
        """Receive rows of rank r's tensor of store ``name``."""
        return self.nrecv.get((r, name), 0)

    def _locals(self, st: dict) -> list:
        """Each rank's tensor of each store: a new one, its own part
        copied, for a store the step writes; the input itself otherwise."""
        loc = [{} for _ in range(self.n)]
        for name, parts in st.items():
            n = self.own_len[name]
            for r in range(self.n):
                t = parts[r]
                if t.shape[0] != n + self.recv_rows(r, name):
                    raise ValueError(
                        f"store {name}: rank {r}'s tensor has {t.shape[0]} "
                        f"rows, the step's layout {n} own and "
                        f"{self.recv_rows(r, name)} received")
                if name in self.targets:
                    buf = torch.empty_like(t)
                    buf[:n] = t[:n]
                    t = buf
                loc[r][name] = t
        return loc

    def _recv(self, loc: list) -> Callable:
        return lambda r, name: loc[r][name][self.own_len[name]:]

    def _exchange_only(self, stores: dict) -> Callable:
        loc = [{name: parts[r] for name, parts in stores.items()}
               for r in range(self.n)]
        recv = self._recv(loc)

        def run():
            for t in self.order:
                _run_sends(self.sends[t], lambda r, nm: loc[r][nm], recv)
        return run

    def _outputs(self, st: dict, loc: list) -> dict:
        """The step's stores, in the layout it was given."""
        if self.final:
            _run_final(self.final, lambda r, nm: loc[r][nm])
        return {name: tuple(loc[r][name] for r in range(self.n))
                for name in st}

    def timings(self, stores: dict, reps: int = 3) -> dict:
        exch = self._exchange_only(stores)
        ex_ms = _time_ms(exch, self.devices, reps)
        step_ms = _time_ms(lambda: self(stores), self.devices, reps)
        return {"step_ms": step_ms, "exchange_ms": ex_ms,
                "exchange_share": ex_ms / step_ms if step_ms else 0.0}


# ---------------------------------------------------------------------------
# chain collapse: one contraction a rank over its own accumulator tiles
# ---------------------------------------------------------------------------

class _ChainStep(_MeshStep):

    def __init__(self, lay, ex, plan, names, per_rank, groups) -> None:
        super().__init__(lay, ex, groups)
        self.combine = plan.info.kernel.chain_combine
        self.an, self.bn, self.cn = names
        self.targets = {self.cn}
        self.per_rank = per_rank      # r -> (ja, jb, jc, (M, N)) | None
        for r, pr in enumerate(per_rank):
            if pr is not None:
                self.placed += [(self.devices[r], x) for x in pr[:3]]

    def __call__(self, st: dict) -> dict:
        loc = self._locals(st)
        _run_sends(self.sends.get(0, ()), lambda r, nm: loc[r][nm],
                   self._recv(loc))
        for r, pr in enumerate(self.per_rank):
            if pr is not None:
                self._rank(r, self._one, loc[r], pr)
        return self._outputs(st, loc)

    def _one(self, loc: dict, pr) -> None:
        ja, jb, jc, m_n = pr
        a, b, c_own = loc[self.an], loc[self.bn], loc[self.cn]
        j = jc.on(c_own.device)
        c = self.combine(a[ja.on(a.device)], b[jb.on(b.device)],
                         c_own[j].reshape(*m_n, *c_own.shape[1:]))
        c_own[j] = c.reshape(-1, *c.shape[2:]).to(c_own.dtype)


def chain_collapse(tp, infos, stores: _Stores, mesh: Any):
    """The chain collapse over a mesh: rank r contracts the accumulator
    tiles it owns, ``(Ms x Ns)``, in one ``chain_combine`` (one K1 launch
    for the GEMM), over lhs rows ``[Ms, K]`` and rhs rows ``[K, Ns]`` it
    holds or received.  A rank whose tiles are not such a product set
    raises :class:`LoweringError` (``"auto"`` then takes the wavefront
    pass)."""
    plan = _chain_plan(tp, infos, stores)
    if plan is None:
        return None
    an, bn, cn = plan.lhs_dc.name, plan.rhs_dc.name, plan.acc_dc.name
    lay = _Layout(stores, mesh, () if _sharded(stores, cn) else {cn})
    IA, IB, IC = plan.IA, plan.IB, plan.IC
    M, N = IC.shape
    tc = plan.info.tc
    owner = np.array([[lay.task_rank([(cn, int(IC[m, n]))], tc,
                                     plan.last[(m, n)])
                       for n in range(N)] for m in range(M)], np.int64)
    ex = _Exchange(lay)
    tiles = []
    for r in range(lay.n):
        mine = owner == r
        if not mine.any():
            tiles.append(None)
            continue
        ms = np.flatnonzero(mine.any(axis=1))
        ns = np.flatnonzero(mine.any(axis=0))
        if mine.sum() != len(ms) * len(ns) \
                or not mine[np.ix_(ms, ns)].all():
            raise LoweringError(
                f"rank {r}'s accumulator tiles are not a product of rows "
                f"and columns: no single contraction covers them")
        tiles.append((ms, ns))
        for row in IA[ms].reshape(-1):
            ex.read(r, an, int(row), 0)
        for row in IB[:, ns].reshape(-1):
            ex.read(r, bn, int(row), 0)
    ex.commit(0)
    per_rank = []
    for r, mn in enumerate(tiles):
        if mn is None:
            per_rank.append(None)
            continue
        ms, ns = mn

        def local(name, rows):
            return _Index(np.vectorize(lambda x: ex.local(r, name, int(x)),
                                       otypes=[np.int64])(rows))
        rows_c = IC[np.ix_(ms, ns)].reshape(-1)
        jc = _Index(np.array([lay.own_row(cn, int(x), r) for x in rows_c],
                             np.int64))
        for x in rows_c:
            ex.write(r, cn, int(x), 0)
        per_rank.append((local(an, IA[ms]), local(bn, IB[:, ns]), jc,
                         (len(ms), len(ns))))
    ex.finish(stores.written)
    groups = [0 if p is None else 1 for p in per_rank]
    step = _ChainStep(lay, ex, plan, (an, bn, cn), per_rank, groups)
    sig = ("mesh-chain", plan.info.kernel, an, bn, cn, _freeze(IA),
           _freeze(IB), _freeze(IC), _freeze(owner))
    return step, sig


# ---------------------------------------------------------------------------
# wavefront: each rank's groups on its own part and its receive rows
# ---------------------------------------------------------------------------

class _WavefrontStep(_MeshStep):

    def __init__(self, lay, ex, levels, specs, targets, dirty,
                 groups) -> None:
        super().__init__(lay, ex, groups)
        self.levels = len(levels)
        self.groups = sum(groups)
        self.level_keys = levels
        self.specs = specs          # rank -> {level: [group spec]}
        self.targets = targets
        self.dirty = dirty          # rank -> {name: _Index of own rows}
        for r in range(self.n):
            dev = self.devices[r]
            self.placed += [(dev, x) for x in (
                *dirty[r].values(), *_level_indices(list(specs[r].values())))]

    def __call__(self, st: dict) -> dict:
        loc = self._locals(st)
        recv = self._recv(loc)
        saved = [{name: loc[r][name][idx.on(loc[r][name].device)].clone()
                  for name, idx in self.dirty[r].items()}
                 for r in range(self.n)]
        for L in self.level_keys:
            sends = self.sends.get(L)
            if sends:
                _run_sends(sends, lambda r, nm: loc[r][nm], recv)
            for r in range(self.n):
                specs = self.specs[r].get(L)
                if specs:
                    self._rank(r, _run_level, loc[r], specs)
        for r in range(self.n):
            for name, idx in self.dirty[r].items():
                t = loc[r][name]
                t[idx.on(t.device)] = saved[r][name]
        return self._outputs(st, loc)


def _writes(out_plan) -> list:
    """The (store, row) pairs a task's out plan scatters to."""
    rows = []
    for primary, extras, _w in out_plan:
        if primary is not None:
            rows.append(primary)
        rows.extend(extras)
    return rows


def wavefront(tp, infos, stores: _Stores, mesh: Any):
    """The wavefront pass over a mesh: the same plan and hazard checks as
    on one rank, each task on its rank, each level's groups split by
    rank over rank-local rows, and the level's exchange before them."""
    plans, dirty_by_name = _wavefront_plan(tp, infos, stores)
    writes = [_writes(p[5]) for p in plans]
    private = {name for rows in writes for name, _ in rows
               if not _sharded(stores, name)} | set(stores.scratch)
    lay = _Layout(stores, mesh, private)
    ranks = [lay.task_rank(w, infos[p[2]].tc, infos[p[2]].tasks[p[0][1]])
             for p, w in zip(plans, writes)]
    ex = _Exchange(lay)
    local: list[list] = [[] for _ in range(lay.n)]
    wrote: list[dict] = [{} for _ in range(lay.n)]
    by_level: dict[int, list] = {}
    for j, p in enumerate(plans):
        by_level.setdefault(p[1], []).append(j)
    for L in sorted(by_level):
        members = by_level[L]
        for j in members:
            for ip in plans[j][4]:
                if ip[0] == "row":
                    ex.read(ranks[j], ip[1], ip[2], L)
        ex.commit(L)
        for j in members:
            node, _L, cname, key, in_plan, out_plan = plans[j]
            r = ranks[j]
            lin = [("row", ip[1], ex.local(r, ip[1], ip[2]))
                   if ip[0] == "row" else ip for ip in in_plan]
            lout = [((p[0], lay.own_row(p[0], p[1], r)) if p else None,
                     [(nm, lay.own_row(nm, rw, r)) for nm, rw in extras], w)
                    for p, extras, w in out_plan]
            local[r].append((node, L, cname, key, lin, lout))
        for j in members:
            for name, row in writes[j]:
                ex.write(ranks[j], name, row, L)
                wrote[ranks[j]].setdefault(name, set()).add(row)
    ex.finish(stores.written)
    specs = [_group_plans(local[r], infos) for r in range(lay.n)]
    groups = [sum(len(v) for v in specs[r].values()) for r in range(lay.n)]
    dirty = []
    for r in range(lay.n):
        mine = {}
        for name, rows in dirty_by_name.items():
            own = [lay.own_row(name, int(x), r) for x in rows
                   if int(x) in wrote[r].get(name, ())]
            if own:
                mine[name] = _Index(np.array(own, np.int64))
        dirty.append(mine)
    targets = {name for rows in writes for name, _ in rows}
    step = _WavefrontStep(lay, ex, sorted(by_level), specs, targets, dirty,
                          groups)
    sig = ("mesh-wavefront", _freeze(dirty_by_name), _freeze(ranks), tuple(
        tuple(tuple((kernel, nw, _freeze(g), _freeze(sc), G)
                    for kernel, nw, g, sc, G, _c in specs[r][L])
              for L in sorted(specs[r]))
        for r in range(lay.n)))
    return step, sig


# ---------------------------------------------------------------------------
# unrolled: task by task, each on its rank
# ---------------------------------------------------------------------------

class _UnrolledStep(_MeshStep):

    def __init__(self, lay, ex, tasks, targets, groups) -> None:
        super().__init__(lay, ex, groups)
        self.tasks = tasks    # (rank, info, in_plan, out_plan, ck) a task
        self.targets = targets
        self.report["value_bytes"] = {}     # the last step's, measured

    def __call__(self, st: dict) -> dict:
        loc = self._locals(st)
        recv = self._recv(loc)
        vals: dict[tuple, tuple] = {}     # ck -> (rank, value)
        moved: dict[tuple, torch.Tensor] = {}
        value_bytes: dict[tuple, int] = {}
        for t, (r, info, in_plan, out_plan, ck) in enumerate(self.tasks):
            sends = self.sends.get(t)
            if sends:
                _run_sends(sends, lambda q, nm: loc[q][nm], recv)
            dev = self.devices[r]
            args = []
            for kind, *ref in in_plan:
                if kind == "store":
                    name, row = ref
                    args.append(loc[r][name][row].clone())
                elif kind == "none":
                    args.append(None)
                elif kind == "new":
                    args.append(torch.zeros(ref[0], dtype=ref[1],
                                            device=dev))
                else:
                    src, v = vals[ref[0]]
                    if src != r:
                        # a value made on another rank: a copy of its own
                        got = moved.get((ref[0], r))
                        if got is None:
                            got = moved[(ref[0], r)] = v.to(dev, copy=True)
                            nb = v.numel() * v.element_size()
                            value_bytes[(src, r)] = \
                                value_bytes.get((src, r), 0) + nb
                        v = got
                    args.append(v)
            self._rank(r, self._one, r, loc, info, args, out_plan, ck, vals)
        self.report["value_bytes"] = dict(sorted(value_bytes.items()))
        return self._outputs(st, loc)

    @staticmethod
    def _one(r, loc, info, args, out_plan, ck, vals) -> None:
        nw = len(info.writable_flows)
        res = _call_one(info.kernel, nw, args) if nw else ()
        wi = {f.flow_index: j for j, f in enumerate(info.writable_flows)}
        for fj, (f, rows) in enumerate(zip(info.data_flows, out_plan)):
            v = res[wi[f.flow_index]] if f.flow_index in wi else args[fj]
            vals[ck + (f.flow_index,)] = (r, v)
            for name, row in rows:
                loc[r][name][row] = v


def unrolled(tp, infos, stores: _Stores, mesh: Any):
    """The unrolled pass over a mesh: task by task in topological order,
    each on its rank, with the rows it reads from other ranks exchanged
    just before it runs."""
    plans = _unrolled_plans(tp, infos, stores)
    writes = [[x for rows in p[4] for x in rows] for p in plans]
    private = {name for rows in writes for name, _ in rows
               if not _sharded(stores, name)}
    lay = _Layout(stores, mesh, private)
    by_key = {}
    for cname, info in infos.items():
        for loc in info.tasks:
            by_key[(cname, info.tc.make_key(loc))] = loc
    ex = _Exchange(lay)
    tasks = []
    groups = [0] * lay.n
    for t, ((cname, key, info, in_plan, out_plan), w) in enumerate(
            zip(plans, writes)):
        r = lay.task_rank(w, info.tc, by_key[(cname, key)])
        for ip in in_plan:
            if ip[0] == "store":
                ex.read(r, ip[1], ip[2], t)
        ex.commit(t)
        lin = [("store", ip[1], ex.local(r, ip[1], ip[2]))
               if ip[0] == "store" else ip for ip in in_plan]
        lout = [[(nm, lay.own_row(nm, row, r)) for nm, row in rows]
                for rows in out_plan]
        for name, row in w:
            ex.write(r, name, row, t)
        tasks.append((r, info, lin, lout, (cname, key)))
        groups[r] += 1
    ex.finish(stores.written)
    targets = {name for rows in writes for name, _ in rows}
    step = _UnrolledStep(lay, ex, tasks, targets, groups)
    sig = ("mesh-unrolled", tuple(
        (cname, key, info.kernel, r, _freeze(lin), _freeze(lout))
        for (r, info, lin, lout, (cname, key)) in tasks))
    return step, sig

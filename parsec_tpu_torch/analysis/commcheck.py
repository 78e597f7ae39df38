"""commcheck: static communication-pattern derivation over PTG pools.

Port of ``parsec_tpu/analysis/commcheck.py``, the comm-side twin of
:mod:`.graphcheck` (and the static twin of the ``prof/critpath`` edge
classes): replay the verified concrete graph a
:class:`~parsec_tpu_torch.analysis.GraphReport` retained against each
collection's ``rank_of`` affinity and derive, WITHOUT executing
anything, every pool's cross-rank traffic:

- **per-edge-class byte counts**: flow name x pow-2 size tier
  (``A:4mib``), the keying ``prof/critpath`` uses for measured comm
  spans, so predicted and measured traffic join on one key;
- **per-rank fan-out/fan-in degrees** and a per-rank-pair byte matrix;
- **a pattern classification** per pool: ``broadcast`` / ``reduce`` /
  ``halo`` / ``point-to-point`` / ``all-to-all`` / ``none``.

Three consumers:

1. typed :class:`~parsec_tpu_torch.analysis.Finding`\\ s (task, flow and
   instance provenance) for static comm hazards graphcheck's rank-blind
   walk cannot see:

   =============================  =======================================
   ``duplicate-activation``       the same flow payload is activated to
                                  the same remote consumer twice (two
                                  active edges land on one instance/flow)
   ``unowned-remote-read``        a cross-rank collection read of a tile
                                  NO task writes, in a collection that IS
                                  written in-pool: the reader snapshots
                                  a never-produced home copy
   ``cross-rank-unordered-write`` a rank-crossing WAR/WAW pair with no
                                  ordering path: the home copy's final
                                  state rests only on message arrival
   ``tree-shape-mismatch``        a bcast/reduce pool whose derived tree
                                  degree is pathological (star/chain) for
                                  its payload class
   =============================  =======================================

2. the ``comm_pattern`` block of ``runtime_report()`` (from
   :func:`report_block`), and the agreement check against the bytes a
   run really moved (:func:`agreement_rel_err`; ``chip_smoke.py``'s
   ``commcheck`` phase holds each pool within 15% of them);
3. :func:`recommend_tree`, a per-edge-class tree shape through the rule
   ``comm_bcast_tree=auto`` resolves by
   (:func:`~parsec_tpu_torch.comm.remote_dep.resolve_tree_kind`).

Beside the JAX report's total, the port's :class:`CommReport` splits
its cross-rank bytes into collection reads (``read_bytes``), write-backs
(``writeback_bytes``) and task-to-task activations
(``activation_bytes``): the port's rank bodies build their input tiles
on every rank, so only activations cross the wire, and the check on the
card holds those against the bytes the GETs landed.

Byte sizes come from the collections' declared geometry: a tile is
``tile_shape x itemsize``, the itemsize read from the collection's
``torch.dtype`` (numpy has no bfloat16, so a bf16 tile sizes through
``torch.dtype.itemsize``, never through ``np.dtype``).

CLI: ``python -m parsec_tpu_torch.analysis --comm`` classifies the model
sweep; ``python -m parsec_tpu_torch.analysis.commcheck --self-test``
runs the built-in invariants.
"""

from __future__ import annotations

from typing import Any

import math

from ..core.params import params as _params
from .graphcheck import (ERROR, WARNING, Finding, _askey, _node_str, _Probe,
                         _Reachability, check_ptg)

PATTERNS = ("broadcast", "reduce", "halo", "point-to-point",
            "all-to-all", "none")

# pool name -> last to_dict() block: the runtime_report() feed (the block
# appears only in processes that actually ran commcheck — byte-compat)
_ANALYZED: dict[str, dict] = {}


def report_block(compact: bool = False) -> dict[str, dict]:
    """Snapshot of every pool analyzed in this process (may be empty).

    ``compact=True`` is the ``runtime_report()`` form — that report has
    a hard compactness contract, so the block shrinks to the decision
    surface (pattern, bytes, recommended tree, finding counts), keeps
    only pools that actually cross ranks or found something, and caps
    at the most recently analyzed entries."""
    if not compact:
        return dict(_ANALYZED)
    keep = [(n, d) for n, d in _ANALYZED.items()
            if d.get("cross_rank_bytes") or d.get("findings")]
    out: dict[str, dict] = {}
    for n, d in keep[-8:]:
        out[n] = {"pattern": d["pattern"],
                  "cross_rank_bytes": d["cross_rank_bytes"],
                  "recommended_tree": d["recommended_tree"],
                  "findings": d["findings"]}
    return out


class CommReport:
    """The outcome of one comm-pattern derivation pass."""

    def __init__(self, name: str, nb_ranks: int) -> None:
        self.name = name
        self.nb_ranks = nb_ranks
        self.findings: list[Finding] = []
        self._seen: dict[tuple, Finding] = {}
        self.ntasks = 0
        self.truncated = False
        self.pattern = "none"
        # edge class ("flow:tier") -> cross-rank payload bytes / transfers
        self.edge_bytes: dict[str, int] = {}
        self.edge_count: dict[str, int] = {}
        # (src_rank, dst_rank) -> cross-rank payload bytes
        self.rank_bytes: dict[tuple[int, int], int] = {}
        self.graph_report: Any = None
        # of the cross-rank bytes: collection reads of a tile another
        # rank owns, and write-backs to one (the rest are activations,
        # task to task); the JAX report keeps only the total
        self.read_bytes = 0
        self.writeback_bytes = 0

    # same collapse discipline as GraphReport.add: first instance carries
    # the provenance, count carries the blast radius
    def add(self, code: str, severity: str, message: str,
            task_class: str | None = None, flow: str | None = None,
            instance: dict | None = None) -> None:
        key = (code, task_class, flow, message)
        f = self._seen.get(key)
        if f is not None:
            f.count += 1
            return
        f = Finding(code, severity, message, task_class, flow, instance)
        self._seen[key] = f
        self.findings.append(f)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def total_bytes(self) -> int:
        return sum(self.edge_bytes.values())

    @property
    def activation_bytes(self) -> int:
        """Cross-rank bytes of task-to-task activations alone (what a
        runtime that reads each rank's own copy of its input collections
        moves): the total less the reads and write-backs."""
        return self.total_bytes - self.read_bytes - self.writeback_bytes

    @property
    def fan_out(self) -> dict[int, int]:
        """rank -> number of distinct ranks it sends payload to."""
        out: dict[int, set] = {}
        for (s, d) in self.rank_bytes:
            out.setdefault(s, set()).add(d)
        return {r: len(v) for r, v in out.items()}

    @property
    def fan_in(self) -> dict[int, int]:
        out: dict[int, set] = {}
        for (s, d) in self.rank_bytes:
            out.setdefault(d, set()).add(s)
        return {r: len(v) for r, v in out.items()}

    def to_dict(self) -> dict:
        return {
            "pattern": self.pattern,
            "nranks": self.nb_ranks,
            "ntasks": self.ntasks,
            "cross_rank_bytes": self.total_bytes,
            "cross_rank_transfers": sum(self.edge_count.values()),
            "edge_classes": dict(sorted(self.edge_bytes.items())),
            "fan_out_max": max(self.fan_out.values(), default=0),
            "fan_in_max": max(self.fan_in.values(), default=0),
            "findings": len(self.findings),
            "recommended_tree": recommend_tree(self)["overall"],
        }

    def summary(self) -> str:
        return (f"commcheck {self.name}: {self.pattern} — {self.ntasks} "
                f"tasks on {self.nb_ranks} rank(s), {self.total_bytes} "
                f"cross-rank bytes over {sum(self.edge_count.values())} "
                f"transfers, {len(self.errors)} errors, "
                f"{len(self.warnings)} warnings"
                + (" (truncated)" if self.truncated else ""))

    def __repr__(self) -> str:
        return f"<CommReport {self.summary()}>"


# ---------------------------------------------------------------------------
# byte-size oracles (best-effort, never raise)
# ---------------------------------------------------------------------------


def _dtt_nbytes(dtt: Any) -> int:
    try:
        return int(dtt.nbytes)
    except Exception:
        return 0


def _itemsize(dtype: Any) -> int:
    """Bytes of one element of ``dtype``: a ``torch.dtype`` answers
    itself (bf16 included); anything else goes through numpy."""
    size = getattr(dtype, "itemsize", None)
    if isinstance(size, int) and not isinstance(dtype, type):
        return size
    import numpy as np
    return int(np.dtype(dtype).itemsize)


def _tile_nbytes(dc: Any, key: tuple) -> int:
    """Bytes of one tile of ``dc``: tile_shape x itemsize when the
    collection declares geometry, its default tile type otherwise."""
    try:
        ts = getattr(dc, "tile_shape", None)
        if ts is not None:
            shape = ts(*key)
            return int(math.prod(shape)) * _itemsize(dc.dtype)
    except Exception:
        pass
    try:
        # 1-D segment collections (VectorTwoDimCyclic): ragged last tile
        if hasattr(dc, "mb") and hasattr(dc, "lm") and len(key) == 1:
            size = min(int(dc.mb), int(dc.lm) - int(key[0]) * int(dc.mb))
            return max(size, 0) * _itemsize(dc.dtype)
    except Exception:
        pass
    return _dtt_nbytes(getattr(dc, "default_dtt", None))


def _flow_itemsize(tc: Any, flow: Any, space: list[dict]) -> int:
    for d in list(flow.deps_in) + list(flow.deps_out):
        if d.data_ref is None:
            continue
        for locals_ in space[:4]:
            try:
                dc, _key = d.data_ref(locals_)
                return _itemsize(dc.dtype)
            except Exception:
                continue
    return 4


def _class_flow_bytes(tc: Any, flow: Any, space: list[dict]) -> int:
    """Static payload estimate for one (class, flow): the largest tile
    any of its data arrows can resolve (guards ignored — the estimate is
    class-level), falling back to declared tile types."""
    if flow.is_ctl:
        return 0
    best = _dtt_nbytes(flow.dtt)
    for d in list(flow.deps_in) + list(flow.deps_out):
        if d.dtt is not None:
            best = max(best, _dtt_nbytes(d.dtt))
        if d.data_ref is None:
            continue
        for locals_ in space:
            try:
                dc, key = d.data_ref(locals_)
                b = _tile_nbytes(dc, _askey(key))
            except Exception:
                continue
            if b:
                best = max(best, b)
                break
    return best


def _slices_nbytes(slices: Any, itemsize: int) -> int | None:
    """Byte size of a wire-view slice tuple (partial-tile datatype);
    None when the extents cannot be derived statically."""
    try:
        n = 1
        for s in slices:
            if not isinstance(s, slice) or s.start is None or s.stop is None:
                return None
            step = s.step or 1
            n *= max((s.stop - s.start + step - 1) // step, 0)
        return n * itemsize
    except Exception:
        return None


# ---------------------------------------------------------------------------
# the derivation walk
# ---------------------------------------------------------------------------


def _node_rank(tc: Any, locals_: dict, probe: _Probe) -> int:
    if tc.affinity is None:
        return 0
    res = probe(tc.affinity, "affinity", tc.name, None, locals_, locals_)
    if res is None:
        return 0
    dc, key = res
    try:
        return int(dc.rank_of(*_askey(key)))
    except Exception:
        return 0


def _dep_active(d: Any, locals_: dict, probe: _Probe, tc: Any,
                flow: Any) -> bool:
    if d.guard is None:
        return True
    return bool(probe(d.guard, "guard", tc.name, flow.name, locals_,
                      locals_, default=False))


def _traffic(cr: CommReport, flow_name: str, src: int, dst: int,
             nbytes: int) -> None:
    from ..prof.critpath import _size_tier
    ec = f"{flow_name}:{_size_tier(nbytes)}"
    cr.edge_bytes[ec] = cr.edge_bytes.get(ec, 0) + int(nbytes)
    cr.edge_count[ec] = cr.edge_count.get(ec, 0) + 1
    cr.rank_bytes[(src, dst)] = \
        cr.rank_bytes.get((src, dst), 0) + int(nbytes)


def check_comm(tp: Any, nb_ranks: int | None = None,
               report: Any = None, max_tasks: int | None = None
               ) -> CommReport:
    """Derive ``tp``'s cross-rank communication pattern statically.

    ``report`` may pass a pre-computed :class:`GraphReport` (its retained
    concrete graph supplies node membership and the ordering oracle);
    otherwise :func:`check_ptg` runs first.  Nothing executes."""
    if nb_ranks is None:
        nb_ranks = tp.context.nb_ranks if tp.context is not None else 1
    nb_ranks = max(int(nb_ranks), 1)
    if report is None:
        report = check_ptg(tp, nb_ranks=nb_ranks, max_tasks=max_tasks)
    if max_tasks is None:
        max_tasks = _params.get("analysis_max_tasks")
    cr = CommReport(tp.name, nb_ranks)
    cr.graph_report = report
    cr.truncated = bool(report.truncated)
    probe = _Probe(cr)

    # ---- phase 1: execution space + the rank_of affinity replay -----------
    instances: dict[str, list[dict]] = {}
    node_rank: dict[tuple, int] = {}
    total = 0
    for tc in tp.task_classes:
        tcb = tp._tc_builders.get(tc.name)
        space: list[dict] = []
        if tcb is not None and not cr.truncated:
            try:
                for locals_ in tcb._enumerate_space():
                    space.append(dict(locals_))
                    total += 1
                    if total >= max_tasks:
                        cr.truncated = True
                        break
            except Exception:
                pass      # graphcheck already reported the range error
        instances[tc.name] = space
        for locals_ in space:
            node = (tc.name, tc.make_key(locals_))
            node_rank[node] = _node_rank(tc, locals_, probe)
    cr.ntasks = total
    graph_nodes = set(report.graph) if report.graph else None

    # ---- phase 2: flow-labeled edge walk ----------------------------------
    # collection writebacks / reads: (id(dc), key) -> [(node, flow, locals)]
    wb: dict[tuple, list[tuple]] = {}
    rd: dict[tuple, list[tuple]] = {}
    tile_owner: dict[tuple, int] = {}
    dc_names: dict[tuple, str] = {}
    dc_written: set[int] = set()
    # (producer node, flow name) -> [(snode, sflow, dst_rank, bytes, locals)]
    acts: dict[tuple, list[tuple]] = {}

    for tc in tp.task_classes:
        space = instances[tc.name]
        flow_bytes = {f.name: _class_flow_bytes(tc, f, space)
                      for f in tc.flows}
        flow_isize = {f.name: _flow_itemsize(tc, f, space)
                      for f in tc.flows}
        for locals_ in space:
            node = (tc.name, tc.make_key(locals_))
            src_rank = node_rank.get(node, 0)
            for flow in tc.flows:
                for d in flow.deps_in:
                    if d.data_ref is None:
                        continue
                    if not _dep_active(d, locals_, probe, tc, flow):
                        continue
                    res = probe(d.data_ref, "input data ref", tc.name,
                                flow.name, locals_, locals_)
                    if res is None:
                        continue
                    dc, key = res
                    key = _askey(key)
                    tkey = (id(dc), key)
                    dc_names[tkey] = getattr(dc, "name", "?")
                    try:
                        owner = int(dc.rank_of(*key)) if nb_ranks > 1 else 0
                    except Exception:
                        owner = 0
                    tile_owner[tkey] = owner
                    rd.setdefault(tkey, []).append(
                        (node, flow.name, dict(locals_)))
                    if owner != src_rank and not flow.is_ctl:
                        nb_ = _tile_nbytes(dc, key)
                        cr.read_bytes += nb_
                        _traffic(cr, flow.name, owner, src_rank, nb_)
                for d in flow.deps_out:
                    if not _dep_active(d, locals_, probe, tc, flow):
                        continue
                    if d.data_ref is not None:
                        res = probe(d.data_ref, "output data ref", tc.name,
                                    flow.name, locals_, locals_)
                        if res is None or flow.is_ctl:
                            continue
                        dc, key = res
                        key = _askey(key)
                        tkey = (id(dc), key)
                        dc_names[tkey] = getattr(dc, "name", "?")
                        try:
                            owner = int(dc.rank_of(*key)) \
                                if nb_ranks > 1 else 0
                        except Exception:
                            owner = 0
                        tile_owner[tkey] = owner
                        dc_written.add(id(dc))
                        wb.setdefault(tkey, []).append(
                            (node, flow.name, dict(locals_)))
                        if owner != src_rank:
                            nb_ = _tile_nbytes(dc, key)
                            cr.writeback_bytes += nb_
                            _traffic(cr, flow.name, src_rank, owner, nb_)
                        continue
                    if d.target_class is None or flow.is_ctl:
                        continue     # NULL outputs / CTL carry no payload
                    succ_tc = tp.task_classes_by_name.get(d.target_class)
                    if succ_tc is None:
                        continue     # graphcheck reported the unknown class
                    eb = flow_bytes[flow.name]
                    if d.wire is not None:
                        ws = probe(d.wire_slices, "wire view", tc.name,
                                   flow.name, locals_, locals_)
                        w = _slices_nbytes(ws, flow_isize[flow.name])
                        if w is not None:
                            eb = min(eb, w) if eb else w
                    targets = probe(d.each_target, "output params", tc.name,
                                    flow.name, locals_, locals_, default=())
                    for sl in targets:
                        try:
                            if succ_tc.in_space is not None \
                                    and not succ_tc.in_space(sl):
                                continue
                        except Exception:
                            pass
                        try:
                            skey = succ_tc.make_key(sl)
                        except Exception:
                            continue       # graphcheck reported the bind
                        snode = (succ_tc.name, skey)
                        if graph_nodes is not None and not cr.truncated \
                                and snode not in graph_nodes:
                            continue       # dangling: graphcheck reported
                        acts.setdefault((node, flow.name), []).append(
                            (snode, d.target_flow,
                             node_rank.get(snode, 0), eb, dict(locals_)))

    # ---- phase 3: activation coalescing + duplicate detection -------------
    # the runtime activates each (task, flow) payload ONCE per remote rank
    # (remote_dep._RemoteOutput.ranks), so traffic counts one transfer per
    # distinct consumer rank; two active edges landing on the SAME
    # instance/flow of a remote peer are the duplicate-activation hazard
    for (node, fname), targets in acts.items():
        src = node_rank.get(node, 0)
        per_rank: dict[int, int] = {}
        pair_count: dict[tuple, tuple] = {}
        for (snode, sflow, dst, eb, locals_) in targets:
            if dst != src:
                per_rank[dst] = max(per_rank.get(dst, 0), eb)
            k2 = (snode, sflow)
            cnt, _ = pair_count.get(k2, (0, None))
            pair_count[k2] = (cnt + 1, locals_)
        for dst, b in per_rank.items():
            _traffic(cr, fname, src, dst, b)
        for (snode, sflow), (cnt, locals_) in pair_count.items():
            dst = node_rank.get(snode, 0)
            if cnt > 1 and dst != src:
                cr.add(
                    "duplicate-activation", WARNING,
                    f"the same payload is activated to "
                    f"{_node_str(snode)}.{sflow} on rank {dst} {cnt} "
                    f"times — duplicate edges to one remote consumer "
                    f"waste activation frames and double-set its dep",
                    task_class=node[0], flow=fname, instance=locals_)

    # ---- phase 4: rank-aware hazards --------------------------------------
    if nb_ranks > 1:
        for tkey, readers in rd.items():
            if tkey in wb or tkey[0] not in dc_written:
                # written tile, or a pure-input collection (legitimate
                # initial data: nothing in-pool was supposed to produce it)
                continue
            owner = tile_owner.get(tkey, 0)
            for (rnode, fname, locals_) in readers:
                if node_rank.get(rnode, 0) != owner:
                    cr.add(
                        "unowned-remote-read", WARNING,
                        f"cross-rank read of tile "
                        f"{dc_names[tkey]}{tkey[1]} (home rank {owner}) "
                        f"that no task writes back, in a collection the "
                        f"pool DOES write — the reader snapshots a "
                        f"never-produced home copy",
                        task_class=rnode[0], flow=fname, instance=locals_)
        if not cr.truncated and cr.ntasks <= 4000:
            reach = _Reachability(report.graph)
            for tkey, writers in wb.items():
                uniq: dict[tuple, tuple] = {}
                for (wnode, fname, locals_) in writers:
                    uniq.setdefault(wnode, (fname, locals_))
                wlist = sorted(uniq)
                for i, a in enumerate(wlist):
                    for b2 in wlist[i + 1:]:
                        ra = node_rank.get(a, 0)
                        rb = node_rank.get(b2, 0)
                        if ra == rb or reach.ordered(a, b2):
                            continue
                        fname, locals_ = uniq[a]
                        cr.add(
                            "cross-rank-unordered-write", ERROR,
                            f"{_node_str(a)} (rank {ra}) and "
                            f"{_node_str(b2)} (rank {rb}) both write back "
                            f"tile {dc_names[tkey]}{tkey[1]} with no "
                            f"ordering path — the home copy's final state "
                            f"is whichever writeback message lands last",
                            task_class=a[0], flow=fname, instance=locals_)
                for (rnode, fname, locals_) in rd.get(tkey, ()):
                    rr = node_rank.get(rnode, 0)
                    for wnode in wlist:
                        if rnode == wnode \
                                or node_rank.get(wnode, 0) == rr \
                                or reach.ordered(rnode, wnode):
                            continue
                        cr.add(
                            "cross-rank-unordered-write", WARNING,
                            f"{_node_str(rnode)} (rank {rr}) reads tile "
                            f"{dc_names[tkey]}{tkey[1]} while "
                            f"{_node_str(wnode)} (rank "
                            f"{node_rank.get(wnode, 0)}) writes it back, "
                            f"unordered across ranks — the WAR outcome "
                            f"is decided by message arrival",
                            task_class=rnode[0], flow=fname,
                            instance=locals_)

    # ---- phase 5: pattern classification + tree-shape sanity --------------
    wb_owner_ranks = {tile_owner.get(t, 0) for t in wb}
    cr.pattern = _classify(cr.rank_bytes, nb_ranks, wb_owner_ranks)
    _check_tree_shape(cr)
    # pop-then-set keeps insertion order = recency, which the compact
    # report_block cap relies on
    _ANALYZED.pop(cr.name, None)
    _ANALYZED[cr.name] = cr.to_dict()
    return cr


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


def _reaches_all(pairs: set, root: int, parts: list[int],
                 reverse: bool = False) -> bool:
    adj: dict[int, list[int]] = {}
    for (s, d) in pairs:
        if reverse:
            s, d = d, s
        adj.setdefault(s, []).append(d)
    seen = {root}
    frontier = [root]
    while frontier:
        n = frontier.pop()
        for s in adj.get(n, ()):
            if s not in seen:
                seen.add(s)
                frontier.append(s)
    return seen >= set(parts)


def _classify(rank_bytes: dict[tuple, int], nb_ranks: int,
              wb_owner_ranks: set[int]) -> str:
    """Rank-pair traffic matrix -> pattern label:
    dense all-pairs -> all-to-all; bidirectional neighbor-only -> halo;
    unique source reaching every participant -> broadcast; unique sink
    every participant reaches -> reduce (chains are disambiguated by
    where the writebacks land); the sparse remainder -> point-to-point."""
    pairs = {(s, d) for (s, d) in rank_bytes if s != d}
    if nb_ranks <= 1 or not pairs:
        return "none"
    parts = sorted({r for p in pairs for r in p})
    k = len(parts)
    if k > 2 and len(pairs) >= 0.8 * k * (k - 1):
        return "all-to-all"

    def neighbor(s: int, d: int) -> bool:
        return abs(s - d) == 1 or abs(s - d) == nb_ranks - 1

    if k >= 3 and all(neighbor(s, d) for (s, d) in pairs) \
            and any((d, s) in pairs for (s, d) in pairs):
        return "halo"
    outd = {r: len({d for (s, d) in pairs if s == r}) for r in parts}
    ind = {r: len({s for (s, d) in pairs if d == r}) for r in parts}
    sources = [r for r in parts if ind[r] == 0 and outd[r] > 0]
    sinks = [r for r in parts if outd[r] == 0 and ind[r] > 0]
    bcast_like = len(sources) == 1 and _reaches_all(pairs, sources[0], parts)
    reduce_like = len(sinks) == 1 and _reaches_all(pairs, sinks[0], parts,
                                                   reverse=True)
    if bcast_like and reduce_like:
        # a chain is both shapes; where the results LAND disambiguates —
        # replicated writebacks mean broadcast, one home rank means reduce
        return "reduce" if len(wb_owner_ranks) == 1 else "broadcast"
    if bcast_like:
        return "broadcast"
    if reduce_like:
        return "reduce"
    return "point-to-point"


def _derived_shape(cr: CommReport) -> str | None:
    """Star/chain detection over the derived rank tree (broadcast keys on
    fan-out, reduce on fan-in); None below 4 participants — star and
    binomial coincide there."""
    pairs = {(s, d) for (s, d) in cr.rank_bytes if s != d}
    parts = sorted({r for p in pairs for r in p})
    k = len(parts)
    if k < 4:
        return None
    deg = cr.fan_out if cr.pattern == "broadcast" else cr.fan_in
    top = max(deg.values(), default=0)
    if top >= k - 1:
        return "star"
    if top == 1:
        return "chain"
    return "binomial"


def _check_tree_shape(cr: CommReport) -> None:
    if cr.pattern not in ("broadcast", "reduce"):
        return
    derived = _derived_shape(cr)
    if derived not in ("star", "chain"):
        return
    rec = recommend_tree(cr)["overall"]
    if rec == derived:
        return
    why = ("the root moves O(n) payload copies"
           if derived == "star" else "the relay depth is O(n) hops")
    cr.add(
        "tree-shape-mismatch", WARNING,
        f"derived {cr.pattern} tree is {derived}-shaped over "
        f"{cr.nb_ranks} ranks ({why}); the traffic profile recommends "
        f"'{rec}' — set comm_bcast_tree={rec} (or 'auto')")


def recommend_tree(report: CommReport) -> dict:
    """Per-edge-class tree-shape recommendation from derived traffic:
    the same rule ``comm_bcast_tree=auto`` resolves through
    (:func:`~parsec_tpu_torch.comm.remote_dep.resolve_tree_kind`) — payloads
    at or under ``comm_short_limit`` on small meshes take the
    latency-minimal star, everything else the egress-bounding binomial.
    ``overall`` follows the heaviest class."""
    from ..comm.remote_dep import resolve_tree_kind
    n = max(int(report.nb_ranks), 2)
    per = {}
    for ec, total in report.edge_bytes.items():
        cnt = max(report.edge_count.get(ec, 1), 1)
        per[ec] = resolve_tree_kind("auto", nbytes=total // cnt, n=n)
    overall = "binomial"
    if report.edge_bytes:
        heavy = max(report.edge_bytes, key=lambda c: report.edge_bytes[c])
        overall = per[heavy]
    return {"per_class": per, "overall": overall}


# ---------------------------------------------------------------------------
# the measured-traffic twin (the collectives' peer_stats comparison)
# ---------------------------------------------------------------------------


def predict_collective_traffic(nranks: int,
                               payload_bytes: int | None = None) -> dict:
    """Static prediction of the exact pools ``_mp_collective_body`` runs
    (one broadcast of ``comm_coll_bench_bytes`` + one 64-element
    reduction over ``nranks`` ranks): total cross-rank payload bytes,
    the root's egress, and the per-edge-class breakdown — what the
    measured ``peer_stats()`` ledger is compared against."""
    from ..comm.collectives import bcast_taskpool, reduce_taskpool
    from ..data_dist.matrix import VectorTwoDimCyclic
    nbytes = int(payload_bytes if payload_bytes is not None
                 else _params.get("comm_coll_bench_bytes"))
    mb = max(nbytes // 4, 1)
    V = VectorTwoDimCyclic("V", lm=mb * nranks, mb=mb, P=nranks)
    crb = check_comm(bcast_taskpool(V, n=nranks), nb_ranks=nranks)
    R = VectorTwoDimCyclic("R", lm=64 * nranks, mb=64, P=nranks)
    O = VectorTwoDimCyclic("O", lm=64, mb=64, P=1)
    crr = check_comm(reduce_taskpool(R, O, op="sum", n=nranks),
                     nb_ranks=nranks)
    edge_bytes: dict[str, int] = {}
    for cr in (crb, crr):
        for ec, b in cr.edge_bytes.items():
            edge_bytes[ec] = edge_bytes.get(ec, 0) + b
    return {
        "bcast_pattern": crb.pattern,
        "reduce_pattern": crr.pattern,
        "total_bytes": crb.total_bytes + crr.total_bytes,
        "root_egress_bytes": sum(
            b for (s, _d), b in crb.rank_bytes.items() if s == 0),
        "edge_bytes": edge_bytes,
    }


def agreement_rel_err(predicted: int, observed: int) -> float:
    """Relative disagreement of a static byte prediction vs the wire
    ledger, on the predicted base (the model is the contract)."""
    return abs(int(observed) - int(predicted)) / max(int(predicted), 1)


# ---------------------------------------------------------------------------
# self-test + CLI
# ---------------------------------------------------------------------------


def self_test() -> int:
    """Built-in invariants over known pools (scripts/check.sh stage)."""
    from ..comm.collectives import bcast_taskpool, reduce_taskpool
    from ..data_dist.matrix import VectorTwoDimCyclic

    def vec(name, n, mb=1024, P=1):
        return VectorTwoDimCyclic(name, lm=mb * n, mb=mb, P=P)

    n = 8
    cr = check_comm(bcast_taskpool(vec("V", n, P=n), n=n), nb_ranks=n)
    assert cr.pattern == "broadcast" and not cr.findings, cr
    assert cr.total_bytes == (n - 1) * 4096, cr.edge_bytes
    assert sum(b for (s, _d), b in cr.rank_bytes.items() if s == 0) \
        == 3 * 4096, cr.rank_bytes     # binomial root egress: 3 children
    out = vec("O", 1)
    cr = check_comm(reduce_taskpool(vec("R", n, P=n), out, n=n),
                    nb_ranks=n)
    assert cr.pattern == "reduce" and not cr.findings, cr
    cr = check_comm(bcast_taskpool(vec("S", n), n=n), nb_ranks=1)
    assert cr.pattern == "none" and cr.total_bytes == 0, cr

    # star shape on a payload-heavy broadcast is degree-pathological
    cr = check_comm(
        bcast_taskpool(vec("W", n, mb=65536, P=n), n=n, kind="star"),
        nb_ranks=n)
    assert cr.pattern == "broadcast", cr
    assert any(f.code == "tree-shape-mismatch" for f in cr.findings), cr
    rec = recommend_tree(cr)
    assert rec["overall"] == "binomial", rec

    # a duplicated activation edge names its producer exactly
    tp = bcast_taskpool(vec("D", n, P=n), n=n)
    fa = tp.task_classes_by_name["B"].flows[0]
    fa.deps_out.append(fa.deps_out[0])
    cr = check_comm(tp, nb_ranks=n)
    hits = [f for f in cr.findings if f.code == "duplicate-activation"]
    assert hits and hits[0].task_class == "B" and hits[0].flow == "A", cr

    pred = predict_collective_traffic(4, payload_bytes=1 << 16)
    assert pred["bcast_pattern"] == "broadcast"
    assert pred["reduce_pattern"] == "reduce"
    assert pred["root_egress_bytes"] == 2 * (1 << 16), pred
    print("commcheck self-test OK")
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m parsec_tpu_torch.analysis.commcheck",
        description="static comm-pattern derivation; the model sweep "
                    "lives on `python -m parsec_tpu_torch.analysis --comm`")
    ap.add_argument("--self-test", action="store_true",
                    help="run the built-in invariants")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test()
    ap.print_help()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

"""graphcheck: static dataflow verification of PTG and DTD taskpools.

Port of ``parsec_tpu/analysis/graphcheck.py`` (the verification half of
the reference's ``parsec_ptgpp`` compiler, ``jdf_sanity_checks`` and the
generated bounds and iterator contracts), over the *built* taskpool: the
concrete execution space is enumerated (never executed) and every
guard, range and assignment closure is evaluated against the namespaces
the runtime would use, so an unbound local or an out-of-range index is a
typed finding instead of an ``AttributeError`` on a worker thread.  No
body runs and no tile is read: the check touches neither the card nor
the host tiles, only the collections' ``has_key`` and ``rank_of``
oracles.

Checks (each finding carries task-class / flow / instance provenance):

=====================  ======================================================
``missing-input-edge``    an output arrow lands on a consumer with no
                          matching active input dep (the classic
                          hand-written-JDF hang: the datum arrives, no bit
                          to set)
``missing-output-edge``   an input arrow names a producer that never sends
                          (the consumer waits forever)
``dangling-input``        an input arrow names a predecessor instance
                          outside its execution space
``dependency-cycle``      the concrete task graph has a cycle
``ctl-data-mismatch``     a CTL flow wired to a data flow (or vice versa)
``write-flow-receives-input``  a WRITE-only flow with a data-carrying input
``no-input-source``       a READ/RW flow instance with outputs but no
                          active input, NEW, or NULL arrow ("no valid
                          copy" at runtime)
``read-chain-never-written``  a same-class serialization chain (the k-chain
                          shape) on a flow that never writes — the
                          RW-flipped-to-READ signature
``unordered-shared-write``  two consumers share one producer copy, at
                          least one mutates, and no dep path orders them
``unordered-writeback``   two writeback edges target one collection tile
                          with no ordering path (WAW on the home copy)
``tile-out-of-range``     a data/affinity reference outside the
                          collection's bounds
``rank-out-of-range``     an affinity resolving outside ``[0, nb_ranks)``
``class-without-affinity``  a multirank pool class with no affinity (runs
                          replicated on every rank)
``edge-eval-error``       a guard/params/key/range closure raised during
                          probe evaluation (unbound local, bad index, ...)
``no-startup-task``       a non-empty pool where no instance starts ready
``dead-flow``             a flow with no active dep on any instance
=====================  ======================================================

Three more codes come from the same walks: ``dangling-output`` and
``unordered-collection-read`` (warnings) and, for DTD,
``inconsistent-dep-count``.  The findings, their provenance and the
retained concrete graph (:attr:`GraphReport.graph`, ``(class, key) ->
successors``) are the JAX package's on the same pool; ``analysis_max_tasks``
caps the enumeration as there.

:meth:`GraphReport.select_regions` carves the retained graph into
megakernel regions (:mod:`.regions`).  :func:`check_jdf` parses a JDF
source with :mod:`parsec_tpu_torch.ptg.jdf` and verifies the built pool.
:meth:`GraphReport.critical_path` runs critpath's
``dag_critical_path`` over the retained graph.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from ..core.params import params as _params
from ..data.data import ACCESS_READ, ACCESS_WRITE

_params.register(
    "analysis_max_tasks", 50000,
    "instance cap for graphcheck's concrete-space enumeration; larger "
    "pools are verified on a truncated prefix (report.truncated)")

ERROR = "error"
WARNING = "warning"


class Finding:
    """One typed verification finding with provenance."""

    __slots__ = ("code", "severity", "message", "task_class", "flow",
                 "instance", "count", "file", "line")

    def __init__(self, code: str, severity: str, message: str,
                 task_class: str | None = None, flow: str | None = None,
                 instance: dict | None = None, file: str | None = None,
                 line: int | None = None) -> None:
        self.code = code
        self.severity = severity
        self.message = message
        self.task_class = task_class
        self.flow = flow
        self.instance = dict(instance) if instance is not None else None
        self.count = 1        # instances collapsed into this finding
        self.file = file      # runtimelint provenance
        self.line = line

    def _where(self) -> str:
        if self.file is not None:
            return f"{self.file}:{self.line}"
        parts = ""
        if self.task_class:
            parts = self.task_class
            if self.instance is not None:
                args = ", ".join(f"{k}={v}" for k, v in self.instance.items())
                parts += f"({args})"
            if self.flow:
                parts += f".{self.flow}"
        return parts

    def __repr__(self) -> str:
        w = self._where()
        n = f" [x{self.count}]" if self.count > 1 else ""
        return f"[{self.severity}] {self.code}{n} {w}: {self.message}"


class GraphCheckError(RuntimeError):
    """Gate-mode rejection: the pool failed static verification.  Raised
    by :func:`check_taskpool` (and, under the ``analysis_check`` param,
    by ``Context.add_taskpool`` and ``DTDTaskpool.close``) instead of
    letting the malformed graph hang or corrupt numerics at run time.
    ``findings`` holds the full report."""

    def __init__(self, report: "GraphReport") -> None:
        errs = report.errors
        lines = "\n  ".join(repr(f) for f in errs[:10])
        more = f"\n  ... +{len(errs) - 10} more" if len(errs) > 10 else ""
        super().__init__(
            f"graphcheck: {len(errs)} error(s) in taskpool "
            f"{report.name!r}:\n  {lines}{more}")
        self.report = report
        self.findings = list(report.findings)


class GraphReport:
    """The outcome of one verification pass."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.findings: list[Finding] = []
        self.ntasks = 0
        self.nedges = 0
        self.truncated = False
        # the concrete task graph the edge walk materialized:
        # (class, key) -> successor nodes, retained for the consumers
        # that work off the verified execution space
        self.graph: dict[tuple, list[tuple]] = {}
        self._seen: dict[tuple, Finding] = {}

    def add(self, code: str, severity: str, message: str,
            task_class: str | None = None, flow: str | None = None,
            instance: dict | None = None) -> None:
        # collapse per-instance repeats of one structural defect: the first
        # instance carries the provenance, the count carries the blast radius
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

    def raise_if_failed(self) -> "GraphReport":
        if not self.ok:
            raise GraphCheckError(self)
        return self

    def select_regions(self, max_tasks: int = 0) -> list:
        """Carve the verified concrete task graph into maximal acyclic
        subregions (:mod:`.regions`): convex wavefront-level bands per
        weakly-connected component, capped at ``max_tasks`` members (0 =
        unbounded).  The megakernel lowering
        (``ptg/lowering.lower_regions``) prepares one step per region.
        Raises on a truncated or failing report: regions over an
        unverified graph could hide the hazards this report surfaces."""
        from .regions import regions_of_report
        return regions_of_report(self, max_tasks=max_tasks)

    def critical_path(self, class_costs: dict | None = None) -> dict:
        """Longest-cost chain over the concrete graph
        (:func:`parsec_tpu_torch.prof.critpath.dag_critical_path`), each
        node weighted by its class's mean exec cost from ``class_costs``
        (``critpath.class_costs_from`` of a critpath report), unit
        weights otherwise."""
        from ..prof.critpath import dag_critical_path
        return dag_critical_path(self.graph, class_costs)

    def summary(self) -> str:
        state = "OK" if self.ok else "FAILED"
        return (f"graphcheck {self.name}: {state} — {self.ntasks} tasks, "
                f"{self.nedges} edges, {len(self.errors)} errors, "
                f"{len(self.warnings)} warnings"
                + (" (truncated)" if self.truncated else ""))

    def __repr__(self) -> str:
        return f"<GraphReport {self.summary()}>"


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def check_taskpool(tp: Any, nb_ranks: int | None = None,
                   raise_on_error: bool = False) -> GraphReport:
    """Verify any supported taskpool; dispatches on its front-end kind."""
    from ..dtd.insert import DTDTaskpool
    from ..ptg.dsl import PTGTaskpool
    if isinstance(tp, PTGTaskpool):
        report = check_ptg(tp, nb_ranks=nb_ranks)
    elif isinstance(tp, DTDTaskpool):
        report = check_dtd(tp, nb_ranks=nb_ranks)
    else:
        raise TypeError(
            f"graphcheck supports PTG and DTD taskpools, "
            f"got {type(tp).__name__}")
    if raise_on_error:
        report.raise_if_failed()
    return report


# ---------------------------------------------------------------------------
# PTG verification
# ---------------------------------------------------------------------------


def _has_key(dc: Any, key: tuple) -> bool | None:
    """Bounds oracle: True/False when the collection can answer, None when
    its key space is open (hash/dict collections without declared keys)."""
    has = getattr(dc, "has_key", None)
    if has is None:
        return None
    try:
        return bool(has(*key))
    except Exception:
        return False


def _askey(v: Any) -> tuple:
    return v if isinstance(v, tuple) else (v,)


class _Probe:
    """Evaluate one edge closure; failures become findings, not crashes."""

    def __init__(self, report: GraphReport) -> None:
        self.report = report

    def __call__(self, fn: Callable, what: str, tc_name: str,
                 flow: str | None, inst: dict, *args: Any,
                 default: Any = None) -> Any:
        try:
            return fn(*args)
        except Exception as e:
            self.report.add(
                "edge-eval-error", ERROR,
                f"{what} raised {type(e).__name__}: {e} (unbound local, "
                f"bad index expression, or missing global)",
                task_class=tc_name, flow=flow, instance=inst)
            return default


def check_ptg(tp: Any, nb_ranks: int | None = None,
              max_tasks: int | None = None) -> GraphReport:
    """Statically verify a built PTG taskpool (kernels never execute)."""
    report = GraphReport(tp.name)
    probe = _Probe(report)
    if nb_ranks is None:
        nb_ranks = tp.context.nb_ranks if tp.context is not None else 1
    if max_tasks is None:
        max_tasks = _params.get("analysis_max_tasks")

    # ---- phase 1: enumerate the concrete execution space ------------------
    # every class gets an entry up front: a truncated enumeration must not
    # leave later classes unindexed (phases 2/3 iterate all of them)
    instances: dict[str, list[dict]] = {tc.name: [] for tc in
                                        tp.task_classes}
    index: set[tuple] = set()          # (class, key) membership
    total = 0
    for tc in tp.task_classes:
        tcb = tp._tc_builders.get(tc.name)
        space: list[dict] = []
        if tcb is not None:
            try:
                for locals_ in tcb._enumerate_space():
                    space.append(dict(locals_))
                    total += 1
                    if total >= max_tasks:
                        report.truncated = True
                        break
            except Exception as e:
                report.add("edge-eval-error", ERROR,
                           f"execution-space range raised "
                           f"{type(e).__name__}: {e}", task_class=tc.name)
        instances[tc.name] = space
        for locals_ in space:
            index.add((tc.name, tc.make_key(locals_)))
        if report.truncated:
            break
    report.ntasks = total

    # ---- phase 2: per-instance edge walk ----------------------------------
    # adjacency over (class, key) nodes for cycle/ordering analysis
    adj: dict[tuple, list[tuple]] = {}
    # (producer node, flow_index) -> [(consumer node, consumer access)]
    fanout: dict[tuple, list[tuple]] = {}
    # collection writebacks / direct reads: (dc id, key) -> [nodes]
    wb_tiles: dict[tuple, list[tuple]] = {}
    rd_tiles: dict[tuple, list[tuple]] = {}
    dc_names: dict[tuple, str] = {}
    flow_active: dict[tuple, bool] = {}        # (class, flow) saw any dep
    chain_in: set[tuple] = set()               # (class, flow) self-chain in
    chain_out: set[tuple] = set()
    any_ready = False

    for tc in tp.task_classes:
        for locals_ in instances[tc.name]:
            node = (tc.name, tc.make_key(locals_))
            adj.setdefault(node, [])   # register even edge-less instances
            # affinity / rank consistency
            if tc.affinity is not None:
                res = probe(tc.affinity, "affinity", tc.name, None, locals_,
                            locals_)
                if res is not None:
                    dc, key = res
                    key = _askey(key)
                    if _has_key(dc, key) is False:
                        report.add(
                            "tile-out-of-range", ERROR,
                            f"affinity names tile "
                            f"{getattr(dc, 'name', '?')}{key} outside the "
                            f"collection bounds",
                            task_class=tc.name, instance=locals_)
                    elif nb_ranks > 1:
                        try:
                            r = dc.rank_of(*key)
                        except Exception as e:
                            report.add("edge-eval-error", ERROR,
                                       f"affinity rank_of raised "
                                       f"{type(e).__name__}: {e}",
                                       task_class=tc.name, instance=locals_)
                            r = 0
                        if not (0 <= r < nb_ranks):
                            report.add(
                                "rank-out-of-range", ERROR,
                                f"affinity resolves to rank {r} outside "
                                f"[0, {nb_ranks})",
                                task_class=tc.name, instance=locals_)
            elif nb_ranks > 1:
                report.add(
                    "class-without-affinity", WARNING,
                    f"no affinity in a {nb_ranks}-rank pool: every rank "
                    f"will run every {tc.name} instance (replicated "
                    f"execution; add .affinity(...) if unintended)",
                    task_class=tc.name)

            if tc.priority is not None:
                probe(tc.priority, "priority", tc.name, None, locals_,
                      locals_)

            has_ready_mask = True   # all in-deps inactive => startup task
            for flow in tc.flows:
                fkey = (tc.name, flow.name)
                has_input = False
                writes_out = False

                # ----- input arrows ------------------------------------
                for d in flow.deps_in:
                    if d.guard is not None:
                        act = probe(d.guard, "input guard", tc.name,
                                    flow.name, locals_, locals_,
                                    default=False)
                    else:
                        act = True
                    if not act:
                        continue
                    flow_active[fkey] = True
                    if d.null:
                        has_input = True
                        continue
                    if d.target_class is None and d.target_params is None \
                            and d.data_ref is None:
                        has_input = True     # NEW arrow: scratch allocation
                        continue
                    if d.data_ref is not None:
                        has_input = True
                        res = probe(d.data_ref, "input data ref", tc.name,
                                    flow.name, locals_, locals_)
                        if res is not None:
                            dc, key = res
                            key = _askey(key)
                            tkey = (id(dc), key)
                            dc_names[tkey] = getattr(dc, "name", "?")
                            rd_tiles.setdefault(tkey, []).append(node)
                            if _has_key(dc, key) is False:
                                report.add(
                                    "tile-out-of-range", ERROR,
                                    f"input reads tile "
                                    f"{getattr(dc, 'name', '?')}{key} "
                                    f"outside the collection bounds",
                                    task_class=tc.name, flow=flow.name,
                                    instance=locals_)
                        continue
                    # task-predecessor arrow
                    has_input = True
                    has_ready_mask = False
                    pred_tc = tp.task_classes_by_name.get(d.target_class)
                    if pred_tc is None:
                        report.add(
                            "missing-output-edge", ERROR,
                            f"input names unknown class "
                            f"{d.target_class!r}",
                            task_class=tc.name, flow=flow.name,
                            instance=locals_)
                        continue
                    targets = probe(d.each_target, "input params", tc.name,
                                    flow.name, locals_, locals_, default=())
                    if pred_tc.name == tc.name and \
                            d.target_flow == flow.name:
                        chain_in.add(fkey)
                    for pl in targets:
                        _check_input_arrow(report, tp, tc, flow, d, locals_,
                                           node, pred_tc, pl, index, adj,
                                           probe)

                # ----- output arrows -----------------------------------
                for d in flow.deps_out:
                    if d.guard is not None:
                        act = probe(d.guard, "output guard", tc.name,
                                    flow.name, locals_, locals_,
                                    default=False)
                    else:
                        act = True
                    if not act:
                        continue
                    flow_active[fkey] = True
                    writes_out = True
                    if d.data_ref is not None:
                        res = probe(d.data_ref, "output data ref", tc.name,
                                    flow.name, locals_, locals_)
                        if res is not None:
                            dc, key = res
                            key = _askey(key)
                            tkey = (id(dc), key)
                            dc_names[tkey] = getattr(dc, "name", "?")
                            if flow.is_ctl:
                                report.add(
                                    "ctl-data-mismatch", ERROR,
                                    f"CTL flow writes back to collection "
                                    f"{getattr(dc, 'name', '?')} (a CTL "
                                    f"flow carries no datum; the "
                                    f"writeback silently does nothing)",
                                    task_class=tc.name, flow=flow.name,
                                    instance=locals_)
                            else:
                                wb_tiles.setdefault(tkey, []).append(node)
                            if _has_key(dc, key) is False:
                                report.add(
                                    "tile-out-of-range", ERROR,
                                    f"writeback targets tile "
                                    f"{getattr(dc, 'name', '?')}{key} "
                                    f"outside the collection bounds",
                                    task_class=tc.name, flow=flow.name,
                                    instance=locals_)
                        continue
                    if d.target_class is None:
                        continue         # NULL output: datum dropped
                    succ_tc = tp.task_classes_by_name.get(d.target_class)
                    if succ_tc is None:
                        report.add(
                            "missing-input-edge", ERROR,
                            f"output names unknown class "
                            f"{d.target_class!r}",
                            task_class=tc.name, flow=flow.name,
                            instance=locals_)
                        continue
                    if succ_tc.name == tc.name and \
                            d.target_flow == flow.name:
                        chain_out.add(fkey)
                    targets = probe(d.each_target, "output params", tc.name,
                                    flow.name, locals_, locals_, default=())
                    for sl in targets:
                        _check_output_arrow(report, tp, tc, flow, d, locals_,
                                            node, succ_tc, sl, index, adj,
                                            fanout, probe)

                # ----- flow-level access consistency -------------------
                if flow.access == ACCESS_WRITE and has_input and any(
                        (d.data_ref is not None or d.target_class is not None)
                        and not d.null for d in flow.deps_in):
                    report.add(
                        "write-flow-receives-input", ERROR,
                        "WRITE-only flow has a data-carrying input arrow "
                        "(WRITE means the task produces the datum; the "
                        "received value would be overwritten or aliased)",
                        task_class=tc.name, flow=flow.name, instance=locals_)
                if (not flow.is_ctl and writes_out and not has_input
                        and flow.access & ACCESS_READ):
                    report.add(
                        "no-input-source", ERROR,
                        "flow reads (READ/RW access) but no input arrow, "
                        "NEW, or NULL is active for these locals — "
                        "prepare_input would find no valid copy",
                        task_class=tc.name, flow=flow.name, instance=locals_)

            if has_ready_mask:
                try:
                    if tc.input_dep_mask(locals_) == 0:
                        any_ready = True
                except Exception:
                    pass
            elif tc.startup_fn is not None:
                any_ready = True

    report.nedges = sum(len(v) for v in adj.values())
    report.graph = adj

    # ---- phase 3: class-level structure ----------------------------------
    for tc in tp.task_classes:
        if tc.startup_fn is not None:
            any_ready = any_ready or bool(instances[tc.name])
        for flow in tc.flows:
            fkey = (tc.name, flow.name)
            if not instances[tc.name]:
                continue
            if (flow.deps_in or flow.deps_out) \
                    and not flow_active.get(fkey):
                report.add(
                    "dead-flow", WARNING,
                    "no dependency arrow of this flow is active for any "
                    "instance (every guard is always false)",
                    task_class=tc.name, flow=flow.name)
            if not flow.deps_in and not flow.deps_out:
                report.add(
                    "dead-flow", WARNING,
                    "flow declares no dependency arrows at all",
                    task_class=tc.name, flow=flow.name)
            if fkey in chain_in and fkey in chain_out \
                    and not flow.is_ctl and not (flow.access & ACCESS_WRITE):
                # distinguish the flipped-RW bug from a legitimate
                # broadcast relay: a chain that feeds a WRITER (or writes
                # back to the collection) hands over a value the chain was
                # supposed to accumulate — but no member ever wrote it
                feeds_writer = any(
                    d.data_ref is not None for d in flow.deps_out)
                for d in flow.deps_out:
                    if feeds_writer or d.target_class is None:
                        break
                    stc = tp.task_classes_by_name.get(d.target_class)
                    sf = next((f for f in (stc.flows if stc else ())
                               if f.name == d.target_flow), None)
                    if sf is not None and sf.access & ACCESS_WRITE:
                        feeds_writer = True
                if feeds_writer:
                    report.add(
                        "read-chain-never-written", ERROR,
                        "same-class serialization chain (the k-chain "
                        "accumulation shape) on a flow that never writes, "
                        "yet its value feeds a writer/writeback — the "
                        "consumer receives the UN-accumulated original "
                        "(an RW flow declared READ?)",
                        task_class=tc.name, flow=flow.name)
                else:
                    report.add(
                        "read-chain-never-written", WARNING,
                        "pure-READ same-class relay chain: legitimate "
                        "only as a broadcast relay (every consumer "
                        "receives the unmodified original)",
                        task_class=tc.name, flow=flow.name)

    if total > 0 and not any_ready and not report.truncated:
        report.add(
            "no-startup-task", ERROR,
            f"{total} tasks enumerated but no instance starts with an "
            f"empty IN-dep mask and no class has a startup override — "
            f"the pool can never make progress", task_class=None)

    # ---- phase 4: cycles ---------------------------------------------------
    if not report.truncated:
        for cycle in _find_cycles(adj, limit=5):
            names = " -> ".join(_node_str(n) for n in cycle)
            report.add(
                "dependency-cycle", ERROR,
                f"dependency cycle: {names} -> {_node_str(cycle[0])}",
                task_class=cycle[0][0],
                instance=dict(zip(tp.task_classes_by_name[cycle[0][0]].params,
                                  cycle[0][1])))

    # ---- phase 5: hazard ordering (WAR/WAW, k-chain discipline) -----------
    if not report.truncated and total <= 4000:
        reach = _Reachability(adj)
        for (pkey, consumers) in fanout.items():
            if len(consumers) < 2:
                continue
            writers = [c for c in consumers if c[1] & ACCESS_WRITE]
            if not writers:
                continue
            for wnode, _ in writers:
                for onode, _ in consumers:
                    if onode == wnode:
                        continue
                    if not reach.ordered(wnode, onode):
                        # a WARNING, not an error: the sanctioned runtime
                        # convention is for the writing body to DETACH into
                        # a fresh copy (functional update — the stencil
                        # halo pattern); a body mutating the shared copy in
                        # place here would race, which statics cannot see
                        report.add(
                            "unordered-shared-write", WARNING,
                            f"{_node_str(wnode)} writes a copy shared "
                            f"with {_node_str(onode)} and no dependency "
                            f"path orders them — safe only if the body "
                            f"detaches into a fresh copy (WAR/WAW on the "
                            f"output of {_node_str(pkey[0])} otherwise)",
                            task_class=wnode[0])
        for tkey, writers in wb_tiles.items():
            uniq = sorted(set(writers))
            for i, a in enumerate(uniq):
                for b in uniq[i + 1:]:
                    if not reach.ordered(a, b):
                        report.add(
                            "unordered-writeback", ERROR,
                            f"{_node_str(a)} and {_node_str(b)} both "
                            f"write back tile "
                            f"{dc_names[tkey]}{tkey[1]} with no ordering "
                            f"path (WAW on the home copy; order them "
                            f"with a flow or CTL edge)",
                            task_class=a[0])
            for rnode in rd_tiles.get(tkey, ()):
                for wnode in uniq:
                    if rnode != wnode and not reach.ordered(rnode, wnode):
                        report.add(
                            "unordered-collection-read", WARNING,
                            f"{_node_str(rnode)} reads tile "
                            f"{dc_names[tkey]}{tkey[1]} directly while "
                            f"{_node_str(wnode)} writes it back, "
                            f"unordered — the read snapshots whichever "
                            f"version raced in first",
                            task_class=rnode[0])
    return report


def _check_input_arrow(report, tp, tc, flow, d, locals_, node, pred_tc, pl,
                       index, adj, probe) -> None:
    """One input arrow target: the backward half of edge symmetry."""
    pkey = None
    try:
        pkey = pred_tc.make_key(pl)
    except Exception:
        report.add("edge-eval-error", ERROR,
                   f"input params bind {pl} which does not name a "
                   f"{pred_tc.name} instance (params are "
                   f"{pred_tc.params})",
                   task_class=tc.name, flow=flow.name, instance=locals_)
        return
    if (pred_tc.name, pkey) not in index:
        if report.truncated:
            return    # membership is unreliable on a truncated prefix
        report.add(
            "dangling-input", ERROR,
            f"input arrow names predecessor "
            f"{_node_str((pred_tc.name, pkey))} outside its execution "
            f"space — the dep can never be satisfied",
            task_class=tc.name, flow=flow.name, instance=locals_)
        return
    # the predecessor must actively send to exactly this instance/flow
    pf = next((f for f in pred_tc.flows if f.name == d.target_flow), None)
    if pf is None:
        report.add(
            "missing-output-edge", ERROR,
            f"input names flow {d.target_flow!r} which "
            f"{pred_tc.name} does not declare",
            task_class=tc.name, flow=flow.name, instance=locals_)
        return
    if pf.is_ctl != flow.is_ctl:
        report.add(
            "ctl-data-mismatch", ERROR,
            f"{'CTL' if flow.is_ctl else 'data'} flow receives from "
            f"{pred_tc.name}.{pf.name} which is "
            f"{'CTL' if pf.is_ctl else 'data'}",
            task_class=tc.name, flow=flow.name, instance=locals_)
    my_key = node[1]
    for od in pf.deps_out:
        if od.target_class != tc.name or od.target_flow != flow.name:
            continue
        try:
            if not od.active(pl):
                continue
            tgts = od.each_target(pl)
        except Exception:
            continue      # reported when the producer instance is walked
        for t in tgts:
            try:
                if tc.make_key(t) == my_key:
                    return      # matched: symmetric edge exists
            except Exception:
                continue
    report.add(
        "missing-output-edge", ERROR,
        f"input expects {pred_tc.name}.{d.target_flow} of "
        f"{_node_str((pred_tc.name, pkey))} but that instance has no "
        f"active output arrow back to this flow — the consumer waits "
        f"forever", task_class=tc.name, flow=flow.name, instance=locals_)


def _check_output_arrow(report, tp, tc, flow, d, locals_, node, succ_tc, sl,
                        index, adj, fanout, probe) -> None:
    """One output arrow target: the forward half of edge symmetry (the
    static twin of the PINS iterators_checker's per-execution walk,
    :mod:`parsec_tpu_torch.prof.iterators_checker`)."""
    from ..runtime.scheduling import _find_input_dep
    try:
        if succ_tc.in_space is not None and not succ_tc.in_space(sl):
            return        # dropped by the generated bounds check: legal
    except Exception:
        pass
    try:
        skey = succ_tc.make_key(sl)
    except Exception:
        report.add("edge-eval-error", ERROR,
                   f"output params bind {sl} which does not name a "
                   f"{succ_tc.name} instance (params are "
                   f"{succ_tc.params})",
                   task_class=tc.name, flow=flow.name, instance=locals_)
        return
    if (succ_tc.name, skey) not in index:
        if report.truncated:
            return    # membership is unreliable on a truncated prefix
        report.add(
            "dangling-output", WARNING,
            f"output targets {_node_str((succ_tc.name, skey))} outside "
            f"its enumerated space (in_space did not reject it — the "
            f"release path would create a task the space never counts)",
            task_class=tc.name, flow=flow.name, instance=locals_)
        return
    try:
        fi, _di = _find_input_dep(succ_tc, d.target_flow, tc.name, sl)
    except (KeyError, LookupError):
        report.add(
            "missing-input-edge", ERROR,
            f"output arrow lands on "
            f"{_node_str((succ_tc.name, skey))}.{d.target_flow} which has "
            f"no matching active input dep from {tc.name} — the datum "
            f"arrives with no dep bit to satisfy (the pool hangs)",
            task_class=tc.name, flow=flow.name, instance=locals_)
        return
    sf = succ_tc.flows[fi]
    if sf.is_ctl != flow.is_ctl:
        report.add(
            "ctl-data-mismatch", ERROR,
            f"{'CTL' if flow.is_ctl else 'data'} flow feeds "
            f"{succ_tc.name}.{sf.name} which is "
            f"{'CTL' if sf.is_ctl else 'data'}",
            task_class=tc.name, flow=flow.name, instance=locals_)
    snode = (succ_tc.name, skey)
    adj.setdefault(node, []).append(snode)
    adj.setdefault(snode, [])
    if not flow.is_ctl:
        fanout.setdefault((node, flow.flow_index), []).append(
            (snode, sf.access))


def _node_str(node: tuple) -> str:
    cls, key = node
    return f"{cls}{tuple(key)}"


def _find_cycles(adj: dict[tuple, list[tuple]],
                 limit: int = 5) -> Iterable[list[tuple]]:
    """Iterative DFS back-edge detection; yields up to ``limit`` cycles."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict[tuple, int] = {}
    found = 0
    for root in adj:
        if color.get(root, WHITE) != WHITE:
            continue
        stack: list[tuple[tuple, int]] = [(root, 0)]
        path: list[tuple] = []
        color[root] = GRAY
        path.append(root)
        while stack:
            node, i = stack[-1]
            succs = adj.get(node, ())
            if i < len(succs):
                stack[-1] = (node, i + 1)
                s = succs[i]
                c = color.get(s, WHITE)
                if c == GRAY:
                    yield path[path.index(s):]
                    found += 1
                    if found >= limit:
                        return
                elif c == WHITE:
                    color[s] = GRAY
                    stack.append((s, 0))
                    path.append(s)
            else:
                color[node] = BLACK
                stack.pop()
                path.pop()


class _Reachability:
    """Memoized forward reachability over the concrete task graph."""

    def __init__(self, adj: dict[tuple, list[tuple]]) -> None:
        self.adj = adj
        self._memo: dict[tuple, bool] = {}

    def reaches(self, a: tuple, b: tuple) -> bool:
        key = (a, b)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        seen = {a}
        frontier = [a]
        ok = False
        while frontier:
            n = frontier.pop()
            for s in self.adj.get(n, ()):
                if s == b:
                    ok = True
                    frontier = []
                    break
                if s not in seen:
                    seen.add(s)
                    frontier.append(s)
        self._memo[key] = ok
        return ok

    def ordered(self, a: tuple, b: tuple) -> bool:
        return self.reaches(a, b) or self.reaches(b, a)


# ---------------------------------------------------------------------------
# DTD verification
# ---------------------------------------------------------------------------


def check_jdf(src: str, name: str = "jdf", **bindings: Any) -> GraphReport:
    """Parse a JDF source (text or path) and verify the built pool."""
    import os
    from ..ptg.jdf import load_jdf, parse_jdf
    if os.path.exists(src) or "\n" not in src and src.endswith(".jdf"):
        jdf = load_jdf(src)
    else:
        jdf = parse_jdf(src, name=name)
    return check_ptg(jdf.build(**bindings))


def check_dtd(tp: Any, nb_ranks: int | None = None) -> GraphReport:
    """Verify a populated DTD taskpool's discovered structure.

    Insertion order is a topological order by construction, so cycles
    cannot arise from the accessor-chain protocol itself — what CAN go
    wrong statically is the data side: tiles mapped outside their
    collection, affinity ranks outside the mesh, and accessor chains whose
    recorded successor edges contradict the k-chain serialization (a
    writer that does not depend on the chain's previous accessors)."""
    report = GraphReport(tp.name)
    if nb_ranks is None:
        nb_ranks = tp.context.nb_ranks if tp.context is not None else 1
    with tp._tlock:
        tiles = list(tp._tiles.values())
    ntasks = set()
    for tile in tiles:
        if tile.dc is not None:
            if _has_key(tile.dc, tile.key) is False:
                report.add(
                    "tile-out-of-range", ERROR,
                    f"tile {tile.dc.name}{tile.key} lies outside the "
                    f"collection bounds", task_class="dtd",
                    instance={"tile": tile.key})
            if nb_ranks > 1:
                try:
                    r = tile.rank
                except Exception as e:
                    report.add("edge-eval-error", ERROR,
                               f"rank_of raised {type(e).__name__}: {e}",
                               task_class="dtd",
                               instance={"tile": tile.key})
                    r = 0
                if not (0 <= r < nb_ranks):
                    report.add(
                        "rank-out-of-range", ERROR,
                        f"tile {tile.dc.name}{tile.key} maps to rank {r} "
                        f"outside [0, {nb_ranks})", task_class="dtd",
                        instance={"tile": tile.key})
        with tile._lock:
            chain = list(tile.last_users)
            if tile.last_writer is not None:
                chain.append(tile.last_writer)
        for (t, _fi) in chain:
            ntasks.add(t.dtd_seq)
            with t._dlock:
                if t.completed and t.deps_pending > 0:
                    report.add(
                        "inconsistent-dep-count", ERROR,
                        f"task seq {t.dtd_seq} completed with "
                        f"{t.deps_pending} deps still pending",
                        task_class=t.task_class.name,
                        instance={"seq": t.dtd_seq})
    report.ntasks = len(ntasks)
    return report

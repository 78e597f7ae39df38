"""Region selection over the concrete task graph (the MPK seam).

Port of ``parsec_tpu/analysis/regions.py``, pure Python over the graph
and copied nearly verbatim.  MPK (PAPERS.md) mega-kernelizes *verified*
task subgraphs: the dependency structure is proven ahead of execution and
the runtime then schedules whole regions, not tasks.  Graphcheck already
enumerates every concrete task instance and edge of a PTG pool without
running a body; this module carves that graph into **maximal acyclic
subregions**: convex groups of tasks that one prepared region step can
run, with runtime scheduling (deps, device staging) only at region
boundaries (:func:`parsec_tpu_torch.ptg.lowering.lower_regions` builds
the steps).

Selection invariants (what makes a grouping a *region*):

- **convexity**: no dependency path leaves a region and re-enters it, so
  the region condensation is a DAG and region-grained scheduling cannot
  deadlock.  Regions are contiguous *wavefront-level bands* within one
  weakly-connected component (every edge strictly increases the
  longest-path level, so a band can only feed later bands; components
  share no edges at all).
- **bounded size**: ``max_tasks`` caps the member count, so a region's
  preparation time stays bounded (the compile budget in
  ``ptg/lowering.py`` prepares region by region).  A single wavefront
  larger than the cap stays whole: splitting a level would break the
  gather-all, compute, scatter-all snapshot semantics of the wavefront
  emission.
- **parallel components**: independent weakly-connected components (the
  decode superpool's per-sequence ATTN chains) become *parallel* regions
  the runtime may run concurrently.

The adjacency consumed here is what :func:`~.graphcheck.check_ptg`
builds during its edge walk (``GraphReport.graph``), so a pool that
fails graphcheck never reaches region lowering.
"""

from __future__ import annotations

from typing import Any

__all__ = ["Region", "select_regions", "task_levels"]


class Region:
    """One convex subregion of a concrete task graph."""

    __slots__ = ("index", "members", "level_lo", "level_hi", "preds",
                 "succs")

    def __init__(self, index: int, members: list[tuple],
                 level_lo: int, level_hi: int) -> None:
        self.index = index
        self.members = members          # [(class_name, key), ...]
        self.level_lo = level_lo        # wavefront-level span (inclusive)
        self.level_hi = level_hi
        self.preds: set[int] = set()    # region indices this one waits on
        self.succs: set[int] = set()

    @property
    def ntasks(self) -> int:
        return len(self.members)

    def __repr__(self) -> str:
        return (f"<Region {self.index}: {self.ntasks} tasks, "
                f"levels {self.level_lo}..{self.level_hi}, "
                f"{len(self.preds)} preds>")


def task_levels(adj: dict[tuple, list[tuple]]) -> dict[tuple, int]:
    """Longest-path wavefront level per node (Kahn); an edge always
    crosses levels strictly, so same-level tasks are independent.
    Raises ``ValueError`` on a cycle (graphcheck reports it properly —
    this is only the backstop for direct callers)."""
    indeg = {v: 0 for v in adj}
    for v, succs in adj.items():
        for s in succs:
            indeg[s] = indeg.get(s, 0) + 1
    ready = [v for v, n in indeg.items() if n == 0]
    levels = {v: 0 for v in ready}
    seen = 0
    while ready:
        v = ready.pop()
        seen += 1
        for s in adj.get(v, ()):
            levels[s] = max(levels.get(s, 0), levels[v] + 1)
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if seen != len(indeg):
        raise ValueError("task graph has a cycle; regions undefined")
    return levels


def _components(adj: dict[tuple, list[tuple]]) -> list[list[tuple]]:
    """Weakly-connected components, each in deterministic first-seen
    order (nodes keep the adjacency's insertion order — keys may mix
    ints and strings across collections, so sorting is not an option)."""
    undirected: dict[tuple, list[tuple]] = {v: [] for v in adj}
    for v, succs in adj.items():
        for s in succs:
            undirected[v].append(s)
            undirected.setdefault(s, []).append(v)
    seen: set[tuple] = set()
    comps: list[list[tuple]] = []
    for root in adj:
        if root in seen:
            continue
        comp = []
        stack = [root]
        seen.add(root)
        while stack:
            n = stack.pop()
            comp.append(n)
            for m in undirected.get(n, ()):
                if m not in seen:
                    seen.add(m)
                    stack.append(m)
        comps.append(comp)
    return comps


def select_regions(adj: dict[tuple, list[tuple]],
                   levels: dict[tuple, int] | None = None,
                   max_tasks: int = 0) -> list[Region]:
    """Partition a concrete task DAG into convex, size-bounded regions.

    ``adj`` maps each node to its successor list (every node present as
    a key — :func:`~.graphcheck.check_ptg` guarantees this for
    ``GraphReport.graph``).  ``max_tasks == 0`` means unbounded: one
    region per weakly-connected component.  The returned regions carry
    their region-graph ``preds``/``succs`` (derived from the task edges)
    and partition the node set exactly.
    """
    if levels is None:
        levels = task_levels(adj)
    regions: list[Region] = []
    assign: dict[tuple, int] = {}
    for comp in _components(adj):
        by_level: dict[int, list[tuple]] = {}
        for n in comp:
            by_level.setdefault(levels[n], []).append(n)
        cur: list[tuple] = []
        for lv in sorted(by_level):
            nodes = by_level[lv]
            if cur and max_tasks > 0 and len(cur) + len(nodes) > max_tasks:
                regions.append(Region(len(regions), cur, 0, 0))
                cur = []
            cur.extend(nodes)
        if cur:
            regions.append(Region(len(regions), cur, 0, 0))
    for r in regions:
        r.level_lo = min(levels[n] for n in r.members)
        r.level_hi = max(levels[n] for n in r.members)
        for n in r.members:
            assign[n] = r.index
    for v, succs in adj.items():
        rv = assign[v]
        for s in succs:
            rs = assign[s]
            if rs != rv:
                regions[rv].succs.add(rs)
                regions[rs].preds.add(rv)
    return regions


def regions_of_report(report: Any, max_tasks: int = 0) -> list[Region]:
    """Region selection over a :class:`~.graphcheck.GraphReport`'s
    retained concrete graph.  The report must be complete (not
    truncated) and error-free — regions over an unverified or partial
    graph could hide the very hazards graphcheck exists to surface."""
    if report.truncated:
        raise ValueError(
            f"graphcheck truncated the enumeration of {report.name!r} "
            f"(analysis_max_tasks); regions over a partial graph are "
            f"unsound")
    if not report.ok:
        from .graphcheck import GraphCheckError
        raise GraphCheckError(report)
    if not report.graph and report.ntasks:
        # only check_ptg retains the concrete graph; a DTD/JDF report
        # here would silently yield zero regions for a non-empty pool
        raise ValueError(
            f"report for {report.name!r} retains no concrete task graph "
            f"(not produced by check_ptg); regions undefined")
    return select_regions(report.graph, max_tasks=max_tasks)

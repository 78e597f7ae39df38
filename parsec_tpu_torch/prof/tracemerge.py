"""Multi-rank Chrome-trace merger: dotmerge's sibling for time.

Port of ``parsec_tpu/prof/tracemerge.py``.  N per-rank trace files
(written by :func:`parsec_tpu_torch.prof.spans.export_chrome`, or any
Chrome trace whose span events carry ``args.flow`` /
``args.flow_side``) union into ONE trace with **flow arrows**
(``ph:"s"`` / ``ph:"f"`` events) across rank boundaries, so a request's
activation hops and rendezvous GETs read as one timeline in Perfetto.

::

    python -m parsec_tpu_torch.prof.tracemerge trace-rank0.json \\
        trace-rank1.json -o merged.json
    python -m parsec_tpu_torch.prof.tracemerge --self-test

Mechanics:

- **clock alignment**: ``perf_counter_ns`` clocks are per process; each
  rank's export carries a ``parsec_clock_sync`` anchor (``unix_ns``
  against ``perf_ns``), and every timestamp is shifted onto the shared
  wall-clock axis before merging.  Rank processes of one host share a
  clock, and the alignment is kept all the same.
- **pid namespacing**: rank *r*'s pids become ``r*100 + pid`` (the rank
  comes from the *filename*, ``rank<N>``, as in dotmerge).
- **flow stitching**: span events whose args carry ``flow`` (e.g.
  ``act:<src_rank>:<seq>``, ``get:<requester>:<get_id>``) and
  ``flow_side`` (``emit``/``recv``) are matched by flow id; each matched
  pair gains an ``s`` event bound to the emitting span and an ``f``
  (``bp:"e"``) event bound to the receiving one.
- **tree latency**: cross-rank ``act`` hops that share a ``trace`` id
  (a propagation tree) fold into per-trace tree stats: hop count, depth,
  the rank set and the slowest root-to-leaf chain of hop latencies.
- **resumed GETs**: a flow key with several emits binds its arrow to the
  last one and counts as resumed.  The port has no ``resume_get`` yet,
  so its own traces never show one; the rule stays so that a JAX
  package's trace merges the same here.

The statistics' layout is the JAX package's.  Left out: nothing of the
module.
"""

from __future__ import annotations

import json
import re
import sys
import zlib
from typing import Any

_RE_RANK = re.compile(r"rank(\d+)")


def _rank_of(path: str, position: int) -> int:
    """Rank tag from the filename (``rank<N>``) — shell globs sort
    rank10 before rank2, so argv position would mislabel (the dotmerge
    rule); falls back to argv position."""
    m = _RE_RANK.search(path.rsplit("/", 1)[-1])
    return int(m.group(1)) if m else position


def _load_events(path: str) -> list[dict]:
    with open(path) as f:
        trace = json.load(f)
    if isinstance(trace, list):
        return trace
    return trace.get("traceEvents", [])


def _tree_stats(flows: dict[str, dict[str, dict]]) -> dict[str, dict]:
    """Per-trace tree latency over matched cross-rank ``act`` hops.

    Each matched pair is one parent→child payload movement; grouping by
    the spans' ``trace`` id recovers the propagation tree a collective
    broadcast actually used.  Depth/critical-path walk the tree from its
    roots (ranks that emit but never receive), summing per-hop latency
    ``recv.ts - emit.ts`` — clocks are already on the shared wall axis.
    """
    by_trace: dict[str, list[tuple[int, int, float, float]]] = {}
    for fl, sides in sorted(flows.items()):
        if not sides.get("emit") or not sides.get("recv"):
            continue
        if fl.split(":", 1)[0] != "act":
            continue
        e, r = _endpoints(sides)
        src, dst = e["pid"] // 100, r["pid"] // 100
        if src == dst:
            continue
        tr = ((e.get("args") or {}).get("trace")
              or (r.get("args") or {}).get("trace"))
        if not tr:
            continue
        by_trace.setdefault(tr, []).append((src, dst, e["ts"], r["ts"]))
    trees: dict[str, dict] = {}
    for tr, edges in sorted(by_trace.items()):
        children: dict[int, list[tuple[int, float]]] = {}
        dsts = set()
        for src, dst, ets, rts in edges:
            children.setdefault(src, []).append((dst, max(rts - ets, 0.0)))
            dsts.add(dst)
        roots = sorted({src for src, *_ in edges} - dsts)
        if not roots:          # a cycle, not a tree — skip, don't loop
            continue
        depth = {r: 0 for r in roots}
        lat = {r: 0.0 for r in roots}
        frontier = list(roots)
        while frontier:
            src = frontier.pop()
            for dst, hop_us in children.get(src, ()):
                if dst in depth:          # duplicate delivery — keep first
                    continue
                depth[dst] = depth[src] + 1
                lat[dst] = lat[src] + hop_us
                frontier.append(dst)
        trees[tr] = {
            "hops": len(edges),
            "depth": max(depth.values()),
            "ranks": sorted(depth),
            "critical_path_us": round(max(lat.values()), 3),
        }
    return trees


def _endpoints(sides: dict[str, list[dict]]) -> tuple[dict, dict]:
    """The hop endpoints for one flow key: the LAST emit (by aligned
    timestamp) to the FIRST recv.  A GET resumed via ``resume_get``
    re-serves under the SAME ``get:<requester>:<get_id>`` key from a
    NEW rank — the survivor's emit is the one whose bytes actually
    landed, so the arrow binds there (matching on (key, src rank)
    would lose it)."""
    emits = sorted(sides["emit"], key=lambda ev: ev["ts"])
    recvs = sorted(sides["recv"], key=lambda ev: ev["ts"])
    return emits[-1], recvs[0]


def _is_resumed(sides: dict[str, list[dict]]) -> bool:
    return (len(sides["emit"]) > 1
            or len({ev["pid"] // 100 for ev in sides["emit"]}) > 1)


def merge_traces(paths: list[str], out_path: str | None = None) -> dict:
    """Merge per-rank traces; returns stats (and writes the merged trace
    when ``out_path`` is given)."""
    merged: list[dict] = []
    # flow id -> side -> ALL events seen (a resumed GET re-serves under
    # the same key from a new rank — every emit must be kept so the
    # arrow can bind to the survivor)
    flows: dict[str, dict[str, list[dict]]] = {}
    for pos, path in enumerate(paths):
        rank = _rank_of(path, pos)
        events = _load_events(path)
        offset_us = 0.0
        for ev in events:
            if ev.get("name") == "parsec_clock_sync":
                a = ev.get("args") or {}
                if "unix_ns" in a and "perf_ns" in a:
                    offset_us = (a["unix_ns"] - a["perf_ns"]) / 1e3
                break
        for ev in events:
            ev = dict(ev)
            pid = ev.get("pid", 0)
            ev["pid"] = rank * 100 + (pid if isinstance(pid, int) else 0)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + offset_us
            merged.append(ev)
            a = ev.get("args") or {}
            fl, side = a.get("flow"), a.get("flow_side")
            if fl and side in ("emit", "recv"):
                flows.setdefault(fl, {}).setdefault(side, []).append(ev)
    stitched = cross = resumed_n = 0
    by_kind: dict[str, int] = {}
    for fl, sides in sorted(flows.items()):
        if not sides.get("emit") or not sides.get("recv"):
            continue
        e, r = _endpoints(sides)
        resumed = _is_resumed(sides)
        fid = zlib.crc32(fl.encode())
        kind = fl.split(":", 1)[0]
        s_args: dict[str, Any] = {
            "hop": f"{e['pid'] // 100}->{r['pid'] // 100}"}
        if resumed:
            s_args["resumed"] = 1
            resumed_n += 1
        # bind arrows to the MIDDLE of each span: s/f events attach to
        # the slice enclosing their timestamp on that pid/tid, and the
        # exact end boundary falls outside the slice
        merged.append({"name": kind, "cat": "xtrace", "ph": "s",
                       "id": fid, "pid": e["pid"], "tid": e.get("tid", 0),
                       "ts": e["ts"] + e.get("dur", 0) / 2,
                       "args": s_args})
        merged.append({"name": kind, "cat": "xtrace", "ph": "f",
                       "bp": "e", "id": fid, "pid": r["pid"],
                       "tid": r.get("tid", 0),
                       "ts": r["ts"] + r.get("dur", 0) / 2})
        stitched += 1
        by_kind[kind] = by_kind.get(kind, 0) + 1
        if e["pid"] // 100 != r["pid"] // 100:
            cross += 1
    stats = {"events": len(merged), "flows_matched": stitched,
             "cross_rank_flows": cross, "resumed_flows": resumed_n,
             "flows_by_kind": by_kind,
             "trees": _tree_stats(flows)}
    # critical-path attribution over the STITCHED trace: the per-rank
    # clocks are already on the shared wall axis here, so the compact
    # report spans rank boundaries (the tree-stats fold's sibling)
    try:
        from .critpath import attribute, from_chrome
        rep = attribute(from_chrome(merged))
        stats["critpath"] = {k: rep[k] for k in
                             ("spans", "traces", "buckets_ms",
                              "overlap_efficiency", "overlap_lost_ms",
                              "top_overlap_lost")}
    except Exception as exc:                 # noqa: BLE001 — best-effort
        stats["critpath"] = {"error": f"{type(exc).__name__}: {exc}"}
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump({"traceEvents": merged}, f)
    return stats


# ---------------------------------------------------------------------------
# self-test
# ---------------------------------------------------------------------------

def _synthetic_rank(rank: int, perf_base: int, unix_base: int,
                    spans: list[tuple[str, int, int, dict]]) -> dict:
    """One rank's trace with a deliberately skewed perf clock, so the
    self-test proves the clock alignment, not just the flow matching."""
    events: list[dict[str, Any]] = [
        {"name": "parsec_clock_sync", "ph": "i", "s": "g",
         "ts": perf_base / 1e3, "pid": rank, "tid": 0,
         "args": {"unix_ns": unix_base, "perf_ns": perf_base}},
    ]
    for name, t0, t1, args in spans:
        events.append({"name": name, "cat": "span", "ph": "X",
                       "ts": (perf_base + t0) / 1e3,
                       "dur": max((t1 - t0) / 1e3, 0.001),
                       "pid": rank, "tid": 0,
                       "args": dict(args, trace="beef01")})
    return {"traceEvents": events}


def self_test() -> int:
    """Synthesize a 2-rank trace pair — one activation hop, one
    fragmented GET, per-rank perf clocks offset by seconds — merge, and
    assert the arrows stitched and the alignment held."""
    import os
    import tempfile
    unix0 = 1_700_000_000_000_000_000
    r0 = _synthetic_rank(0, perf_base=5_000_000_000, unix_base=unix0, spans=[
        ("comm.activate", 1000, 2000,
         {"flow": "act:0:7", "flow_side": "emit"}),
        ("comm.get_serve", 9000, 12000,
         {"flow": "get:1:3", "flow_side": "emit"}),
    ])
    # rank 1's perf clock started at a wildly different origin; its wall
    # clock is 5 µs ahead of rank 0's at anchor time
    r1 = _synthetic_rank(1, perf_base=77_000_000_000,
                         unix_base=unix0 + 5_000, spans=[
        ("comm.activate", 4000, 5000,
         {"flow": "act:0:7", "flow_side": "recv"}),
        ("comm.get", 8000, 14000,
         {"flow": "get:1:3", "flow_side": "recv"}),
    ])
    with tempfile.TemporaryDirectory(prefix="tracemerge_") as d:
        p0, p1 = (os.path.join(d, f"trace-rank{r}.json") for r in (0, 1))
        for p, t in ((p0, r0), (p1, r1)):
            with open(p, "w") as f:
                json.dump(t, f)
        out = os.path.join(d, "merged.json")
        stats = merge_traces([p0, p1], out)
        assert stats["flows_matched"] == 2, stats
        assert stats["cross_rank_flows"] == 2, stats
        assert stats["resumed_flows"] == 0, stats
        assert stats["flows_by_kind"] == {"act": 1, "get": 1}, stats
        # the stitched trace feeds critpath cross-rank: both comm spans
        # attributed, the 6 µs GET fully unhidden (no exec anywhere)
        cp = stats["critpath"]
        assert cp["spans"] == 4, cp
        assert cp["buckets_ms"]["comm.get"] > 0, cp
        assert cp["top_overlap_lost"] and \
            cp["top_overlap_lost"][0][0].startswith("comm.get"), cp
        with open(out) as f:
            evs = json.load(f)["traceEvents"]
        s = [e for e in evs if e.get("ph") == "s"]
        fl = [e for e in evs if e.get("ph") == "f"]
        assert len(s) == 2 and len(fl) == 2, (s, fl)
        # clock alignment: after the unix anchors applied, every rank's
        # spans sit on one axis — the activation's recv must start
        # AFTER its emit despite rank 1's perf clock being 72 s ahead
        act_emit = next(e for e in evs if (e.get("args") or {})
                        .get("flow") == "act:0:7"
                        and e["args"]["flow_side"] == "emit")
        act_recv = next(e for e in evs if (e.get("args") or {})
                        .get("flow") == "act:0:7"
                        and e["args"]["flow_side"] == "recv")
        assert act_recv["ts"] > act_emit["ts"], (act_emit, act_recv)
        assert act_recv["pid"] // 100 == 1 and act_emit["pid"] // 100 == 0
        # the single act hop is a degenerate tree: 1 hop, depth 1
        # (latency tolerance: the wall axis sits at ~1.7e15 µs, so the
        # float64 grid is ~0.25 µs there)
        t1 = stats["trees"]["beef01"]
        assert (t1["hops"], t1["depth"], t1["ranks"]) == \
            (1, 1, [0, 1]), t1
        assert abs(t1["critical_path_us"] - 8.0) < 1.0, t1

    # --- the collective-tree case: a 4-rank binomial broadcast (edges
    # 0->1, 0->2, 1->3) whose staged hops share one trace id.  Hop
    # latencies 3/1/4 µs make 0->1->3 the critical path (7 µs), longer
    # than the shallow 0->2 branch despite equal fan-out at the root. ---
    def _tree_rank(rank, spans):
        t = _synthetic_rank(rank, perf_base=1_000_000 * (rank + 1),
                            unix_base=unix0, spans=spans)
        for ev in t["traceEvents"]:
            if ev.get("cat") == "span":
                ev["args"]["trace"] = "beef02"
        return t
    tr = [
        _tree_rank(0, [("comm.activate", 1000, 2000,
                        {"flow": "act:0:1", "flow_side": "emit"}),
                       ("comm.activate", 2000, 3000,
                        {"flow": "act:0:2", "flow_side": "emit"})]),
        _tree_rank(1, [("comm.activate", 4000, 5000,
                        {"flow": "act:0:1", "flow_side": "recv"}),
                       ("comm.activate", 5000, 6000,
                        {"flow": "act:1:3", "flow_side": "emit"})]),
        _tree_rank(2, [("comm.activate", 3000, 4000,
                        {"flow": "act:0:2", "flow_side": "recv"})]),
        _tree_rank(3, [("comm.activate", 9000, 10000,
                        {"flow": "act:1:3", "flow_side": "recv"})]),
    ]
    with tempfile.TemporaryDirectory(prefix="tracemerge_") as d:
        paths = []
        for r, t in enumerate(tr):
            p = os.path.join(d, f"trace-rank{r}.json")
            with open(p, "w") as f:
                json.dump(t, f)
            paths.append(p)
        stats = merge_traces(paths, os.path.join(d, "merged.json"))
        assert stats["flows_matched"] == 3, stats
        tree = stats["trees"]["beef02"]
        assert tree["hops"] == 3, tree
        assert tree["depth"] == 2, tree          # root -> 1 -> 3
        assert tree["ranks"] == [0, 1, 2, 3], tree
        assert abs(tree["critical_path_us"] - 7.0) < 1.0, tree

    # --- the resumed-GET case: rank 0 starts
    # serving get:1:9, dies mid-flight; resume_get retargets the landing
    # zone at rank 2, which re-serves under the SAME flow key; rank 1's
    # recv completes against the survivor.  The arrow must bind rank 2's
    # emit (matching on (key, src rank) would keep only rank 0's dead
    # partial) and carry resumed=1. ---
    r0 = _synthetic_rank(0, perf_base=1_000_000, unix_base=unix0, spans=[
        ("comm.get_serve", 1000, 3000,
         {"flow": "get:1:9", "flow_side": "emit", "partial": 1}),
    ])
    r1 = _synthetic_rank(1, perf_base=2_000_000, unix_base=unix0, spans=[
        ("comm.get", 1000, 9000,
         {"flow": "get:1:9", "flow_side": "recv"}),
    ])
    r2 = _synthetic_rank(2, perf_base=3_000_000, unix_base=unix0, spans=[
        ("comm.get_serve", 5000, 8000,
         {"flow": "get:1:9", "flow_side": "emit"}),
    ])
    with tempfile.TemporaryDirectory(prefix="tracemerge_") as d:
        paths = []
        for r, t in enumerate((r0, r1, r2)):
            p = os.path.join(d, f"trace-rank{r}.json")
            with open(p, "w") as f:
                json.dump(t, f)
            paths.append(p)
        out = os.path.join(d, "merged.json")
        stats = merge_traces(paths, out)
        assert stats["flows_matched"] == 1, stats
        assert stats["resumed_flows"] == 1, stats
        with open(out) as f:
            evs = json.load(f)["traceEvents"]
        s = [e for e in evs if e.get("ph") == "s"]
        assert len(s) == 1, s
        # the arrow leaves the SURVIVOR's emit (rank 2), tagged resumed
        assert s[0]["pid"] // 100 == 2, s
        assert s[0]["args"].get("resumed") == 1, s
        assert s[0]["args"]["hop"] == "2->1", s
    print("tracemerge self-test: ok (2 flows stitched, 2 cross-rank, "
          "clock-aligned; 4-rank tree: 3 hops, depth 2; resumed GET "
          "rebinds to the survivor emit)")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-test" in argv:
        return self_test()
    out = "merged_trace.json"
    if "-o" in argv:
        i = argv.index("-o")
        if i + 1 >= len(argv):
            print(__doc__, file=sys.stderr)
            return 2
        out = argv[i + 1]
        del argv[i:i + 2]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    stats = merge_traces(argv, out)
    print(f"{out}: {stats['events']} events, "
          f"{stats['flows_matched']} flows stitched "
          f"({stats['cross_rank_flows']} cross-rank, "
          f"{stats['resumed_flows']} resumed, "
          f"by kind {stats['flows_by_kind']})")
    cp = stats.get("critpath") or {}
    if cp.get("buckets_ms"):
        bk = cp["buckets_ms"]
        eff = cp.get("overlap_efficiency")
        print("  critpath: " + " | ".join(
            f"{b} {v:.2f}ms" for b, v in bk.items() if v > 0)
            + (f"  (overlap eff {eff:.3f}, lost "
               f"{cp['overlap_lost_ms']:.2f}ms)" if eff is not None
               else ""))
    for tr, t in stats["trees"].items():
        print(f"  tree {tr}: {t['hops']} hops, depth {t['depth']}, "
              f"ranks {t['ranks']}, critical path "
              f"{t['critical_path_us']:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())

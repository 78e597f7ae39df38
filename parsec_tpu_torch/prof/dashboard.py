"""Live runtime dashboard: the ``tools/aggregator_visu`` consumer.

Port of ``parsec_tpu/prof/dashboard.py``.  It tails the JSON snapshot
file a context writes when ``props_stream`` is set
(:meth:`~parsec_tpu_torch.prof.counters.PropertiesDictionary.stream_to`)
and renders the gauges as a refreshing terminal table: scheduler depth,
live pools and tasks, SDE counters, alperf throughput, the SLO plane,
one column per namespace (rank).

Usage::

    PARSEC_MCA_props_stream=props.json python my_app.py &
    python -m parsec_tpu_torch.prof.dashboard props.json
    python -m parsec_tpu_torch.prof.dashboard --critpath trace.json

The runtime never blocks on the observer, and the observer never
perturbs the runtime.  Left out: nothing of the module.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any

from .counters import read_live_snapshot


def render_critpath(report: dict) -> str:
    """The critical-path panel (pure; testable): bucket bar + top
    overlap_lost edge classes from a :mod:`critpath` compact report."""
    lines = ["critical path"]
    bk = report.get("buckets_ms") or {}
    tot = sum(bk.values()) or 1.0
    order = ("exec", "release", "queue", "comm.activate", "comm.get",
             "idle")
    parts = [f"{b} {bk[b]:.1f}ms ({100 * bk[b] / tot:.0f}%)"
             for b in order if bk.get(b, 0) > 0]
    lines.append("  " + (" | ".join(parts) if parts else "(no spans)"))
    eff = report.get("overlap_efficiency")
    if eff is not None:
        lines.append(f"  overlap eff {eff:.3f}   "
                     f"lost {report.get('overlap_lost_ms', 0):.2f}ms")
    for cls, ms in report.get("top_overlap_lost") or []:
        lines.append(f"  lost {cls:<28} {ms:9.3f}ms")
    return "\n".join(lines)


def render_snapshot(snap: dict) -> str:
    """One snapshot -> a fixed-width table (pure; testable)."""
    props: dict[str, dict[str, Any]] = snap.get("props", {})
    ts = snap.get("ts", 0.0)
    lines = [f"parsec-tpu live properties   "
             f"@ {time.strftime('%H:%M:%S', time.localtime(ts))}"]
    if snap.get("critpath"):
        lines.append(render_critpath(snap["critpath"]))
    namespaces = sorted(props)
    # collect the union of scalar gauge names; dict-valued gauges (sde)
    # expand into their own rows
    rows: dict[str, dict[str, Any]] = {}
    for ns in namespaces:
        for name, val in props[ns].items():
            if isinstance(val, dict):
                for k, v in val.items():
                    rows.setdefault(f"{name}:{k}", {})[ns] = v
            else:
                rows.setdefault(name, {})[ns] = val
    if not rows:
        lines.append("  (no properties registered)")
        return "\n".join(lines)
    w0 = max(len(r) for r in rows) + 2
    wc = max(12, *(len(ns) + 2 for ns in namespaces))
    lines.append(" " * w0 + "".join(ns.rjust(wc) for ns in namespaces))
    for rname in sorted(rows):
        cells = []
        for ns in namespaces:
            v = rows[rname].get(ns, "")
            if isinstance(v, float):
                v = f"{v:.1f}"
            cells.append(str(v).rjust(wc))
        lines.append(rname.ljust(w0) + "".join(cells))
    return "\n".join(lines)


def watch(path: str, interval: float = 0.5, iterations: int | None = None,
          out: Any = None) -> None:
    """Refresh loop (``iterations=None`` runs until interrupted)."""
    out = out or sys.stdout
    n = 0
    while iterations is None or n < iterations:
        try:
            snap = read_live_snapshot(path)
            text = render_snapshot(snap)
        except FileNotFoundError:
            text = f"waiting for {path} ..."
        except (ValueError, json.JSONDecodeError):
            text = f"unreadable snapshot at {path} (mid-write?)"
        out.write("\x1b[2J\x1b[H" if out is sys.stdout else "")
        out.write(text + "\n")
        out.flush()
        n += 1
        if iterations is None or n < iterations:
            time.sleep(interval)


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if args[0] == "--critpath":
        # one-shot offline panel over a trace artifact (chrome or raw
        # spans export) — the same renderer the live loop embeds
        from .critpath import attribute, load
        rep = attribute(load(args[1]))
        print(render_critpath(rep))
        return 0
    interval = float(args[1]) if len(args) > 1 else 0.5
    try:
        watch(args[0], interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

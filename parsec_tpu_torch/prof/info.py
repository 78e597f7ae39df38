"""Trace statistics CLI: the ``dbpinfos`` / ``dbp2xml`` role.

Port of ``parsec_tpu/prof/info.py``: open one or more binary ``PTPB``
traces (one per rank, written by ``trace_state.dump``) and print their
dictionary, streams and per-event-class statistics: counts,
total/mean/min/max durations, and byte volumes where the event infos
carry them.

::

    python -m parsec_tpu_torch.prof.info rank0.prof [rank1.prof ...]
    python -m parsec_tpu_torch.prof.info --validate rank*.prof
    python -m parsec_tpu_torch.prof.info --chrome out.json rank0.prof

The returned statistics are the JAX package's on the same file.  Left
out: nothing of the module.
"""

from __future__ import annotations

import sys

from .profiling import Profiling


def _fmt_ns(ns: float) -> str:
    for unit, div in (("s", 1e9), ("ms", 1e6), ("us", 1e3)):
        if ns >= div:
            return f"{ns / div:.3f}{unit}"
    return f"{ns:.0f}ns"


def summarize(path: str, out=None, validate: bool = False) -> dict:
    """Per-class stats of one trace file; printed dbpinfos-style to
    ``out`` and returned as a dict (tests and tooling consume it)."""
    out = out or sys.stdout
    p = Profiling.load(path)
    w = out.write
    w(f"==================== {path} ====================\n")
    w(f"  dictionary: {len(p.dictionary)} event classes\n")
    for name, ec in p.dictionary.items():
        fields = (f" fields={','.join(ec.info_fields)}"
                  if ec.info_fields else "")
        w(f"    {name}  color={ec.color}{fields}\n")
    w(f"  streams: {len(p.streams)}\n")
    for s in p.streams:
        w(f"    [{s.stream_id}] {s.name}: {len(s.events)} raw events\n")

    stats: dict[str, dict] = {}
    for rec in p.to_records():
        st = stats.setdefault(rec["name"], {
            "count": 0, "total_ns": 0, "min_ns": None, "max_ns": 0,
            "bytes": 0})
        d = rec["duration_ns"]
        st["count"] += 1
        st["total_ns"] += d
        st["min_ns"] = d if st["min_ns"] is None else min(st["min_ns"], d)
        st["max_ns"] = max(st["max_ns"], d)
        for k, v in rec.items():
            # byte-volume infos (traffic counters ride event infos as
            # info.bytes / info.nbytes / ...)
            if k.startswith("info.") and k.removeprefix("info.") in (
                    "bytes", "nbytes", "bytes_in", "bytes_out") \
                    and isinstance(v, (int, float)):
                st["bytes"] += int(v)

    w("  per-class stats (matched begin/end pairs):\n")
    w(f"    {'class':24} {'count':>7} {'total':>10} {'mean':>10} "
      f"{'min':>10} {'max':>10} {'bytes':>12}\n")
    for name in sorted(stats):
        st = stats[name]
        mean = st["total_ns"] / st["count"] if st["count"] else 0
        w(f"    {name:24} {st['count']:>7} {_fmt_ns(st['total_ns']):>10} "
          f"{_fmt_ns(mean):>10} {_fmt_ns(st['min_ns'] or 0):>10} "
          f"{_fmt_ns(st['max_ns']):>10} {st['bytes']:>12}\n")

    problems: list[str] = []
    if validate:
        problems = p.validate()
        if problems:
            w(f"  VALIDATION: {len(problems)} problem(s)\n")
            for pr in problems:
                w(f"    {pr}\n")
        else:
            w("  VALIDATION: ok\n")
    return {"path": path, "classes": stats, "streams": len(p.streams),
            "problems": problems}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    validate = "--validate" in argv
    chrome = None
    if "--chrome" in argv:
        i = argv.index("--chrome")
        if i + 1 >= len(argv):
            print(__doc__, file=sys.stderr)
            return 2
        chrome = argv[i + 1]
        del argv[i:i + 2]
    paths = [a for a in argv if a != "--validate"]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for path in paths:
        res = summarize(path, validate=validate)
        if res["problems"]:
            rc = 1
    if chrome is not None:
        # one-command standard-viewer conversion (dbp2xml role): the
        # FIRST trace exports; merge multi-rank views in the viewer
        Profiling.load(paths[0]).to_chrome_trace(chrome)
        print(f"chrome trace written: {chrome}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())

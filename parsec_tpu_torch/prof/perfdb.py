"""Persistent perf ledger and regression sentinel.

Port of ``parsec_tpu/prof/perfdb.py``: an append-only JSONL ledger of
measured perf scalars, keyed by a **workload** name, the backend triple
(:func:`backend_signature`: ``(torch version, "cuda" | "cpu", device
name)``, the lowering cache's :func:`~parsec_tpu_torch.ptg.lowering.
_backend_signature`) and an explicit **knob vector**, so a number is only
compared against its own configuration class.  The file accrues across
runs (``$PARSEC_TPU_ARTIFACT_DIR/perfdb.jsonl`` by default, else
``perfdb.jsonl`` in ``tempfile.gettempdir()``) and is both
the regression sentinel and the autotuner's memory
(:mod:`parsec_tpu_torch.tune.search` appends every trial with
:meth:`PerfDB.note_trial` and prunes known-bad vectors from it).

Drift detection is an EWMA per key: :meth:`PerfDB.check` folds the key's
history into an exponentially weighted mean and variance and verdicts a
new value ``ok`` / ``regressed`` / ``improved`` with a z-score.  The
variance floor is relative (``REL_FLOOR`` of the mean), so steady history
does not make every change infinite-z; direction comes from the metric
name (:func:`better_of`).  A torn last line (a writer killed mid-append)
is skipped, never fatal.  The JSONL layout is the JAX package's, so each
package reads the other's file; their records never share a key, since
the backend column differs.

::

    python -m parsec_tpu_torch.prof.perfdb --self-test
    python -m parsec_tpu_torch.prof.perfdb --history tune.<signature>
    python -m parsec_tpu_torch.prof.perfdb --ingest BENCH_r01.json ...

MCA knobs: ``perfdb`` (0 disables every append), ``perfdb_path``
(overrides the ledger location).  Nothing is left out.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from typing import Iterable

from ..core.params import params as _params

_params.register("perfdb", True,
                 "append bench/microbench perf scalars to the JSONL "
                 "perf ledger and run the EWMA drift sentinel over "
                 "them (0 = no ledger writes, no sentinel)")
_params.register("perfdb_path", "",
                 "perf ledger location (default: "
                 "$PARSEC_TPU_ARTIFACT_DIR/perfdb.jsonl, else in "
                 "the temporary directory, tempfile.gettempdir())")

# EWMA fold + verdict thresholds: alpha weights recent runs, the z gate
# needs a genuinely multi-sigma move, REL_FLOOR stops steady history
# from making sigma ~0 (any change would then be infinite-z), and
# MIN_HISTORY keeps the sentinel quiet until the key has a real mean.
ALPHA = 0.3
Z_THRESHOLD = 4.0
REL_FLOOR = 0.05
MIN_HISTORY = 3

_HIGHER_IS_BETTER = ("per_s", "gbps", "gflops", "throughput", "_hits",
                     "efficiency", "speedup", "rate", "_frac", "pct_")
_LOWER_IS_BETTER = ("latency", "_wait", "_p50", "_p99", "dispatch",
                    "compile", "ttft", "overhead", "_err", "dropped",
                    "_lost", "_relerr")


def better_of(metric: str) -> str:
    """Direction heuristic from the metric name: throughput-shaped
    metrics (rates, GB/s, GFLOPS, hit counts, efficiency) are better
    HIGH; time/latency-shaped ones (``*_us``/``*_ms``/``*_s``,
    latency, compile seconds) better LOW.  The rate check runs first so
    ``tokens_per_s`` never reads as a seconds metric."""
    m = metric.lower()
    if any(t in m for t in _HIGHER_IS_BETTER):
        return "higher"
    if m.endswith(("_us", "_ms", "_ns", "_s", "_seconds")) \
            or any(t in m for t in _LOWER_IS_BETTER):
        return "lower"
    return "higher"


def default_path() -> str:
    p = str(_params.get("perfdb_path") or "")
    if p:
        return p
    return os.path.join(os.environ.get("PARSEC_TPU_ARTIFACT_DIR",
                                       tempfile.gettempdir()),
                        "perfdb.jsonl")


def backend_signature() -> list:
    """The lowering cache's backend triple as a list, degraded to a
    host-only triple when it cannot be read (the ledger must still
    work)."""
    try:
        from ..ptg.lowering import _backend_signature
        return list(_backend_signature())
    except Exception:                       # noqa: BLE001 — ledger first
        return ["notorch", "cpu", ""]


def make_key(workload: str, metric: str, backend: list | None = None,
             knobs: dict | None = None) -> str:
    """Canonical key string: equal key ⇒ comparable measurement class
    (same workload structure, same backend triple, same knob vector)."""
    return json.dumps({"workload": workload, "metric": metric,
                       "backend": backend if backend is not None
                       else backend_signature(),
                       "knobs": knobs or {}},
                      sort_keys=True, separators=(",", ":"))


class PerfDB:
    """One ledger file.  ``append`` writes a record; ``check`` verdicts
    a value against the key's EWMA history; ``append_and_check`` does
    both in the order a sentinel wants (check against history BEFORE
    this run's own sample joins it)."""

    def __init__(self, path: str | None = None) -> None:
        self.path = path or default_path()
        self._cache: list[dict] | None = None

    # -- storage ---------------------------------------------------------
    def records(self) -> list[dict]:
        if self._cache is not None:
            return self._cache
        recs: list[dict] = []
        try:
            with open(self.path) as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    try:
                        recs.append(json.loads(ln))
                    except ValueError:
                        continue            # a torn tail line: skip, keep rest
        except OSError:
            pass
        self._cache = recs
        return recs

    def append(self, key: str, value: float, *, unit: str | None = None,
               run: str | None = None, meta: dict | None = None) -> dict:
        rec = {"key": key, "value": float(value), "ts": round(time.time(), 3)}
        if unit:
            rec["unit"] = unit
        if run:
            rec["run"] = run
        if meta:
            rec["meta"] = meta
        line = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
        if self._cache is not None:
            self._cache.append(rec)
        return rec

    def history(self, key: str) -> list[float]:
        return [r["value"] for r in self.records()
                if r.get("key") == key and isinstance(r.get("value"),
                                                      (int, float))]

    # -- the sentinel ----------------------------------------------------
    @staticmethod
    def _ewma(values: Iterable[float]) -> tuple[float, float, int]:
        """Fold history (file order = time order) into (mean, std, n)
        with an exponentially-weighted mean and variance."""
        m = v = 0.0
        n = 0
        for x in values:
            n += 1
            if n == 1:
                m, v = x, 0.0
                continue
            d = x - m
            m += ALPHA * d
            v = (1.0 - ALPHA) * (v + ALPHA * d * d)
        return m, math.sqrt(max(v, 0.0)), n

    def check(self, key: str, value: float,
              better: str | None = None) -> dict:
        """Verdict ``value`` against the key's EWMA history: ``ok`` /
        ``regressed`` / ``improved`` (+ ``warming`` below MIN_HISTORY),
        with the signed z-score (positive = above the EWMA)."""
        hist = self.history(key)
        m, sd, n = self._ewma(hist)
        if n < MIN_HISTORY:
            return {"verdict": "warming", "z": 0.0, "n": n, "ewma": m}
        if better is None:
            try:
                better = better_of(json.loads(key).get("metric", ""))
            except ValueError:
                better = "higher"
        sigma = max(sd, REL_FLOOR * abs(m), 1e-12)
        z = (float(value) - m) / sigma
        worse = z < -Z_THRESHOLD if better == "higher" else z > Z_THRESHOLD
        improv = z > Z_THRESHOLD if better == "higher" else z < -Z_THRESHOLD
        verdict = "regressed" if worse else ("improved" if improv else "ok")
        return {"verdict": verdict, "z": round(z, 2), "n": n,
                "ewma": round(m, 6)}

    def append_and_check(self, key: str, value: float, *,
                         unit: str | None = None, run: str | None = None,
                         better: str | None = None) -> dict:
        out = self.check(key, value, better=better)
        self.append(key, value, unit=unit, run=run)
        return out

    # -- trial provenance (the autotuner hook) ---------------------------
    def note_trial(self, workload: str, objective: str, value: float, *,
                   knobs: dict | None = None, meta: dict | None = None,
                   backend: list | None = None) -> dict:
        """Append one autotuner trial (:mod:`parsec_tpu_torch.tune`): the
        knob vector IS the key's knobs field, so each candidate point accrues
        its own EWMA history — which is exactly what lets a later search
        prune a known-bad vector without re-measuring it."""
        key = make_key(workload, objective, backend=backend, knobs=knobs)
        return self.append(key, float(value), run="tune", meta=meta)

    # -- bulk note (the bench / microbench hook) -------------------------
    def note_result(self, workload: str, result: dict, *,
                    knobs: dict | None = None, run: str | None = None,
                    backend: list | None = None) -> list[dict]:
        """Append every finite scalar of ``result`` under
        ``workload``/metric keys and verdict each against its history.
        Returns one entry per metric: {metric, key, value, verdict, z}.
        Nested dicts are skipped (bench stages nest runtime_report /
        sweeps; their scalars are not stage headlines) — except that a
        ``partial`` block's scalars ARE walked: a deadline-dead stage's
        flushed metrics still reach the ledger."""
        out: list[dict] = []
        be = backend if backend is not None else backend_signature()
        items = list(result.items())
        part = result.get("partial")
        if isinstance(part, dict):
            items += [(f"partial.{k}", v) for k, v in part.items()]
        for metric, value in items:
            if isinstance(value, bool) or not isinstance(value,
                                                         (int, float)):
                continue
            if not math.isfinite(float(value)):
                continue
            if metric in ("ts",) or metric.startswith("_"):
                continue
            key = make_key(workload, metric, backend=be, knobs=knobs)
            v = self.append_and_check(key, float(value), run=run)
            out.append({"metric": metric, "workload": workload,
                        "key": key, "value": float(value), **v})
        return out


# ---------------------------------------------------------------------------
# backfill: import existing BENCH_* / MULTICHIP_* artifacts
# ---------------------------------------------------------------------------

def _scalars(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(float(v))}


def ingest(paths: list[str], db: PerfDB | None = None) -> dict:
    """Backfill the ledger from existing run artifacts so the sentinel
    starts with r01-r05 history instead of a cold EWMA.

    Accepts the repo-root artifact shapes: ``BENCH_r*.json`` (a wrapper
    whose ``parsed`` field is the bench emit line — or the emit line
    itself), and ``MULTICHIP_r*.json`` (ingested only when ``ok``).
    The backend triple is the CURRENT process signature with the device
    kind replaced by the artifact's recorded ``device_kind`` — a future
    run on the same device class and torch build lands on the same keys,
    which is the whole point of warming them."""
    db = db or PerfDB()
    imported = skipped = 0
    for path in paths:
        run = os.path.basename(path).rsplit(".", 1)[0]
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"[perfdb] {path}: unreadable ({e}) — skipped",
                  file=sys.stderr)
            skipped += 1
            continue
        line = doc.get("parsed") if isinstance(doc.get("parsed"), dict) \
            else (doc if "metric" in doc else None)
        if line is None:
            if doc.get("ok") is False or doc.get("rc", 0) != 0:
                print(f"[perfdb] {path}: failed run (rc="
                      f"{doc.get('rc')}) — skipped", file=sys.stderr)
                skipped += 1
                continue
            print(f"[perfdb] {path}: no parsed emit line — skipped",
                  file=sys.stderr)
            skipped += 1
            continue
        extra = line.get("extra") or {}
        be = backend_signature()
        kind = extra.get("device_kind")
        if kind:
            be = be[:2] + [kind]
        n = 0
        # the headline metric
        if isinstance(line.get("value"), (int, float)):
            db.append(make_key("bench.gemm",
                               line.get("metric", "headline"),
                               backend=be,
                               knobs={"n": extra.get("n"),
                                      "nb": extra.get("nb")}),
                      float(line["value"]), unit=line.get("unit"),
                      run=run)
            n += 1
        # flat extra scalars ride as workload "bench"; nested stage
        # namespaces (overhead/comm/serve/llm/...) as "bench.<ns>" —
        # the same workload names the live bench append uses
        for k, v in _scalars(extra).items():
            db.append(make_key("bench", k, backend=be), v, run=run)
            n += 1
        for ns, sub in extra.items():
            if isinstance(sub, dict) and ns != "runtime_reports":
                for k, v in _scalars(sub).items():
                    db.append(make_key(f"bench.{ns}", k, backend=be),
                              v, run=run)
                    n += 1
        print(f"[perfdb] {path}: {n} scalars ingested as run {run!r}")
        imported += 1
    return {"files": imported, "skipped": skipped,
            "records": len(db.records()), "path": db.path}


# ---------------------------------------------------------------------------
# self-test (scripts/check.sh gate)
# ---------------------------------------------------------------------------

def self_test() -> int:
    """The sentinel round-trip the perf_smoke gate also pins: steady
    history + 5% noise stays ok; a 10x cliff is flagged in BOTH
    directions; histories accrue across PerfDB instances (two
    'invocations' of one file)."""
    with tempfile.TemporaryDirectory(prefix="perfdb_") as d:
        p = os.path.join(d, "perfdb.jsonl")
        db = PerfDB(p)
        k_hi = make_key("selftest", "tokens_per_s", backend=["t", "c", ""])
        k_lo = make_key("selftest", "dispatch_us", backend=["t", "c", ""])
        for i in range(8):
            db.append(k_hi, 1000.0 + (i % 3) * 10)      # ~1% wobble
            db.append(k_lo, 10.0 + (i % 3) * 0.1)
        db2 = PerfDB(p)                     # a fresh "second invocation"
        assert db2.check(k_hi, 1050.0)["verdict"] == "ok"       # 5% noise
        assert db2.check(k_hi, 100.0)["verdict"] == "regressed"  # 10x down
        assert db2.check(k_hi, 10000.0)["verdict"] == "improved"
        assert db2.check(k_lo, 10.4)["verdict"] == "ok"
        r = db2.check(k_lo, 100.0)          # 10x slower: worse for _us
        assert r["verdict"] == "regressed", r
        assert r["z"] > Z_THRESHOLD, r
        assert db2.check(k_lo, 1.0)["verdict"] == "improved"
        # the commcheck agreement gate rides the _err direction: growing
        # static-vs-wire disagreement must read as a regression
        assert better_of("comm_agree_8r_err") == "lower"
        assert better_of("bytes_relerr") == "lower"
        # cold keys warm silently
        k_new = make_key("selftest", "fresh_metric")
        assert db2.check(k_new, 5.0)["verdict"] == "warming"
        # note_result walks scalars (partial included) and skips nests
        notes = db2.note_result("selftest.stage",
                                {"gflops": 3.0, "runtime_report": {"x": 1},
                                 "partial": {"compile_s": 2.0},
                                 "label": "str-skipped"})
        assert {e["metric"] for e in notes} == \
            {"gflops", "partial.compile_s"}, notes
        n0 = len(db2.records())     # 16 loop appends + 2 note_result
        assert n0 == 16 + 2, n0
    print("perfdb self-test: ok (EWMA sentinel: 5% noise ok, 10x cliff "
          "flagged both directions, cross-instance accrual)")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-test" in argv:
        return self_test()
    path = None
    if "-o" in argv:
        i = argv.index("-o")
        path = argv[i + 1]
        del argv[i:i + 2]
    if "--history" in argv:
        i = argv.index("--history")
        workload = argv[i + 1]
        db = PerfDB(path)
        seen: dict[str, list[float]] = {}
        for r in db.records():
            try:
                kd = json.loads(r["key"])
            except (KeyError, ValueError):
                continue
            if kd.get("workload") == workload:
                seen.setdefault(kd["metric"], []).append(r["value"])
        for metric in sorted(seen):
            vals = seen[metric]
            m, sd, n = PerfDB._ewma(vals)
            print(f"{workload}/{metric}: n={n} ewma={m:.4g} sd={sd:.3g} "
                  f"last={vals[-1]:.4g}")
        return 0
    if "--ingest" in argv:
        argv.remove("--ingest")
        if not argv:
            print(__doc__, file=sys.stderr)
            return 2
        stats = ingest(argv, PerfDB(path))
        print(f"perfdb: {stats['files']} artifacts ingested "
              f"({stats['skipped']} skipped) -> {stats['path']} "
              f"({stats['records']} records)")
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())

"""Persistent tuning DB: the knob vectors that won.

Port of ``parsec_tpu/tune/db.py``: an append-only JSONL store
(``$PARSEC_TPU_ARTIFACT_DIR/tunedb.jsonl`` by default, else
``tunedb.jsonl`` in ``tempfile.gettempdir()``, which honours ``TMPDIR``;
the perf ledger's sibling) keyed by
``(signature, backend, objective)``:

- **signature**: a workload's structural signature (:mod:`.signature`)
  or an ambient tag (``ambient:context``, ``ambient:tenant:<t>``);
- **backend**: the lowering cache's ``(torch version, "cuda" | "cpu",
  device name)`` triple, so a vector tuned on one backend never applies
  on another (and a JAX record, whose triple names jax, never applies
  here, though the file and its layout are shared);
- **objective**: what the score means (``wall_s``, ``tok_latency_ms``...),
  with its direction from :func:`parsec_tpu_torch.prof.perfdb.better_of`.

``best(signature)`` is one in-memory dict probe: the file is parsed once
per (mtime, size) generation (:func:`cached_db`).  Writers only append;
the best-per-key reduction happens at read time, and a torn last line is
skipped, never fatal.

MCA knobs: ``tune_db`` (0 disables every consult), ``tune_db_path``
(overrides the store location).  Left out: the JAX module's runtimelint
contract table (``_LOCK_PROTECTED``); its rule holds all the same: the
process-wide cache mutates only under ``_cache_lock``.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import time

from ..core.params import params as _params
from ..prof.perfdb import backend_signature, better_of

_params.register("tune_db", True,
                 "consult the persistent tuning DB at Context start and "
                 "RuntimeServer per-tenant submit and apply the stored "
                 "knob vector (0 = always run at the configured "
                 "defaults; explicit env/cli overrides always win)")
_params.register("tune_db_path", "",
                 "tuning DB location (default: "
                 "$PARSEC_TPU_ARTIFACT_DIR/tunedb.jsonl, else in "
                 "the temporary directory, tempfile.gettempdir())")

def default_path() -> str:
    p = str(_params.get("tune_db_path") or "")
    if p:
        return p
    return os.path.join(os.environ.get("PARSEC_TPU_ARTIFACT_DIR",
                                       tempfile.gettempdir()),
                        "tunedb.jsonl")


def make_key(signature: str, backend: list | None = None,
             objective: str = "wall_s") -> str:
    """Canonical key string — same discipline as
    :func:`parsec_tpu_torch.prof.perfdb.make_key`: equal key ⇒ the stored
    vector is applicable (same structure, same backend, same meaning of
    the score)."""
    return json.dumps({"sig": signature,
                       "backend": backend if backend is not None
                       else backend_signature(),
                       "objective": objective},
                      sort_keys=True, separators=(",", ":"))


class TuneDB:
    """One tuning store file: ``note`` appends a scored knob vector,
    ``best`` returns the winning vector for a key (direction from the
    objective name), ``None`` on miss."""

    def __init__(self, path: str | None = None) -> None:
        self.path = path or default_path()
        self._records: list[dict] | None = None
        self._best: dict[str, dict] | None = None

    # -- storage ---------------------------------------------------------
    def records(self) -> list[dict]:
        if self._records is not None:
            return self._records
        recs: list[dict] = []
        try:
            with open(self.path) as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    try:
                        r = json.loads(ln)
                    except ValueError:
                        continue        # torn tail line: skip, keep rest
                    if isinstance(r, dict) and isinstance(
                            r.get("knobs"), dict):
                        recs.append(r)
        except OSError:
            pass
        self._records = recs
        return recs

    def note(self, signature: str, knobs: dict, score: float, *,
             objective: str = "wall_s", backend: list | None = None,
             source: str = "search", meta: dict | None = None) -> dict:
        """Append one scored vector.  ``source`` says who produced it
        (``search`` / ``adaptive`` / ``seed``) — provenance, not part of
        the key."""
        if not math.isfinite(float(score)):
            raise ValueError(f"non-finite tune score: {score!r}")
        rec = {"key": make_key(signature, backend, objective),
               "sig": signature, "objective": objective,
               "knobs": dict(knobs), "score": float(score),
               "source": source, "ts": round(time.time(), 3)}
        if meta:
            rec["meta"] = meta
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True,
                               separators=(",", ":")) + "\n")
        if self._records is not None:
            self._records.append(rec)
        self._best = None
        return rec

    # -- queries ---------------------------------------------------------
    def _index(self) -> dict[str, dict]:
        if self._best is not None:
            return self._best
        best: dict[str, dict] = {}
        for r in self.records():
            k = r.get("key")
            s = r.get("score")
            if not isinstance(k, str) or not isinstance(s, (int, float)):
                continue
            cur = best.get(k)
            if cur is None:
                best[k] = r
                continue
            hi = better_of(str(r.get("objective", ""))) == "higher"
            if (s > cur["score"]) == hi and s != cur["score"]:
                best[k] = r
        self._best = best
        return best

    def best(self, signature: str, *, objective: str = "wall_s",
             backend: list | None = None) -> dict | None:
        """The winning record for ``(signature, backend, objective)`` —
        ``{"knobs": ..., "score": ..., "source": ...}`` — or ``None``:
        the caller falls back to its configured defaults."""
        return self._index().get(make_key(signature, backend, objective))


# -- the process-wide cached consult path -----------------------------------
# Context start and per-tenant submit probe the DB on hot paths; the
# file is re-parsed only when its (mtime_ns, size) generation moves.
_cache_lock = threading.Lock()
_cached: dict[str, tuple[tuple, TuneDB]] = {}


def cached_db(path: str | None = None) -> TuneDB:
    path = path or default_path()
    try:
        st = os.stat(path)
        gen = (st.st_mtime_ns, st.st_size)
    except OSError:
        gen = (0, -1)                   # absent file: one shared miss DB
    with _cache_lock:
        hit = _cached.get(path)
        if hit is not None and hit[0] == gen:
            return hit[1]
        db = TuneDB(path)
        _cached[path] = (gen, db)
        return db


def best(signature: str, *, objective: str = "wall_s",
         backend: list | None = None, path: str | None = None
         ) -> dict | None:
    """Module-level convenience over the cached store."""
    return cached_db(path).best(signature, objective=objective,
                                backend=backend)

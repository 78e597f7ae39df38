"""Closed-loop autotuner: signature-keyed knob search over the perf
ledger, with live per-tenant adaptation.

Port of ``parsec_tpu/tune``:

- :mod:`.signature` and :mod:`.search`: a workload's structural
  signature keys a budgeted coordinate-descent search over the DECLARED
  knob space (:class:`~parsec_tpu_torch.core.params.KnobSpec`), each
  trial under a scoped MCA override and recorded to the perf ledger;
- :mod:`.db`: the persistent tuning DB (``tunedb.jsonl``), consulted at
  ``Context`` start and at a RuntimeServer tenant's first stream
  (``tune_db``, on by default; an operator's env value always wins);
- :mod:`.adaptive`: the EWMA controller resizing ``llm_steps_per_pool``
  per tenant live (``tune_adaptive``, off by default), converged values
  written back to the DB.

``python -m parsec_tpu_torch.tune --self-test`` runs the synthetic
quadratic-basin gate.  Nothing is left out.
"""

from __future__ import annotations

import json

from ..core.params import params as _params
from ..prof.perfdb import backend_signature
from .db import TuneDB, best, cached_db, default_path, make_key  # noqa: F401
from .signature import (ambient_signature, size_bucket,  # noqa: F401
                        workload_signature)

__all__ = ["TuneDB", "best", "cached_db", "default_path", "make_key",
           "ambient_signature", "size_bucket", "workload_signature",
           "search", "KnobController", "apply_ambient", "consult_ambient"]


def __getattr__(name: str):
    # the heavy halves load on first use: importing the tuner from
    # Context.__init__ must not drag the search/adaptive machinery in
    if name == "search":
        from .search import search
        return search
    if name == "KnobController":
        from .adaptive import KnobController
        return KnobController
    raise AttributeError(name)


def consult_ambient(tag: str, *, objective: str | None = None
                    ) -> dict | None:
    """The stored knob vector for an ambient tag (``context``,
    ``tenant:<t>``), or ``None``: gate (``tune_db``), cached-store probe,
    declared-knob filter — but no application.  Any objective matches
    when ``objective`` is None (ambient tags rarely carry more than
    one), but only among records of this backend: the file is shared
    with the JAX package, whose records carry another backend triple in
    their key and so never apply here."""
    if not _params.get("tune_db"):
        return None
    try:
        db = cached_db()
        sig = ambient_signature(tag)
        if objective is not None:
            rec = db.best(sig, objective=objective)
        else:
            rec = None
            backend = backend_signature()
            for r in db._index().values():
                if r.get("sig") != sig or \
                        json.loads(r["key"]).get("backend") != backend:
                    continue
                rec = r if rec is None or r["ts"] > rec["ts"] else rec
    except Exception:                   # noqa: BLE001 — a corrupt DB must
        return None                     # never fail a Context start
    if rec is None:
        return None
    space = _params.knob_space()
    knobs = {n: v for n, v in rec["knobs"].items()
             if n in space and space[n].contains(v)}
    return knobs or None


def apply_ambient(tag: str) -> dict | None:
    """Consult + APPLY: set every declared, registered knob from the
    stored vector — skipping knobs the operator pinned via env/cli (an
    explicit override always wins over a persisted tuning).  Returns
    the dict actually applied, or ``None`` on miss/disabled.  The port's
    registry has no command line: an ``env`` source is the pin."""
    knobs = consult_ambient(tag)
    if not knobs:
        return None
    applied: dict = {}
    for name, value in knobs.items():
        p = _params.lookup(name)
        if p is None:                   # owning module not loaded yet:
            continue                    # nothing to apply the knob to
        if p.source in ("env", "cli"):
            continue
        try:
            _params.set(name, value)
            applied[name] = _params.get(name)
        except Exception:               # noqa: BLE001 — one bad knob must
            continue                    # not lose the rest of the vector
    return applied or None

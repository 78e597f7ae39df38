"""Budgeted knob search: coordinate descent with random restarts.

Port of ``parsec_tpu/tune/search.py``.  One trial runs the workload
under a scoped MCA override (``params.overrides``) of a candidate knob
vector and scores it.  The search walks the DECLARED knob space
(:class:`~parsec_tpu_torch.core.params.KnobSpec`), coordinate by
coordinate, keeping improving moves; when a sweep makes no move it
restarts from a vector sampled with ``random.Random(seed)`` until the
trial budget is spent.  With the same seed, space, budget and objective
it walks the JAX search's trajectory.

The perf ledger (:mod:`parsec_tpu_torch.prof.perfdb`) is provenance and
memory: every executed trial is appended under ``tune.<signature>`` with
its knob vector in the key, and a candidate whose recorded history is
already ``PRUNE_FACTOR`` worse than the incumbent is pruned without
spending a trial.  The winner persists to the tuning DB (:mod:`.db`)
under the workload's signature (and an ambient tag a fresh Context or a
tenant's first stream consults).  A trial that raises is a failed trial
(a non-move), never a rerun elsewhere.  Nothing is left out.
"""

from __future__ import annotations

import math
import random
import time
from typing import Any, Callable

from ..core.params import KnobSpec, params as _params
from ..prof import perfdb as _perfdb
from .db import TuneDB
from .signature import ambient_signature

# a candidate whose perfdb EWMA is this factor worse than the incumbent
# score is pruned from the search without re-measuring
PRUNE_FACTOR = 2.0


def declared_space(names: list[str] | None = None) -> dict[str, KnobSpec]:
    """The search domain: the declared knob space, optionally
    restricted to ``names`` (undeclared names raise — an undeclared
    param is configuration, not a knob)."""
    space = _params.knob_space()
    if names is None:
        return space
    missing = [n for n in names if n not in space]
    if missing:
        raise KeyError(f"undeclared knob(s): {missing} "
                       f"(declare via params.declare_knob)")
    return {n: space[n] for n in names}


def score_from_report(objective: str) -> float | None:
    """Pull ``objective`` out of the runtime self-measurement: a flat
    ``runtime_report()`` scalar, or an SLO quantile spelled
    ``slo:<metric>_p<q>`` (e.g. ``slo:tok_latency_ms_p99``) from the
    merged per-tenant plane.  ``None`` when the run recorded nothing."""
    from ..prof.flight_recorder import runtime_report
    if objective.startswith("slo:"):
        # "slo:tok_latency_ms_p99" — the worst tenant's value across
        # every live plane (the summary is {tenant: {metric_pQ: v}})
        name = objective[4:]
        _metric, _, q = name.rpartition("_p")
        try:
            from ..prof.histogram import merged_summary
            s = merged_summary(quantiles=(float(q) / 100.0,))
        except Exception:               # noqa: BLE001 — no plane, no score
            return None
        vals = [d[name] for d in s.values()
                if isinstance(d, dict)
                and isinstance(d.get(name), (int, float))]
        return float(max(vals)) if vals else None
    v = runtime_report().get(objective)
    return float(v) if isinstance(v, (int, float)) else None


class _Evaluator:
    """Runs + scores one knob vector, with perfdb provenance/pruning."""

    def __init__(self, workload_fn: Callable[[dict], Any], signature: str,
                 objective: str, perf: "_perfdb.PerfDB | None",
                 note: Callable[..., None] | None) -> None:
        self.fn = workload_fn
        self.signature = signature
        self.objective = objective
        self.perf = perf
        self.note = note
        self.higher = _perfdb.better_of(objective) == "higher"
        self.evals = 0
        self.pruned = 0
        self.trials: list[dict] = []
        self.failed: list[dict] = []
        self._seen: dict[tuple, float] = {}

    def _key(self, knobs: dict) -> str:
        return _perfdb.make_key(f"tune.{self.signature}", self.objective,
                                knobs=knobs)

    def better(self, a: float, b: float) -> bool:
        return a > b if self.higher else a < b

    def prior(self, knobs: dict) -> float | None:
        """The perfdb EWMA of this exact vector's history, if any."""
        if self.perf is None:
            return None
        hist = self.perf.history(self._key(knobs))
        if not hist:
            return None
        m, _sd, _n = self.perf._ewma(hist)
        return m

    def __call__(self, knobs: dict, incumbent: float | None) -> float | None:
        """Score ``knobs`` (memoized); ``None`` = pruned or failed."""
        frozen = tuple(sorted(knobs.items()))
        if frozen in self._seen:
            return self._seen[frozen]
        prior = self.prior(knobs)
        if prior is not None and incumbent is not None:
            bad = (prior < incumbent / PRUNE_FACTOR if self.higher
                   else prior > incumbent * PRUNE_FACTOR)
            if bad:
                self.pruned += 1
                self._seen[frozen] = prior      # known-bad: trust history
                return prior
        mca = {n: v for n, v in knobs.items()
               if _params.knob_spec(n) is not None
               and self._registered(n)}
        t0 = time.perf_counter()
        try:
            with _params.overrides(mca):
                out = self.fn(dict(knobs))
        except Exception as e:          # noqa: BLE001 — a failed trial is
            self._seen[frozen] = math.inf if not self.higher else -math.inf
            self.failed.append({"knobs": dict(knobs), "error": repr(e)})
            return None                 # a non-move, never fatal
        wall = time.perf_counter() - t0
        if isinstance(out, dict):
            score = out.get(self.objective)
        elif isinstance(out, (int, float)) and not isinstance(out, bool):
            score = float(out)
        else:
            score = None
        if score is None:
            score = (score_from_report(self.objective)
                     if self.objective != "wall_s" else None)
        if score is None:
            score = wall                # the universal fallback objective
        score = float(score)
        self.evals += 1
        self._seen[frozen] = score
        self.trials.append({"knobs": dict(knobs), "score": score,
                            "wall_s": round(wall, 4)})
        if self.perf is not None:
            try:
                self.perf.note_trial(f"tune.{self.signature}",
                                     self.objective, score, knobs=knobs,
                                     meta={"trial": self.evals})
            except Exception:           # noqa: BLE001 — ledger never fatal
                pass
        if self.note is not None:
            try:
                self.note(trial=self.evals, score=score, knobs=dict(knobs))
            except Exception:           # noqa: BLE001 — observer never fatal
                pass
        return score

    @staticmethod
    def _registered(name: str) -> bool:
        try:
            _params.get(name)
            return True
        except KeyError:
            return False


def search(workload_fn: Callable[[dict], Any], *, signature: str,
           space: dict[str, KnobSpec] | None = None, budget: int = 16,
           restarts: int = 1, objective: str = "wall_s", seed: int = 0,
           start: dict | None = None, db: TuneDB | None = None,
           persist: bool = True, ambient_tag: str | None = None,
           note: Callable[..., None] | None = None) -> dict:
    """Coordinate-descent search over ``space`` (default: every
    declared knob), at most ``budget`` executed trials.

    ``workload_fn(knobs)`` runs the workload under the already-applied
    scoped MCA overrides (knobs without a registered param — e.g. a
    workload-level tile size — are the callable's to consume) and
    returns the score: a number, a dict carrying ``objective``, or
    ``None`` to fall back to measured wall seconds /
    :func:`score_from_report`.

    Returns ``{"best", "best_score", "evals", "pruned", "trials",
    "failed"}``, ``failed`` listing each vector whose trial raised (a
    non-move here, but a caller that must see every trial scored checks
    it is empty);
    with ``persist`` the winner lands in the tuning DB under
    ``signature`` (and ``ambient:<ambient_tag>`` when given), where
    ``Context`` start / per-tenant submit pick it up."""
    space = dict(space if space is not None else _params.knob_space())
    if not space:
        raise ValueError("empty knob space: declare knobs first")
    db = db or TuneDB()
    ev = _Evaluator(workload_fn, signature, objective,
                    _perfdb.PerfDB() if _params.get("perfdb") else None,
                    note)
    rng = random.Random(seed)

    def start_vector(r: int) -> dict:
        if r > 0:
            return {n: spec.sample(rng) for n, spec in space.items()}
        # restart 0: current values, then a persisted earlier winner,
        # then the caller's explicit start vector — most specific wins
        vec = {n: _params.get(n) if ev._registered(n) else spec.sample(rng)
               for n, spec in space.items()}
        prev = db.best(signature, objective=objective)
        if prev is not None:
            for n, v in prev["knobs"].items():
                if n in space and space[n].contains(v):
                    vec[n] = v
        if start is not None:
            vec.update({n: v for n, v in start.items() if n in space})
        return vec

    best_vec: dict | None = None
    best_score: float | None = None
    for r in range(max(1, restarts)):
        if ev.evals >= budget:
            break
        cur = start_vector(r)
        cur_score = ev(cur, best_score)
        if cur_score is None:
            continue
        if best_score is None or ev.better(cur_score, best_score):
            best_vec, best_score = dict(cur), cur_score
        moved = True
        while moved and ev.evals < budget:
            moved = False
            for name, spec in space.items():
                if ev.evals >= budget:
                    break
                for cand in spec.neighbors(cur[name]):
                    if ev.evals >= budget:
                        break
                    trial = dict(cur)
                    trial[name] = cand
                    s = ev(trial, best_score)
                    if s is not None and ev.better(s, cur_score):
                        cur, cur_score = trial, s
                        moved = True
                        if ev.better(s, best_score):
                            best_vec, best_score = dict(trial), s
    out = {"best": best_vec, "best_score": best_score,
           "objective": objective, "signature": signature,
           "evals": ev.evals, "pruned": ev.pruned, "trials": ev.trials,
           "failed": ev.failed}
    if persist and best_vec is not None and best_score is not None \
            and math.isfinite(best_score):
        db.note(signature, best_vec, best_score, objective=objective,
                source="search")
        if ambient_tag:
            db.note(ambient_signature(ambient_tag), best_vec, best_score,
                    objective=objective, source="search")
        out["db_path"] = db.path
    return out

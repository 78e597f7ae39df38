"""``python -m parsec_tpu_torch.tune --self-test``: the budgeted search
must find the basin of a synthetic quadratic objective within its trial
budget, the winner must round-trip through the tuning DB, and the
ambient consult must hand it back filtered to the declared space.  Port
of ``parsec_tpu/tune/__main__.py``."""

from __future__ import annotations

import os
import sys
import tempfile


def self_test() -> int:
    from ..core.params import params
    from ..prof import perfdb  # noqa: F401 — registers perfdb_path
    from . import ambient_signature, apply_ambient
    from .db import TuneDB
    from .search import declared_space, search

    # a private 2-D knob space: one registered numeric knob, one
    # enumerated — the search must navigate both kinds
    params.register("tune_selftest_x", 32,
                    "tune self-test knob (synthetic)")
    params.declare_knob("tune_selftest_x", lo=1, hi=256, scale="log2")
    params.register("tune_selftest_mode", "slow",
                    "tune self-test knob (synthetic)")
    params.declare_knob("tune_selftest_mode", values=("slow", "fast"))
    space = declared_space(["tune_selftest_x", "tune_selftest_mode"])

    calls = {"n": 0}

    def objective(knobs: dict) -> float:
        # the scoped override IS the contract: the workload reads its
        # knobs through the params registry, like any real stage
        calls["n"] += 1
        x = params.get("tune_selftest_x")
        mode = params.get("tune_selftest_mode")
        import math
        return (math.log2(x) - 4.0) ** 2 + (5.0 if mode == "slow" else 0.0)

    with tempfile.TemporaryDirectory(prefix="tunedb_") as d:
        db = TuneDB(os.path.join(d, "tunedb.jsonl"))
        budget = 24
        # the trials' ledger stays in the temporary directory too
        with params.overrides({"perfdb_path":
                               os.path.join(d, "perfdb.jsonl")}):
            out = search(objective, signature="selftest:quadratic",
                         space=space, budget=budget, restarts=2,
                         objective="cost_s", seed=7, db=db,
                         ambient_tag="selftest")
        assert out["evals"] <= budget, out
        best = out["best"]
        assert best is not None, out
        # the basin: x=16 (log2=4), mode=fast, score 0
        assert best["tune_selftest_mode"] == "fast", out
        assert 8 <= best["tune_selftest_x"] <= 32, out
        assert out["best_score"] <= 1.0 + 1e-9, out
        # overrides restored after every trial: the live values are
        # untouched defaults
        assert params.get("tune_selftest_x") == 32
        assert params.get("tune_selftest_mode") == "slow"

        # DB round-trip: a FRESH store instance reads the winner back
        db2 = TuneDB(db.path)
        rec = db2.best("selftest:quadratic", objective="cost_s")
        assert rec is not None and rec["knobs"] == best, rec

        # ambient consult + apply: the persisted winner lands on the
        # registered params (filtered to the declared space)
        prev = str(params.get("tune_db_path") or "")
        params.set("tune_db_path", db.path)
        try:
            applied = apply_ambient("selftest")
        finally:
            params.set("tune_db_path", prev)
        assert applied == best, (applied, best)
        assert params.get("tune_selftest_mode") == "fast"
        params.set("tune_selftest_x", 32)       # restore
        params.set("tune_selftest_mode", "slow")
        assert db2.best(ambient_signature("selftest"),
                        objective="cost_s") is not None

    print(f"tune self-test: ok (quadratic basin found in {out['evals']} "
          f"trials of {budget}, {out['pruned']} pruned; DB round-trip + "
          f"ambient apply)")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-test" in argv:
        return self_test()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())

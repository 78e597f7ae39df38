"""The readings each limit is set from, each taken through a run of the
cell (:func:`portbench.harness.measure`): the program's, over many seeds,
and those of the reference put in the program's place, computed one
precision below the configuration's (the kind's ``CONTROLS``) or with a
fault planted (its ``FAULTS``).  A stand-in is computed once from the
run's seeded inputs, and each solve of the window returns it; the run's
own comparison then judges it, as it judges the program.

    python3 -m portbench.control --workload potrf16k.lowered --seeds 1 2 3

prints one JSON line a run: the seed, what stood in (``program`` or the
control's or fault's name), ``correct`` and each number compared beside
its limit.  ``--stand-ins`` names the seeds that also run the controls and
faults (all of them by default).  The benchmark's own runs do not run it;
``tests/test_portbench_control.py`` runs it at a small size on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness, spec


def stand_in_step(kind, cfg: dict, name: str):
    """A ``break_step`` for :func:`portbench.harness.measure` whose every
    solve returns the stand-in ``name`` of the run's inputs."""
    def brk(problem):
        out = kind.stand_in(cfg, problem, name)
        return lambda stores: {problem.output: out}
    return brk


def readings(bench: dict, cell_name: str, seed: int, device,
             seconds: float, cfg: dict | None = None,
             stand_ins: bool = True) -> list[dict]:
    """The program's run and, with ``stand_ins``, each control's and each
    fault's, on ``seed``: for each, ``correct`` and the checks."""
    cfg = cfg or spec.config(bench, spec.cell(bench, cell_name)["config"])
    kind = spec.kind(cfg["kind"])
    names = ["program"]
    if stand_ins:
        names += list(kind.CONTROLS) + list(kind.FAULTS)
    out = []
    for name in names:
        brk = None if name == "program" else stand_in_step(kind, cfg, name)
        role = ("program" if brk is None else
                "control" if name in kind.CONTROLS else "fault")
        try:
            res, lines = harness.measure(bench, cell_name, seed, seconds,
                                         False, device, time.perf_counter(),
                                         cfg=cfg, break_step=brk)
        except Exception as e:      # a stand-in that crashes has failed
            if brk is None:
                raise
            out.append({"seed": seed, "run": name, "role": role,
                        "correct": False, "crashed": repr(e)[:300]})
            continue
        out.append({"seed": seed, "run": name, "role": role,
                    "correct": res["correct"], "solves": res["attempted"],
                    "checks": res["checks"], "lines": lines})
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--stand-ins", type=int, nargs="*", default=None,
                    help="the seeds that also run the controls and faults")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = spec.load()
    for seed in args.seeds:
        full = args.stand_ins is None or seed in args.stand_ins
        for line in readings(bench, args.workload, seed,
                             torch.device("cuda", 0), args.seconds,
                             stand_ins=full):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""One solve of each benchmark cell, reduced to what must not change when
only the host side of the program changes, so two checkouts can be held
equal within one call on one card.  Needs an NVIDIA GPU::

    python3 scripts/solve_digest.py [--root DIR] [--seed N] [CELL ...]

``--root`` imports ``parsec_tpu_torch`` (and the benchmark harness)
from another checkout, say a parent commit unpacked into a git-ignored
directory.  Each cell (``BENCHMARK.json``'s, all by default) is built
from the seed by the harness's kinds and warmed up as a benchmark run
warms it; then one more solve on the same stores gives, on one JSON
line with the card's name and power limit: the SHA-256 of the result
store's bytes (the factor, or C), K1's launches in that solve by variant
and by form, the diagonal factor's launches by (operation, route), and
the lowering's plan and ``rows_moved``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _delta(after: dict, before: dict) -> dict:
    return {".".join(k) if isinstance(k, tuple) else k: v - before.get(k, 0)
            for k, v in after.items() if v != before.get(k, 0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("cells", nargs="*")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from parsec_tpu_torch.ops import factor
    from parsec_tpu_torch.ops.gemm import gemm_update
    from portbench import harness, loop, spec

    harness.set_cache_dirs()
    bench = spec.load()
    device = torch.device("cuda", 0)
    for name in args.cells or [w["name"] for w in bench["workloads"]]:
        cfg = spec.config(bench, spec.cell(bench, name)["config"])
        traffic = spec.traffic(spec.cell(bench, name)["traffic"])
        problem = spec.kind(cfg["kind"]).build(cfg, args.seed, device)
        loop.run(problem, device, solves=traffic["warmup_solves"])
        loop.synchronize(device)
        counts = (gemm_update.launches_by_variant,
                  gemm_update.launches_by_form, factor.launches_by_route)
        before = [dict(c) for c in counts]
        out = problem.result(problem.step(problem.stores))
        loop.synchronize(device)
        by_variant, by_form, by_route = (_delta(dict(c), b)
                                         for c, b in zip(counts, before))
        digest = hashlib.sha256(
            out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        print(json.dumps({
            "cell": name, "root": str(Path(args.root).resolve()),
            "seed": args.seed, "sha256": digest.hexdigest(),
            "shape": list(out.shape), "dtype": str(out.dtype),
            "k1_launches_by_variant": by_variant,
            "k1_launches_by_form": by_form,
            "factor_launches_by_route": by_route,
            "plan": problem.plan,
            "rows_moved": problem.lowered.rows_moved,
            "card": harness.card_info()}), flush=True)
        problem.release()
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

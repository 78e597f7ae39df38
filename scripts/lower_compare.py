#!/usr/bin/env python3
"""``lower_taskpool``'s host time for one checkout, so two checkouts can
be timed in turns within one call::

    python3 scripts/lower_compare.py [--root DIR]

``--root`` imports ``parsec_tpu_torch`` from another checkout (say, a
parent commit unpacked into a git-ignored directory).  Two pools, each
lowered four times from freshly built pools: the headline GEMM (N=16384,
nb=512, bf16 A/B, fp32 C; the chain-collapse pass, dense) and the
Cholesky of ``chip_smoke.py``'s ``lowered_cholesky`` phase (n=16384,
nb=512; the wavefront pass).  Where the checkout has the lowering cache
(the ``lowering_cache`` param), the four run with the cache off, on (a
miss), on (a hit) and off again, and the line says which each was; else
all four run as the checkout lowers.  It prints one JSON line of
seconds, with the card's name and power limit (the work is the host's,
but ``lower_taskpool`` lowers onto the card).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    # this checkout's helpers first (they import the package only when
    # called), then the package of the checkout under test
    sys.path.insert(0, str(HERE))
    import chip_smoke
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import parsec_tpu_torch
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
    from parsec_tpu_torch.ptg import lowering

    try:
        params.get("lowering_cache")
        modes = ("off", "miss", "hit", "off")
    except KeyError:
        modes = ("plain",) * 4

    n, nb = 16384, 512
    g = torch.Generator(device="cuda").manual_seed(600)
    a_host = torch.randn(n, n, device="cuda", generator=g).bfloat16().cpu()
    b_host = torch.randn(n, n, device="cuda", generator=g).bfloat16().cpu()
    _a, chol = chip_smoke._factor_input("cholesky", n, nb)

    def gemm_pool():
        return tiled_gemm_ptg(TiledMatrix.from_dense("A", a_host, nb, nb),
                              TiledMatrix.from_dense("B", b_host, nb, nb),
                              TiledMatrix("C", n, n, nb, nb,
                                          dtype=torch.float32))

    def chol_pool():
        return chip_smoke._factor_ptg("cholesky", chol)

    out: dict = {}
    for name, build in (("gemm", gemm_pool), ("cholesky", chol_pool)):
        if modes[0] != "plain":
            lowering.lowering_cache.clear()
        runs = []
        for mode in modes:
            tp = build()                  # off the clock
            if mode != "plain":
                params.set("lowering_cache", mode != "off")
            t0 = time.perf_counter()
            low = lowering.lower_taskpool(tp)
            runs.append({"mode": mode, "lower_s": time.perf_counter() - t0,
                         "pass": low.mode})
        if modes[0] != "plain":
            params.set("lowering_cache", True)
            hit = runs[2]
            hit["cache"] = [lowering.lowering_cache.hits,
                            lowering.lowering_cache.misses]
        out[name] = runs
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        card = None
    print(json.dumps({"root": args.root, "package": parsec_tpu_torch.__file__,
                      "lowerings": out, "host_cpu": chip_smoke._host_cpu(),
                      "host_cpus": len(os.sched_getaffinity(0)),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

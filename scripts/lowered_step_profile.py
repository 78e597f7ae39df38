#!/usr/bin/env python3
"""Host profile of one lowered taskpool step of the PyTorch/CUDA port.

Lowers the 1-D stencil at ``chip_smoke.py``'s configuration (n = 2^24,
mb = 2^18, R = 4, 64 iterations) onto the card, warms it, prints the
host enqueue time and the synchronized wall of three steps, then the
functions that took the most host time over three steps under
``cProfile``.  Needs an NVIDIA GPU::

    python3 scripts/lowered_step_profile.py [--top 25]

The step is a Python loop over levels that enqueues a few PyTorch ops and
one K3 launch per group; when the enqueue time matches the wall, the host
bounds the step.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this profile is of the card's step",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic
    from parsec_tpu_torch.models.stencil import stencil_1d_ptg
    from parsec_tpu_torch.ptg.lowering import lower_taskpool

    n, mb, R, T = 1 << 24, 1 << 18, 4, 64
    base = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    V = VectorTwoDimCyclic("V", lm=n, mb=mb,
                           init_fn=lambda m, s: base[m * mb:m * mb + s])
    low = lower_taskpool(stencil_1d_ptg(V, np.full(2 * R + 1, 1 / 9), T))
    st = low.initial_stores()
    for _ in range(3):
        low.step_fn(st)
    torch.cuda.synchronize()
    for _ in range(3):
        t0 = time.perf_counter()
        low.step_fn(st)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"step: enqueue {1e3 * (t1 - t0):.2f} ms, "
              f"wall {1e3 * (t2 - t0):.2f} ms")
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(3):
        low.step_fn(st)
    torch.cuda.synchronize()
    prof.disable()
    pstats.Stats(prof).sort_stats("tottime").print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""K3 (the 1-D stencil kernel) alone on the card, and the lowered 1-D
stencil's step split by device operation, through the entry points every
version of it has, so two checkouts can be timed in turns within one call
on one card.  Needs an NVIDIA GPU::

    python3 scripts/k3_compare.py [--root DIR]

``--root`` imports ``parsec_tpu_torch`` from another checkout (say, a
parent commit unpacked into a git-ignored directory); the inputs, the
timers and the tracer are this checkout's ``chip_smoke.py``'s.

It prints one JSON line a shape, then one a lowered step:

- the padded entry ``stencil1d(padded, w)`` at the lowered stencils'
  group shapes (62, 16, 15 and 1 rows of 2^18 + 8 fp32, and 62 in bf16):
  the CUDA-event time over a run of calls (``ms``), the kernel's own
  device time under ``torch.profiler`` (``kernel_ms``), ``conv1d`` on the
  same rows (``library_ms``) and the byte bound;
- where the checkout has it, the rows entry ``stencil1d_rows`` at one
  rank's level (64 rows of a 64-row store, -1 at the two edges, fp32 and
  bf16) and at a mesh rank's level (16 rows of a 48-row local tensor,
  the ghosts from scattered receive rows), the same numbers, on
  ``chip_smoke.py``'s inputs;
- the lowered stencil's step (n = 2^24, mb = 2^18, R = 4, 64 levels, one
  rank; then 8 levels over a 4-rank ``DeviceMesh`` on the one card): its
  wall, K3's launches, and a warmed step's device time by operation name
  (``chip_smoke.py``'s ``_traced_step``), summed into K3, the
  concatenation, the index gathers and scatters, the copies and the
  rest.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
TAPS = 9
PADDED = [("[62, 262152] fp32", 62, "float32", 50),
          ("[16, 262152] fp32", 16, "float32", 50),
          ("[15, 262152] fp32", 15, "float32", 50),
          ("[1, 262152] fp32", 1, "float32", 200),
          ("[62, 262152] bf16", 62, "bfloat16", 50)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: K3 runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    # this checkout's measuring helpers first (they import the package
    # only when called), then the package of the checkout under test
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.root).resolve()))
    from parsec_tpu_torch.ops import stencil as ks
    card = cs._card()
    w = [1.0 / TAPS] * TAPS
    for i, (label, rows, dtype, iters) in enumerate(PADDED):
        g = torch.Generator(device="cuda").manual_seed(500 + i)
        p = torch.randn(rows, (1 << 18) + TAPS - 1, device="cuda",
                        generator=g).to(getattr(torch, dtype))
        _row(torch, cs, ks, card, args.root, "padded " + label,
             lambda: ks.stencil1d(p, w), lambda: ks.stencil1d_plain(p, w),
             p, iters)
    if hasattr(ks, "stencil1d_rows"):
        for label, _dtype, args_, iters in cs._stencil_rows_inputs(torch,
                                                                   510):
            _row(torch, cs, ks, card, args.root, label,
                 lambda: ks.stencil1d_rows(*args_, w),
                 lambda: ks.stencil1d_rows_plain(*args_, w),
                 cs._stencil_padded(torch, args_, (TAPS - 1) // 2), iters)
    _steps(torch, cs, ks, card, args.root)
    return 0


def _row(torch, cs, ks, card, root, label, fn, plain, padded,
         iters) -> None:
    import torch.nn.functional as F
    got = fn()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ms = cs._time_ms(torch, fn, iters)
    kernel_ms, sessions = cs._kernel_device_ms(
        torch, fn, iters, "stencil1d_kernel", ks.stencil1d)
    rows2 = padded.reshape(-1, 1, padded.shape[-1])
    wt = torch.full((1, 1, TAPS), 1.0 / TAPS, device="cuda",
                    dtype=padded.dtype)
    lib_ms = cs._time_ms(torch, lambda: F.conv1d(rows2, wt), iters)
    esize = padded.element_size()
    nbytes = (padded.numel() + got.numel()) * esize
    bound_ms, bound_by = cs._bound(2.0 * TAPS * got.numel(), nbytes,
                                   "float32")
    print(json.dumps(dict(
        card=card, root=root, shape=label, max_abs_err=err, ms=ms,
        kernel_ms=kernel_ms, kernel_ms_sessions=sessions,
        library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / kernel_ms,
        gbps=nbytes / kernel_ms / 1e6)), flush=True)
    del got, want, rows2
    torch.cuda.empty_cache()


# device operation names, summed by what they do in the stencil's step
KINDS = (("k3", ("stencil1d",)), ("cat", ("CatArray",)),
         ("index", ("index", "Index", "gather", "scatter")),
         ("copy", ("copy", "Memcpy", "Memset")),
         ("fill", ("fill", "zero")))


def _kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def _steps(torch, cs, ks, card, root) -> None:
    import numpy as np

    from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic
    from parsec_tpu_torch.models.stencil import stencil_1d_ptg
    from parsec_tpu_torch.ptg.lowering import DeviceMesh, lower_taskpool

    n, mb = 1 << 24, 1 << 18
    base = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    weights = np.full(TAPS, 1.0 / TAPS)
    for label, ranks, levels in (("one rank", 1, 64),
                                 ("4-rank mesh", 4, 8)):
        V = VectorTwoDimCyclic("V", lm=n, mb=mb, P=ranks,
                               init_fn=lambda m, s: base[m * mb:m * mb + s])
        tp = stencil_1d_ptg(V, weights, levels)
        low = (lower_taskpool(tp) if ranks == 1 else
               lower_taskpool(tp, mesh=DeviceMesh(["cuda:0"] * ranks)))
        st = low.initial_stores()
        step_s = cs._step_wall(torch, low.step_fn, st, reps=5)
        ks.stencil1d.launches = 0
        low.step_fn(st)
        torch.cuda.synchronize()
        launches = ks.stencil1d.launches
        traced = cs._traced_step(torch, low.step_fn, st, ks.stencil1d,
                                 "stencil1d_kernel")
        by_kind: dict[str, float] = {}
        for d in traced["device_ms_by_name"]:
            k = _kind(d["name"])
            by_kind[k] = by_kind.get(k, 0.0) + d["ms"]
        print(json.dumps(dict(
            card=card, root=root, step=label, levels=levels,
            step_ms=step_s * 1e3, k3_launches=launches,
            device_ms_by_kind=dict(sorted(by_kind.items())), **traced)),
            flush=True)
        del st, low, tp, V
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())

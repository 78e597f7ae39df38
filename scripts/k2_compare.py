#!/usr/bin/env python3
"""K2 (the ragged paged-attention page update) alone on the card, through
the entry points every version of it has, so two checkouts can be timed
in turns within one call on one card.  Needs an NVIDIA GPU::

    python3 scripts/k2_compare.py [--root DIR] [--kv-bytes N ...]

``--root`` imports ``parsec_tpu_torch`` from another checkout (say, a
parent commit unpacked into a git-ignored directory); the inputs and the
timers are this checkout's ``chip_smoke.py``'s.  ``--kv-bytes`` runs the
shapes once for each given budget of a block's staged K/V
(``ops/ragged_attention.py:_KV_SMEM_BYTES``, which sets the heads a
block), where the checkout has one.  At the serving path's shape (64
ToyLM pages (3,16,4,8) fp32) and at a Llama-2-7B head geometry (1024
pages (3,16,32,128), fp32 and bf16), the same inputs as ``chip_smoke.py``'s
K2 phase, it prints one JSON line a shape: the functional tile-list
entry's time (CUDA events over a run of calls) and host time (its
enqueue), the kernel's own device time (``torch.profiler`` device
events), the strided entry's time, and the largest difference from the
plain version.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SHAPES = [("ToyLM 64x(3,16,4,8) fp32", 64, 16, 4, 8, "float32", 200),
          ("Llama 1024x(3,16,32,128) fp32", 1024, 16, 32, 128, "float32", 20),
          ("Llama 1024x(3,16,32,128) bf16", 1024, 16, 32, 128, "bfloat16",
           20)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--kv-bytes", type=int, nargs="*", default=[None])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: K2 runs only on the card", file=sys.stderr)
        return 1
    # this checkout's measuring helpers first (they import the package
    # only when called), then the package of the checkout under test
    sys.path.insert(0, str(HERE))
    import chip_smoke
    sys.path.insert(0, str(Path(args.root).resolve()))
    from parsec_tpu_torch.ops import ragged_attention as ra
    card = chip_smoke._card()
    for kv_bytes in args.kv_bytes:
        if kv_bytes is not None:
            ra._KV_SMEM_BYTES = kv_bytes
            ra.plan.cache_clear()
        _shapes(torch, chip_smoke, ra, args.root, card)
    return 0


def _shapes(torch, cs, ra, root: str, card: str) -> None:
    for i, (label, batch, P, H, D, dtype, iters) in enumerate(SHAPES):
        qs, pages, accs, q3, page, acc, _ = cs._attn_inputs(
            torch, batch, P, H, D, 300 + min(i, 1))
        page = page.to(getattr(torch, dtype))
        pages = list(page.unbind(0))
        want = ra.attn_page_update_plain(q3, page, acc)
        got = torch.stack(ra.attn_page_update_tiles(qs, pages, accs))
        torch.cuda.synchronize()

        def tiles():
            return ra.attn_page_update_tiles(qs, pages, accs)

        plan = getattr(ra, "plan", None)
        print(json.dumps(dict(
            root=root, shape=label,
            kv_bytes=getattr(ra, "_KV_SMEM_BYTES", None),
            plan=plan(P, H, D, page.element_size()) if plan else None,
            tiles_ms=cs._time_ms(torch, tiles, iters),
            host_ms=cs._host_ms(torch, tiles, iters),
            kernel_ms=cs._kernel_device_ms(torch, tiles, iters,
                                           "ragged_attn_page_kernel"),
            strided_ms=cs._time_ms(torch, lambda: ra.attn_page_update(
                q3, page, acc), iters),
            max_abs_err=(got - want).abs().max().item(), card=card)))
        del q3, page, acc, qs, pages, accs, want, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())

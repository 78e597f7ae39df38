#!/usr/bin/env python3
"""K1's variants alone on the card: the build and the kernel phase of
``chip_smoke.py`` (each variant against its plain version at the GEMM
paths' shapes, with its time, the plain version's, ``torch.baddbmm``'s
and the bound), without the paths.  Needs an NVIDIA GPU::

    python3 scripts/k1_variants.py [--root DIR]

``--root`` runs the package and ``chip_smoke.py`` of another checkout
(say, a parent commit unpacked into a git-ignored directory), so two
versions can be timed in turns within one call on one card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: K1 runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke._card()
    print(f"card: {card}  root: {args.root}")
    chip_smoke.phase_build(card)
    chip_smoke.phase_kernel(card, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

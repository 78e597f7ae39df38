#!/usr/bin/env python3
"""Per-task dispatch of one checkout's runtime on this host, so two
checkouts can be timed in turns within one call::

    python3 scripts/dispatch_compare.py [--root DIR] [--reps N]

``--root`` imports ``parsec_tpu_torch`` from another checkout (say, a
parent commit unpacked into a git-ignored directory); the pool and the
timer are this checkout's ``chip_smoke.py``'s (phase ``dispatch``): the EP
pool of 50 lanes and 10,000 CTL-only tasks with empty bodies, drained by
the caller, median of ``--reps`` fresh pools; ``dispatch_us`` on the
compiled-DAG executor and ``dynamic_dispatch_us`` under each of the
eleven schedulers.  Where the checkout has PINS (``prof/pins.py``), the
line also carries ``pins_disabled_ns``, one disabled fire site.  Where
it has the flight recorder, ``flightrec_size`` is the ring size the runs
had (0: off); ``PARSEC_MCA_prof_flightrec_size=0`` turns it off.  It
prints one JSON line, with the card's name and power limit when
``nvidia-smi`` is there (the work is the host's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SCHEDULERS = ("lfq", "ap", "spq", "ip", "gd", "rnd", "ll", "llp", "pbq",
              "ltq", "lhq")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    # this checkout's measuring helpers first (they import the package
    # only when called), then the package of the checkout under test
    sys.path.insert(0, str(HERE))
    import chip_smoke
    sys.path.insert(0, str(Path(args.root).resolve()))
    import parsec_tpu_torch
    from parsec_tpu_torch.models.ep import ep_pool
    ntasks, nt = 10000, 50
    builder = ep_pool(nt, ntasks // nt)
    us, engaged = chip_smoke._drain_us(builder, ntasks, args.reps,
                                       compiled=True)
    dynamic = {name: chip_smoke._drain_us(builder, ntasks, args.reps,
                                          compiled=False,
                                          scheduler=name)[0]
               for name in SCHEDULERS}
    has_pins = (Path(parsec_tpu_torch.__file__).parent / "prof"
                / "pins.py").is_file()
    flightrec = sys.modules.get("parsec_tpu_torch.prof.flight_recorder")
    rec = getattr(flightrec, "recorder", None)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        card = None
    print(json.dumps({
        "root": args.root, "package": parsec_tpu_torch.__file__,
        "dispatch_us": us, "compiled": engaged,
        "dynamic_dispatch_us": dynamic,
        "dynamic_median_us": sorted(dynamic.values())[len(dynamic) // 2],
        "pins_disabled_ns": chip_smoke._pins_disabled_ns()
        if has_pins else None,
        "flightrec_size": rec.size if rec is not None else 0,
        "host_cpu": chip_smoke._host_cpu(),
        "host_cpus": len(os.sched_getaffinity(0)), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

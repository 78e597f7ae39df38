"""The lowering's data movement (``ptg/lowering.py``: its gathers,
scatters and clones): the profiler's device milliseconds a traced solve of
the operations whose names hold one of the patterns of
``movement_ms.json``, a list written from the names a traced run of the
lowered Cholesky showed."""

import json
from pathlib import Path

UNIT = "ms"
BETTER = "lower"
MOVES = "tflops"
PATTERNS = json.loads(
    (Path(__file__).with_suffix(".json")).read_text())["patterns"]


def read(run):
    t = run.trace
    if t is None or not t.solves:
        return None
    ns = sum(v for n, v in t.device_ns.items()
             if any(p in n for p in PATTERNS))
    return ns / 1e6 / t.solves if ns else None

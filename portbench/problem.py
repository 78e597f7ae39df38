"""What a kind builds: the program's lowered pool on its stores, and the
seeded inputs the reference is handed."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class Problem:
    """``step`` is the timed call (``LoweredTaskpool.step_fn``), run on
    ``stores``; ``output`` names the store each solve's result is read
    from.  ``inputs`` are the seeded tensors both sides are given;
    ``lowered`` is the program's lowered pool, held as its caller holds
    it.  ``lower_s`` is the seconds ``lower_taskpool`` took and
    ``stores_s`` those of ``initial_stores()`` and ``warm()`` (which
    loads, or builds, the kernel library).  ``plan`` holds the lowering's
    counts (mode, levels, groups) as the program reports them."""

    step: Callable[[dict], dict]
    stores: dict
    output: str
    inputs: dict[str, torch.Tensor]
    lowered: Any = None
    lower_s: float = 0.0
    stores_s: float = 0.0
    plan: dict = field(default_factory=dict)

    def result(self, out: dict) -> torch.Tensor:
        """The part of a solve's result that is kept and judged."""
        return out[self.output]

    def release(self) -> None:
        """Drop the program's state: the lowered pool and its stores."""
        self.step = None
        self.stores = {}
        self.lowered = None


def lowered_plan(low: Any) -> dict:
    """The lowering's counts as the program reports them."""
    return {"mode": low.mode, "levels": low.levels, "groups": low.groups,
            "layout": dict(low.layout)}

"""The traceable-kernel registry (the batched side of ``dyld=``).

Port of the registry half of ``parsec_tpu/ptg/lowering.py``
(``Traceable``, ``register_traceable``, ``find_traceable``): a task body
registered here as a batched torch function lets the device module run a
whole batch of same-class tasks as one call.  The taskpool lowering
itself (chain-collapse, wavefront, unrolled, regions, mesh SPMD and the
compile cache) is not ported yet; a later slice fills in the rest of this
module, and ``chain_combine`` is the seam it will use.
"""

from __future__ import annotations

import threading
from typing import Callable


class Traceable:
    """A batched incarnation of a task body.

    ``apply(*flow_lists)`` receives, for each non-CTL flow in flow order,
    the list of that flow's values over B tasks (same shapes and dtypes),
    and returns, for each writable flow, the list of its new values.  It
    is ONE call over the batch (for GEMM, one kernel launch), and every
    new value has storage of its own, so the tile cache frees a tile's
    memory when it evicts it.

    ``bilinear=True`` declares tile-matmul semantics ``acc' = acc + lhs @
    rhs`` (fp32 accumulate) over the class's two READ flows and its RW
    flow; ``chain_combine`` is left for the chain-collapse lowering.
    """

    __slots__ = ("apply", "bilinear", "chain_combine")

    def __init__(self, apply: Callable, bilinear: bool = False,
                 chain_combine: Callable | None = None) -> None:
        self.apply = apply
        self.bilinear = bilinear
        self.chain_combine = chain_combine


_lock = threading.Lock()
_traceables: dict[str, Traceable] = {}


def register_traceable(name: str, apply: Callable, *, bilinear: bool = False,
                       chain_combine: Callable | None = None) -> Traceable:
    t = Traceable(apply, bilinear=bilinear, chain_combine=chain_combine)
    with _lock:
        _traceables[name] = t
    return t


def find_traceable(name: str) -> Traceable | None:
    with _lock:
        return _traceables.get(name)

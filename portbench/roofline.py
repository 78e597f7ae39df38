"""Peaks, roofline arithmetic and the device's busy time: the yardstick's
arithmetic, kept here so that no change to the program can move it.

``PEAK_FLOPS`` and ``PEAK_BYTES_PER_S`` are NVIDIA's published dense rates
for one H100 SXM at its full 700 W (data sheet; no sparsity).
:func:`least_time` is the larger of the operation and byte bounds, and
:func:`device_busy` the union of device intervals, both as ``chip_smoke.py``
has them (``_bound``, ``_device_busy``), copied rather than imported.
"""

from __future__ import annotations

import math

PEAK_FLOPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def least_time(flops: float, nbytes: float, peak: str) -> tuple[float, str]:
    """The least seconds the card could take for ``flops`` operations at
    the ``peak`` rate and ``nbytes`` of device memory traffic, and which of
    the two bounds it (``"operations"`` or ``"bytes"``)."""
    t_ops = flops / PEAK_FLOPS[peak]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def device_busy(spans) -> int:
    """Nanoseconds in which at least one of ``spans`` (``(start, end)``
    pairs of device operations, in ns) ran: the union of the intervals."""
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(spans) -> list[tuple[int, int]]:
    """The gaps between the union's intervals, as ``(start, end)`` in ns."""
    gaps, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` by nearest rank: the
    smallest value with at least ``q`` percent of the values at or below
    it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]

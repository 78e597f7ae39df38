"""Log-bucketed, mergeable streaming histograms and the per-tenant SLO plane.

Port of ``parsec_tpu/prof/histogram.py``, the latency side of the
observability plane.  A :class:`LogHistogram` keeps counts in
geometrically spaced buckets (``bounds[i] = lo * growth**i``), so

- ``record`` is O(1): one ``log``, one index, one increment;
- a quantile is the geometric midpoint of its bucket, within a factor
  ``sqrt(growth)`` of the empirical quantile (about 9% at the default
  ``growth = 2**0.25``), whatever the distribution;
- ``merge`` is exact bucket-wise addition, associative and commutative,
  so per-rank or per-stage histograms combine without loss;
- ``to_dict``/``from_dict`` serialize the sparse bucket array in the
  JAX package's layout, so a dict written by one package is read by the
  other.

:class:`SLOPlane` is the per-tenant metrics surface over it: named
histograms keyed ``(tenant, metric)`` plus plain counters.  Every plane
registers itself in a weak module registry, so
:func:`~parsec_tpu_torch.prof.flight_recorder.runtime_report` (its
``slo`` block) and the live properties dictionary (namespace ``slo``,
:mod:`parsec_tpu_torch.prof.counters`) aggregate every live plane with
no wiring from their owners.  The bucket geometry, the names of the
summary keys and the serialized layouts are the JAX package's.

Left out: nothing of the module; the bench's partial flush that reads
:func:`serialized_planes` has no port yet.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Any, Iterable

DEFAULT_LO = 1e-3          # 1 µs, in ms units
DEFAULT_HI = 6e7           # ~16.6 h in ms — everything above is "overflow"
DEFAULT_GROWTH = 2 ** 0.25  # rel. quantile error ≤ 2**0.125 - 1 ≈ 9%


class LogHistogram:
    """Fixed-geometry log histogram.  Bucket 0 is the underflow bucket
    (values ≤ ``lo``), the last bucket the overflow; bucket ``i`` covers
    ``[lo * g**(i-1), lo * g**i)``.  ``record`` takes no lock — the
    serving completion listeners DO race here (whichever worker retires
    a pool records), and a preempted increment at worst drops a sample,
    never corrupts the array; readers tolerate ``count`` and the bucket
    sum diverging by a few samples (``quantile`` clamps its rank to the
    buckets actually present)."""

    __slots__ = ("lo", "growth", "nbuckets", "_lg", "counts", "count",
                 "total")

    def __init__(self, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 growth: float = DEFAULT_GROWTH,
                 nbuckets: int | None = None) -> None:
        if growth <= 1.0 or lo <= 0.0:
            raise ValueError("need growth > 1 and lo > 0")
        self.lo = float(lo)
        self.growth = float(growth)
        self._lg = math.log(growth)
        if nbuckets is None:
            nbuckets = int(math.ceil(math.log(hi / lo) / self._lg)) + 2
        self.nbuckets = nbuckets
        self.counts = [0] * nbuckets
        self.count = 0
        self.total = 0.0

    # -- record --------------------------------------------------------
    def record(self, v: float) -> None:
        if v <= self.lo:
            i = 0
        else:
            i = int(math.log(v / self.lo) / self._lg) + 1
            if i >= self.nbuckets:
                i = self.nbuckets - 1
        self.counts[i] += 1
        self.count += 1
        self.total += v

    # -- merge (exact, associative) ------------------------------------
    def _same_geometry(self, other: "LogHistogram") -> bool:
        return (self.lo == other.lo and self.growth == other.growth
                and self.nbuckets == other.nbuckets)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Bucket-wise add ``other`` into ``self`` (returns self)."""
        if not self._same_geometry(other):
            raise ValueError("cannot merge histograms of different "
                             "geometry (lo/growth/nbuckets)")
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c
        self.count += other.count
        self.total += other.total
        return self

    def copy(self) -> "LogHistogram":
        h = LogHistogram(self.lo, growth=self.growth,
                         nbuckets=self.nbuckets)
        h.counts = list(self.counts)
        h.count = self.count
        h.total = self.total
        return h

    # -- quantiles -----------------------------------------------------
    def _bucket_value(self, i: int) -> float:
        if i <= 0:
            return self.lo
        if i >= self.nbuckets - 1:
            return self.lo * self.growth ** (self.nbuckets - 2)
        # geometric midpoint of [lo*g^(i-1), lo*g^i)
        return self.lo * self.growth ** (i - 1) * math.sqrt(self.growth)

    def quantile(self, q: float) -> float:
        """The q-quantile's bucket midpoint (0 when empty).  Error bound:
        within a factor ``sqrt(growth)`` of the empirical quantile.  The
        rank is clamped to the bucket total: a lock-free ``record`` race
        can leave ``count`` a few samples ahead of the buckets, and an
        unclamped rank would fall through to the overflow midpoint."""
        if self.count == 0:
            return 0.0
        total = sum(self.counts)
        if total == 0:
            return 0.0
        rank = min(max(1, math.ceil(q * self.count)), total)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self._bucket_value(i)
        return self._bucket_value(self.nbuckets - 1)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    # -- serialization (the partial-flush form) ------------------------
    def to_dict(self) -> dict:
        return {"lo": self.lo, "growth": self.growth,
                "nbuckets": self.nbuckets, "count": self.count,
                "total": self.total,
                "counts": [[i, c] for i, c in enumerate(self.counts)
                           if c]}

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        h = cls(d["lo"], growth=d["growth"], nbuckets=d["nbuckets"])
        for i, c in d["counts"]:
            h.counts[i] = c
        h.count = d["count"]
        h.total = d["total"]
        return h


# ---------------------------------------------------------------------------
# the per-tenant SLO plane
# ---------------------------------------------------------------------------

_planes: "weakref.WeakSet[SLOPlane]" = weakref.WeakSet()
_planes_lock = threading.Lock()
_props_registered = False


def _register_props() -> None:
    """Lazily publish the aggregate as a live property (namespace
    ``slo``), so `props_stream` + ``prof/dashboard.py`` render per-tenant
    quantiles with zero owner wiring."""
    global _props_registered
    if _props_registered:
        return
    _props_registered = True
    from .counters import properties

    def flat() -> dict:
        out: dict[str, Any] = {}
        for tenant, d in merged_summary().items():
            for k, v in d.items():
                out[f"{tenant}.{k}"] = v
        return out

    properties.register("slo", "tenants", flat)


class SLOPlane:
    """Named per-tenant histograms + counters.  The lock guards only
    creation and counter bumps; ``observe`` on an existing histogram is
    the bare lock-free ``record``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: dict[tuple[str, str], LogHistogram] = {}
        self._counters: dict[tuple[str, str], int] = {}
        with _planes_lock:
            _planes.add(self)
        _register_props()

    def observe(self, tenant: str, metric: str, value: float) -> None:
        h = self._hists.get((tenant, metric))
        if h is None:
            with self._lock:
                h = self._hists.setdefault((tenant, metric),
                                           LogHistogram())
        h.record(value)

    def inc(self, tenant: str, counter: str, n: int = 1) -> None:
        with self._lock:
            self._counters[(tenant, counter)] = \
                self._counters.get((tenant, counter), 0) + n

    def hist(self, tenant: str, metric: str) -> LogHistogram | None:
        return self._hists.get((tenant, metric))

    def items(self) -> list[tuple[tuple[str, str], LogHistogram]]:
        with self._lock:
            return list(self._hists.items())

    def counters(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self._counters)

    def summary(self, quantiles: Iterable[float] = (0.5, 0.99)) -> dict:
        """``{tenant: {"<metric>_p50": v, "<metric>_p99": v,
        "<metric>_count": n, "<counter>": n}}`` — the block
        ``RuntimeServer.metrics()`` surfaces."""
        return _summarize(self.items(), list(self.counters().items()),
                          quantiles)

    def to_dict(self) -> dict:
        """Serialized bucket arrays (the ``_note_partial`` flush form):
        ``{tenant: {metric: hist.to_dict()}}`` plus ``_counters``."""
        return _serialize(self.items(), list(self.counters().items()))

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()
            self._counters.clear()


def _serialize(items, counters) -> dict:
    """The ONE statement of the serialized-plane shape — per-plane dumps
    (``SLOPlane.to_dict``) and the merged dump
    (:func:`serialized_planes`) must never diverge, or
    ``LogHistogram.from_dict`` round-trips break for one of them."""
    out: dict[str, Any] = {}
    for (tenant, metric), h in items:
        out.setdefault(tenant, {})[metric] = h.to_dict()
    ctr: dict[str, dict[str, int]] = {}
    for (tenant, name), n in counters:
        ctr.setdefault(tenant, {})[name] = n
    if ctr:
        out["_counters"] = ctr
    return out


def _summarize(items, counters, quantiles=(0.5, 0.99)) -> dict:
    out: dict[str, dict[str, Any]] = {}
    for (tenant, metric), h in items:
        d = out.setdefault(tenant, {})
        for q in quantiles:
            d[f"{metric}_p{int(q * 100)}"] = round(h.quantile(q), 3)
        d[f"{metric}_count"] = h.count
    for (tenant, name), n in counters:
        out.setdefault(tenant, {})[name] = n
    return out


def _merged() -> tuple[list, list]:
    """Union of every live plane: histograms merged bucket-wise per
    (tenant, metric), counters summed."""
    with _planes_lock:
        planes = list(_planes)
    hists: dict[tuple[str, str], LogHistogram] = {}
    counters: dict[tuple[str, str], int] = {}
    for p in planes:
        for key, h in p.items():
            acc = hists.get(key)
            if acc is None:
                hists[key] = h.copy()
            elif acc._same_geometry(h):
                acc.merge(h)
        for key, n in p.counters().items():
            counters[key] = counters.get(key, 0) + n
    return list(hists.items()), list(counters.items())


def merged_summary(quantiles: Iterable[float] = (0.5, 0.99)) -> dict:
    """Per-tenant quantile summary across every live plane — the ``slo``
    block of :func:`~parsec_tpu_torch.prof.flight_recorder.runtime_report`."""
    items, counters = _merged()
    return _summarize(items, counters, quantiles)


def serialized_planes() -> dict:
    """Serialized bucket arrays across every live plane — what
    a mid-run flush keeps (empty dict when no
    plane holds data)."""
    items, counters = _merged()
    return _serialize(items, counters)

"""Typed runtime parameters ("MCA params").

Port of ``parsec_tpu/core/params.py``: parameters are registered at point
of use with a type, default and help text, and resolved from the
environment (``PARSEC_MCA_<name>``) or else the registered default;
``set`` overrides either.  :class:`MCAParamValueError` names a param
whose value lies outside its legal set.

The knob layer is ported whole: a :class:`KnobSpec` declares a param's
tunable domain (``declare_knob``, at the param's point of registration),
``knob_space``/``knob_spec`` read the declared domain the autotuner
(:mod:`parsec_tpu_torch.tune`) may move, ``overrides`` applies one
trial's knob vector for a ``with`` block and restores each param's
``(value, source)`` after it, and ``snapshot``/``lookup`` read the
resolved vector and one param's record.

Left out of this copy: ``--mca`` command-line parsing, the param file
and ``dump``: nothing on the port's path reads them.  The registry is the
port's own; it shares the ``PARSEC_MCA_`` environment namespace with the
JAX package but no state.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator

_TYPES: dict[str, Callable[[str], Any]] = {
    "int": int,
    "float": float,
    "bool": lambda s: s.strip().lower() in ("1", "true", "yes", "on"),
    "string": str,
}


@dataclass
class Param:
    name: str
    type: str
    default: Any
    help: str = ""
    read_only: bool = False
    # where the current value came from: default/env/set
    source: str = "default"
    value: Any = None


@dataclass(frozen=True)
class KnobSpec:
    """The declared legal domain of ONE tunable param: what the autotuner
    may move and where.  A param without a spec is configuration, not a
    knob.  ``values`` enumerates a discrete domain; ``lo``/``hi`` bound a
    numeric one, stepped multiplicatively when ``scale == "log2"`` or
    additively by ``step`` otherwise."""

    name: str
    values: tuple = ()
    lo: float | None = None
    hi: float | None = None
    scale: str = "linear"           # "linear" | "log2"
    step: float = 1.0

    def neighbors(self, cur: Any) -> list:
        """The coordinate-descent moves from ``cur``: adjacent enumerated
        values, or the one-step up/down numeric moves, clamped to the
        declared bounds."""
        if self.values:
            vals = list(self.values)
            if cur not in vals:
                return vals
            i = vals.index(cur)
            return [vals[j] for j in (i - 1, i + 1) if 0 <= j < len(vals)]
        out = []
        for nxt in ((cur * 2, cur / 2) if self.scale == "log2"
                    else (cur + self.step, cur - self.step)):
            if self.lo is not None:
                nxt = max(nxt, self.lo)
            if self.hi is not None:
                nxt = min(nxt, self.hi)
            if isinstance(cur, int):
                nxt = int(round(nxt))
            if nxt != cur and nxt not in out:
                out.append(nxt)
        return out

    def contains(self, v: Any) -> bool:
        if self.values:
            return v in self.values
        return ((self.lo is None or v >= self.lo)
                and (self.hi is None or v <= self.hi))

    def sample(self, rng) -> Any:
        """One random restart point (``rng``: ``random.Random``)."""
        if self.values:
            return rng.choice(list(self.values))
        lo = self.lo if self.lo is not None else 1
        hi = self.hi if self.hi is not None else max(lo, 1) * 64
        if self.scale == "log2":
            v = 2.0 ** rng.uniform(math.log2(max(lo, 1e-9)), math.log2(hi))
        else:
            v = rng.uniform(lo, hi)
        return int(round(v)) if isinstance(lo, int) else v


class ParamRegistry:
    """Process-global registry of typed parameters."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._params: dict[str, Param] = {}
        self._knobs: dict[str, KnobSpec] = {}

    def register(self, name: str, default: Any, help: str = "",
                 type: str | None = None, read_only: bool = False) -> Param:
        if type is None:
            type = ("bool" if isinstance(default, bool)
                    else "int" if isinstance(default, int)
                    else "float" if isinstance(default, float)
                    else "string")
        with self._lock:
            p = self._params.get(name)
            if p is None:
                p = Param(name=name, type=type, default=default, help=help,
                          read_only=read_only)
                p.value, p.source = self._resolve(p)
                self._params[name] = p
            return p

    def _resolve(self, p: Param) -> tuple[Any, str]:
        env = os.environ.get(f"PARSEC_MCA_{p.name}")
        if env is not None:
            return _TYPES[p.type](env), "env"
        return p.default, "default"

    def lookup(self, name: str) -> Param | None:
        """The registered :class:`Param` (value and source) or None;
        never registers."""
        with self._lock:
            return self._params.get(name)

    def get(self, name: str, default: Any = None) -> Any:
        with self._lock:
            p = self._params.get(name)
            if p is None:
                if default is None:
                    raise KeyError(f"unregistered param: {name}")
                return default
            return p.value

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            p = self._params.get(name)
            if p is None:
                raise KeyError(f"unregistered param: {name}")
            if p.read_only:
                raise PermissionError(f"param {name} is read-only")
            p.value, p.source = _TYPES[p.type](str(value)), "set"

    # -- knob space (the autotuner's declared search domain) -----------------
    def declare_knob(self, name: str, values: tuple | list = (),
                     lo: float | None = None, hi: float | None = None,
                     scale: str = "linear", step: float = 1.0) -> KnobSpec:
        """Declare ``name`` tunable over the given domain.  The search and
        every persisted knob vector are confined to declared knobs, so a
        stale tuning DB can never set an undeclared param.  The first
        declaration of a name wins, as in :meth:`register`."""
        with self._lock:
            spec = self._knobs.get(name)
            if spec is None:
                spec = KnobSpec(name=name, values=tuple(values), lo=lo,
                                hi=hi, scale=scale, step=step)
                self._knobs[name] = spec
            return spec

    def knob_space(self) -> dict[str, KnobSpec]:
        with self._lock:
            return dict(self._knobs)

    def knob_spec(self, name: str) -> KnobSpec | None:
        with self._lock:
            return self._knobs.get(name)

    # -- scoped overrides (one trial's knob vector) --------------------------
    @contextlib.contextmanager
    def overrides(self, knobs: dict[str, Any]) -> Iterator[None]:
        """Apply ``knobs`` for the ``with`` block and restore each param's
        prior ``(value, source)`` on exit.  Unregistered names raise
        KeyError before anything is applied, so a failed vector never
        half-applies."""
        saved: dict[str, tuple[Any, str]] = {}
        with self._lock:
            missing = [n for n in knobs if n not in self._params]
            if missing:
                raise KeyError(f"unregistered param(s): {missing}")
            for name, value in knobs.items():
                p = self._params[name]
                if p.read_only:
                    raise PermissionError(f"param {name} is read-only")
                saved[name] = (p.value, p.source)
                p.value, p.source = _TYPES[p.type](str(value)), "set"
        try:
            yield
        finally:
            with self._lock:
                for name, (v, src) in saved.items():
                    p = self._params.get(name)
                    if p is not None:
                        p.value, p.source = v, src

    def snapshot(self) -> dict[str, Any]:
        """Every registered param's current scalar value, sorted by name:
        the knob vector a ledger entry or a tuning trial is keyed by."""
        with self._lock:
            return {name: p.value for name, p in sorted(self._params.items())
                    if isinstance(p.value, (bool, int, float, str))}


class MCAParamValueError(ValueError):
    """A param value outside its legal set, naming the param and the set."""

    def __init__(self, param: str, value: Any, allowed: tuple) -> None:
        super().__init__(f"{param}={value!r} is not one of {list(allowed)}")
        self.param = param
        self.value = value
        self.allowed = tuple(allowed)


params = ParamRegistry()

"""Live knob adaptation: a hysteresis EWMA controller over one knob.

Port of ``parsec_tpu/tune/adaptive.py``.  :class:`KnobController` folds
an observed signal into an EWMA per knob value, moves only past a
**hysteresis** margin (noise never flaps the knob) and re-tests a
neighbour on a bounded, **staggered** cadence once converged.  The
shipped user is per-tenant ``llm_steps_per_pool``: the batcher feeds
each tenant's inter-token latency (what lands in its SLO histogram) into
one controller per tenant and sizes that tenant's next decode superpool
by the controller's value.  The knob moves BATCHING, never tokens, so a
stream's output stays oracle-equal whatever the controller does.  A
converged controller writes its value back to the tuning DB
(``ambient:tenant:<t>``), where the next server's consult starts from
it.

:func:`steps_controller` staggers by ``abs(hash(tenant))``, which changes
from process to process (string hashing is salted): two controllers
compared across processes or packages take an explicit ``stagger``.

MCA knob: ``tune_adaptive`` (default off: an explicit
``llm_steps_per_pool`` stays authoritative unless the operator opts in).
Left out: the JAX module's empty runtimelint contract table; every
controller is single-owner (one tenant's batcher loop drives it).
"""

from __future__ import annotations

import math

from ..core.params import params as _params
from .db import TuneDB
from .signature import ambient_signature

_params.register("tune_adaptive", False,
                 "live per-tenant adaptation of llm_steps_per_pool from "
                 "the observed inter-token latency (tune/adaptive."
                 "KnobController): converged values persist to the "
                 "tuning DB.  Off by default: explicit "
                 "llm_steps_per_pool settings and sweeps stay "
                 "authoritative unless the operator opts in")

# controller cadence: how many observations one probe holds, and how
# many observations a converged knob waits before probing again
PROBE_LEN = 8
PROBE_EVERY = 64
# hysteresis: a probe must beat the incumbent EWMA by this relative
# margin to be adopted — flapping costs more than a slightly-suboptimal
# plateau (the spec drafter's 0.6/0.35 band, expressed relatively)
HYSTERESIS = 0.10
# consecutive garbage (non-finite / non-positive) observations before
# the controller abandons adaptation and falls back to the default —
# the garbage-drafter shape: a broken objective must cost a
# bounded number of probes, then leave the knob alone
GARBAGE_LIMIT = 8


class KnobController:
    """Hysteresis EWMA controller over one integer knob.

    ``observe(objective)`` folds one observation of the signal measured
    UNDER the current :attr:`value` and returns the value to apply next.
    Not thread-safe — each owner (one tenant's batcher loop) drives its
    own controller."""

    def __init__(self, name: str, default: int, lo: int, hi: int, *,
                 better: str = "lower", alpha: float = 0.3,
                 probe_every: int = PROBE_EVERY,
                 probe_len: int = PROBE_LEN, stagger: int = 0) -> None:
        self.name = name
        self.default = int(default)
        self.lo, self.hi = int(lo), int(hi)
        self.value = max(self.lo, min(self.hi, int(default)))
        self.better = better
        self.alpha = alpha
        self.probe_every = max(1, probe_every)
        self.probe_len = max(1, probe_len)
        self._ewma: dict[int, float] = {}
        self._incumbent = self.value
        self._probing: int | None = None
        self._probe_seen = 0
        # staggered: a fleet of controllers (one per tenant) offsets its
        # first probe so they never all probe on the same iteration
        self._since_probe = stagger % self.probe_every
        self._probe_dir = 1             # alternate up/down candidates
        self._garbage = 0
        self.dead = False               # garbage objective: adaptation off
        self.probes = 0
        self.adoptions = 0
        self._dirty = False             # converged movement not yet persisted

    # -- the fold --------------------------------------------------------
    def observe(self, objective: float) -> int:
        if self.dead:
            return self.value
        if not isinstance(objective, (int, float)) \
                or not math.isfinite(float(objective)) or objective <= 0.0:
            self._garbage += 1
            if self._garbage >= GARBAGE_LIMIT:
                # bounded fallback: stop moving, return to the default
                self.dead = True
                self.value = self.default
                self._probing = None
            return self.value
        self._garbage = 0
        x = float(objective)
        m = self._ewma.get(self.value)
        self._ewma[self.value] = x if m is None \
            else m + self.alpha * (x - m)
        if self._probing is not None:
            self._probe_seen += 1
            if self._probe_seen >= self.probe_len:
                self._settle_probe()
            return self.value
        self._since_probe += 1
        if self._since_probe >= self.probe_every:
            self._start_probe()
        return self.value

    # -- probes ----------------------------------------------------------
    def _candidate(self) -> int | None:
        for _ in range(2):              # try one direction, then the other
            c = (self._incumbent * 2 if self._probe_dir > 0
                 else self._incumbent // 2)
            self._probe_dir = -self._probe_dir
            c = max(self.lo, min(self.hi, c))
            if c != self._incumbent:
                return c
        return None

    def _start_probe(self) -> None:
        self._since_probe = 0
        cand = self._candidate()
        if cand is None:
            return
        self._probing = cand
        self._probe_seen = 0
        self.value = cand
        self.probes += 1

    def _settle_probe(self) -> None:
        cand = self._probing
        self._probing = None
        self._probe_seen = 0
        inc = self._ewma.get(self._incumbent)
        got = self._ewma.get(cand)
        adopt = False
        if inc is None:
            adopt = True
        elif got is not None:
            adopt = (got > inc * (1 + HYSTERESIS) if self.better == "higher"
                     else got < inc * (1 - HYSTERESIS))
        if adopt:
            self._incumbent = cand
            self.adoptions += 1
            self._dirty = True
        self.value = self._incumbent

    # -- state -----------------------------------------------------------
    @property
    def converged(self) -> bool:
        """Between probes at a settled incumbent (or dead): the value is
        stable enough to persist."""
        return self.dead or (self._probing is None
                             and self._incumbent in self._ewma)

    def take_writeback(self) -> int | None:
        """The converged value to persist, exactly once per adoption
        (``None`` = nothing new)."""
        if self._dirty and self.converged and self._probing is None:
            self._dirty = False
            return self._incumbent
        return None

    def ewma_of(self, value: int) -> float | None:
        return self._ewma.get(value)

    def stats(self) -> dict:
        return {"value": self.value, "incumbent": self._incumbent,
                "probes": self.probes, "adoptions": self.adoptions,
                "dead": self.dead}


def steps_controller(tenant: str, default: int, *, lo: int = 1,
                     hi: int = 32) -> KnobController:
    """The per-tenant ``llm_steps_per_pool`` controller the batcher
    creates lazily: objective = observed inter-token ms (lower better),
    stagger keyed off the tenant name so a fleet's probes interleave."""
    return KnobController("llm_steps_per_pool", default, lo, hi,
                          better="lower", stagger=abs(hash(tenant)))


def writeback(tenant: str, value: int, score: float, *,
              db: TuneDB | None = None) -> None:
    """Persist a converged per-tenant value under the tenant's ambient
    signature; best-effort (a read-only artifact dir must never fail
    the decode loop)."""
    try:
        (db or TuneDB()).note(ambient_signature(f"tenant:{tenant}"),
                              {"llm_steps_per_pool": int(value)},
                              float(score), objective="tok_latency_ms",
                              source="adaptive")
    except Exception:                   # noqa: BLE001 — advisory only
        pass

"""Fourcounter: distributed termination detection by counting waves.

Port of ``parsec_tpu/comm/termdet_fourcounter.py`` (the reference's
``parsec/mca/termdet/fourcounter``): local counters alone cannot end a
distributed taskpool, since a rank with no local task left may still have
a message flying toward it.  Mattern's four-counter (double-wave) method
circulates a token around the rank ring accumulating

- ``S``, the activation messages sent by all ranks,
- ``R``, the activation messages received (counted at delivery),
- ``idle``, every rank locally idle (no task, no pending action).

Rank 0 concludes termination when a wave returns all idle with ``S == R``
and the same pair as the wave before it (no traffic between two
consecutive snapshots); a TERMINATE token then goes around the ring and
every rank fires its pool's termination.  A rank that is busy when the
token arrives holds it until it goes idle.  Tokens ride the reserved
:data:`~parsec_tpu_torch.comm.engine.AM_TAG_TERMDET` tag.

Importing :mod:`parsec_tpu_torch.comm` registers the detector as
``fourcounter`` (``termdet=fourcounter``).
Nothing of the original is left out.
"""

from __future__ import annotations

from typing import Any

from ..runtime.termdet import (STATE_BUSY, STATE_IDLE, STATE_TERMINATED,
                               TermDetMonitor, register_termdet)


class FourCounterTermDet(TermDetMonitor):
    """Per-taskpool monitor; one instance per rank, linked over the ring."""

    name = "fourcounter"

    def __init__(self, context: Any) -> None:
        super().__init__()
        self.ctx = context
        self.msgs_sent = 0
        self.msgs_recv = 0
        self._held_tokens: list[dict] = []
        self._kick_wave = False
        # rank 0 only: the previous wave's snapshot and a single wave out
        # at a time (overlapping waves break the consecutive-snapshot rule)
        self._prev_wave: tuple[int, int] | None = None
        self._wave_out = False

    @property
    def _engine(self):
        return self.ctx.comm_engine

    def _comm_id(self) -> int:
        return self.taskpool.comm_id

    def on_comm_sent(self) -> None:
        with self._lock:
            self.msgs_sent += 1

    def on_comm_recv(self) -> None:
        with self._lock:
            self.msgs_recv += 1

    # -- state machine --------------------------------------------------------
    # going idle never terminates here: it releases a wave instead
    def _check_idle_locked(self) -> bool:
        if self.ctx is None or self.ctx.nb_ranks <= 1:
            return super()._check_idle_locked()
        if (self.state == STATE_BUSY and self.nb_tasks == 0
                and self.nb_pending_actions == 0):
            self.state = STATE_IDLE
            self._kick_wave = True
        elif self.state == STATE_IDLE and (self.nb_tasks > 0
                                           or self.nb_pending_actions > 0):
            self.state = STATE_BUSY
        return False

    # the mutators flush wave work once their lock is released
    def taskpool_addto_nb_tasks(self, delta: int) -> int:
        n = super().taskpool_addto_nb_tasks(delta)
        self._flush_wave_work()
        return n

    def taskpool_addto_nb_pa(self, delta: int) -> int:
        n = super().taskpool_addto_nb_pa(delta)
        self._flush_wave_work()
        return n

    def ready(self) -> None:
        super().ready()
        self._flush_wave_work()

    def _flush_wave_work(self) -> None:
        if self.ctx is None or self.ctx.nb_ranks <= 1:
            return
        if not self._kick_wave:   # unlocked fast path: the flag is set
            return                # under the lock by the mutator that ran
        tokens: list[dict] = []
        start = False
        with self._lock:
            if self.state != STATE_IDLE or not self._kick_wave:
                return
            self._kick_wave = False
            if self._held_tokens:
                tokens, self._held_tokens = self._held_tokens, []
            elif self.ctx.my_rank == 0 and not self._wave_out:
                self._wave_out = True
                start = True
        for token in tokens:
            self._contribute_and_forward(token)
        if start:
            self._start_wave()

    # -- waves ----------------------------------------------------------------
    def _start_wave(self) -> None:
        self._contribute_and_forward({"tp": self._comm_id(), "kind": "wave",
                                      "S": 0, "R": 0, "idle": True})

    def _contribute_and_forward(self, token: dict) -> None:
        with self._lock:
            token["S"] += self.msgs_sent
            token["R"] += self.msgs_recv
            token["idle"] = token["idle"] and self.state == STATE_IDLE
        nxt = (self.ctx.my_rank + 1) % self.ctx.nb_ranks
        self._engine.send_termdet(nxt, token)

    def on_token(self, token: dict) -> None:
        """A wave or terminate token arrived for this taskpool."""
        if token["kind"] == "term":
            self._ring_terminate()
            return
        if self.ctx.my_rank == 0:
            self._conclude_wave(token)
            return
        with self._lock:
            if self.state != STATE_IDLE:
                self._held_tokens.append(token)   # until the counters drain
                return
        self._contribute_and_forward(token)

    def _conclude_wave(self, token: dict) -> None:
        with self._lock:
            self._wave_out = False
            my_idle = self.state == STATE_IDLE
        snap = (token["S"], token["R"])
        if (token["idle"] and my_idle and token["S"] == token["R"]
                and self._prev_wave == snap):
            self._ring_terminate()
            return
        self._prev_wave = snap
        with self._lock:
            if my_idle and not self._wave_out:
                self._wave_out = True
            else:
                self._kick_wave = True    # re-kick when next idle
                return
        self._start_wave()

    def _ring_terminate(self) -> None:
        nxt = (self.ctx.my_rank + 1) % self.ctx.nb_ranks
        if nxt != 0:
            self._engine.send_termdet(nxt, {"tp": self._comm_id(),
                                            "kind": "term"})
        fire = False
        with self._lock:
            if self.state != STATE_TERMINATED:
                self.state = STATE_TERMINATED
                fire = True
        if fire:
            self._terminate()


register_termdet("fourcounter", FourCounterTermDet)

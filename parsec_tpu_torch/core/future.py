"""Futures: completion promises with chained callbacks.

Port of ``parsec_tpu/core/future.py`` (the reference's ``parsec_future.h``
and ``parsec_datacopy_future.c``): the promise behind the serving layer's
tickets and the lazy conversion behind typed-edge reshape
(:mod:`parsec_tpu_torch.data.reshape`).

- :class:`Future`: single assignment, with ``on_ready`` callbacks (one
  registered after completion fires at once, on the caller's thread);
- :class:`CountableFuture`: completes after ``count`` contributions,
  folded by ``combine``;
- :class:`DataCopyFuture`: computed by its ``convert`` on the first thread
  that asks for it (the enable callback), optionally after a ``parent``
  future, so conversions chain (nested futures).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

# status flags, as in parsec_future.h
FUTURE_STATUS_NASCENT = 0
FUTURE_STATUS_INIT = 1 << 0
FUTURE_STATUS_TRIGGERED = 1 << 1
FUTURE_STATUS_COMPLETED = 1 << 2


class Future:
    """A single-assignment future with completion callbacks."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._status = FUTURE_STATUS_NASCENT
        self._value: Any = None
        self._callbacks: list[Callable[["Future"], None]] = []

    @property
    def status(self) -> int:
        return self._status

    def is_ready(self) -> bool:
        return bool(self._status & FUTURE_STATUS_COMPLETED)

    def on_ready(self, cb: Callable[["Future"], None]) -> None:
        """Register a callback; it fires at once when already complete."""
        with self._cond:
            if not self.is_ready():
                self._callbacks.append(cb)
                return
        cb(self)

    def set(self, value: Any) -> None:
        with self._cond:
            if self.is_ready():
                raise RuntimeError("future already completed")
            self._value = value
            self._status |= FUTURE_STATUS_COMPLETED
            cbs, self._callbacks = self._callbacks, []
            self._cond.notify_all()
        for cb in cbs:
            cb(self)

    def get(self, timeout: float | None = None) -> Any:
        """Block until completed and return the value."""
        with self._cond:
            if not self._cond.wait_for(self.is_ready, timeout):
                raise TimeoutError("future not completed")
            return self._value


class CountableFuture(Future):
    """Completes after ``count`` :meth:`contribute` calls; the values fold
    through ``combine`` (the first one when there is none)."""

    def __init__(self, count: int,
                 combine: Callable[[Any, Any], Any] | None = None) -> None:
        super().__init__()
        if count <= 0:
            raise ValueError("count must be positive")
        self._remaining = count
        self._combine = combine
        self._acc: Any = None
        self._first = True

    def contribute(self, value: Any = None) -> None:
        with self._cond:
            if self._remaining <= 0:
                raise RuntimeError("countable future already satisfied")
            if self._first:
                self._acc, self._first = value, False
            elif self._combine is not None:
                self._acc = self._combine(self._acc, value)
            self._remaining -= 1
            done = self._remaining == 0
        if done:
            self.set(self._acc)


class DataCopyFuture(Future):
    """A future resolved by ``convert(parent value)`` (``convert(None)``
    with no parent) on the first thread that asks for it: N consumers of
    one future share one conversion, and a chain of nested futures
    resolves parent first."""

    def __init__(self, parent: Future | None = None,
                 convert: Callable[[Any], Any] | None = None) -> None:
        super().__init__()
        self._parent = parent
        self._convert = convert
        self._trigger_lock = threading.Lock()

    def trigger(self) -> None:
        """Run the conversion chain once, on this thread."""
        with self._trigger_lock:
            if self.is_ready():
                return
            src = self._parent.get() if self._parent is not None else None
            value = self._convert(src) if self._convert is not None else src
            with self._cond:
                self._status |= FUTURE_STATUS_TRIGGERED
            self.set(value)

    def get(self, timeout: float | None = None) -> Any:
        # the getter materializes when the chain can resolve from here
        if not self.is_ready() and (
                self._parent is None or _chain_resolvable(self._parent)):
            self.trigger()
        return super().get(timeout)


def _chain_resolvable(f: Future) -> bool:
    if f.is_ready():
        return True
    if isinstance(f, DataCopyFuture):
        return f._parent is None or _chain_resolvable(f._parent)
    return False

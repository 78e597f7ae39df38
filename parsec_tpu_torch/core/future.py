"""Futures: single-assignment completion promises.

Port of :class:`Future` and :class:`DataCopyFuture` from
``parsec_tpu/core/future.py`` (the reference's ``parsec_future.h`` and
``parsec_datacopy_future.c``): the promise behind the serving layer's
tickets, and the lazy conversion behind typed-edge reshape
(:mod:`parsec_tpu_torch.data.reshape`).  Left out: completion callbacks
(``on_ready``, which no ticket uses), ``CountableFuture`` and the nested
(parent-chained) form of ``DataCopyFuture``, which no reshape builds.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class Future:
    """A single-assignment future."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._ready = False
        self._value: Any = None

    def is_ready(self) -> bool:
        return self._ready

    def set(self, value: Any) -> None:
        with self._cond:
            if self._ready:
                raise RuntimeError("future already completed")
            self._value = value
            self._ready = True
            self._cond.notify_all()

    def get(self, timeout: float | None = None) -> Any:
        """Block until completed and return the value."""
        with self._cond:
            if not self._cond.wait_for(self.is_ready, timeout):
                raise TimeoutError("future not completed")
            return self._value


class DataCopyFuture(Future):
    """A future whose value is computed by ``convert(None)`` on the first
    thread that asks for it (the datacopy future's enable callback): N
    consumers of one future share one conversion."""

    def __init__(self, convert: Callable[[Any], Any] | None = None) -> None:
        super().__init__()
        self._convert = convert
        self._trigger_lock = threading.Lock()

    def trigger(self) -> None:
        """Run the conversion once, on this thread."""
        with self._trigger_lock:
            if self.is_ready():
                return
            self.set(self._convert(None) if self._convert is not None
                     else None)

    def get(self, timeout: float | None = None) -> Any:
        if not self.is_ready():
            self.trigger()
        return super().get(timeout)

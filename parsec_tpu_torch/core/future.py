"""Futures: single-assignment completion promises.

Port of :class:`Future` from ``parsec_tpu/core/future.py`` (the
reference's ``parsec_future.h``), the promise behind the serving
layer's tickets.  Left out: completion callbacks (``on_ready``, which no
ticket uses), ``CountableFuture`` and ``DataCopyFuture`` (the reshape
system's nested futures).
"""

from __future__ import annotations

import threading
from typing import Any


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

"""Exponential backoff for idle drivers (cf. ``utils/backoff.h``).

Port of ``parsec_tpu/core/backoff.py``; nothing is left out.
"""

from __future__ import annotations

import time


class Backoff:
    def __init__(self, base_ns: int = 1_000, max_ns: int = 2_000_000) -> None:
        self.base_ns = base_ns
        self.max_ns = max_ns
        self._cur_ns = 0

    def reset(self) -> None:
        self._cur_ns = 0

    def wait(self) -> None:
        if self._cur_ns == 0:
            self._cur_ns = self.base_ns
            return  # first miss: just yield
        time.sleep(self._cur_ns / 1e9)
        self._cur_ns = min(self._cur_ns * 2, self.max_ns)

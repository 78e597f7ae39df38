"""Bounded per-stream ready queues that spill to a parent store.

Port of ``parsec_tpu/core/hbbuffer.py`` (the reference's
``class/hbbuffer``): :class:`StealDeque`, the lock-free-common-path
queue of the LFQ scheduler, and :class:`HBBuffer`, the locked buffer of
the PBQ/LTQ/LHQ schedulers.  Nothing of the original is left out.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable


class StealDeque:
    """Bounded per-stream deque that spills to a parent store when full.

    Ownership discipline: exactly ONE thread (the owning stream's worker)
    pops locally; any thread may push; thieves pop the other end.  CPython
    deque operations are each a single C call and therefore atomic under
    the GIL, so the common path is lock-free:

    - owner pop = ``deque.pop()`` (newest end — LIFO locality),
    - push      = ``deque.extend()``,
    - steal     = ``deque.popleft()`` under ``_steal_lock``.

    The moment any pushed task carries a nonzero priority the queue flips
    (one-way) into priority mode, where the owner's pop is a locked
    best-priority scan: the scan's index arithmetic is only safe when
    thieves cannot shift the left end.  The capacity check is advisory
    (concurrent pushers may briefly overshoot): capacity bounds locality,
    not correctness.
    """

    __slots__ = ("capacity", "_parent_push", "_dq", "_steal_lock", "_prio")

    def __init__(self, capacity: int,
                 parent_push: Callable[[list[Any], int], None]) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._parent_push = parent_push
        self._dq: deque = deque()
        self._steal_lock = threading.Lock()
        self._prio = False

    def __len__(self) -> int:
        return len(self._dq)

    def push_all(self, items: list[Any], distance: int = 0) -> None:
        dq = self._dq
        if not self._prio and any(t.priority for t in items):
            self._prio = True
        room = self.capacity - len(dq)
        if room >= len(items):
            dq.extend(items)
            return
        if room > 0:
            dq.extend(items[:room])
            items = items[room:]
        self._parent_push(list(items), distance + 1)

    def try_pop_best(self, priority: Callable[[Any], float] | None = None
                     ) -> Any | None:
        if priority is None or not self._prio:
            try:
                return self._dq.pop()
            except IndexError:
                return None
        with self._steal_lock:
            dq = self._dq
            n = len(dq)
            if not n:
                return None
            best_i = max(range(n), key=lambda i: priority(dq[i]))
            t = dq[best_i]
            del dq[best_i]
            return t

    def steal(self) -> Any | None:
        """Victim-side pop from the *oldest* end."""
        with self._steal_lock:
            try:
                return self._dq.popleft()
            except IndexError:
                return None


class HBBuffer:
    """Fixed-capacity task buffer: pushes that do not fit spill their
    tail to ``parent_push``; the owner pops the newest item or the best
    by priority, thieves the oldest.  Every operation holds ``_lock``."""

    def __init__(self, capacity: int,
                 parent_push: Callable[[list[Any], int], None]) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._parent_push = parent_push
        self._items: list[Any] = []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._items)

    def push_all(self, items: list[Any], distance: int = 0) -> None:
        """Keep the head of ``items`` as far as room allows; spill the
        rest to the parent one distance further out."""
        overflow: list[Any] = []
        with self._lock:
            room = self.capacity - len(self._items)
            if room >= len(items):
                self._items.extend(items)
            else:
                if room > 0:
                    self._items.extend(items[:room])
                overflow = items[max(room, 0):]
        if overflow:
            self._parent_push(overflow, distance + 1)

    def try_pop_best(self, priority: Callable[[Any], float] | None = None
                     ) -> Any | None:
        with self._lock:
            if not self._items:
                return None
            if priority is None:
                return self._items.pop()
            best_i = max(range(len(self._items)),
                         key=lambda i: priority(self._items[i]))
            return self._items.pop(best_i)

    def steal(self) -> Any | None:
        """Victim-side pop from the oldest end."""
        with self._lock:
            if not self._items:
                return None
            return self._items.pop(0)

"""Object pools with per-thread freelists.

Port of ``parsec_tpu/core/mempool.py`` (the reference's
``class/mempool.{h,c}``): each thread allocates from a freelist of its
own (:meth:`Mempool.thread_pool`), and an element carries its owner
(``_mempool_owner``) so that any thread can return it to the list it came
from.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class ThreadMempool:
    """One thread's freelist (``parsec_thread_mempool_t``)."""

    __slots__ = ("parent", "_free")

    def __init__(self, parent: "Mempool") -> None:
        self.parent = parent
        self._free: list[Any] = []

    def allocate(self) -> Any:
        obj = self._free.pop() if self._free else self.parent.factory()
        try:        # the owner, so that any thread can return it
            obj._mempool_owner = self
        except AttributeError:
            pass
        return obj

    def free(self, obj: Any) -> None:
        if self.parent.reset is not None:
            self.parent.reset(obj)
        self._free.append(obj)


class Mempool:
    """A pool of identical objects (``factory()``, cleared by ``reset``
    on the way back) with a freelist a thread; :meth:`free` routes an
    element to its owner's list."""

    def __init__(self, factory: Callable[[], Any],
                 reset: Callable[[Any], None] | None = None) -> None:
        self.factory = factory
        self.reset = reset
        self._tls = threading.local()
        self._all: list[ThreadMempool] = []
        self._lock = threading.Lock()

    def thread_pool(self) -> ThreadMempool:
        tp = getattr(self._tls, "pool", None)
        if tp is None:
            tp = ThreadMempool(self)
            self._tls.pool = tp
            with self._lock:
                self._all.append(tp)
        return tp

    def allocate(self) -> Any:
        return self.thread_pool().allocate()

    def free(self, obj: Any) -> None:
        owner = getattr(obj, "_mempool_owner", None)
        if owner is not None and owner.parent is self:
            owner.free(obj)
        else:
            self.thread_pool().free(obj)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"thread_pools": len(self._all),
                    "free_elements": sum(len(tp._free) for tp in self._all)}

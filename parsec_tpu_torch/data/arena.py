"""Arenas: bounded freelist allocators for temporary tiles and wire bytes.

Port of ``parsec_tpu/data/arena.py`` (the reference's ``arena.{c,h}``):
an :class:`Arena` hands out data copies of one tile type with a bounded
cache of released buffers (``max_used`` caps live allocations,
``max_released`` the freelist), and marks each copy's ``arena_chunk`` so
it can go back; here the buffers are host tensors.  :class:`BufferPool`
recycles the socket fabric's wire scratch (frame metadata, the discard
sink of duplicate fragments) by power-of-two size class, and
:data:`wire_pool` is the process's one pool.
:class:`ArenaDatatypeRegistry` maps an id to an arena (the DTD
arena-datatype table).
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from .data import Data, DataCopy
from .datatype import TileType

# the runtime lint's contract (analysis/runtimelint.py)
_LOCK_PROTECTED = {
    "Arena._free": "_lock",
    "Arena._used": "_lock",
    "BufferPool._free": "_lock",
    "BufferPool.hits": "_lock",
    "BufferPool.misses": "_lock",
    "ArenaDatatypeRegistry._by_id": "_lock",
}


class Arena:
    def __init__(self, dtt: TileType, max_used: int = 0,
                 max_released: int = 64) -> None:
        self.dtt = dtt
        self.max_used = max_used          # 0 = unbounded
        self.max_released = max_released
        self._free: list[torch.Tensor] = []
        self._used = 0
        self._lock = threading.Lock()

    def get_copy(self, device_index: int = 0,
                 original: Data | None = None) -> DataCopy:
        """A tile-backed copy from the freelist or fresh
        (``parsec_arena_get_copy``)."""
        with self._lock:
            if self.max_used and self._used >= self.max_used:
                raise MemoryError(
                    f"arena {self.dtt}: max_used={self.max_used} reached")
            buf = self._free.pop() if self._free else None
            self._used += 1
        if buf is None:
            buf = torch.empty(self.dtt.shape, dtype=self.dtt.dtype)
        d = original if original is not None else Data(
            nb_elts=self.dtt.nbytes)
        copy = DataCopy(d, device_index, value=buf, dtt=self.dtt)
        copy.arena_chunk = self
        d.attach_copy(copy)
        return copy

    def release_copy(self, copy: DataCopy) -> None:
        buf = copy.value
        copy.value = None
        copy.arena_chunk = None
        with self._lock:
            self._used -= 1
            if isinstance(buf, torch.Tensor) \
                    and len(self._free) < self.max_released:
                self._free.append(buf)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"used": self._used, "cached": len(self._free)}


class BufferPool:
    """Power-of-two byte-buffer freelist for the wire receive path.

    ``acquire(n)`` returns a length-``n`` writable memoryview over a
    pooled bytearray (at least 256 bytes); ``release(mv)`` returns the
    buffer to its class.  Each class keeps at most ``max_per_class``
    buffers, and a buffer above ``max_pooled_bytes`` is never kept (a
    one-off 64 MiB frame must not stay resident)."""

    def __init__(self, max_per_class: int = 8,
                 max_pooled_bytes: int = 16 << 20) -> None:
        self.max_per_class = max_per_class
        self.max_pooled_bytes = max_pooled_bytes
        self._free: dict[int, list[bytearray]] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _cls(n: int) -> int:
        return max(1 << (int(n) - 1).bit_length(), 256)

    def acquire(self, n: int) -> memoryview:
        if n == 0:
            return memoryview(b"")
        size = self._cls(n)
        with self._lock:
            lst = self._free.get(size)
            buf = lst.pop() if lst else None
            if buf is None:
                self.misses += 1
            else:
                self.hits += 1
        if buf is None:
            buf = bytearray(size)
        return memoryview(buf)[:n]

    def release(self, mv: memoryview) -> None:
        buf = mv.obj
        mv.release()
        if not isinstance(buf, bytearray) or len(buf) > self.max_pooled_bytes:
            return
        with self._lock:
            lst = self._free.setdefault(len(buf), [])
            if len(lst) < self.max_per_class:
                lst.append(buf)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"classes": len(self._free),
                    "cached": sum(len(v) for v in self._free.values()),
                    "hits": self.hits, "misses": self.misses}


#: the process's pool for wire frame scratch (comm/socket_fabric.py)
wire_pool = BufferPool()


class ArenaDatatypeRegistry:
    """Id -> arena of a tile type (``insert_function.h``'s table)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_id: dict[Any, Arena] = {}

    def register(self, key: Any, dtt: TileType, **kw) -> Arena:
        with self._lock:
            a = self._by_id.get(key)
            if a is None:
                a = Arena(dtt, **kw)
                self._by_id[key] = a
            return a

    def get(self, key: Any) -> Arena:
        with self._lock:
            return self._by_id[key]

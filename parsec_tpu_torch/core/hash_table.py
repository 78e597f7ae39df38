"""Striped-lock concurrent hash table.

Port of ``parsec_tpu/core/hash_table.py`` (the reference's
``parsec_hash_table``): CPython dicts are thread-safe for single
operations, but the runtime needs compound atomic ones — ``find_or_insert``
for the dep table and data repos, ``remove`` returning the element, and
bucket-locked read-modify-write sections — hence lock striping.
Nothing of the original is left out.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Hashable, Iterator

_NSTRIPES = 64


class ConcurrentHashTable:
    def __init__(self, nstripes: int = _NSTRIPES) -> None:
        self._stripes = [threading.RLock() for _ in range(nstripes)]
        self._maps: list[dict[Hashable, Any]] = [{} for _ in range(nstripes)]

    def _stripe(self, key: Hashable) -> int:
        return hash(key) % len(self._stripes)

    def get(self, key: Hashable, default: Any = None) -> Any:
        i = self._stripe(key)
        with self._stripes[i]:
            return self._maps[i].get(key, default)

    def insert(self, key: Hashable, value: Any) -> None:
        i = self._stripe(key)
        with self._stripes[i]:
            self._maps[i][key] = value

    def find_or_insert(self, key: Hashable, factory: Callable[[], Any]) -> Any:
        """Atomic get-or-create (cf. ``parsec_hash_find_deps``)."""
        i = self._stripe(key)
        with self._stripes[i]:
            m = self._maps[i]
            v = m.get(key)
            if v is None:
                v = m[key] = factory()
            return v

    def remove(self, key: Hashable) -> Any | None:
        i = self._stripe(key)
        with self._stripes[i]:
            return self._maps[i].pop(key, None)

    def locked(self, key: Hashable):
        """Context manager holding the bucket lock for ``key``."""
        return self._stripes[self._stripe(key)]

    def __len__(self) -> int:
        return sum(len(m) for m in self._maps)

    def __contains__(self, key: Hashable) -> bool:
        i = self._stripe(key)
        with self._stripes[i]:
            return key in self._maps[i]

    def items(self) -> Iterator[tuple[Hashable, Any]]:
        for i, m in enumerate(self._maps):
            with self._stripes[i]:
                yield from list(m.items())

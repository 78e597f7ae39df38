"""Data collection interface: the distribution vtable.

Port of ``parsec_tpu/data_dist/collection.py`` (the reference's
``parsec_data_collection_t``): a collection maps logical keys to the
owning rank (``rank_of``), the master :class:`Data` (``data_of``) and a
virtual-process hint (``vpid_of``).  :class:`DictCollection` is the
host-dict-backed collection the LLM pools keep their side tiles in.
:func:`enumerate_keys` lists a collection's keys for the taskpool
lowering.  Left out: ``key_to_string`` and ``open_key_space`` (no ported
taskpool writes fresh keys into a lowered dict collection).
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable

import torch

from ..data.data import Data, data_create
from ..data.datatype import TileType, to_tensor


class DataCollection:
    """Abstract distribution (cf. the ``parsec_data_collection_t`` vtable)."""

    def __init__(self, name: str = "", nodes: int = 1, myrank: int = 0) -> None:
        self.name = name
        self.nodes = nodes
        self.myrank = myrank
        self.default_dtt: TileType | None = None

    def rank_of(self, *key) -> int:
        raise NotImplementedError

    def data_of(self, *key) -> Data:
        raise NotImplementedError

    def vpid_of(self, *key) -> int:
        return 0

    def has_key(self, *key) -> bool:
        return True


class DictCollection(DataCollection):
    """Host-dict-backed collection: every key owned by ``rank_of_fn``
    (default rank 0), data created lazily from ``init_fn(*key)`` (a
    tensor or array-like) or as zeros of ``dtt``.  ``keys`` optionally
    declares the key space up front (still lazily materialized);
    ``has_key`` then answers from it.
    """

    def __init__(self, name: str = "dict", dtt: TileType | None = None,
                 init_fn: Callable | None = None,
                 keys: Iterable[tuple] | None = None,
                 rank_of_fn: Callable | None = None) -> None:
        super().__init__(name)
        self.default_dtt = dtt
        self._init_fn = init_fn
        self._rank_of_fn = rank_of_fn
        # the declared key space, in declaration order (the lowering lays
        # its store rows out in this order)
        self._key_list = None if keys is None else list(dict.fromkeys(
            tuple(k) for k in keys))
        self._keys = None if keys is None else frozenset(self._key_list)
        self._store: dict[tuple, Data] = {}
        self._lock = threading.Lock()

    def rank_of(self, *key) -> int:
        return 0 if self._rank_of_fn is None else self._rank_of_fn(*key)

    def data_of(self, *key) -> Data:
        with self._lock:
            d = self._store.get(key)
            if d is None:
                if self._init_fn is not None:
                    value = to_tensor(self._init_fn(*key))
                elif self.default_dtt is not None:
                    value = torch.zeros(self.default_dtt.shape,
                                        dtype=self.default_dtt.dtype)
                else:
                    raise KeyError(f"{self.name}: no data and no init for "
                                   f"{key}")
                d = data_create(value, key=(self.name,) + key,
                                dtt=self.default_dtt, dc=self)
                self._store[key] = d
            return d

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return tuple(key) in self._store

    def has_key(self, *key) -> bool:
        """A declared key space is closed; an undeclared one is open
        (keys materialize on first touch)."""
        return self._keys is None or tuple(key) in self._keys

    def discard(self, *key) -> bool:
        """Drop a materialized key (serving retirement: a long-lived
        store must not grow by every sequence it ever served).  A
        declared key stays legal and re-materializes on next touch."""
        with self._lock:
            return self._store.pop(tuple(key), None) is not None

    def known_keys(self) -> list[tuple]:
        """The declared key space (in declaration order) if one was
        given, else the keys materialized so far."""
        if self._key_list is not None:
            return list(self._key_list)
        with self._lock:
            return sorted(self._store, key=repr)


def enumerate_keys(dc: DataCollection) -> list[tuple]:
    """Every key of a collection with an enumerable key space: tiled grids
    (``mt``/``nt``), 1-D segmented vectors (``mt``), or a dict
    collection's known keys.  What the taskpool lowering lays its store
    rows out by."""
    if hasattr(dc, "mt") and hasattr(dc, "nt"):
        has = getattr(dc, "has_tile", lambda m, n: True)
        return [(m, n) for m in range(dc.mt) for n in range(dc.nt)
                if has(m, n)]
    if hasattr(dc, "mt"):
        return [(m,) for m in range(dc.mt)]
    if isinstance(dc, DictCollection):
        return dc.known_keys()   # [] for an empty collection, not an error
    raise TypeError(f"cannot enumerate keys of {type(dc).__name__} "
                    f"{dc.name!r}")

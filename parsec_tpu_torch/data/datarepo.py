"""Data repositories: produced-output stash with consumer-count GC.

Port of ``parsec_tpu/data/datarepo.py`` (the reference's ``datarepo``):
one repo per task class; an entry stores the data copies a task produced,
keyed by the task's key, and lives until all its consumers have retrieved
them.  The producer seals the entry with a usage limit; each consumer
``consume``s once; the entry retires when consumed == limit.  Nothing of
the original is left out.
"""

from __future__ import annotations

import threading
from typing import Any

from ..core.hash_table import ConcurrentHashTable


class DataRepoEntry:
    __slots__ = ("key", "data", "_usage_limit", "_usage", "_sealed", "_lock",
                 "_repo")

    def __init__(self, repo: "DataRepo", key: Any, nflows: int) -> None:
        self._repo = repo
        self.key = key
        self.data: list[Any] = [None] * nflows
        self._usage_limit = 0
        self._usage = 0
        self._sealed = False
        self._lock = threading.Lock()

    def set_output(self, flow_index: int, copy: Any) -> None:
        self.data[flow_index] = copy

    def addto_usage_limit(self, n: int) -> None:
        """Producer side: declare n more expected consumptions."""
        with self._lock:
            self._usage_limit += n
            self._sealed = True
            retire = self._usage >= self._usage_limit
        if retire:
            self._repo._retire(self)

    def consume(self, flow_index: int) -> Any:
        """Consumer side: fetch flow data and count one usage."""
        copy = self.data[flow_index]
        with self._lock:
            self._usage += 1
            retire = self._sealed and self._usage >= self._usage_limit
        if retire:
            self._repo._retire(self)
        return copy


class DataRepo:
    """Per-task-class repository."""

    def __init__(self, nflows: int, name: str = "") -> None:
        self.nflows = nflows
        self.name = name
        self._table = ConcurrentHashTable()

    def lookup_and_create(self, key: Any) -> DataRepoEntry:
        return self._table.find_or_insert(
            key, lambda: DataRepoEntry(self, key, self.nflows))

    def lookup(self, key: Any) -> DataRepoEntry | None:
        return self._table.get(key)

    def _retire(self, entry: DataRepoEntry) -> None:
        self._table.remove(entry.key)

    def __len__(self) -> int:
        return len(self._table)

"""Data substrate: master data, device copies, repos, tile types."""

from .data import (ACCESS_NONE, ACCESS_READ, ACCESS_RW, ACCESS_WRITE,
                   COHERENCY_EXCLUSIVE, COHERENCY_INVALID, COHERENCY_OWNED,
                   COHERENCY_SHARED, Data, DataCopy, data_create)
from .datarepo import DataRepo, DataRepoEntry
from .datatype import TileType

__all__ = [
    "ACCESS_NONE", "ACCESS_READ", "ACCESS_RW", "ACCESS_WRITE",
    "COHERENCY_EXCLUSIVE", "COHERENCY_INVALID", "COHERENCY_OWNED",
    "COHERENCY_SHARED", "Data", "DataCopy", "DataRepo", "DataRepoEntry",
    "TileType", "data_create",
]

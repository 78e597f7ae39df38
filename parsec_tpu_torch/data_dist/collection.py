"""Data collection interface: the distribution vtable.

Port of ``parsec_tpu/data_dist/collection.py`` (the reference's
``parsec_data_collection_t``): a collection maps logical keys to the
owning rank (``rank_of``), the master :class:`Data` (``data_of``) and a
virtual-process hint (``vpid_of``).  Left out: ``DictCollection`` and
``enumerate_keys`` (used by operators and the lowering, not ported yet).
"""

from __future__ import annotations

from ..data.data import Data
from ..data.datatype import TileType


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

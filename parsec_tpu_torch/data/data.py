"""Master data + per-device versioned copies (coherency substrate).

Port of ``parsec_tpu/data/data.py`` (the reference's ``parsec_data_t`` /
``parsec_data_copy_t``): a master datum {key, owner_device, device_copies}
with per-device copies {device_index, coherency, readers, version,
value, dtt}.  A copy's value is a ``torch.Tensor``: on the CPU for device
0, on the card for a CUDA device.  Coherency follows the reference's
MOESI-like protocol (INVALID / OWNED / EXCLUSIVE / SHARED) and versions
decide staleness at stage-in.

Left out: arena chunks, reshape futures and the paranoid write-back mark
of the JAX copy — nothing on the port's path sets them.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any

import torch

from .datatype import TileType

COHERENCY_INVALID = 0
COHERENCY_OWNED = 1
COHERENCY_EXCLUSIVE = 2
COHERENCY_SHARED = 3

ACCESS_NONE = 0x0
ACCESS_READ = 0x1
ACCESS_WRITE = 0x2
ACCESS_RW = ACCESS_READ | ACCESS_WRITE

_data_keys = itertools.count()


def nbytes_of(value: Any) -> int:
    """Bytes held by a tile value (0 for none)."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return 0


class DataCopy:
    """One device's copy of a datum (cf. ``parsec_data_copy_t``)."""

    __slots__ = ("original", "device_index", "coherency", "readers",
                 "version", "value", "dtt")

    def __init__(self, original: "Data", device_index: int,
                 value: Any = None, dtt: TileType | None = None) -> None:
        self.original = original
        self.device_index = device_index
        self.coherency = (COHERENCY_INVALID if value is None
                          else COHERENCY_SHARED)
        self.readers = 0
        self.version = 0
        self.value = value
        self.dtt = dtt

    def __repr__(self) -> str:
        return (f"<DataCopy key={self.original.key} dev={self.device_index} "
                f"v{self.version} coh={self.coherency}>")


class Data:
    """Master record for one datum (cf. ``parsec_data_t``)."""

    def __init__(self, key: Any = None, dc: Any = None,
                 nb_elts: int = 0) -> None:
        self.key = key if key is not None else next(_data_keys)
        self.dc = dc
        self.nb_elts = nb_elts
        self.owner_device = 0
        self.device_copies: dict[int, DataCopy] = {}
        self._lock = threading.RLock()

    def get_copy(self, device_index: int = 0) -> DataCopy | None:
        with self._lock:
            return self.device_copies.get(device_index)

    def attach_copy(self, copy: DataCopy) -> DataCopy:
        with self._lock:
            self.device_copies[copy.device_index] = copy
            return copy

    def detach_copy(self, device_index: int) -> DataCopy | None:
        with self._lock:
            return self.device_copies.pop(device_index, None)

    def newest_copy(self) -> DataCopy | None:
        """The highest-version valid copy on any device."""
        with self._lock:
            best = None
            for c in self.device_copies.values():
                if c.coherency == COHERENCY_INVALID:
                    continue
                if best is None or c.version > best.version:
                    best = c
            return best


def data_create(value: Any, device_index: int = 0, key: Any = None,
                dtt: TileType | None = None, dc: Any = None) -> Data:
    """Create a master datum with an initial copy (``parsec_data_create``)."""
    d = Data(key=key, dc=dc, nb_elts=nbytes_of(value))
    if value is not None:
        c = DataCopy(d, device_index, value=value, dtt=dtt)
        c.coherency = COHERENCY_EXCLUSIVE
        c.version = 1
        d.attach_copy(c)
        d.owner_device = device_index
    return d


def scratch_copy(dtt: TileType) -> DataCopy:
    """A fresh zeroed host tile of the declared type (WRITE-only and NEW
    flows)."""
    return data_create(torch.zeros(dtt.shape, dtype=dtt.dtype),
                       dtt=dtt).get_copy(0)

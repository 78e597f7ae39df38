"""Tile type descriptors, and the numpy <-> tensor crossing.

Port of ``parsec_tpu/data/datatype.py``: a logical tile type is a shape
and an element dtype (here a ``torch.dtype``).  :func:`wire_slice_key`
names the partial-tile view a remote edge ships (its ``wire=`` slices),
hashable for grouping and the activation message; :class:`WireRegion` is
the JDF ``[type_remote = LR, displ_remote = ...]`` form of such a view.
:func:`convert` is the typed-edge reshape's conversion (shape and dtype).
A tile type also carries a layout tag (``TileType.layout``, default
``row_major``): same-shape types of other layouts are told apart, and
:func:`convert` relays a tile through the converters of
:func:`register_layout` (to the canonical row-major form and back).

Added: :func:`to_tensor` / :func:`to_numpy`, the one place tiles cross
between numpy and torch.  bf16 host tiles of the JAX package are
``ml_dtypes`` arrays that ``torch.from_numpy`` rejects, so they cross as
their 16-bit pattern (``.view(np.int16)`` then ``.view(torch.bfloat16)``)
and come back the same way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


def torch_dtype(dtype: Any) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype, or the
    ``ml_dtypes`` bfloat16 numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    nd = np.dtype(dtype)
    if nd.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=nd)).dtype


def to_tensor(value: Any) -> torch.Tensor:
    """A host array or tensor as a CPU tensor, sharing memory with a numpy
    input where torch allows it."""
    if isinstance(value, torch.Tensor):
        return value
    a = np.asarray(value)
    if not a.flags.writeable:
        a = a.copy()   # torch.from_numpy wants memory it may write
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a host numpy array; bf16 comes back as an
    ``ml_dtypes.bfloat16`` array, the JAX package's host tile type."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # only bf16 tiles need it
        return t.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return t.numpy()


@dataclass(frozen=True)
class TileType:
    """A logical tile datatype: shape, element dtype and layout tag."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    layout: str = "row_major"

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * torch.empty(0, dtype=torch_dtype(self.dtype)).element_size()


@dataclass(frozen=True)
class WireRegion:
    """A partial-tile wire datatype for remote edges (the reference's
    ``parsec_add2arena_rect`` types picked per dep by ``[type_remote = LR,
    displ_remote = ...]``): an edge tagged with a region ships ``rows x
    cols`` elements of the tile, and the remote consumer receives that
    block as a buffer of its own; local edges share the whole tile.

    The displacement is a byte offset into the tile in column-major
    order, as in the reference, so ``sizeof_datatype*mb*R`` works as
    written: for a row-major ``(mb, nb)`` tile an offset of
    ``itemsize*mb*c0`` selects ``tile[0:rows, c0:c0+cols]``.  The JAX
    package's slices leave the row range open (``tile[:, ...]``); here
    both ranges are closed, the same cut of an ``mb == rows`` tile, so
    commcheck can size the view (it sizes an open range as the whole
    tile)."""

    rows: int
    cols: int
    itemsize: int = 4

    def slices(self, displ_bytes: int = 0) -> tuple:
        elems = displ_bytes // self.itemsize
        if elems % self.rows:
            raise ValueError(
                f"displ_remote {displ_bytes}B is not column-aligned for a "
                f"{self.rows}-row region (itemsize {self.itemsize})")
        c0 = elems // self.rows
        return (slice(0, self.rows), slice(c0, c0 + self.cols))

    @property
    def nbytes(self) -> int:
        return self.rows * self.cols * self.itemsize


# layout tag -> (to_canonical, from_canonical): tensor -> tensor functions
_layout_converters: dict[str, tuple] = {
    "row_major": (lambda x: x, lambda x: x),
}


def register_layout(tag: str, to_canonical, from_canonical) -> None:
    """Declare a layout: ``to_canonical`` takes a tile of that layout to
    row-major, ``from_canonical`` back."""
    _layout_converters[tag] = (to_canonical, from_canonical)


def convert(value: torch.Tensor, src: TileType,
            dst: TileType) -> torch.Tensor:
    """A tile of type ``src`` as type ``dst``: out of ``src``'s layout, a
    reshape of the same element count and a dtype cast, then into
    ``dst``'s layout, on the tile's own device (no implicit resize)."""
    if src.layout != "row_major":
        value = _layout_converters[src.layout][0](value)
    if tuple(src.shape) != tuple(dst.shape):
        if math.prod(src.shape) != math.prod(dst.shape):
            raise ValueError(f"cannot reshape {src.shape} -> {dst.shape}")
        value = value.reshape(dst.shape)
    if torch_dtype(src.dtype) != torch_dtype(dst.dtype):
        value = value.to(torch_dtype(dst.dtype))
    if dst.layout != "row_major":
        value = _layout_converters[dst.layout][1](value)
    return value


def wire_slice_key(slices: tuple | None) -> tuple | None:
    """Hashable identity of a wire view (grouping + message metadata)."""
    if slices is None:
        return None
    return tuple((s.start, s.stop, s.step) if isinstance(s, slice) else s
                 for s in slices)

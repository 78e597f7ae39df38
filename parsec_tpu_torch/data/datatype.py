"""Tile type descriptors, and the numpy <-> tensor crossing.

Port of ``parsec_tpu/data/datatype.py``: a logical tile type is a shape
and an element dtype (here a ``torch.dtype``).  Left out: layout tags and
``convert`` (reshape beyond identity), and the partial-tile
``WireRegion`` of remote edges — the port has no comm layer yet.

Added: :func:`to_tensor` / :func:`to_numpy`, the one place tiles cross
between numpy and torch.  bf16 host tiles of the JAX package are
``ml_dtypes`` arrays that ``torch.from_numpy`` rejects, so they cross as
their 16-bit pattern (``.view(np.int16)`` then ``.view(torch.bfloat16)``)
and come back the same way.
"""

from __future__ import annotations

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
    """A logical tile datatype: shape and element dtype."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * torch.empty(0, dtype=self.dtype).element_size()

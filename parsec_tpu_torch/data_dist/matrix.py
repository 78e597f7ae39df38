"""Tiled-matrix descriptor.

Port of :class:`TiledMatrix` from ``parsec_tpu/data_dist/matrix.py`` (the
reference's ``parsec_tiled_matrix_t``): tile sizes mb x nb over an
lm x ln matrix, mt x nt tiles, ragged edge tiles.  Tiles are CPU
``torch.Tensor`` values created lazily on first touch; the device module
stages them onto the card.

Left out: the block-cyclic, symmetric, band, tabular, vector, sub-tile
and hash distributions — the port runs on one rank, and no ported model
needs them yet.

:meth:`TiledMatrix.from_numpy_tiles` / :meth:`to_numpy_tiles` carry the
JAX package's ``{(i, j): np.ndarray}`` host tiles across, so both
packages run on the same bytes (bf16 through its 16-bit pattern, see
:mod:`parsec_tpu_torch.data.datatype`).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import numpy as np
import torch

from ..data.data import Data, data_create
from ..data.datatype import TileType, to_numpy, to_tensor, torch_dtype
from .collection import DataCollection


class TiledMatrix(DataCollection):
    """Tiled matrix on one rank; keys are tile coordinates ``(m, n)``.

    ``init_fn(m, n, shape)`` returns a tile (tensor or array-like); tiles
    without one start as zeros.
    """

    def __init__(self, name: str, lm: int, ln: int, mb: int, nb: int,
                 dtype: Any = torch.float32,
                 init_fn: Callable | None = None) -> None:
        super().__init__(name)
        self.lm, self.ln = lm, ln
        self.mb, self.nb = mb, nb
        self.mt = (lm + mb - 1) // mb
        self.nt = (ln + nb - 1) // nb
        self.dtype = torch_dtype(dtype)
        self.default_dtt = TileType((mb, nb), self.dtype)
        self._init_fn = init_fn
        self._store: dict[tuple, Data] = {}
        self._lock = threading.Lock()

    # -- tile geometry -------------------------------------------------------
    def tile_shape(self, m: int, n: int) -> tuple[int, int]:
        """Edge tiles may be ragged; interior tiles are (mb, nb)."""
        return (min(self.mb, self.lm - m * self.mb),
                min(self.nb, self.ln - n * self.nb))

    def has_tile(self, m: int, n: int) -> bool:
        return 0 <= m < self.mt and 0 <= n < self.nt

    def has_key(self, *key) -> bool:
        return len(key) == 2 and self.has_tile(*key)

    def rank_of(self, m: int, n: int) -> int:
        return 0

    def data_of(self, m: int, n: int) -> Data:
        with self._lock:
            d = self._store.get((m, n))
            if d is None:
                shape = self.tile_shape(m, n)
                if self._init_fn is not None:
                    value = to_tensor(self._init_fn(m, n, shape)).to(
                        self.dtype).contiguous()
                    if tuple(value.shape) != shape:
                        raise ValueError(
                            f"{self.name}({m},{n}): init_fn gave "
                            f"{tuple(value.shape)}, tile is {shape}")
                else:
                    value = torch.zeros(shape, dtype=self.dtype)
                d = data_create(value, key=(self.name, m, n),
                                dtt=TileType(shape, self.dtype), dc=self)
                self._store[(m, n)] = d
            return d

    # -- whole-matrix conversion ---------------------------------------------
    def to_dense(self) -> np.ndarray:
        """The matrix as one host numpy array (newest copy of each tile,
        wherever it lives)."""
        out = None
        for m in range(self.mt):
            for n in range(self.nt):
                t = to_numpy(self.data_of(m, n).newest_copy().value)
                if out is None:
                    out = np.zeros((self.lm, self.ln), dtype=t.dtype)
                out[m * self.mb:m * self.mb + t.shape[0],
                    n * self.nb:n * self.nb + t.shape[1]] = t
        return out

    def to_numpy_tiles(self) -> dict[tuple[int, int], np.ndarray]:
        return {(m, n): to_numpy(self.data_of(m, n).newest_copy().value)
                for m in range(self.mt) for n in range(self.nt)}

    @classmethod
    def from_dense(cls, name: str, a: Any, mb: int, nb: int) -> "TiledMatrix":
        t = to_tensor(a)

        def init(m, n, shape):
            return t[m * mb:m * mb + shape[0], n * nb:n * nb + shape[1]]

        return cls(name, t.shape[0], t.shape[1], mb, nb, dtype=t.dtype,
                   init_fn=init)

    @classmethod
    def from_numpy_tiles(cls, name: str,
                         tiles: dict[tuple[int, int], np.ndarray],
                         m: int, n: int, mb: int, nb: int) -> "TiledMatrix":
        """A matrix over ``{(i, j): array}`` host tiles (the values the
        JAX package's ``TiledMatrix.data_of(i, j).newest_copy().value``
        holds).  Every tile of the m x n matrix must be present."""
        conv = {k: to_tensor(v) for k, v in tiles.items()}
        dtypes = {v.dtype for v in conv.values()}
        if len(dtypes) != 1:
            raise ValueError(f"{name}: tiles of mixed dtypes {dtypes}")
        out = cls(name, m, n, mb, nb, dtype=dtypes.pop(),
                  init_fn=lambda i, j, shape: conv[(i, j)])
        missing = [(i, j) for i in range(out.mt) for j in range(out.nt)
                   if (i, j) not in conv]
        if missing:
            raise KeyError(f"{name}: tiles {missing[:4]} missing")
        return out

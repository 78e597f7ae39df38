"""Tiled-matrix and segmented-vector descriptors.

Port of :class:`TiledMatrix`, :class:`TwoDimBlockCyclic`,
:class:`SymTwoDimBlockCyclic` and :class:`VectorTwoDimCyclic` from
``parsec_tpu/data_dist/matrix.py`` (the reference's
``parsec_tiled_matrix_t``, ``two_dim_rectangle_cyclic``,
``sym_two_dim_rectangle_cyclic`` and ``vector_two_dim_cyclic``): tile
sizes mb x nb over an lm x ln matrix, mt x nt tiles, ragged edge tiles;
or mb segments of an lm vector.  Tiles are CPU ``torch.Tensor`` values
created lazily on first touch; the device module and the lowering move
them onto the card.  :meth:`TiledMatrix.to_tensor` is ``to_dense``
without numpy: bf16 tiles stay bf16 on their way to the card.

The symmetric distribution stores one triangle (``uplo``): a tile of the
other raises ``KeyError``, and ``has_tile`` is False there, so the
lowering lays its store rows over the stored tiles only
(:func:`~parsec_tpu_torch.data_dist.collection.enumerate_keys`), and the
whole-matrix conversions leave the missing triangle's tiles as zeros.

:class:`TwoDimBlockCyclic` spreads the tiles over a ``P x Q`` grid of
ranks with ``kp x kq`` supertiles (``rank_of``); each rank builds its own
descriptor with its ``myrank``, and a multi-rank run assembles the whole
matrix from every rank's :meth:`TiledMatrix.to_dense`, which holds that
rank's own tiles only.  :class:`VectorTwoDimCyclic` deals its segments
over ``P`` ranks.  A rank may still read a tile another rank owns through
``data_of`` (the GEMM reads A and B on C's rank): the tile is made from
``init_fn`` where it is read.

Left out: the band, tabular, sub-tile and hash distributions.

:meth:`TiledMatrix.from_numpy_tiles` / :meth:`to_numpy_tiles` carry the
JAX package's ``{(i, j): np.ndarray}`` host tiles of the stored tiles
across, so both packages run on the same bytes (bf16 through its 16-bit
pattern, see :mod:`parsec_tpu_torch.data.datatype`).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import numpy as np
import torch

from ..data.data import Data, data_create
from ..data.datatype import TileType, to_numpy, to_tensor, torch_dtype
from .collection import DataCollection, enumerate_keys


class TiledMatrix(DataCollection):
    """Tiled matrix; keys are tile coordinates ``(m, n)``.

    ``init_fn(m, n, shape)`` returns a tile (tensor or array-like); tiles
    without one start as zeros.  ``nodes`` ranks share it, this one being
    ``myrank``; the base class puts every tile on rank 0.
    """

    def __init__(self, name: str, lm: int, ln: int, mb: int, nb: int,
                 dtype: Any = torch.float32,
                 init_fn: Callable | None = None, nodes: int = 1,
                 myrank: int = 0) -> None:
        super().__init__(name, nodes, myrank)
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

    def is_local(self, m: int, n: int) -> bool:
        """Whether this rank owns tile (m, n) (always, on one rank)."""
        return self.nodes <= 1 or self.rank_of(m, n) == self.myrank

    # -- whole-matrix conversion ---------------------------------------------
    def to_dense(self) -> np.ndarray:
        """The matrix as one host numpy array (newest copy of each stored
        tile, wherever it lives; zeros where no tile is stored).  Over
        several ranks it holds this rank's tiles only, zeros elsewhere:
        the ranks' arrays sum to the whole matrix."""
        out = None
        for m, n in enumerate_keys(self):
            if not self.is_local(m, n):
                continue
            t = to_numpy(self.data_of(m, n).newest_copy().value)
            if out is None:
                out = np.zeros((self.lm, self.ln), dtype=t.dtype)
            out[m * self.mb:m * self.mb + t.shape[0],
                n * self.nb:n * self.nb + t.shape[1]] = t
        if out is None:       # a rank that owns no tile
            out = np.zeros((self.lm, self.ln), dtype=to_numpy(
                torch.empty(0, dtype=self.dtype)).dtype)
        return out

    def to_tensor(self) -> torch.Tensor:
        """The matrix as one CPU tensor of the matrix dtype (newest copy of
        each stored tile, wherever it lives; zeros where no tile is
        stored, and, over several ranks, where another rank owns the
        tile), built with no numpy crossing."""
        out = torch.zeros((self.lm, self.ln), dtype=self.dtype)
        for m, n in enumerate_keys(self):
            if not self.is_local(m, n):
                continue
            t = self.data_of(m, n).newest_copy().value
            out[m * self.mb:m * self.mb + t.shape[0],
                n * self.nb:n * self.nb + t.shape[1]] = t
        return out

    def to_numpy_tiles(self) -> dict[tuple[int, int], np.ndarray]:
        return {k: to_numpy(self.data_of(*k).newest_copy().value)
                for k in enumerate_keys(self)}

    @classmethod
    def from_dense(cls, name: str, a: Any, mb: int, nb: int,
                   **kw) -> "TiledMatrix":
        t = to_tensor(a)

        def init(m, n, shape):
            return t[m * mb:m * mb + shape[0], n * nb:n * nb + shape[1]]

        return cls(name, t.shape[0], t.shape[1], mb, nb, dtype=t.dtype,
                   init_fn=init, **kw)

    @classmethod
    def from_numpy_tiles(cls, name: str,
                         tiles: dict[tuple[int, int], np.ndarray],
                         m: int, n: int, mb: int, nb: int,
                         **kw) -> "TiledMatrix":
        """A matrix over ``{(i, j): array}`` host tiles (the values the
        JAX package's ``TiledMatrix.data_of(i, j).newest_copy().value``
        holds).  Every stored tile of the m x n matrix must be present;
        ``kw`` goes to the constructor (``uplo=`` of the symmetric
        distribution)."""
        conv = {k: to_tensor(v) for k, v in tiles.items()}
        dtypes = {v.dtype for v in conv.values()}
        if len(dtypes) != 1:
            raise ValueError(f"{name}: tiles of mixed dtypes {dtypes}")
        out = cls(name, m, n, mb, nb, dtype=dtypes.pop(),
                  init_fn=lambda i, j, shape: conv[(i, j)], **kw)
        missing = [k for k in enumerate_keys(out) if k not in conv]
        if missing:
            raise KeyError(f"{name}: tiles {missing[:4]} missing")
        return out


class TwoDimBlockCyclic(TiledMatrix):
    """``P x Q`` block-cyclic distribution with ``kp x kq`` supertiles
    (``parsec_matrix_block_cyclic_init``): tile (m, n) lies on rank
    ``((m // kp) % P) * Q + (n // kq) % Q``."""

    def __init__(self, name: str, lm: int, ln: int, mb: int, nb: int,
                 P: int = 1, Q: int = 1, kp: int = 1, kq: int = 1,
                 **kw) -> None:
        if min(P, Q, kp, kq) < 1:
            raise ValueError(f"{name}: P, Q, kp and kq must be positive, "
                             f"got {P}, {Q}, {kp}, {kq}")
        kw.setdefault("nodes", P * Q)
        super().__init__(name, lm, ln, mb, nb, **kw)
        self.P, self.Q = P, Q
        self.kp, self.kq = kp, kq

    def rank_of(self, m: int, n: int) -> int:
        return ((m // self.kp) % self.P) * self.Q + (n // self.kq) % self.Q


class SymTwoDimBlockCyclic(TwoDimBlockCyclic):
    """Symmetric/triangular storage on one rank: only the tiles with
    m >= n (``uplo=LOWER``) or m <= n (``UPPER``) exist
    (``sym_two_dim_rectangle_cyclic.c``); any other raises ``KeyError``."""

    LOWER, UPPER = 0, 1

    def __init__(self, *args, uplo: int = 0, **kw) -> None:
        if uplo not in (self.LOWER, self.UPPER):
            raise ValueError(f"uplo must be LOWER (0) or UPPER (1), "
                             f"got {uplo!r}")
        super().__init__(*args, **kw)
        self.uplo = uplo

    def _check(self, m: int, n: int) -> None:
        if self.uplo == self.LOWER and n > m:
            raise KeyError(f"upper tile ({m},{n}) of a lower-sym matrix")
        if self.uplo == self.UPPER and m > n:
            raise KeyError(f"lower tile ({m},{n}) of an upper-sym matrix")

    def data_of(self, m: int, n: int) -> Data:
        self._check(m, n)
        return super().data_of(m, n)

    def rank_of(self, m: int, n: int) -> int:
        self._check(m, n)
        return super().rank_of(m, n)

    def has_tile(self, m: int, n: int) -> bool:
        if not super().has_tile(m, n):
            return False
        return not (self.uplo == self.LOWER and n > m
                    or self.uplo == self.UPPER and m > n)


class VectorTwoDimCyclic(DataCollection):
    """A vector of ``mt`` segments of ``mb`` elements (the last may be
    shorter), keys ``(m,)``, dealt cyclically over ``P`` ranks (segment m
    on rank ``m % P``).  ``init_fn(m, size)`` returns a segment (tensor or
    array-like); segments without one start as zeros.
    """

    def __init__(self, name: str, lm: int, mb: int, P: int = 1,
                 dtype: Any = torch.float32,
                 init_fn: Callable | None = None, nodes: int | None = None,
                 myrank: int = 0) -> None:
        if P < 1:
            raise ValueError(f"{name}: P must be a positive number of "
                             f"ranks, got {P}")
        super().__init__(name, P if nodes is None else nodes, myrank)
        self.lm, self.mb = lm, mb
        self.P = P
        self.mt = (lm + mb - 1) // mb
        self.dtype = torch_dtype(dtype)
        self.default_dtt = TileType((mb,), self.dtype)
        self._init_fn = init_fn
        self._store: dict[tuple, Data] = {}
        self._lock = threading.Lock()

    def rank_of(self, m: int) -> int:
        return m % self.P

    def has_key(self, *key) -> bool:
        return len(key) == 1 and 0 <= key[0] < self.mt

    def data_of(self, m: int) -> Data:
        with self._lock:
            d = self._store.get((m,))
            if d is None:
                size = min(self.mb, self.lm - m * self.mb)
                value = (to_tensor(self._init_fn(m, size)).to(self.dtype)
                         .contiguous() if self._init_fn
                         else torch.zeros(size, dtype=self.dtype))
                if tuple(value.shape) != (size,):
                    raise ValueError(f"{self.name}({m}): init_fn gave "
                                     f"{tuple(value.shape)}, segment is "
                                     f"({size},)")
                d = data_create(value, key=(self.name, m),
                                dtt=TileType((size,), self.dtype), dc=self)
                self._store[(m,)] = d
            return d

"""Typed-edge reshape: a lazy, shared repack of a copy to a dep's type.

Port of ``parsec_tpu/data/reshape.py`` (the reference's
``parsec_reshape.c``): a dependency may declare a tile type (``dtt=`` in
the DSL, ``[type = ...]`` in JDF) other than the producer's copy, and
its consumer observes the datum converted to that type.  One rule holds
everywhere: the conversion happens at the consuming edge (a local
release, a collection read, a remote receive, a write-back), never at the
producer.  The repack is

- lazy: a :class:`~parsec_tpu_torch.core.future.DataCopyFuture` stands in
  the consumer's input slot and is resolved at ``prepare_input`` by the
  first consumer that runs;
- shared: cached on the source copy by target type and version, so N
  consumers of one datum with the same type pay one conversion.

The conversion is :func:`parsec_tpu_torch.data.datatype.convert` (a
reshape and a cast, on the tile's own device).  Left out: layout tags.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from ..core.future import DataCopyFuture
from ..core.params import params as _params
from .data import DataCopy, data_create
from .datatype import TileType, convert, torch_dtype

_params.register("reshape_timeout_s", 60.0,
                 "Seconds resolve_copy waits for a reshape future before "
                 "declaring the producing thread stalled")

__all__ = ["needs_reshape", "reshaped_future", "resolve_copy", "edge_dtt",
           "reshape_for_edge", "reshape_for_writeback"]


def edge_dtt(out_dep: Any, in_dep: Any) -> TileType | None:
    """The type a consumer edge wants: the input dep's declaration wins,
    else the output dep's."""
    want = getattr(in_dep, "dtt", None) if in_dep is not None else None
    if want is None and out_dep is not None:
        want = out_dep.dtt
    return want


def _copy_dtt(copy: DataCopy) -> TileType:
    if copy.dtt is not None:
        return copy.dtt
    v = copy.value
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v)
    return TileType(tuple(v.shape), v.dtype)


def needs_reshape(copy: DataCopy, want: TileType | None) -> bool:
    if want is None:
        return False
    have = _copy_dtt(copy)
    return (tuple(have.shape) != tuple(want.shape)
            or torch_dtype(have.dtype) != torch_dtype(want.dtype))


def _convert_copy(copy: DataCopy, want: TileType) -> DataCopy:
    value = convert(copy.value, _copy_dtt(copy), want)
    if value is copy.value or value.data_ptr() == copy.value.data_ptr():
        value = value.clone()   # the repack never aliases its source
    d = data_create(value, key=("reshape", copy.original.key,
                                tuple(want.shape),
                                str(torch_dtype(want.dtype))), dtt=want)
    out = d.get_copy(0)
    out.version = copy.version
    return out


_cache_lock = threading.Lock()


def reshaped_future(copy: DataCopy, want: TileType) -> DataCopyFuture:
    """The shared lazy repack of ``copy`` to ``want``.  The cache key holds
    the copy's version, so a write to the source is never served a stale
    conversion; entries of older versions are pruned on insert."""
    key = (tuple(want.shape), str(torch_dtype(want.dtype)), copy.version)
    with _cache_lock:
        cache = copy.reshaped
        if cache is None:
            cache = copy.reshaped = {}
        f = cache.get(key)
        if f is None:
            for k in [k for k in cache if k[2] != copy.version]:
                del cache[k]
            f = DataCopyFuture(convert=lambda _src, c=copy, w=want:
                               _convert_copy(c, w))
            cache[key] = f
    return f


def resolve_copy(v: Any) -> Any:
    """Materialize a reshape future (the conversion runs once, on any
    thread), waiting at most ``reshape_timeout_s``."""
    if isinstance(v, DataCopyFuture):
        v.trigger()
        return v.get(timeout=_params.get("reshape_timeout_s"))
    return v


def reshape_for_edge(copy: Any, out_dep: Any, in_dep: Any) -> Any:
    """The consumer-edge rule of the local and remote release paths:
    ``copy`` itself, or a lazy shared repack when the edge's type differs."""
    if copy is None:
        return None
    want = edge_dtt(out_dep, in_dep)
    if needs_reshape(copy, want):
        return reshaped_future(copy, want)
    return copy


def reshape_for_writeback(copy: DataCopy, dep: Any, dc: Any,
                          key: tuple) -> DataCopy:
    """The write-back rule of the local and remote apply sites: convert to
    the dep's type or, for an untyped dep whose copy differs from the home
    tile, back to the home tile's type (a write-back never changes a
    tile's shape)."""
    want = dep.dtt if dep is not None else None
    if want is None:
        home = dc.data_of(*key).get_copy(0)
        if home is not None and home is not copy and home.value is not None:
            want = _copy_dtt(home)
    if needs_reshape(copy, want):
        return resolve_copy(reshaped_future(copy, want))
    return copy

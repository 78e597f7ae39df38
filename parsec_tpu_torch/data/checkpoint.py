"""Checkpoint and restore of data collections.

Port of ``parsec_tpu/data/checkpoint.py``: between pool executions the
collections are the whole program state, so saving tiles and versions at
a phase boundary and restoring them later is a complete restart story::

    run(phase1); save_collections(path, A, B)
    ...
    restore_collections(path, A, B); run(phase2)

The format is the JAX package's, so a checkpoint written by either
package restores in the other: one ``.npz`` per rank holding the tiles
this rank owns (``{name}:{i}``) and a JSON ``__header__`` (rank, ranks,
each collection's keys and versions, the caller's ``meta``); over several
ranks each rank writes its own ``path.rankN``.  The archive is stored
uncompressed (``np.savez``; the JAX package compresses): tiles of
floating-point values shrink by a few percent at many times the cost,
and ``np.load`` reads either form, so each package restores the other's.
Restore refuses a collection whose geometry, distribution, tile shape or
dtype changed.

On the card.  A tile's newest copy may live on the device, as a device
copy or as a home copy whose value is the device tensor a write-back
left there: the save copies that version to the host (``to_numpy``, a
D2H) and never reads a stale host tensor.  The restore rewrites the home
copies, then drops every other copy of each datum (the device module's
``release_data``: its LRU entry goes and the copy is marked invalid, so
a queued eviction skips it), so the next pool stages the restored
bytes.  bf16 tiles cross as
their 16-bit pattern (:mod:`parsec_tpu_torch.data.datatype`): numpy
writes an ``ml_dtypes`` bfloat16 array as two-byte voids, which the
restore reads back as bf16.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .data import COHERENCY_INVALID
from .datatype import to_numpy

__all__ = ["save_collections", "restore_collections", "CheckpointError"]


class CheckpointError(RuntimeError):
    pass


def _rank_path(path: str, rank: int, nranks: int) -> str:
    return path if nranks <= 1 else f"{path}.rank{rank}"


def _own_keys(dc: Any) -> list[tuple]:
    from ..data_dist.collection import enumerate_keys
    keys = enumerate_keys(dc)
    if getattr(dc, "nodes", 1) > 1:
        keys = [k for k in keys if dc.rank_of(*k) == dc.myrank]
    return keys


def _rank_of(collections: tuple) -> tuple[int, int]:
    return (max(getattr(dc, "myrank", 0) for dc in collections),
            max(getattr(dc, "nodes", 1) for dc in collections))


def save_collections(path: str, *collections: Any,
                     meta: dict | None = None) -> str:
    """Snapshot every owned tile (and its version) of each collection.
    Returns the file written (rank-suffixed over several ranks)."""
    if not collections:
        raise CheckpointError("nothing to checkpoint")
    rank, nranks = _rank_of(collections)
    out = _rank_path(path, rank, nranks)
    names = [dc.name for dc in collections]
    if len(set(names)) != len(names):
        raise CheckpointError(f"duplicate collection names: {names}; the "
                              f"archive is keyed by name")
    arrays: dict[str, np.ndarray] = {}
    header: dict[str, Any] = {"rank": rank, "nranks": nranks,
                              "collections": {}, "meta": meta or {}}
    for dc in collections:
        entry: dict[str, list] = {"keys": [], "versions": []}
        for i, k in enumerate(_own_keys(dc)):
            copy = dc.data_of(*k).newest_copy()
            if copy is None:
                raise CheckpointError(f"{dc.name}{k}: no valid copy")
            arrays[f"{dc.name}:{i}"] = to_numpy(copy.value)
            entry["keys"].append(list(k))
            entry["versions"].append(copy.version)
        header["collections"][dc.name] = entry
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out + ".tmp.npz", **arrays)
    os.replace(out + ".tmp.npz", out)      # atomic publish: no torn file
    return out


def _as_tensor(value: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A loaded array as a host tensor of the home tile's dtype, or None
    when the dtypes differ (bf16 arrives as two-byte voids)."""
    if like.dtype == torch.bfloat16:
        if value.dtype.itemsize != 2 or value.dtype.kind not in "Vf":
            return None
        if value.dtype.kind == "f" and value.dtype.name != "bfloat16":
            return None
        bits = np.ascontiguousarray(value).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    if value.dtype.kind == "V":
        return None
    t = torch.from_numpy(np.array(value))
    return t if t.dtype == like.dtype else None


def _drop_other_copies(datum: Any, home_index: int) -> None:
    """Invalidate and detach every copy but the home one: through the
    device module where a device of that index is registered."""
    from ..device.device import registry
    for idx in [i for i in datum.device_copies if i != home_index]:
        dev = registry.devices[idx] if idx < len(registry.devices) else None
        release = getattr(dev, "release_data", None)
        if release is not None:
            release(datum)
            continue
        stale = datum.detach_copy(idx)
        if stale is not None:
            stale.coherency = COHERENCY_INVALID


def restore_collections(path: str, *collections: Any) -> dict:
    """Load a snapshot back into the collections' home copies; returns the
    checkpoint's ``meta``."""
    if not collections:
        raise CheckpointError("nothing to restore")
    rank, nranks = _rank_of(collections)
    src = _rank_path(path, rank, nranks)
    with np.load(src) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header["nranks"] != nranks or header["rank"] != rank:
            raise CheckpointError(
                f"{src}: checkpoint is rank {header['rank']}/"
                f"{header['nranks']}, collections are {rank}/{nranks}")
        for dc in collections:
            entry = header["collections"].get(dc.name)
            if entry is None:
                raise CheckpointError(f"{src}: no collection {dc.name!r}")
            own = _own_keys(dc)
            keys = [tuple(k) for k in entry["keys"]]
            if keys != own:
                raise CheckpointError(
                    f"{dc.name}: geometry/distribution changed since the "
                    f"checkpoint ({len(keys)} saved vs {len(own)} owned "
                    f"tiles)")
            for i, (k, ver) in enumerate(zip(keys, entry["versions"])):
                value = z[f"{dc.name}:{i}"]
                datum = dc.data_of(*k)
                home = datum.get_copy(0)
                if home is None:
                    raise CheckpointError(f"{dc.name}{k}: no home copy")
                cur = home.value
                if tuple(value.shape) != tuple(cur.shape):
                    raise CheckpointError(
                        f"{dc.name}{k}: tile shape changed "
                        f"({value.shape} vs {tuple(cur.shape)})")
                t = _as_tensor(value, cur)
                if t is None:
                    raise CheckpointError(
                        f"{dc.name}{k}: tile dtype changed "
                        f"({value.dtype} vs {cur.dtype})")
                home.value = t
                home.version = ver
                # a device copy staged before the restore would keep
                # serving the old bytes (its version beats the rewound
                # home): drop it, and its LRU entry with it
                _drop_other_copies(datum, home.device_index)
        return header["meta"]

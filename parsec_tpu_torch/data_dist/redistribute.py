"""Redistribution between arbitrary tiled-matrix distributions.

Port of ``parsec_tpu/data_dist/redistribute.py`` (the reference's
``data_dist/matrix/redistribute/``): copy a submatrix of a source tiled
matrix into a target of another tiling and distribution.  The fragment
DAG is discovered with the DTD front-end: one ``copy_frag`` task for each
overlap of a source tile and a target tile, serialized per target tile by
the accessor chains.  On several ranks, a source tile that two or more
remote ranks read is relayed down the ``comm_bcast_tree`` tree through a
:class:`~parsec_tpu_torch.data_dist.matrix.HashDataDist` of staging tiles
(``relay_tile`` tasks; the ``redist_collective_fanout`` param), so the
owner serves its tree children only.

Where the copies run.  With ``devices="cuda"`` (the default) both classes
carry only a CUDA chore (``cuda_kernel="copy_frag"`` / ``"relay_tile"``):
the device module stages the tiles, and the copy is one ``copy_`` of the
source slice into the target tile's copy on the card, with the tile's
version bumped, so a pool that runs next on the card (the tiled GEMM)
reads the redistributed tiles where they lie.  With no CUDA device
registered such a pool fails with no runnable chore: it never falls back
to the host.  ``devices="cpu"`` takes host bodies over the home tiles.
Under ``init_cuda_devices(device="cpu")`` the CUDA chore runs on the host
stand-in, writing into a copy of the target tile (never into the home
tensor the stand-in's device copy aliases).  The pool counts its
fragments (``nb_frags``) and relays (``nb_relays``); the module counts
the copies each chore ran (:data:`copies`).
"""

from __future__ import annotations

from collections import Counter
from typing import Any

import torch

from ..core.params import params as _params
from ..device.kernels import register_kernel
from ..dtd.insert import AFFINITY, DTDTaskpool, INOUT, INPUT, VALUE
from .matrix import HashDataDist

_params.register("redist_collective_fanout", True,
                 "stage source tiles with >= 2 remote consumer ranks "
                 "along the comm_bcast_tree relay tree instead of serving "
                 "every consumer pairwise from the owner")

#: copies run, by chore: ``cuda`` (the device module's) and ``host``
copies: Counter = Counter()


def _overlaps(lo_a: int, hi_a: int, lo_b: int, hi_b: int) -> tuple | None:
    lo, hi = max(lo_a, lo_b), min(hi_a, hi_b)
    return (lo, hi) if lo < hi else None


def _copy_frag(dst, src, dr0, dr1, dc0, dc1, sr0, sr1, sc0, sc1):
    copies["host"] += 1
    dst[dr0:dr1, dc0:dc1].copy_(src[sr0:sr1, sc0:sc1])


def _relay_tile(stage, src):
    copies["host"] += 1
    stage.copy_(src)


def _values(task: Any) -> list:
    return [s.obj for s in task.args if s.flags & VALUE]


def _target(copy: Any) -> torch.Tensor:
    """The tensor a device chore writes: the device copy itself on the
    card; a fresh copy of it on the host stand-in, whose device copy may
    alias the home tensor."""
    v = copy.value
    return v if v.is_cuda else v.clone()


def _copy_frag_cuda(es: Any, task: Any, device: Any) -> None:
    dst, src = task.data[0], task.data[1]
    dr0, dr1, dc0, dc1, sr0, sr1, sc0, sc1 = _values(task)
    out = _target(dst)
    out[dr0:dr1, dc0:dc1].copy_(src.value[sr0:sr1, sc0:sc1])
    dst.value = out
    dst.version += 1
    copies["cuda"] += 1


def _relay_tile_cuda(es: Any, task: Any, device: Any) -> None:
    stage, src = task.data[0], task.data[1]
    out = _target(stage)
    out.copy_(src.value)
    stage.value = out
    stage.version += 1
    copies["cuda"] += 1


register_kernel("copy_frag", "cuda", _copy_frag_cuda)
register_kernel("relay_tile", "cuda", _relay_tile_cuda)


def fragments(src: Any, dst: Any, size_row: int, size_col: int,
              disi_src: int, disj_src: int, disi_dst: int,
              disj_dst: int) -> list[tuple]:
    """Every (target tile, source tile, slice bounds) overlap: the bounds
    are ``dr0, dr1, dc0, dc1`` in the target tile and ``sr0, sr1, sc0,
    sc1`` in the source tile."""
    out = []
    m0, m1 = disi_dst // dst.mb, (disi_dst + size_row - 1) // dst.mb
    n0, n1 = disj_dst // dst.nb, (disj_dst + size_col - 1) // dst.nb
    shift_r, shift_c = disi_src - disi_dst, disj_src - disj_dst
    for m in range(m0, m1 + 1):
        for n in range(n0, n1 + 1):
            rows, cols = dst.tile_shape(m, n)
            d_r = _overlaps(m * dst.mb, m * dst.mb + rows,
                            disi_dst, disi_dst + size_row)
            d_c = _overlaps(n * dst.nb, n * dst.nb + cols,
                            disj_dst, disj_dst + size_col)
            if d_r is None or d_c is None:
                continue
            s_r0, s_r1 = d_r[0] + shift_r, d_r[1] + shift_r
            s_c0, s_c1 = d_c[0] + shift_c, d_c[1] + shift_c
            for sm in range(s_r0 // src.mb, (s_r1 - 1) // src.mb + 1):
                for sn in range(s_c0 // src.nb, (s_c1 - 1) // src.nb + 1):
                    srows, scols = src.tile_shape(sm, sn)
                    o_r = _overlaps(sm * src.mb, sm * src.mb + srows,
                                    s_r0, s_r1)
                    o_c = _overlaps(sn * src.nb, sn * src.nb + scols,
                                    s_c0, s_c1)
                    if o_r is None or o_c is None:
                        continue
                    args = (o_r[0] - shift_r - m * dst.mb,
                            o_r[1] - shift_r - m * dst.mb,
                            o_c[0] - shift_c - n * dst.nb,
                            o_c[1] - shift_c - n * dst.nb,
                            o_r[0] - sm * src.mb, o_r[1] - sm * src.mb,
                            o_c[0] - sn * src.nb, o_c[1] - sn * src.nb)
                    out.append(((m, n), (sm, sn), args))
    return out


def redistribute_taskpool(src: Any, dst: Any,
                          size_row: int | None = None,
                          size_col: int | None = None,
                          disi_src: int = 0, disj_src: int = 0,
                          disi_dst: int = 0, disj_dst: int = 0,
                          name: str = "redistribute",
                          devices: str = "cuda") -> DTDTaskpool:
    """Copy ``src[disi_src:+size_row, disj_src:+size_col]`` into
    ``dst[disi_dst:..., disj_dst:...]`` across any two tilings.  ``src``
    and ``dst`` have the tiled-matrix geometry (``lm``, ``ln``, ``mb``,
    ``nb``, ``tile_shape``, ``rank_of``, ``data_of``).

    Returns a DTD pool that inserts its whole DAG at enqueue
    (``on_enqueue``) and closes itself, so it composes (:func:`~parsec_tpu_
    torch.runtime.taskpool.compose`).  ``devices`` is ``"cuda"`` or
    ``"cpu"`` (module docstring)."""
    if devices not in ("cuda", "cpu"):
        raise ValueError(f"devices must be 'cuda' or 'cpu', got {devices!r}")
    size_row = size_row if size_row is not None else min(
        src.lm - disi_src, dst.lm - disi_dst)
    size_col = size_col if size_col is not None else min(
        src.ln - disj_src, dst.ln - disj_dst)
    on_card = devices == "cuda"
    tp = DTDTaskpool(name=name)
    tp.nb_frags = tp.nb_relays = 0

    def populate(taskpool: DTDTaskpool) -> None:
        frags = fragments(src, dst, size_row, size_col, disi_src, disj_src,
                          disi_dst, disj_dst)
        ctx = taskpool.context
        nranks = ctx.nb_ranks if ctx is not None else 1
        myrank = ctx.my_rank if ctx is not None else 0
        copy_kw = {"cuda_kernel": "copy_frag"} if on_card else {}
        relay_kw = {"cuda_kernel": "relay_tile"} if on_card else {}

        # a source tile two or more remote ranks read is relayed down the
        # tree: the owner serves its tree children, interior ranks
        # re-serve their landed copy
        stage_src: dict[tuple, dict[int, Any]] = {}
        if nranks > 1 and _params.get("redist_collective_fanout"):
            from ..comm.remote_dep import resolve_tree_kind, tree_parent
            consumers: dict[tuple, set[int]] = {}
            for (m, n), skey, _a in frags:
                consumers.setdefault(skey, set()).add(dst.rank_of(m, n))
            stages = HashDataDist(f"{name}_stage", nodes=nranks,
                                  myrank=myrank,
                                  rank_fn=lambda sm, sn, r: r)
            for skey in sorted(consumers):
                owner = src.rank_of(*skey)
                remote = sorted(consumers[skey] - {owner})
                if len(remote) < 2:
                    continue
                order = [owner] + remote
                shape = src.tile_shape(*skey)
                kind = resolve_tree_kind(
                    nbytes=shape[0] * shape[1] * src.dtype.itemsize,
                    n=len(order))
                stile = taskpool.tile_of(src, *skey)
                tiles: dict[int, Any] = {}
                for pos in range(1, len(order)):
                    key = skey + (order[pos],)
                    stages.register(key, torch.zeros(shape, dtype=src.dtype))
                    tiles[order[pos]] = taskpool.tile_of(stages, *key)
                for pos in range(1, len(order)):
                    parent = tree_parent(kind, pos, len(order))
                    upstream = stile if parent == 0 \
                        else tiles[order[parent]]
                    taskpool.insert_task(
                        _relay_tile, (tiles[order[pos]], INOUT | AFFINITY),
                        (upstream, INPUT), name="relay_tile", **relay_kw)
                    taskpool.nb_relays += 1
                stage_src[skey] = tiles

        for (m, n), skey, args in frags:
            dtile = taskpool.tile_of(dst, m, n)
            drank = dst.rank_of(m, n)
            tiles = stage_src.get(skey)
            read = tiles[drank] if tiles is not None and drank in tiles \
                else taskpool.tile_of(src, *skey)
            taskpool.insert_task(
                _copy_frag, (dtile, INOUT | AFFINITY), (read, INPUT),
                *[(a, VALUE) for a in args], name="copy_frag", **copy_kw)
            taskpool.nb_frags += 1
        # the whole DAG is in: release the insertion guard, so the pool
        # terminates with no wait() (composition)
        taskpool.close()

    tp.on_enqueue = populate
    return tp

"""Ulysses: sequence parallelism by re-sharding sequence into heads.

Port of ``parsec_tpu/parallel/alltoall.py``.  With ``x`` of shape
``[b, n_local, h, d]`` split over ``sp`` along the sequence,
:func:`seq_to_heads_local` returns ``[b, n, h_local, d]`` split along the
heads: each rank then holds whole sequences for a group of heads (the
DeepSpeed-Ulysses layout), so dense attention runs locally.
:func:`heads_to_seq_local` is the inverse.  Each is one
:meth:`~.mesh.Mesh.all_to_all` over the axis.
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import Mesh

__all__ = ["seq_to_heads_local", "heads_to_seq_local",
           "make_ulysses_attention"]


def seq_to_heads_local(x: torch.Tensor, mesh: Mesh,
                       axis: str = "sp") -> torch.Tensor:
    """``[b, n_loc, h, d] -> [b, n, h/axis, d]``."""
    return mesh.all_to_all(x, axis, split_dim=2, concat_dim=1)


def heads_to_seq_local(x: torch.Tensor, mesh: Mesh,
                       axis: str = "sp") -> torch.Tensor:
    """``[b, n, h_loc, d] -> [b, n/axis, h, d]``."""
    return mesh.all_to_all(x, axis, split_dim=1, concat_dim=2)


def make_ulysses_attention(mesh: Mesh, attention_fn: Callable,
                           axis: str = "sp") -> Callable:
    """Sequence-parallel attention by head re-sharding: all-to-all the
    split sequence into split heads, run ``attention_fn(q, k, v)`` on
    ``[b, h_group, n, d]``, and all-to-all back.  ``fn(q, k, v)`` takes
    this rank's ``[b, h, n_local, d]`` blocks."""

    def to_heads(t):
        t = t.transpose(1, 2)                        # [b, n_loc, h, d]
        t = seq_to_heads_local(t, mesh, axis)        # [b, n, h_loc, d]
        return t.transpose(1, 2).contiguous()        # [b, h_loc, n, d]

    def to_seq(t):
        t = t.transpose(1, 2)                        # [b, n, h_loc, d]
        t = heads_to_seq_local(t, mesh, axis)        # [b, n_loc, h, d]
        return t.transpose(1, 2).contiguous()        # [b, h, n_loc, d]

    def fn(q, k, v):
        return to_seq(attention_fn(to_heads(q), to_heads(k), to_heads(v)))

    return fn

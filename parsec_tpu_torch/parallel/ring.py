"""Ring attention: sequence parallelism over a ring of ranks.

Port of ``parsec_tpu/parallel/ring.py``.  Each rank holds one block of
the sequence; each of ``n - 1`` steps computes one [q-block x kv-block]
attention partial while the KV block rotates to the next rank, and the
online softmax keeps a running (max, sum, out) per query row: the same
function as ``softmax(QKᵀ)V`` up to summation order.

The rotation is :meth:`~.mesh.Mesh.shift` (``ppermute``) over the mesh's
``sp`` axis, wrapped in an autograd function whose backward rotates the
cotangent the other way, so the block trains (the flagship step of
:mod:`.train`).  The block partials are torch ops on the card (the JAX
package computes them in XLA, outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import Mesh

__all__ = ["ring_attention_local", "make_ring_attention", "dense_attention"]

_NEG_INF = -1e30
_BACK_TAG = 1 << 16     # the backward rotations' tags


def _block_attention(q, k, v, mask):
    """One [q-block, kv-block] partial.  q: [b, h, nq, d]; k, v:
    [b, h, nk, d]; mask: [nq, nk] additive.  Returns (max [b,h,nq],
    sum [b,h,nq], pv [b,h,nq,d]), in fp32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s + mask
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m, l, pv


class _Shift(torch.autograd.Function):
    """``ppermute`` by ``offset`` along an axis; its backward sends the
    cotangent back by ``-offset``.  Each shift has its own ``tag``, so
    the K and V rotations (same shapes) never cross, forward or back."""

    @staticmethod
    def forward(ctx, x, mesh, axis, offset, tag):
        ctx.mesh, ctx.axis, ctx.offset, ctx.tag = mesh, axis, offset, tag
        return mesh.shift(x, axis, offset, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shift(g.contiguous(), ctx.axis, -ctx.offset,
                              tag=ctx.tag + _BACK_TAG), None, None, None, None


def ring_attention_local(q, k, v, mesh: Mesh, axis: str = "sp",
                         causal: bool = False) -> torch.Tensor:
    """This rank's ring attention: q, k, v ``[b, h, n_local, d]``, the
    sequence split over ``axis`` in rank order.  Rotates the KV block
    ``n - 1`` times with the online-softmax recurrence; returns
    ``[b, h, n_local, d]`` in q's dtype."""
    n_dev = mesh.size(axis)
    my = mesh.index(axis)
    b, h, n_loc, d = q.shape
    dev = q.device
    q_pos = my * n_loc + torch.arange(n_loc, device=dev)

    def accumulate(acc, t, k_blk, v_blk):
        o, m, l = acc
        src = (my - t) % n_dev                 # the block now held
        if causal:
            k_pos = src * n_loc + torch.arange(n_loc, device=dev)
            mask = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                               _NEG_INF).to(torch.float32)
        else:
            mask = torch.zeros((n_loc, n_loc), dtype=torch.float32,
                               device=dev)
        bm, bl, bpv = _block_attention(q, k_blk, v_blk, mask)
        m_new = torch.maximum(m, bm)
        corr = torch.exp(m - m_new)
        bcorr = torch.exp(bm - m_new)
        l = l * corr + bl * bcorr
        o = o * corr[..., None] + bpv * bcorr[..., None]
        return o, m_new, l

    acc = (torch.zeros((b, h, n_loc, d), dtype=torch.float32, device=dev),
           torch.full((b, h, n_loc), _NEG_INF, dtype=torch.float32,
                      device=dev),
           torch.zeros((b, h, n_loc), dtype=torch.float32, device=dev))
    acc = accumulate(acc, 0, k, v)
    for t in range(1, n_dev):
        # receive from the previous rank: after t rotations the block of
        # rank (my - t) % n is here
        k = _Shift.apply(k, mesh, axis, 1, 2 * t)
        v = _Shift.apply(v, mesh, axis, 1, 2 * t + 1)
        acc = accumulate(acc, t, k, v)
    o, _m, l = acc
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def make_ring_attention(mesh: Mesh, axis: str = "sp", causal: bool = False
                        ) -> Callable:
    """Ring attention over ``mesh``: ``fn(q, k, v)`` on this rank's
    ``[b_l, h_l, n_l, d]`` blocks (batch and heads may also be split, over
    other axes, by the caller)."""
    def fn(q, k, v):
        return ring_attention_local(q, k, v, mesh, axis=axis, causal=causal)
    return fn


def dense_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Dense softmax attention, the oracle: ``[b, h, n, d]`` each."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        n = q.shape[2]
        keep = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=q.device))
        s = s + torch.where(keep, 0.0, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)

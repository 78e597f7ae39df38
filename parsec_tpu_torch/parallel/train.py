"""Composed distributed training steps over a :class:`~.mesh.Mesh`.

Port of ``parsec_tpu/parallel/train.py``.  In the JAX package a step is a
``shard_map`` over the mesh with XLA's collectives; here each mesh
position is a process, the step runs once per rank on its shards, and the
collectives are the mesh's over ``torch.distributed``.  Gradients come
from autograd; the Megatron f/g pair are :class:`torch.autograd.Function`
s, since a gradient through a plain ``dist.all_reduce`` is lost:

- :func:`psum_r` (*g*): forward all-reduce over an axis, backward the
  identity (the cotangent arriving after a row-parallel product is
  replicated);
- :func:`ident_f` (*f*): forward the identity, backward all-reduce (the
  activation's cotangent is the sum of every shard's partial).

Two steps, as in the JAX package:

- :func:`make_train_step`: the dp x tp MLP block (column- then
  row-parallel, one ``psum_r`` a block);
- :func:`make_transformer_train_step`: the flagship dp x tp x sp block,
  its attention ring attention over ``sp`` (:mod:`.ring`), heads over
  ``tp``, batch over ``dp``; gradients of replicated parameters averaged
  over dp and sp.

The parameters are a dict of tensors: :func:`init_params` and
:func:`init_transformer_params` draw them from a seeded
``torch.Generator`` (the JAX package's come from ``jax.random``; the
tests carry the JAX values across with :func:`shard_params`).  The
products are ``torch.matmul``, the backward is autograd's.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .mesh import Mesh
from .ring import ring_attention_local

__all__ = ["psum_r", "ident_f", "init_params", "make_train_step",
           "init_transformer_params", "transformer_param_specs",
           "make_transformer_train_step", "shard_params"]


class _PsumR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _IdentF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


def psum_r(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Megatron's *g*: all-reduce forward, identity backward."""
    return _PsumR.apply(x, mesh, axis)


def ident_f(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Megatron's *f*: identity forward, all-reduce backward."""
    return _IdentF.apply(x, mesh, axis)


def init_params(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    """The MLP's weights, drawn on the generator's device."""
    dev = gen.device
    return {
        "w1": torch.randn(d_model, d_ff, generator=gen, device=dev) * 0.02,
        "w2": torch.randn(d_ff, d_model, generator=gen, device=dev) * 0.02,
    }


MLP_SPECS = {"w1": (None, "tp"), "w2": ("tp", None)}


def _shard(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: one mesh axis (or None)
    a dimension, the dimension split evenly along it."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n, i = mesh.size(ax), mesh.index(ax)
        step = t.shape[dim] // n
        t = t.narrow(dim, i * step, step)
    return t


def shard_params(params: dict, specs: dict, mesh: Mesh) -> dict:
    """Each rank's shards of whole parameters (tensors or arrays), on the
    mesh's device, as leaf tensors."""
    return {k: _shard(torch.as_tensor(v), specs[k], mesh).to(
                mesh.device, torch.float32).contiguous()
            for k, v in params.items()}


def shard_batch(x: Any, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a batch under ``spec`` (``("dp",)`` or
    ``("dp", "sp", None)``)."""
    return _shard(torch.as_tensor(x), spec, mesh).to(
        mesh.device, torch.float32).contiguous()


def _sgd(params: dict, grads: dict, lr: float) -> dict:
    return {k: (params[k] - lr * grads[k]).detach() for k in params}


def make_train_step(mesh: Mesh, lr: float = 0.1) -> Callable:
    """One SGD step of the tp-sharded MLP block over dp x tp:
    ``step(params, x, y) -> (new_params, loss)`` on this rank's shards
    (``w1`` column-sharded and ``w2`` row-sharded over tp; ``x``, ``y``
    sharded over dp)."""

    def step(params: dict, x: torch.Tensor, y: torch.Tensor):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        h = torch.relu(x @ p["w1"])
        o = psum_r(h @ p["w2"], mesh, "tp")
        loss = torch.mean((o - y) ** 2)
        grads = torch.autograd.grad(loss, [p[k] for k in p])
        # data-parallel gradient mean over dp (tp shards stay sharded)
        grads = {k: mesh.all_reduce(g, "dp", mean=True)
                 for k, g in zip(p, grads)}
        return (_sgd(params, grads, lr),
                mesh.all_reduce(loss.detach(), "dp", mean=True))

    return step


# ---------------------------------------------------------------------------
# flagship: transformer block over dp x tp x sp
# ---------------------------------------------------------------------------

def init_transformer_params(gen: torch.Generator, d_model: int,
                            n_heads: int, d_head: int, d_ff: int) -> dict:
    """The block's weights, drawn on the generator's device."""
    s = 0.02
    hd = n_heads * d_head
    shapes = {"wq": (d_model, hd), "wk": (d_model, hd), "wv": (d_model, hd),
              "wo": (hd, d_model), "w1": (d_model, d_ff),
              "w2": (d_ff, d_model)}
    return {k: torch.randn(*sh, generator=gen, device=gen.device) * s
            for k, sh in shapes.items()}


def transformer_param_specs() -> dict:
    """q/k/v column-sharded by head group over tp, ``wo`` row-sharded,
    the MLP Megatron-style; replicated over dp and sp."""
    return {"wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
            "wo": ("tp", None), "w1": (None, "tp"), "w2": ("tp", None)}


def make_transformer_train_step(mesh: Mesh, n_heads: int, d_head: int,
                                lr: float = 0.1,
                                causal: bool = True) -> Callable:
    """One SGD step of a transformer block on this rank's shards: ring
    attention over ``sp``, head groups over ``tp``, batch over ``dp``.
    ``step(params, x, y) -> (new_params, loss)``; ``x``, ``y`` are the
    rank's ``[b_l, s_l, d]`` block."""
    tp_size = mesh.size("tp")
    h_loc = n_heads // tp_size
    if h_loc * tp_size != n_heads:
        raise ValueError(f"{n_heads} heads do not split over tp={tp_size}")

    def block(p: dict, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape

        def heads(t):   # [b, s, h_l*dh] -> [b, h_l, s, dh]
            return t.reshape(b, s, h_loc, d_head).transpose(1, 2)

        xf = ident_f(x, mesh, "tp")
        q = heads(xf @ p["wq"])
        k = heads(xf @ p["wk"])
        v = heads(xf @ p["wv"])
        a = ring_attention_local(q, k, v, mesh, axis="sp", causal=causal)
        a = a.transpose(1, 2).reshape(b, s, h_loc * d_head)
        x = x + psum_r(a @ p["wo"], mesh, "tp")
        h = torch.relu(ident_f(x, mesh, "tp") @ p["w1"])
        return x + psum_r(h @ p["w2"], mesh, "tp")

    def step(params: dict, x: torch.Tensor, y: torch.Tensor):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = torch.mean((block(p, x) - y) ** 2)
        grads = torch.autograd.grad(loss, [p[k] for k in p])
        grads = {k: mesh.all_reduce(g, ("dp", "sp"), mean=True)
                 for k, g in zip(p, grads)}
        return (_sgd(params, grads, lr),
                mesh.all_reduce(loss.detach(), ("dp", "sp"), mean=True))

    return step

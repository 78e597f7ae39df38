"""Rank bodies that run the mesh recipes in one ``run_multiproc`` launch.

:func:`mesh_body` is a ``run_multiproc(..., distributed=True)`` body: it
reads a list of jobs from the JSON in ``PARSEC_PAR_SPEC`` (which every
rank inherits) and runs them in order, each on a :class:`~.mesh.Mesh` of
its own over the world group, on the rank's device
(``PARSEC_MP_DEVICE``: ``cpu`` for the host stand-in, else the card).

A job is a dict: ``kind`` (``ring``, ``ulysses``, ``mlp``,
``transformer``, ``pipeline``, ``moe``), ``mesh`` (axis sizes, row-major;
an axis no recipe reads, such as ``x``, replicates the job), its sizes,
and where its inputs come from: ``inputs`` (an ``.npz`` path, the arrays
named as the job's ``keys`` map them) or ``seed`` (drawn on the device
from a ``torch.Generator``, the same on every rank).  With ``ret`` the
rank returns its blocks of the outputs as numpy; with ``check`` it also
runs the same function on one process (the whole inputs, on the same
device) and returns the largest difference on its blocks.  Every job
returns its seconds and the bytes the mesh staged through the host.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from .alltoall import make_ulysses_attention
from .expert import make_moe_step, reference_moe
from .mesh import Mesh
from .pipeline import make_pipeline_step
from .ring import dense_attention, make_ring_attention
from .train import (MLP_SPECS, init_params, init_transformer_params,
                    make_train_step, make_transformer_train_step,
                    shard_batch, shard_params, transformer_param_specs)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


class _Inputs:
    """A job's named inputs: from the npz, else drawn from the seed."""

    def __init__(self, job: dict, dev: torch.device) -> None:
        self.dev = dev
        self.npz = np.load(job["inputs"]) if job.get("inputs") else None
        self.keys = job.get("keys", {})
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(job.get("seed", 0)))

    def get(self, name: str, shape: tuple, scale: float = 1.0
            ) -> torch.Tensor:
        if self.npz is not None:
            return torch.as_tensor(
                self.npz[self.keys.get(name, name)]).to(self.dev,
                                                        torch.float32)
        return torch.randn(*shape, generator=self.gen,
                           device=self.dev) * scale


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def _qkv_spec(mesh: Mesh) -> tuple:
    """[b, h, n, d]: batch over dp, heads over tp, sequence over sp, for
    the axes the mesh has."""
    return tuple(a if a in mesh.shape else None
                 for a in ("dp", "tp", "sp")) + (None,)


def _attention(job: dict, mesh: Mesh, inp: _Inputs) -> dict:
    b, h, n, d = job["shape"]
    causal = bool(job.get("causal", False))
    q, k, v = (inp.get(nm, (b, h, n, d)) for nm in ("q", "k", "v"))
    spec = _qkv_spec(mesh)
    ql, kl, vl = (shard_batch(t, spec, mesh) for t in (q, k, v))
    if job["kind"] == "ring":
        fn = make_ring_attention(mesh, causal=causal)
    else:
        fn = make_ulysses_attention(
            mesh, lambda a, b_, c: dense_attention(a, b_, c, causal=causal))
    _sync(mesh.device)
    t0 = time.perf_counter()
    out = fn(ql, kl, vl)
    _sync(mesh.device)
    res = {"seconds": time.perf_counter() - t0}
    if job.get("ret"):
        res["out"] = _np(out)
    if job.get("check"):
        want = shard_batch(dense_attention(q, k, v, causal=causal), spec,
                           mesh)
        res["err"] = _err(out, want)
    return res


def _mlp(job: dict, mesh: Mesh, inp: _Inputs) -> dict:
    d, f, B, S = job["d_model"], job["d_ff"], job["batch"], job["seq"]
    if inp.npz is not None:
        params = {k: inp.get(k, ()) for k in ("w1", "w2")}
    else:
        params = init_params(inp.gen, d, f)
    x, y = inp.get("x", (B, S, d)), inp.get("y", (B, S, d))
    step = make_train_step(mesh, lr=job.get("lr", 0.1))
    local = shard_params(params, MLP_SPECS, mesh)
    _sync(mesh.device)
    t0 = time.perf_counter()
    new, loss = step(local, shard_batch(x, ("dp",), mesh),
                     shard_batch(y, ("dp",), mesh))
    _sync(mesh.device)
    res = {"seconds": time.perf_counter() - t0, "loss": float(loss)}
    if job.get("ret"):
        res["params"] = {k: _np(v) for k, v in new.items()}
    if job.get("check"):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        rl = torch.mean((torch.relu(x @ p["w1"]) @ p["w2"] - y) ** 2)
        grads = torch.autograd.grad(rl, [p[k] for k in p])
        want = shard_params({k: (params[k] - job.get("lr", 0.1) * g)
                             for k, g in zip(p, grads)}, MLP_SPECS, mesh)
        res["err"] = max(_err(new[k], want[k]) for k in new)
        res["loss_err"] = abs(float(loss) - float(rl))
    return res


def _block_reference(p: dict, x: torch.Tensor, n_heads: int, d_head: int,
                     causal: bool) -> torch.Tensor:
    b, s, _ = x.shape

    def heads(t):
        return t.reshape(b, s, n_heads, d_head).transpose(1, 2)

    a = dense_attention(heads(x @ p["wq"]), heads(x @ p["wk"]),
                        heads(x @ p["wv"]), causal=causal)
    a = a.transpose(1, 2).reshape(b, s, n_heads * d_head)
    x = x + a @ p["wo"]
    return x + torch.relu(x @ p["w1"]) @ p["w2"]


def _transformer(job: dict, mesh: Mesh, inp: _Inputs) -> dict:
    d, H, dh, f = job["d_model"], job["n_heads"], job["d_head"], job["d_ff"]
    B, S = job["batch"], job["seq"]
    lr, causal = job.get("lr", 0.1), bool(job.get("causal", True))
    names = ("wq", "wk", "wv", "wo", "w1", "w2")
    if inp.npz is not None:
        params = {k: inp.get(k, ()) for k in names}
    else:
        params = init_transformer_params(inp.gen, d, H, dh, f)
    x = inp.get("x", (B, S, d))
    y = inp.get("y", (B, S, d)) if job.get("target") != "half_x" else x * 0.5
    specs = transformer_param_specs()
    step = make_transformer_train_step(mesh, H, dh, lr=lr, causal=causal)
    local = shard_params(params, specs, mesh)
    xl = shard_batch(x, ("dp", "sp", None), mesh)
    yl = shard_batch(y, ("dp", "sp", None), mesh)
    losses, seconds, first = [], [], None
    for _ in range(int(job.get("steps", 1))):
        _sync(mesh.device)
        t0 = time.perf_counter()
        local, loss = step(local, xl, yl)
        _sync(mesh.device)
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if first is None:
            first = local
    res = {"seconds": sum(seconds), "step_seconds": seconds,
           "losses": losses}
    if job.get("ret"):
        res["params"] = {k: _np(v) for k, v in first.items()}
    if job.get("check"):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        rl = torch.mean((_block_reference(p, x, H, dh, causal) - y) ** 2)
        grads = torch.autograd.grad(rl, [p[k] for k in p])
        want = shard_params({k: (params[k] - lr * g).detach()
                             for k, g in zip(p, grads)}, specs, mesh)
        res["err"] = max(_err(first[k], want[k]) for k in first)
        res["loss_err"] = abs(losses[0] - float(rl))
        del p, grads, want, rl
    return res


def _pipeline(job: dict, mesh: Mesh, inp: _Inputs) -> dict:
    S, M, nb, d = job["stages"], job["micro"], job["nb"], job["d"]
    w = inp.get("w", (S, d, d), scale=float(job.get("w_scale", 0.3)))
    xs = inp.get("xs", (M, nb, d))
    act = torch.tanh if job.get("act", "tanh") == "tanh" else torch.relu

    def stage_fn(wl, x):
        return act(x @ wl)

    run = make_pipeline_step(mesh, stage_fn, S, M)
    wl = w[mesh.index("pp")].contiguous()
    _sync(mesh.device)
    t0 = time.perf_counter()
    ys = run(wl, xs)
    _sync(mesh.device)
    res = {"seconds": time.perf_counter() - t0}
    if job.get("ret"):
        res["out"] = _np(ys)
    if job.get("check"):
        want = xs
        for s in range(S):
            want = stage_fn(w[s], want)
        res["err"] = _err(ys, want)
    return res


def _moe(job: dict, mesh: Mesh, inp: _Inputs) -> dict:
    T, d, E = job["tokens"], job["d"], job["experts"]
    x = inp.get("x", (T, d))
    wg = inp.get("wg", (d, E))
    we = inp.get("we", (E, d, d), scale=float(job.get("we_scale", 1.0)))
    e_loc = E // mesh.size("ep")
    e0 = mesh.index("ep") * e_loc
    step = make_moe_step(mesh)
    _sync(mesh.device)
    t0 = time.perf_counter()
    y = step(x, wg, we[e0:e0 + e_loc].contiguous())
    _sync(mesh.device)
    res = {"seconds": time.perf_counter() - t0}
    if job.get("ret"):
        res["out"] = _np(y)
    if job.get("check"):
        res["err"] = _err(y, reference_moe(x, wg, we))
    return res


_KINDS = {"ring": _attention, "ulysses": _attention, "mlp": _mlp,
          "transformer": _transformer, "pipeline": _pipeline, "moe": _moe}


def mesh_body(ctx: Any, rank: int, nranks: int) -> list[dict]:
    """Run every job of ``PARSEC_PAR_SPEC`` on this rank; returns one
    result dict a job."""
    jobs = json.loads(os.environ["PARSEC_PAR_SPEC"])
    name = os.environ.get("PARSEC_MP_DEVICE") or None
    dev = torch.device(name) if name else \
        torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = []
    for job in jobs:
        mesh = Mesh(job["mesh"], device=dev)
        res = _KINDS[job["kind"]](job, mesh, _Inputs(job, dev))
        res.update(mesh.stats(), coords=mesh.coords, kind=job["kind"])
        out.append(res)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out

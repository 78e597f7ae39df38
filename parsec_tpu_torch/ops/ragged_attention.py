"""Ragged paged attention: the LLM decode task bodies and their
hand-written Hopper kernel.

Port of ``parsec_tpu/ops/ragged_attention.py``.  The kernel,
``csrc/ragged_attn.cu`` (K2), is the port of the TPU kernel
``build_pallas_page_update`` (``parsec_tpu/ops/ragged_attention.py:448``):
the per-page online-softmax update at the heart of the decode ATTN class.

The accumulator tile is ``(H, D+2)``: columns ``[:D]`` the unnormalized
weighted value sum, ``[D]`` the running max, ``[D+1]`` the running
softmax denominator; ``l == 0`` is the empty accumulator, so zeroed NEW
tiles work unchanged.  A page is ``(3, P, H, D)``: K, V, and the fill
count at ``page[2, 0, 0, 0]``.

- :func:`attn_page_update` ``(q3, page, acc) -> acc'``: one task, or a
  strided batch with a leading dimension.  On a CUDA tensor it launches
  K2 (``attn_page_update.launches`` counts launches) or raises; on a CPU
  tensor it takes :func:`attn_page_update_plain`.
- :func:`attn_page_update_tiles` ``(qs, pages, accs) -> [acc', ...]``: the
  same kernel over lists of tiles in ONE launch that reads each tile
  where it lies (a device array of tile pointers), each result in storage
  of its own.  It is the batched ``"ragged_attn_page"`` body the device
  module hands its fused batches to.
- :func:`finalize_acc`, :func:`attn_out`, :func:`sample_step` and the
  prefill copy: the OUT, SAMPLE and PF bodies.  The JAX package computes
  them in jnp, not in Pallas, so here they are PyTorch ops that run on
  whatever device their tiles are on.  They are masked like the jnp twins
  (the fill and the sampled token index with tensors), so a task body
  never reads a value back to the host.  Their batched forms stack the
  batch, compute once, and give every output tile storage of its own.
- :func:`ragged_attention_reference`: the dense float64 oracle.
- The ``"cuda"`` and ``"cpu"`` incarnations of ``ragged_attn_page``,
  ``ragged_attn_out``, ``llm_sample`` and ``llm_prefill_copy``.

Left out: the speculative bodies (verify, batched spec attention and
verify), the numpy bodies (the plain versions take their place on the
CPU) and the ``llm_use_pallas`` switch (the device body is always K2).
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Sequence

import torch

from ..device.kernels import register_kernel
from ..ptg.lowering import register_traceable

NEG_INF = -1e30          # finite sentinel: exp(x - m) underflows to 0.0

_PAGE_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535       # gridDim.y
_MAX_D = 1024            # threads of one block
_MAX_SMEM_FLOATS = 12 * 1024   # query row + scores in 48 KiB of shared memory


# ---------------------------------------------------------------------------
# plain PyTorch versions (any leading batch dimensions)
# ---------------------------------------------------------------------------

def attn_page_update_plain(q3: torch.Tensor, page: torch.Tensor,
                           acc: torch.Tensor) -> torch.Tensor:
    """Online-softmax update of a query against one KV page: K2's plain
    version, masked like ``_page_update_jnp``.  ``q3 (..., 3, H, D)``,
    ``page (..., 3, P, H, D)``, ``acc (..., H, D+2)`` -> fp32 acc."""
    D = acc.shape[-1] - 2
    P = page.shape[-3]
    q = q3[..., 0, :, :].float()
    k = page[..., 0, :, :, :].float()
    v = page[..., 1, :, :, :].float()
    fill = page[..., 2, 0, 0, 0].float()
    acc = acc.float()
    scores = (k * q.unsqueeze(-3)).sum(-1) / math.sqrt(D)      # (..., P, H)
    slots = torch.arange(P, device=page.device)
    valid = (slots < fill.unsqueeze(-1)).unsqueeze(-1)         # (..., P, 1)
    scores = torch.where(valid, scores, NEG_INF)
    l_prev = acc[..., D + 1]
    m_prev = torch.where(l_prev > 0, acc[..., D], NEG_INF)
    m_new = torch.maximum(m_prev, scores.amax(-2))
    w = torch.where(valid, torch.exp(scores - m_new.unsqueeze(-2)), 0.0)
    alpha = torch.exp(m_prev - m_new)
    o = acc[..., :D] * alpha.unsqueeze(-1) + (w.unsqueeze(-1) * v).sum(-3)
    return torch.cat([o, m_new.unsqueeze(-1),
                      (l_prev * alpha + w.sum(-2)).unsqueeze(-1)], dim=-1)


def finalize_acc(acc: torch.Tensor) -> torch.Tensor:
    """Normalize the flash state to the attention output ``(..., H, D)``;
    an empty cache (``l == 0``) yields zeros, not NaN."""
    D = acc.shape[-1] - 2
    acc = acc.float()
    l = acc[..., D + 1]
    return torch.where((l > 0).unsqueeze(-1),
                       acc[..., :D] / torch.clamp(l, min=1e-30).unsqueeze(-1),
                       0.0)


def attn_out(acc: torch.Tensor, q3: torch.Tensor,
             page: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode epilog: finalize the attention output and append the
    query token's k/v into the tail page at its fill slot.  Returns
    ``(new_page, o)``; the new page is a fresh tensor.  The slot is
    chosen by a mask, as ``.at[fill].set`` does in the jnp twin: a fill
    past the page writes nothing."""
    o = finalize_acc(acc)
    P = page.shape[-3]
    fill = page[..., 2, 0, 0, 0].to(torch.int64)
    at = torch.arange(P, device=page.device) == fill.unsqueeze(-1)
    at = at[..., :, None, None]                                 # (..., P, 1, 1)
    k = torch.where(at, q3[..., 1, :, :].unsqueeze(-3).to(page.dtype),
                    page[..., 0, :, :, :])
    v = torch.where(at, q3[..., 2, :, :].unsqueeze(-3).to(page.dtype),
                    page[..., 1, :, :, :])
    meta = page[..., 2, :, :, :].clone()
    meta[..., 0, 0, 0] = (fill + 1).to(page.dtype)
    return torch.stack([k, v, meta], dim=-4), o


def sample_step(o: torch.Tensor, tok_prev: torch.Tensor,
                q3t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The in-graph SAMPLE body: greedy argmax of ``o . E^T`` plus the
    next step's query stack, predicated on the token chain.

    ``o (..., H, D)``; ``tok_prev (..., 3)`` the ``[token, done, eos]``
    chain tile (``eos < 0`` disables EOS); ``q3t`` the ``(V, 3, H, D)``
    q/k/v stack table, shared by the batch, or one per task
    ``(..., V, 3, H, D)``.  A finished stream holds its token.  Returns
    ``(tok_tile (..., 3), q3_next (..., 3, H, D))``, fp32."""
    V = q3t.shape[-4]
    E = q3t.select(-3, 0).float().flatten(-2)                   # (.., V, HD)
    logits = (E * o.float().flatten(-2).unsqueeze(-2)).sum(-1)  # (..., V)
    samp = logits.argmax(-1).float()
    tp = tok_prev.float()
    done_p = tp[..., 1] > 0.5
    eos = tp[..., 2]
    tok = torch.where(done_p, tp[..., 0], samp)
    done = torch.where(done_p | ((eos >= 0.0) & (tok == eos)), 1.0, 0.0)
    idx = tok.to(torch.int64) % V
    if q3t.dim() == 4:
        qn = q3t.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, *q3t.shape[1:])
    else:
        flat = q3t.reshape(-1, *q3t.shape[-4:])
        qn = flat[torch.arange(flat.shape[0], device=flat.device),
                  idx.reshape(-1)].reshape(*idx.shape, *q3t.shape[-3:])
    return torch.stack([tok, done, eos], dim=-1), qn.float()


def ragged_attention_reference(q: torch.Tensor, ks: torch.Tensor,
                               vs: torch.Tensor) -> torch.Tensor:
    """Dense single-shot oracle in float64: ``softmax(q.K/sqrt(D)).V``
    over an unpaginated cache ``ks, vs (n, H, D)``, cast to fp32 — what
    the paged online-softmax chain must equal."""
    q = torch.as_tensor(q).double()
    if len(ks) == 0:
        return torch.zeros(q.shape, dtype=torch.float32)
    ks = torch.as_tensor(ks).double()
    vs = torch.as_tensor(vs).double()
    scores = torch.einsum("nhd,hd->nh", ks, q) / math.sqrt(q.shape[-1])
    scores = scores - scores.amax(0, keepdim=True)
    w = torch.exp(scores)
    w = w / w.sum(0, keepdim=True)
    return torch.einsum("nh,nhd->hd", w, vs).float()


# ---------------------------------------------------------------------------
# K2: the hand-written kernel behind attn_page_update
# ---------------------------------------------------------------------------

def _check(q3: torch.Tensor, page: torch.Tensor,
           acc: torch.Tensor) -> tuple[int, int, int, int]:
    """Validate what K2 takes; return (batch, P, H, D)."""
    ts = (q3, page, acc)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("ragged_attn: operands must be torch tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"ragged_attn: operands on different devices "
                         f"{[str(t.device) for t in ts]}")
    lead = q3.dim() - 3
    if lead not in (0, 1) or page.dim() != lead + 4 or acc.dim() != lead + 2:
        raise ValueError(f"ragged_attn: want q3 (3,H,D), page (3,P,H,D), "
                         f"acc (H,D+2), optionally batched; got "
                         f"{[tuple(t.shape) for t in ts]}")
    batch = q3.shape[0] if lead else 1
    _, H, D = q3.shape[lead:]
    P = page.shape[lead + 1]
    if tuple(page.shape[lead:]) != (3, P, H, D) \
            or tuple(acc.shape[lead:]) != (H, D + 2) \
            or q3.shape[lead] != 3 \
            or (lead and not page.shape[0] == acc.shape[0] == batch):
        raise ValueError(f"ragged_attn: shapes do not match: "
                         f"{[tuple(t.shape) for t in ts]}")
    if q3.dtype != torch.float32 or acc.dtype != torch.float32 \
            or page.dtype not in _PAGE_DTYPE_CODE:
        raise TypeError(f"ragged_attn: want fp32 q3 and acc, fp32 or bf16 "
                        f"page; got {q3.dtype}, {page.dtype}, {acc.dtype}")
    if batch < 1 or batch > _MAX_BATCH or P < 1 or H < 1 \
            or not 1 <= D <= _MAX_D or D + P > _MAX_SMEM_FLOATS:
        raise ValueError(f"ragged_attn: batch={batch} P={P} H={H} D={D} "
                         f"outside the kernel's range")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("ragged_attn: operands must be contiguous")
    return batch, P, H, D


def _launch(q3: torch.Tensor, page: torch.Tensor, acc: torch.Tensor,
            out: torch.Tensor, batch: int, P: int, H: int, D: int,
            ptrs: torch.Tensor | None = None) -> None:
    """One K2 launch on the current stream.  With ``ptrs`` (a device
    int64 array of 4*batch tile pointers: q3 tiles, then pages, accs,
    outs) the batch is read through it and the tensors give only the
    page dtype and the device."""
    if q3.device.type != "cuda":
        raise ValueError(f"ragged_attn: no kernel for device {q3.device}")
    from ._build import load
    lib = load("ragged_attn")
    fn = lib.parsec_ragged_attn_page
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        if ptrs is None:
            bufs = (q3.data_ptr(), page.data_ptr(), acc.data_ptr(),
                    out.data_ptr(), None)
        else:
            bufs = (None, None, None, None, ptrs.data_ptr())
        rc = fn(*bufs, batch, P, H, D, _PAGE_DTYPE_CODE[page.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ragged_attn: kernel launch failed (cudaError "
                           f"{rc}) at batch={batch} P={P} H={H} D={D} "
                           f"page {page.dtype}")


def attn_page_update(q3: torch.Tensor, page: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """One page's online-softmax update of ``acc`` (a new fp32 tensor;
    no input is modified).  One task, or a strided batch along a
    leading dimension."""
    batch, P, H, D = _check(q3, page, acc)
    if q3.device.type == "cpu":
        return attn_page_update_plain(q3, page, acc)
    out = torch.empty_like(acc)
    _launch(q3, page, acc, out, batch, P, H, D)
    attn_page_update.launches += 1
    return out


attn_page_update.launches = 0


def attn_page_update_tiles(qs: Sequence[torch.Tensor],
                           pages: Sequence[torch.Tensor],
                           accs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``[attn_page_update(q, page, acc) for each task]`` in ONE K2
    launch over lists of tiles.  Each result is a new tile with storage of
    its own.  The tiles of a list must share the first tile's shape,
    dtype and device, and be contiguous; only the first tiles are
    checked, since the device module's batched dispatch already checks
    that a batch's shapes and dtypes agree, and its tiles are contiguous
    tiles of its card."""
    if not (len(qs) == len(pages) == len(accs)) or not qs:
        raise ValueError(f"ragged_attn: tile lists of lengths {len(qs)}, "
                         f"{len(pages)}, {len(accs)}")
    q0, p0, a0 = qs[0], pages[0], accs[0]
    _, P, H, D = _check(q0, p0, a0)
    if q0.dim() != 3:
        raise ValueError("ragged_attn: tile lists hold unbatched tiles")
    if q0.device.type == "cpu":
        return [attn_page_update_plain(q, p, a)
                for q, p, a in zip(qs, pages, accs)]
    batch = len(qs)
    if batch > _MAX_BATCH:
        raise ValueError(f"ragged_attn: {batch} tiles in one launch, at "
                         f"most {_MAX_BATCH}")
    outs = [torch.empty_like(a) for a in accs]
    host = torch.tensor([t.data_ptr() for col in (qs, pages, accs, outs)
                         for t in col], dtype=torch.int64, pin_memory=True)
    ptrs = host.to(q0.device, non_blocking=True)
    _launch(q0, p0, a0, outs[0], batch, P, H, D, ptrs=ptrs)
    attn_page_update.launches += 1
    return outs


# ---------------------------------------------------------------------------
# batched bodies of the PyTorch-op classes
# ---------------------------------------------------------------------------

def _owned(x: torch.Tensor) -> list[torch.Tensor]:
    """Split a stacked batch into tiles with storage of their own (one
    fused multi-tensor copy, not one copy per tile), so the device tile
    cache frees each tile's memory when it evicts it."""
    outs = [torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
            for _ in range(x.shape[0])]
    torch._foreach_copy_(outs, list(x.unbind(0)))
    return outs


def attn_out_tiles(accs: Sequence[torch.Tensor], qs: Sequence[torch.Tensor],
                   pages: Sequence[torch.Tensor],
                   os_: Sequence[torch.Tensor]
                   ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The batched OUT body (flows ACC, Q, KVW, O): new pages and outputs.
    The O flow's scratch tiles are write-only and unused."""
    del os_
    new_pages, o = attn_out(torch.stack(list(accs)), torch.stack(list(qs)),
                            torch.stack(list(pages)))
    return _owned(new_pages), _owned(o)


def sample_tiles(os_: Sequence[torch.Tensor], toks: Sequence[torch.Tensor],
                 embs: Sequence[torch.Tensor], qns: Sequence[torch.Tensor]
                 ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The batched SAMPLE body (flows O, TOK, EMB, QN): new token tiles
    and next queries.  Every task of a pool reads the one ``EMB(0,)``
    table; tasks with tables of their own gather from each."""
    del qns
    e0 = embs[0]
    table = e0 if all(e is e0 for e in embs) else torch.stack(list(embs))
    tok, qn = sample_step(torch.stack(list(os_)), torch.stack(list(toks)),
                          table)
    return _owned(tok), _owned(qn)


def prefill_copy_tiles(chunks: Sequence[torch.Tensor],
                       pages: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The batched PF body (flows T, KV): each page's new contents are a
    copy of its prompt chunk."""
    del pages
    return _owned(torch.stack(list(chunks)))


register_traceable("ragged_attn_page", attn_page_update_tiles)
register_traceable("ragged_attn_out", attn_out_tiles)
register_traceable("llm_sample", sample_tiles)
register_traceable("llm_prefill_copy", prefill_copy_tiles)


# ---------------------------------------------------------------------------
# per-task incarnations: (es, task, device) on the "cuda" device type, run
# on the card or, under init_cuda_devices(device="cpu"), on the host;
# (es, task) on "cpu".  Flow order follows llm/decode.py.
# ---------------------------------------------------------------------------

def _page_body(es: Any, task: Any, device: Any = None) -> Any:
    """ATTN(Q, KV, ACC): ACC folds in one page."""
    acc = task.data[2]
    acc.value = attn_page_update(task.data[0].value, task.data[1].value,
                                 acc.value)
    acc.version += 1
    return acc.value


def _out_body(es: Any, task: Any, device: Any = None) -> Any:
    """OUT(ACC, Q, KVW, O): finalize into O, append q's k/v to KVW."""
    kvw, o = task.data[2], task.data[3]
    kvw.value, o.value = attn_out(task.data[0].value, task.data[1].value,
                                  kvw.value)
    kvw.version += 1
    o.version += 1
    return o.value


def _sample_body(es: Any, task: Any, device: Any = None) -> Any:
    """SAMPLE(O, TOK, EMB, QN): the next token and its query stack."""
    tok, qn = task.data[1], task.data[3]
    tok.value, qn.value = sample_step(task.data[0].value, tok.value,
                                      task.data[2].value)
    tok.version += 1
    qn.version += 1
    return tok.value


def _prefill_body(es: Any, task: Any, device: Any = None) -> Any:
    """PF(T, KV): the page becomes a copy of the prompt chunk."""
    kvw = task.data[1]
    kvw.value = task.data[0].value.clone()
    kvw.version += 1
    return kvw.value


for _name, _body in (("ragged_attn_page", _page_body),
                     ("ragged_attn_out", _out_body),
                     ("llm_sample", _sample_body),
                     ("llm_prefill_copy", _prefill_body)):
    register_kernel(_name, "cuda", _body)
    register_kernel(_name, "cpu", _body)

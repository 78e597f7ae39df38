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
  where it lies, each result in storage of its own.
- :func:`attn_page_update_` and :func:`attn_page_update_tiles_`: the same,
  written into the given ``acc`` tiles (PyTorch's trailing-underscore
  idiom).  They are the ATTN class's per-task body and the batched body
  the device module hands its fused batches to.  Up to 64 tasks a launch
  (``device_cuda_batch_max``) the tile pointers travel in the kernel's
  parameters, so a launch makes no tensor, no pinned buffer and no H2D:
  it reads each tile's address and makes one ctypes call.

  Updating ACC in place is safe because the ACC flow is RW and each of its
  versions has exactly one consumer, ``ATTN(p+1)`` or ``OUT``
  (``llm/decode.py``): no task reads a version after the update.  A NEW
  ACC tile lands on the card by an H2D into a tensor of its own, and the
  device module's host stand-in gives every tile a task writes a tensor
  of its own too (``CUDADevice._own_written``), so an in-place write never
  shows through a host copy that holds an older version.  The JAX package
  has no in-place form: its arrays are immutable.
- :func:`finalize_acc`, :func:`attn_out`, :func:`sample_step` and the
  prefill copy: the OUT, SAMPLE and PF bodies.  The JAX package computes
  them in jnp, not in Pallas, so here they are PyTorch ops that run on
  whatever device their tiles are on.  They are masked like the jnp twins
  (the fill and the sampled token index with tensors), so a task body
  never reads a value back to the host.  Their batched forms stack the
  batch, compute once, and give every output tile storage of its own.
- :func:`verify_step`, :func:`spec_attn_page` and :func:`spec_verify`:
  the speculative bodies (VERIFY of the per-position spec superpool,
  SATTN and SVERIFY of the batched one).  The JAX package computes them
  in XLA, outside any Pallas kernel, so they are PyTorch ops too, in the
  branchless form of its jnp twins (masks, ``cumprod``, ``cumsum``): no
  Python loop over positions and no value read back to the host, which
  on the card would be a synchronization per body.  None is a port of a
  TPU kernel and none calls a library attention kernel.
- :func:`ragged_attention_reference`: the dense float64 oracle.
- The ``"cuda"`` and ``"cpu"`` incarnations of ``ragged_attn_page``,
  ``ragged_attn_out``, ``llm_sample``, ``llm_verify``, ``llm_spec_attn``,
  ``llm_spec_verify`` and ``llm_prefill_copy``.

Left out: the numpy bodies (the plain versions take their place on the
CPU) and the ``llm_use_pallas`` switch (the device body is always K2).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Any, Sequence

import torch

from ..device.kernels import register_kernel
from ..ptg.lowering import register_traceable

NEG_INF = -1e30          # finite sentinel: exp(x - m) underflows to 0.0

_PAGE_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535       # gridDim.y


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
    samp = _logits(o, q3t).argmax(-1).float()
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


def _logits(o: torch.Tensor, q3t: torch.Tensor,
            rows: bool = False) -> torch.Tensor:
    """fp32 logits of ``o (..., H, D)``, or with ``rows`` of every
    position of ``o (..., S, H, D)``, against the embedding channel of a
    ``(V, 3, H, D)`` table shared by the batch or one table a task
    ``(..., V, 3, H, D)``: ``(..., V)`` or ``(..., S, V)``."""
    E = q3t.select(-3, 0).float().flatten(-2)                   # (.., V, HD)
    if rows:
        return o.float().flatten(-2) @ E.transpose(-1, -2)
    return (E * o.float().flatten(-2).unsqueeze(-2)).sum(-1)


def verify_step(o: torch.Tensor, st_prev: torch.Tensor, dtok: torch.Tensor,
                q3t: torch.Tensor) -> torch.Tensor:
    """The in-graph VERIFY body: one speculative position's accept or
    reject, threading the ``(4,)`` state ``[token, live, done, eos]``.
    Position t's query (draft token ``dtok``) was right iff the previous
    position emitted it; a live position emits the target's token, a
    dead one holds the prior state, so an EOS in a rejected branch never
    finishes the stream.  ``o (..., H, D)``, ``st_prev (..., 4)``,
    ``dtok (..., 1)``; fp32 ``(..., 4)``."""
    st = st_prev.float()
    tok_prev, eos = st[..., 0], st[..., 3]
    alive = (st[..., 1] > 0.5) & ~(st[..., 2] > 0.5) \
        & (tok_prev == dtok.float()[..., 0])
    samp = _logits(o, q3t).argmax(-1).float()
    tok = torch.where(alive, samp, tok_prev)
    done = torch.where(torch.where(alive, (eos >= 0.0) & (samp == eos),
                                   st[..., 2] > 0.5), 1.0, 0.0)
    live = torch.where(alive, 1.0, 0.0)
    return torch.stack([tok, live, done, eos], dim=-1)


def spec_attn_page(qs: torch.Tensor, page: torch.Tensor, lim: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """The batched speculative page update (SATTN): every draft
    position's query against one KV page at once, with per-position
    causal limits.  ``qs (..., S, 3, H, D)`` (channel 0 of row t is
    position t's query; padded rows are zeros), ``page (..., 3, P, H,
    D)``, ``lim (..., S)`` position t's valid slots on this page (0 for
    padded rows), ``acc (..., S, H, D+2)``; a new fp32 acc."""
    D = acc.shape[-1] - 2
    P = page.shape[-3]
    q = qs.select(-3, 0).float()                               # (.., S, H, D)
    k = page.select(-4, 0).float()                             # (.., P, H, D)
    v = page.select(-4, 1).float()
    acc = acc.float()
    scores = torch.einsum("...phd,...shd->...sph", k, q) / math.sqrt(D)
    valid = (torch.arange(P, device=page.device)
             < lim.float().unsqueeze(-1)).unsqueeze(-1)         # (.., S, P, 1)
    scores = torch.where(valid, scores, NEG_INF)
    l_prev = acc[..., D + 1]                                   # (.., S, H)
    m_prev = torch.where(l_prev > 0, acc[..., D], NEG_INF)
    m_new = torch.maximum(m_prev, scores.amax(-2))
    w = torch.where(valid, torch.exp(scores - m_new.unsqueeze(-2)), 0.0)
    alpha = torch.exp(m_prev - m_new)
    o = acc[..., :D] * alpha.unsqueeze(-1) \
        + torch.einsum("...sph,...phd->...shd", w, v)
    return torch.cat([o, m_new.unsqueeze(-1),
                      (l_prev * alpha + w.sum(-2)).unsqueeze(-1)], dim=-1)


def spec_verify(acc: torch.Tensor, dtoks: torch.Tensor,
                q3t: torch.Tensor) -> torch.Tensor:
    """The batched VERIFY epilog (SVERIFY): finalize every position,
    sample the target's token per position and emit the accepted prefix.
    ``acc (..., S, H, D+2)``; ``dtoks (..., S+2)`` ``[n, eos, chain_0 ..
    chain_{S-1}]`` with ``chain_0`` the real current token.  The emitted
    set is always a prefix (acceptance is a running AND, a live EOS ends
    it), so compaction is a mask.  Returns fp32 ``(..., S+2)`` ``[n_emit,
    done, tok_0 .. tok_{n_emit-1}, 0 pad]``."""
    S = acc.shape[-3]
    dt = dtoks.float()
    n, eos = dt[..., 0:1], dt[..., 1:2]
    chain = dt[..., 2:2 + S]
    tgt = _logits(finalize_acc(acc), q3t, rows=True).argmax(-1).float()
    idx = torch.arange(S, device=acc.device)
    prev_tgt = torch.cat([chain[..., :1], tgt[..., :-1]], dim=-1)
    match = (chain == prev_tgt) & (idx < n)
    live = torch.cumprod(match.to(torch.int32), dim=-1) > 0
    is_eos = live & (eos >= 0.0) & (tgt == eos)
    eos_i = is_eos.to(torch.int32)
    emit = live & ((torch.cumsum(eos_i, dim=-1) - eos_i) == 0)
    m = emit.sum(-1, keepdim=True).float()
    done = torch.where(is_eos.any(-1, keepdim=True), 1.0, 0.0)
    return torch.cat([m, done, torch.where(emit, tgt, 0.0)], dim=-1)


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

_MAX_BYVAL = 64               # tasks whose tile pointers ride by value
# one block's staged K and V: small blocks keep many resident on an SM and
# spread a few tasks over the SMs (the budget that measured best at 1024
# Llama-2-7B pages in fp32, ``scripts/k2_compare.py --kv-bytes``)
_KV_SMEM_BYTES = 16 * 1024
_SMEM_OPTIN = 227 * 1024      # one block's shared memory on an H100


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(hg: int, cs: int, D: int, esize: int) -> int:
    """Shared memory of one K2 block of ``hg`` heads staging ``cs`` slots
    (``layout`` in ``csrc/ragged_attn.cu``): K and V rows, query rows, the
    running state, the chunk's weights, each head's alpha."""
    return (2 * cs * _round16(hg * D * esize) + _round16(hg * D * 4)
            + _round16(hg * (D + 2) * 4) + _round16(hg * cs * 4)
            + _round16(hg * 4))


@functools.lru_cache(maxsize=None)
def plan(P: int, H: int, D: int, esize: int) -> tuple[int, int]:
    """K2's blocking ``(hg, cs)`` for pages ``(3, P, H, D)`` of
    ``esize``-byte elements: ``hg`` heads a block, ``cs`` slots staged a
    chunk.  A block takes as many heads as keep a whole page's K and V of
    them within ``_KV_SMEM_BYTES`` of shared memory, balanced over the
    groups; where one head's page does not fit, it takes one head and
    walks the filled slots in chunks of ``cs``."""
    def staged(hg: int, cs: int) -> int:
        return 2 * cs * _round16(hg * D * esize)

    if staged(1, P) <= _KV_SMEM_BYTES:
        hg = max(h for h in range(1, H + 1)
                 if staged(h, P) <= _KV_SMEM_BYTES)
        groups = -(-H // hg)
        return -(-H // groups), P
    return 1, max(1, min(P, _KV_SMEM_BYTES // staged(1, 1)))


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
    esize = page.element_size()
    if batch < 1 or batch > _MAX_BATCH or P < 1 or H < 1 or D < 1 \
            or smem_bytes(*plan(P, H, D, esize), D, esize) > _SMEM_OPTIN:
        raise ValueError(f"ragged_attn: batch={batch} P={P} H={H} D={D} "
                         f"outside the kernel's range")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("ragged_attn: operands must be contiguous")
    return batch, P, H, D


@functools.cache
def _entry() -> Any:
    """K2's C entry point, built at first use and bound once."""
    from ._build import load
    fn = load("ragged_attn").parsec_ragged_attn_page
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return fn


_tls = threading.local()


def _host_ptrs() -> Any:
    """This thread's host array for the pointers of a by-value batch,
    made once: the C entry copies it into the launch's parameters."""
    buf = getattr(_tls, "ptrs", None)
    if buf is None:
        buf = _tls.ptrs = (ctypes.c_uint64 * (4 * _MAX_BYVAL))()
    return buf


class _PointerRing:
    """Device arrays of tile pointers for batches past ``_MAX_BYVAL``, on
    one card: two pinned host + device buffer pairs, used in turn.  A
    pair is refilled only once the event recorded behind its last launch
    has passed, so neither that launch's H2D nor its kernel still reads
    it; a pair grows when a batch outgrows it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pairs: list[Any] = [None, None]
        self._turn = 0

    def launch(self, ptrs: list[int], device: torch.device, stream: Any,
               call: Any) -> int:
        """Copy ``ptrs`` to the card on ``stream`` and return
        ``call(device_address)``, the launch's return code."""
        n = len(ptrs)
        with self._lock:
            i, self._turn = self._turn, self._turn ^ 1
            pair = self._pairs[i]
            if pair is None or pair[0].numel() < n:
                host = torch.empty(n, dtype=torch.int64, pin_memory=True)
                pair = self._pairs[i] = [
                    host, host.numpy(),
                    torch.empty(n, dtype=torch.int64, device=device), None]
            elif pair[3] is not None:
                pair[3].synchronize()
            host, host_np, dev, _ = pair
            host_np[:n] = ptrs
            dev[:n].copy_(host[:n], non_blocking=True)
            rc = call(dev.data_ptr())
            pair[3] = torch.cuda.Event()
            pair[3].record(stream)
            return rc


_rings: dict[int, _PointerRing] = {}


def _launch(q3: torch.Tensor, page: torch.Tensor, acc: torch.Tensor,
            out: torch.Tensor, batch: int, P: int, H: int, D: int,
            tile_ptrs: list[int] | None = None) -> None:
    """One K2 launch on the current stream of the operands' card: a
    strided batch at ``q3``, ``page``, ``acc`` and ``out`` (``out`` may be
    ``acc``), or, with ``tile_ptrs`` (4*batch tile pointers: q3 tiles,
    then pages, accs, outs), a batch of tiles where they lie; the tensors
    then give only the card and the page dtype."""
    dev = q3.device
    if dev.type != "cuda":
        raise ValueError(f"ragged_attn: no kernel for device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(q3, page, acc, out, batch, P, H, D, tile_ptrs)
    fn = _entry()
    code = _PAGE_DTYPE_CODE[page.dtype]
    hg, cs = plan(P, H, D, page.element_size())
    stream = torch.cuda.current_stream(dev)
    shape = (batch, P, H, D, code, hg, cs, stream.cuda_stream)
    if tile_ptrs is None:
        rc = fn(q3.data_ptr(), page.data_ptr(), acc.data_ptr(),
                out.data_ptr(), None, None, *shape)
    elif batch <= _MAX_BYVAL:
        buf = _host_ptrs()
        buf[:4 * batch] = tile_ptrs
        rc = fn(None, None, None, None, ctypes.addressof(buf), None, *shape)
    else:
        ring = _rings.get(dev.index)
        if ring is None:
            ring = _rings.setdefault(dev.index, _PointerRing())
        rc = ring.launch(tile_ptrs, dev, stream, lambda ptrs: fn(
            None, None, None, None, None, ptrs, *shape))
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


def attn_page_update_(q3: torch.Tensor, page: torch.Tensor,
                      acc: torch.Tensor) -> torch.Tensor:
    """:func:`attn_page_update` written into ``acc``, which it returns:
    the per-task ATTN body (a batch of one)."""
    batch, P, H, D = _check(q3, page, acc)
    if q3.device.type == "cpu":
        return acc.copy_(attn_page_update_plain(q3, page, acc))
    _launch(q3, page, acc, acc, batch, P, H, D)
    attn_page_update.launches += 1
    return acc


def _check_tiles(qs: Sequence[torch.Tensor], pages: Sequence[torch.Tensor],
                 accs: Sequence[torch.Tensor]) -> tuple[int, int, int]:
    """Validate tile lists; return (P, H, D).  The tiles of a list must
    share the first tile's shape, dtype and device, and be contiguous;
    only the first tiles are checked, since the device module's batched
    dispatch already checks that a batch's shapes and dtypes agree, and
    its tiles are contiguous tiles of its card."""
    if not (len(qs) == len(pages) == len(accs)) or not qs:
        raise ValueError(f"ragged_attn: tile lists of lengths {len(qs)}, "
                         f"{len(pages)}, {len(accs)}")
    _, P, H, D = _check(qs[0], pages[0], accs[0])
    if qs[0].dim() != 3:
        raise ValueError("ragged_attn: tile lists hold unbatched tiles")
    if len(qs) > _MAX_BATCH:
        raise ValueError(f"ragged_attn: {len(qs)} tiles in one launch, at "
                         f"most {_MAX_BATCH}")
    return P, H, D


def _launch_tiles(qs: Sequence[torch.Tensor], pages: Sequence[torch.Tensor],
                  accs: Sequence[torch.Tensor], outs: Sequence[torch.Tensor],
                  P: int, H: int, D: int) -> None:
    """One K2 launch over lists of tiles: reads each tile's address and
    makes no tensor."""
    ptr = torch.Tensor.data_ptr
    ptrs = list(map(ptr, qs))
    ptrs += map(ptr, pages)
    acc_ptrs = list(map(ptr, accs))
    ptrs += acc_ptrs
    ptrs += acc_ptrs if outs is accs else map(ptr, outs)
    _launch(qs[0], pages[0], accs[0], outs[0], len(qs), P, H, D, ptrs)
    attn_page_update.launches += 1


def attn_page_update_tiles(qs: Sequence[torch.Tensor],
                           pages: Sequence[torch.Tensor],
                           accs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``[attn_page_update(q, page, acc) for each task]`` in ONE K2
    launch over lists of tiles.  Each result is a new tile with storage of
    its own; no input is modified."""
    P, H, D = _check_tiles(qs, pages, accs)
    if qs[0].device.type == "cpu":
        return [attn_page_update_plain(q, p, a)
                for q, p, a in zip(qs, pages, accs)]
    outs = [torch.empty_like(a) for a in accs]
    _launch_tiles(qs, pages, accs, outs, P, H, D)
    return outs


def attn_page_update_tiles_(qs: Sequence[torch.Tensor],
                            pages: Sequence[torch.Tensor],
                            accs: Sequence[torch.Tensor]
                            ) -> list[torch.Tensor]:
    """:func:`attn_page_update_tiles` written into the ``accs`` tiles,
    which it returns: the batched ATTN body.  Up to 64 tiles (the device
    module's ``device_cuda_batch_max``) a launch makes no tensor, no
    pinned buffer and no H2D: the tile pointers travel in the kernel's
    parameters."""
    P, H, D = _check_tiles(qs, pages, accs)
    accs = list(accs)
    if qs[0].device.type == "cpu":
        for q, p, a in zip(qs, pages, accs):
            a.copy_(attn_page_update_plain(q, p, a))
        return accs
    _launch_tiles(qs, pages, accs, accs, P, H, D)
    return accs


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
    tok, qn = sample_step(torch.stack(list(os_)), torch.stack(list(toks)),
                          _table(embs))
    return _owned(tok), _owned(qn)


def _table(embs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every task of a pool reads the one ``EMB(0,)`` table; tasks with
    tables of their own give a stack."""
    e0 = embs[0]
    return e0 if all(e is e0 for e in embs) else torch.stack(list(embs))


def verify_tiles(os_: Sequence[torch.Tensor], sts: Sequence[torch.Tensor],
                 dtoks: Sequence[torch.Tensor],
                 embs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The batched VERIFY body (flows O, STOK, DTOK, EMB): new states."""
    return _owned(verify_step(torch.stack(list(os_)), torch.stack(list(sts)),
                              torch.stack(list(dtoks)), _table(embs)))


def spec_attn_page_tiles(qss: Sequence[torch.Tensor],
                         pages: Sequence[torch.Tensor],
                         lims: Sequence[torch.Tensor],
                         accs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The batched SATTN body (flows QS, KV, LIM, ACC): new accs."""
    return _owned(spec_attn_page(torch.stack(list(qss)),
                                 torch.stack(list(pages)),
                                 torch.stack(list(lims)),
                                 torch.stack(list(accs))))


def spec_verify_tiles(accs: Sequence[torch.Tensor],
                      dtoks: Sequence[torch.Tensor],
                      embs: Sequence[torch.Tensor],
                      vouts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The batched SVERIFY body (flows ACC, DTOKS, EMB, VOUT): each
    stream's accepted prefix.  The VOUT flow's scratch tiles are
    write-only and unused."""
    del vouts
    return _owned(spec_verify(torch.stack(list(accs)),
                              torch.stack(list(dtoks)), _table(embs)))


def prefill_copy_tiles(chunks: Sequence[torch.Tensor],
                       pages: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The batched PF body (flows T, KV): each page's new contents are a
    copy of its prompt chunk."""
    del pages
    return _owned(torch.stack(list(chunks)))


# the device module's fused ATTN dispatch runs the in-place form; the
# lowering's steps keep the functional one
register_traceable("ragged_attn_page", attn_page_update_tiles,
                   inplace=attn_page_update_tiles_, libs=("ragged_attn",))
register_traceable("ragged_attn_out", attn_out_tiles)
register_traceable("llm_sample", sample_tiles)
register_traceable("llm_verify", verify_tiles)
register_traceable("llm_spec_attn", spec_attn_page_tiles)
register_traceable("llm_spec_verify", spec_verify_tiles)
register_traceable("llm_prefill_copy", prefill_copy_tiles)


# ---------------------------------------------------------------------------
# per-task incarnations: (es, task, device) on the "cuda" device type, run
# on the card or, under init_cuda_devices(device="cpu"), on the host;
# (es, task) on "cpu".  Flow order follows llm/decode.py.
# ---------------------------------------------------------------------------

def _page_body(es: Any, task: Any, device: Any = None) -> Any:
    """ATTN(Q, KV, ACC): ACC folds in one page, in place."""
    acc = task.data[2]
    acc.value = attn_page_update_(task.data[0].value, task.data[1].value,
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


def _verify_body(es: Any, task: Any, device: Any = None) -> Any:
    """VERIFY(O, STOK, DTOK, EMB): the next accept state."""
    st = task.data[1]
    st.value = verify_step(task.data[0].value, st.value, task.data[2].value,
                           task.data[3].value)
    st.version += 1
    return st.value


def _spec_attn_body(es: Any, task: Any, device: Any = None) -> Any:
    """SATTN(QS, KV, LIM, ACC): every position folds in one page."""
    acc = task.data[3]
    acc.value = spec_attn_page(task.data[0].value, task.data[1].value,
                               task.data[2].value, acc.value)
    acc.version += 1
    return acc.value


def _spec_verify_body(es: Any, task: Any, device: Any = None) -> Any:
    """SVERIFY(ACC, DTOKS, EMB, VOUT): the accepted prefix into VOUT."""
    vout = task.data[3]
    vout.value = spec_verify(task.data[0].value, task.data[1].value,
                             task.data[2].value)
    vout.version += 1
    return vout.value


def _prefill_body(es: Any, task: Any, device: Any = None) -> Any:
    """PF(T, KV): the page becomes a copy of the prompt chunk."""
    kvw = task.data[1]
    kvw.value = task.data[0].value.clone()
    kvw.version += 1
    return kvw.value


for _name, _body in (("ragged_attn_page", _page_body),
                     ("ragged_attn_out", _out_body),
                     ("llm_sample", _sample_body),
                     ("llm_verify", _verify_body),
                     ("llm_spec_attn", _spec_attn_body),
                     ("llm_spec_verify", _spec_verify_body),
                     ("llm_prefill_copy", _prefill_body)):
    register_kernel(_name, "cuda", _body)
    register_kernel(_name, "cpu", _body)

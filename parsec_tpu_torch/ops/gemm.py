"""GEMM: the tiled-GEMM task bodies and their hand-written Hopper kernel.

Port of ``parsec_tpu/ops/gemm.py``.  The kernel, ``csrc/gemm.cu``, is the
port of the TPU kernel ``matmul_pallas`` (``parsec_tpu/ops/gemm.py:66-93``),
extended to the ``C + A@B`` epilogue of the GEMM task body and to a batch
dimension for the device module's fused dispatch.

- :func:`gemm_update` ``(a, b, c) -> c + a@b``, fp32 accumulate, cast to
  ``c.dtype``; 2-D tiles or batched ``(B, m, k) x (B, k, n) + (B, m, n)``.
  fp32 A/B/C, or bf16 A/B with fp32 C.  On a CUDA tensor it launches the
  kernel (``gemm_update.launches`` counts launches) or raises; on a CPU
  tensor it takes :func:`gemm_update_plain`.
- :func:`gemm_update_tiles` ``(as_, bs, cs) -> [c + a@b, ...]``: the same
  kernel over lists of same-shaped 2-D tiles, in ONE launch that reads
  each tile where it lies (a device array of tile pointers) and writes
  each result into storage of its own.  The device module's fused
  dispatch calls it: nothing is stacked, and every output tile frees its
  memory alone when the LRU evicts it.  Its launches count on
  ``gemm_update.launches``, since it is the same kernel.
- :func:`matmul` ``(a, b) -> a@b`` in ``a.dtype``: the direct counterpart
  of ``matmul_pallas``, on the same kernel.
- :func:`gemm_chain` ``(lhs, rhs, acc0)``: the chain-collapse lowering's
  contraction ``acc0[m,n] + sum_k lhs[m,k] @ rhs[k,n]`` over tile stacks
  ``[M,K,ta,tk]``, ``[K,N,tk,tb]``, ``[M,N,ta,tb]``, relaid out to whole
  matrices and run as ONE launch (the JAX package's einsum,
  ``parsec_tpu/ptg/lowering.py:138-158``).
- The ``"gemm"`` incarnations for the ``cuda`` and ``cpu`` device types,
  and the ``"gemm"`` traceable: its list form (the device module's fused
  dispatch and the lowering), its stacked form over a leading group axis
  (:func:`gemm_update_stacked`, the wavefront pass) and its chain.

The kernel computes strict fp32 products, so every path through it,
the lowered chain included, accumulates in strict fp32; the JAX
package's ``gemm_precision`` knob has no port until the kernel has a
reduced-precision mode.  Left out: ``matmul_xla`` (the jitted XLA body has no
port of its own: :func:`gemm_update` is the body).
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from ..device.kernels import register_kernel
from ..ptg.lowering import register_traceable

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535     # gridDim.z
_INT_MAX = 2**31 - 1


def gemm_update_plain(a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``c + a@b`` in fp32, cast to
    ``c.dtype``.  What the CPU path runs, and what the card's kernel is
    held against."""
    return (c.float() + torch.matmul(a.float(), b.float())).to(c.dtype)


def _check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None,
           out_dtype: torch.dtype) -> tuple[int, int, int, int]:
    """Validate what the kernel takes; return (batch, m, n, k)."""
    ts = [a, b] if c is None else [a, b, c]
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("gemm: operands must be torch tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"gemm: operands on different devices "
                         f"{[str(t.device) for t in ts]}")
    if a.dim() not in (2, 3) or any(t.dim() != a.dim() for t in ts):
        raise ValueError(f"gemm: operands must all be 2-D or all 3-D, got "
                         f"{[tuple(t.shape) for t in ts]}")
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2 or (a.dim() == 3 and b.shape[0] != batch):
        raise ValueError(f"gemm: A {tuple(a.shape)} and B {tuple(b.shape)} "
                         f"do not chain")
    if c is not None and tuple(c.shape) != (
            (batch, m, n) if a.dim() == 3 else (m, n)):
        raise ValueError(f"gemm: C {tuple(c.shape)} does not match "
                         f"A {tuple(a.shape)} @ B {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm: A and B must share dtype float32 or bfloat16, "
                        f"got {a.dtype}, {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm: output dtype {out_dtype} not supported")
    if batch > _MAX_BATCH or max(m, n, k) > _INT_MAX:
        raise ValueError(f"gemm: shape batch={batch} m={m} n={n} k={k} "
                         f"outside the kernel's range")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("gemm: operands must be contiguous")
    if batch == 0 or m == 0 or n == 0:
        raise ValueError("gemm: empty operand")
    return batch, m, n, k


def _launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None,
            out: torch.Tensor, batch: int, m: int, n: int, k: int,
            ptrs: torch.Tensor | None = None) -> None:
    """One kernel launch on the current stream.  With ``ptrs`` (a device
    int64 array of 4*batch tile pointers: A tiles, then B, C, out) the
    batch is read through it and a/b/c/out give only dtypes and device."""
    if a.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {a.device}")
    from ._build import load
    lib = load("gemm")
    fn = lib.parsec_gemm_update
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if ptrs is None:
            bufs = (a.data_ptr(), b.data_ptr(),
                    None if c is None else c.data_ptr(), out.data_ptr(), None)
        else:
            bufs = (None, None, None, None, ptrs.data_ptr())
        rc = fn(*bufs, batch, m, n, k, _DTYPE_CODE[a.dtype],
                _DTYPE_CODE[out.dtype], 0 if c is None else 1, stream)
    if rc != 0:
        raise RuntimeError(f"gemm: kernel launch failed (cudaError {rc}) "
                           f"at batch={batch} m={m} n={n} k={k} "
                           f"{a.dtype}->{out.dtype}")


def gemm_update(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """``c + a@b`` with fp32 accumulation, cast to ``c.dtype`` (a new
    tensor; ``c`` is not modified)."""
    batch, m, n, k = _check(a, b, c, c.dtype)
    if a.device.type == "cpu":
        return gemm_update_plain(a, b, c)
    out = torch.empty_like(c)
    _launch(a, b, c, out, batch, m, n, k)
    gemm_update.launches += 1
    return out


gemm_update.launches = 0


def gemm_update_tiles(as_: list[torch.Tensor], bs: list[torch.Tensor],
                      cs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``[c + a@b for each tile triple]`` in ONE kernel launch over lists
    of 2-D tiles that share their shapes and dtypes.  Each result is a
    new tile with storage of its own; no input is modified."""
    if not (len(as_) == len(bs) == len(cs)) or not as_:
        raise ValueError(f"gemm: tile lists of lengths {len(as_)}, "
                         f"{len(bs)}, {len(cs)}")
    a0, b0, c0 = as_[0], bs[0], cs[0]
    _, m, n, k = _check(a0, b0, c0, c0.dtype)
    if a0.dim() != 2:
        raise ValueError("gemm: tile lists hold 2-D tiles")
    for col, t0 in ((as_, a0), (bs, b0), (cs, c0)):
        for t in col:
            if not isinstance(t, torch.Tensor) or t.shape != t0.shape \
                    or t.dtype != t0.dtype or t.device != t0.device \
                    or not t.is_contiguous():
                raise ValueError("gemm: the tiles of a list must share "
                                 "shape, dtype and device, and be "
                                 "contiguous")
    if a0.device.type == "cpu":
        return [gemm_update_plain(a, b, c) for a, b, c in zip(as_, bs, cs)]
    batch = len(as_)
    if batch > _MAX_BATCH:
        raise ValueError(f"gemm: {batch} tiles in one launch, at most "
                         f"{_MAX_BATCH}")
    outs = [torch.empty_like(c) for c in cs]
    host = torch.tensor([t.data_ptr() for col in (as_, bs, cs, outs)
                         for t in col], dtype=torch.int64, pin_memory=True)
    ptrs = host.to(a0.device, non_blocking=True)
    _launch(a0, b0, c0, outs[0], batch, m, n, k, ptrs=ptrs)
    gemm_update.launches += 1
    return outs


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a@b`` in ``a.dtype`` with fp32 accumulation (``matmul_pallas``)."""
    batch, m, n, k = _check(a, b, None, a.dtype)
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    out = a.new_empty((*a.shape[:-1], n))
    _launch(a, b, None, out, batch, m, n, k)
    matmul.launches += 1
    return out


matmul.launches = 0


def gemm_update_stacked(a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """``c + a@b`` over a leading group axis ``[G, ...]``, in one launch;
    a tile shared by the group arrives as a broadcast view and is made
    contiguous here."""
    return gemm_update(a.contiguous(), b.contiguous(), c.contiguous())


def gemm_chain(lhs: torch.Tensor, rhs: torch.Tensor,
               acc0: torch.Tensor) -> torch.Tensor:
    """``acc0[m,n] + sum_k lhs[m,k] @ rhs[k,n]`` over tile stacks
    ``lhs [M,K,ta,tk]``, ``rhs [K,N,tk,tb]``, ``acc0 [M,N,ta,tb]``, in
    ``acc0.dtype``.  The stacks are relaid out to ``[M*ta, K*tk]``,
    ``[K*tk, N*tb]`` and ``[M*ta, N*tb]`` and contracted in ONE launch of
    the kernel (fp32 accumulate), rather than one launch per (m, n)."""
    M, K, ta, tk = lhs.shape
    N, tb = rhs.shape[1], rhs.shape[3]
    a = lhs.permute(0, 2, 1, 3).reshape(M * ta, K * tk)
    b = rhs.permute(0, 2, 1, 3).reshape(K * tk, N * tb)
    c = acc0.permute(0, 2, 1, 3).reshape(M * ta, N * tb)
    out = gemm_update(a.contiguous(), b.contiguous(), c.contiguous())
    return out.reshape(M, ta, N, tb).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# task-body incarnations
# ---------------------------------------------------------------------------

def gemm_cuda_body(es: Any, task: Any, device: Any) -> Any:
    """Device incarnation of GEMM(m,n,k): C_tile += A_tile @ B_tile.
    Flows by position: 0=A (READ), 1=B (READ), 2=C (RW); stage-in has
    already placed the tiles on the device."""
    c_copy = task.data[2]
    c_copy.value = gemm_update(task.data[0].value, task.data[1].value,
                               c_copy.value)
    c_copy.version += 1
    return c_copy.value


def gemm_cpu_body(es: Any, task: Any) -> None:
    c_copy = task.data[2]
    c_copy.value = gemm_update_plain(task.data[0].value, task.data[1].value,
                                     c_copy.value)
    c_copy.version += 1


register_kernel("gemm", "cuda", gemm_cuda_body)
register_kernel("gemm", "cpu", gemm_cpu_body)
# the batched body: lists of A, B and C tiles -> list of new C tiles; its
# stacked form and its chain for the lowering
register_traceable("gemm", gemm_update_tiles, bilinear=True,
                   chain_combine=gemm_chain, stacked=gemm_update_stacked)

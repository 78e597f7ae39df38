"""GEMM: the tiled-GEMM task bodies and their hand-written Hopper kernel.

Port of ``parsec_tpu/ops/gemm.py``.  The kernel, ``csrc/gemm.cu`` (K1), is
the port of the TPU kernel ``matmul_pallas`` (``parsec_tpu/ops/gemm.py:
66-93``), extended to the ``C + A@B`` epilogue of the GEMM task body and
to a batch dimension for the device module's fused dispatch.

- :func:`gemm_update` ``(a, b, c) -> c + a@b``, fp32 accumulate, cast to
  ``c.dtype``; 2-D tiles or batched ``(B, m, k) x (B, k, n) + (B, m, n)``.
  fp32 or bf16 A/B, fp32 or bf16 C.  On a CUDA tensor it launches the
  kernel (``gemm_update.launches`` counts launches, and
  ``gemm_update.launches_by_variant`` the same launches by variant) or
  raises; on a CPU tensor it takes :func:`gemm_update_plain`.
- :func:`gemm_update_tiles` ``(as_, bs, cs) -> [c + a@b, ...]``: the same
  kernel over lists of same-shaped 2-D tiles, in ONE launch that reads
  each tile where it lies (a device array of tile pointers) and writes
  each result into storage of its own.  The device module's fused
  dispatch and the dense chain collapse call it: nothing is stacked, and
  every output tile frees its memory alone when the LRU evicts it.  Its
  launches count on ``gemm_update.launches``, since it is the same kernel.
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

**Precision.**  The ``gemm_precision`` knob (``default|highest``, the
JAX package's knob and environment name ``PARSEC_MCA_gemm_precision``,
with a registry of its own) is read at every call, so the dynamic body,
the lowering's chain collapse and the wavefront pass all honour it, as
the JAX package's three sites do.  It acts on CUDA tensors only:
``default`` runs fp32 inputs on TF32 tensor cores, as the JAX package's
default does on an NVIDIA GPU, and ``highest`` runs them in strict fp32.
bf16 inputs run on bf16 tensor cores under both, since bf16 products are
exact in fp32.  A CPU tensor takes :func:`gemm_update_plain` in full
fp32 under either setting, which is what the JAX package computes on the
CPU.  :func:`k1_variant` is the rule that picks the kernel's variant
before each launch.

Left out: ``matmul_xla`` (the jitted XLA body has no port of its own:
:func:`gemm_update` is the body).
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from ..core.params import params as _params
from ..device.kernels import register_kernel
from ..ptg.lowering import register_traceable

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535     # gridDim.z
_INT_MAX = 2**31 - 1

K1_VARIANTS = ("simt_fp32", "mma_tf32", "wgmma_bf16")   # csrc/gemm.cu codes
PRECISIONS = ("default", "highest")
_MAP_BYTES = 128       # one CUtensorMap

_params.register("gemm_precision", "default",
                 "matmul precision for GEMM bodies: default|highest")


def gemm_precision(precision: str | None = None) -> str:
    """``precision``, or else the ``gemm_precision`` knob as it reads
    now; raises on anything but ``default`` and ``highest``."""
    p = _params.get("gemm_precision") if precision is None else precision
    if p not in PRECISIONS:
        raise ValueError(f"gemm_precision must be one of {PRECISIONS}, "
                         f"got {p!r}")
    return p


def k1_variant(a_dtype: torch.dtype, out_dtype: torch.dtype, m: int, n: int,
               k: int, aligned: bool, precision: str) -> str:
    """The K1 variant that runs ``(m, k) @ (k, n)`` on the card.

    - ``wgmma_bf16`` for bf16 A/B whose row pitches (``k*2`` and ``n*2``
      bytes) are multiples of 16 and whose operands start on 16-byte
      boundaries (``aligned``): TMA's rule for global strides and bases.
      Under both precisions, since bf16 products are exact in fp32.
    - ``mma_tf32`` for fp32 A/B under ``default`` whose ``k`` and ``n``
      are multiples of 4, ``aligned`` (16-byte ``cp.async`` chunks).
    - ``simt_fp32`` otherwise: strict fp32, any pitch.

    Edges are masked in every variant, so ``m`` and ``out_dtype`` narrow
    no choice; they complete the shape the rule is stated over.
    """
    if a_dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"k1_variant: dtypes {a_dtype} -> {out_dtype}")
    if precision not in PRECISIONS:
        raise ValueError(f"k1_variant: precision {precision!r}")
    if a_dtype == torch.bfloat16:
        tma_ok = aligned and (2 * k) % 16 == 0 and (2 * n) % 16 == 0
        return "wgmma_bf16" if tma_ok else "simt_fp32"
    if precision == "default" and aligned and k % 4 == 0 and n % 4 == 0:
        return "mma_tf32"
    return "simt_fp32"


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 as ``cvt.rna.tf32.f32`` rounds them: to
    the nearest value with 10 stored mantissa bits, ties away from zero
    (half of the 13 dropped bits added to the magnitude, then cut);
    infinities and NaNs pass through."""
    bits = x.float().contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, (bits + 0x1000) & -0x2000,
                       bits).view(torch.float32)


def gemm_update_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      tf32: bool = False) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``c + a@b`` in fp32, cast to
    ``c.dtype``.  What the CPU path runs, and what the card's kernel is
    held against.  ``tf32=True`` first rounds fp32 A and B with
    :func:`round_tf32`, whose products are exact in fp32: the reference of
    the ``mma_tf32`` variant (run it with TF32 matmuls off).  Nothing on
    the main path passes it."""
    a, b = a.float(), b.float()
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return (c.float() + torch.matmul(a, b)).to(c.dtype)


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


def _lib() -> ctypes.CDLL:
    from ._build import load
    lib = load("gemm")
    fn = lib.parsec_gemm_update
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    enc = lib.parsec_gemm_encode_tiles
    enc.restype = ctypes.c_int
    enc.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    return lib


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {t.device}")


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None,
            out: torch.Tensor, batch: int, m: int, n: int, k: int,
            variant: str, ptrs: int | None = None,
            maps: int | None = None) -> None:
    """One kernel launch of ``variant`` on the current stream.  With
    ``ptrs`` (the device address of an int64 array of 4*batch tile
    pointers: A tiles, then B, C, out; and for ``wgmma_bf16`` ``maps``,
    the device address of their tensor maps) the batch is read through
    it and a/b/c/out give only dtypes and device."""
    fn = _lib().parsec_gemm_update
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if ptrs is None:
            bufs = (a.data_ptr(), b.data_ptr(),
                    None if c is None else c.data_ptr(), out.data_ptr(),
                    None, None)
        else:
            bufs = (None, None, None, None, ptrs, maps)
        rc = fn(*bufs, batch, m, n, k, _DTYPE_CODE[a.dtype],
                _DTYPE_CODE[out.dtype], 0 if c is None else 1,
                K1_VARIANTS.index(variant), stream)
    if rc != 0:
        raise RuntimeError(f"gemm: {variant} kernel launch failed "
                           f"(cudaError {rc}) at batch={batch} m={m} n={n} "
                           f"k={k} {a.dtype}->{out.dtype}")


def _count(variant: str) -> None:
    gemm_update.launches += 1
    gemm_update.launches_by_variant[variant] += 1


def gemm_update(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                precision: str | None = None) -> torch.Tensor:
    """``c + a@b`` with fp32 accumulation, cast to ``c.dtype`` (a new
    tensor; ``c`` is not modified).  ``precision`` (``default`` or
    ``highest``; None reads the ``gemm_precision`` knob) picks the
    kernel's variant on the card (:func:`k1_variant`): fp32 inputs run
    on TF32 tensor cores under ``default`` and in strict fp32 under
    ``highest``; bf16 inputs run on bf16 tensor cores (``wgmma``) under
    both, their products being exact in fp32."""
    precision = gemm_precision(precision)
    batch, m, n, k = _check(a, b, c, c.dtype)
    if a.device.type == "cpu":
        return gemm_update_plain(a, b, c)
    _require_cuda(a)
    out = torch.empty_like(c)
    variant = k1_variant(a.dtype, c.dtype, m, n, k, _aligned(a, b, c),
                         precision)
    _launch(a, b, c, out, batch, m, n, k, variant)
    _count(variant)
    return out


gemm_update.launches = 0
gemm_update.launches_by_variant = dict.fromkeys(K1_VARIANTS, 0)


def gemm_update_tiles(as_: list[torch.Tensor], bs: list[torch.Tensor],
                      cs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``[c + a@b for each tile triple]`` in ONE kernel launch over lists
    of 2-D tiles that share their shapes and dtypes, at the
    ``gemm_precision`` knob's setting (see :func:`gemm_update`).  Each
    result is a new tile with storage of its own; no input is modified.

    The tile pointers (and, for ``wgmma_bf16``, a pair of TMA tensor maps
    a tile, encoded here on the host) go up in one pinned host-to-device
    copy."""
    precision = gemm_precision()
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
    _require_cuda(a0)
    batch = len(as_)
    if batch > _MAX_BATCH:
        raise ValueError(f"gemm: {batch} tiles in one launch, at most "
                         f"{_MAX_BATCH}")
    ptrs = [t.data_ptr() for col in (as_, bs, cs) for t in col]
    variant = k1_variant(a0.dtype, c0.dtype, m, n, k,
                         all(p % 16 == 0 for p in ptrs), precision)
    outs = [torch.empty_like(c) for c in cs]
    ptrs += [t.data_ptr() for t in outs]
    # [4*batch tile pointers | pad to 64 B | 2*batch tensor maps]
    maps_at = -(-8 * len(ptrs) // 64) * 64
    nmaps = 2 * batch if variant == "wgmma_bf16" else 0
    host = torch.empty(maps_at + nmaps * _MAP_BYTES, dtype=torch.uint8,
                       pin_memory=True)
    host[:8 * len(ptrs)].view(torch.int64).copy_(
        torch.tensor(ptrs, dtype=torch.int64))
    if nmaps:
        rc = _lib().parsec_gemm_encode_tiles(
            host.data_ptr(), host.data_ptr() + maps_at, batch, m, n, k)
        if rc != 0:
            raise RuntimeError(f"gemm: tensor maps of {batch} tiles "
                               f"{m}x{k}@{k}x{n} refused (cudaError {rc})")
    dev = host.to(a0.device, non_blocking=True)
    _launch(a0, b0, c0, outs[0], batch, m, n, k, variant,
            ptrs=dev.data_ptr(),
            maps=dev.data_ptr() + maps_at if nmaps else None)
    _count(variant)
    return outs


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a@b`` in ``a.dtype`` with fp32 accumulation (``matmul_pallas``),
    at the ``gemm_precision`` knob's setting."""
    precision = gemm_precision()
    batch, m, n, k = _check(a, b, None, a.dtype)
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    _require_cuda(a)
    out = a.new_empty((*a.shape[:-1], n))
    variant = k1_variant(a.dtype, a.dtype, m, n, k, _aligned(a, b),
                         precision)
    _launch(a, b, None, out, batch, m, n, k, variant)
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
    the kernel (fp32 accumulate, at the ``gemm_precision`` knob's
    setting), rather than one launch per (m, n)."""
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

"""GEMM: the tiled-GEMM task bodies and their hand-written Hopper kernel.

Port of ``parsec_tpu/ops/gemm.py``.  The kernel, ``csrc/gemm.cu`` (K1), is
the port of the TPU kernel ``matmul_pallas`` (``parsec_tpu/ops/gemm.py:
66-93``), extended to the ``C + A@B`` epilogue of the GEMM task body and
to a batch dimension for the device module's fused dispatch.

- :func:`gemm_update` ``(a, b, c) -> c + a@b``, fp32 accumulate, cast to
  ``c.dtype``; 2-D tiles or batched ``(B, m, k) x (B, k, n) + (B, m, n)``.
  fp32 or bf16 A/B, fp32 or bf16 C.  On a CUDA tensor it launches the
  kernel (``gemm_update.launches`` counts launches, and
  ``gemm_update.launches_by_variant`` and ``launches_by_form`` the same
  launches by variant and by :func:`k1_form`) or raises; on a CPU
  tensor it takes :func:`gemm_update_plain`.  Two forms for the
  Cholesky and LU trailing updates: ``trans_b=True`` takes B as ``(n,
  k)`` and computes ``a @ bᵀ``, ``subtract=True`` computes ``c - a@b``
  (``-a@b`` with no C); with ``c=None`` the result is the product alone,
  in ``a.dtype``.
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
               k: int, aligned: bool, precision: str, trans_b: bool = False,
               subtract: bool = False) -> str:
    """The K1 variant that runs ``(m, k) @ (k, n)`` on the card (B given
    as ``(n, k)`` with ``trans_b``; the sum subtracted with
    ``subtract``).

    - ``wgmma_bf16`` for bf16 A/B whose row pitches (``k*2`` and ``n*2``
      bytes) are multiples of 16 and whose operands start on 16-byte
      boundaries (``aligned``): TMA's rule for global strides and bases.
      Under both precisions, since bf16 products are exact in fp32.  It
      takes neither ``trans_b`` nor ``subtract``.
    - ``mma_tf32`` for fp32 A/B under ``default`` whose ``k`` and ``n``
      are multiples of 4, ``aligned`` (16-byte ``cp.async`` chunks), in
      all four forms: a transposed B's rows are ``k`` long.
    - ``simt_fp32`` otherwise: strict fp32, any pitch, all four forms;
      so bf16 A/B with ``trans_b`` or ``subtract`` run here.

    Edges are masked in every variant, so ``m`` and ``out_dtype`` narrow
    no choice; they complete the shape the rule is stated over.
    """
    if a_dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"k1_variant: dtypes {a_dtype} -> {out_dtype}")
    if precision not in PRECISIONS:
        raise ValueError(f"k1_variant: precision {precision!r}")
    if a_dtype == torch.bfloat16:
        tma_ok = (aligned and (2 * k) % 16 == 0 and (2 * n) % 16 == 0
                  and not trans_b and not subtract)
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


def gemm_update_plain(a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor | None = None, tf32: bool = False,
                      trans_b: bool = False,
                      subtract: bool = False) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``c + a@b`` in fp32, cast to
    ``c.dtype`` (with ``trans_b``, ``b`` is ``(n, k)`` and ``a @ bᵀ`` is
    taken; with ``subtract``, ``c - a@b``; with no ``c``, the product
    alone, negated under ``subtract``, in ``a.dtype``).  What the CPU path
    runs, and what the card's kernel is held against.  ``tf32=True``
    first rounds fp32 A and B with :func:`round_tf32`, whose products are
    exact in fp32: the reference of the ``mma_tf32`` variant (run it with
    TF32 matmuls off).  Nothing on the main path passes it."""
    dtype = a.dtype if c is None else c.dtype
    a, b = a.float(), b.float()
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    p = torch.matmul(a, b.transpose(-1, -2) if trans_b else b)
    if c is None:
        return (-p if subtract else p).to(dtype)
    return (c.float() - p if subtract else c.float() + p).to(dtype)


def _check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None,
           out_dtype: torch.dtype,
           trans_b: bool = False) -> tuple[int, int, int, int]:
    """Validate what the kernel takes (B as ``(n, k)`` with ``trans_b``);
    return (batch, m, n, k)."""
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
    if trans_b:
        n, k2 = b.shape[-2:]
    else:
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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
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
            maps: int | None = None, trans_b: bool = False,
            subtract: bool = False) -> None:
    """One kernel launch of ``variant`` on the current stream.  With
    ``ptrs`` (the device address of an int64 array of 4*batch tile
    pointers: A tiles, then B, C, out; and for ``wgmma_bf16`` ``maps``,
    the device address of their tensor maps) the batch is read through
    it and a/b/c/out give only dtypes and device; ``c`` None launches
    with no C."""
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
                _DTYPE_CODE[out.dtype], 0 if c is None else 1, int(trans_b),
                int(subtract), K1_VARIANTS.index(variant), stream)
    if rc != 0:
        raise RuntimeError(f"gemm: {variant} kernel launch failed "
                           f"(cudaError {rc}) at batch={batch} m={m} n={n} "
                           f"k={k} {a.dtype}->{out.dtype} trans_b={trans_b} "
                           f"subtract={subtract}")


def k1_form(trans_b: bool, subtract: bool, add_c: bool) -> str:
    """A launch's form as ``gemm_update.launches_by_form`` keys it:
    ``nn``/``nt`` (B as given or transposed), ``-sub`` for the
    subtracting epilogue, ``-noc`` with no C."""
    return (("nt" if trans_b else "nn") + ("-sub" if subtract else "")
            + ("" if add_c else "-noc"))


def _count(variant: str, key: str = "nn") -> None:
    gemm_update.launches += 1
    gemm_update.launches_by_variant[variant] += 1
    gemm_update.launches_by_form[key] = \
        gemm_update.launches_by_form.get(key, 0) + 1


def gemm_update(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor | None = None, precision: str | None = None,
                *, trans_b: bool = False,
                subtract: bool = False) -> torch.Tensor:
    """``c + a@b`` with fp32 accumulation, cast to ``c.dtype`` (a new
    tensor; ``c`` is not modified).  ``trans_b``: ``b`` is ``(n, k)`` and
    ``a @ bᵀ`` is taken; ``subtract``: ``c - a@b``; ``c=None``: the
    product alone (negated under ``subtract``) in ``a.dtype``.
    ``precision`` (``default`` or ``highest``; None reads the
    ``gemm_precision`` knob) picks the kernel's variant on the card
    (:func:`k1_variant`): fp32 inputs run on TF32 tensor cores under
    ``default`` and in strict fp32 under ``highest``; bf16 inputs run on
    bf16 tensor cores (``wgmma``) under both, their products being exact
    in fp32, in the plain ``c + a@b`` form."""
    precision = gemm_precision(precision)
    out_dtype = a.dtype if c is None else c.dtype
    batch, m, n, k = _check(a, b, c, out_dtype, trans_b)
    if a.device.type == "cpu":
        return gemm_update_plain(a, b, c, trans_b=trans_b, subtract=subtract)
    _require_cuda(a)
    out = a.new_empty((*a.shape[:-1], n), dtype=out_dtype)
    variant = k1_variant(a.dtype, out_dtype, m, n, k,
                         _aligned(a, b, *([] if c is None else [c])),
                         precision, trans_b, subtract)
    _launch(a, b, c, out, batch, m, n, k, variant, trans_b=trans_b,
            subtract=subtract)
    _count(variant, k1_form(trans_b, subtract, c is not None))
    return out


gemm_update.launches = 0
gemm_update.launches_by_variant = dict.fromkeys(K1_VARIANTS, 0)
gemm_update.launches_by_form = {}


def gemm_update_tiles(as_: list[torch.Tensor], bs: list[torch.Tensor],
                      cs: list[torch.Tensor] | None = None, *,
                      trans_b: bool = False, subtract: bool = False,
                      out: torch.Tensor | None = None) -> list[torch.Tensor]:
    """``[c + a@b for each tile triple]`` in ONE kernel launch over lists
    of 2-D tiles that share their shapes and dtypes, at the
    ``gemm_precision`` knob's setting; ``trans_b``, ``subtract`` and
    ``cs=None`` as in :func:`gemm_update`.  A tile may stand in more than
    one list (SYRK passes the same tile as A and B).  Each result is a
    new tile with storage of its own, or with ``out`` (a contiguous
    ``[len, m, n]`` tensor of the result dtype) a row of ``out``; no input
    is modified.

    The tile pointers (and, for ``wgmma_bf16``, a pair of TMA tensor maps
    a tile, encoded here on the host) go up in one pinned host-to-device
    copy."""
    precision = gemm_precision()
    if not (len(as_) == len(bs) == len(as_ if cs is None else cs)) \
            or not as_:
        raise ValueError(f"gemm: tile lists of lengths {len(as_)}, "
                         f"{len(bs)}, {None if cs is None else len(cs)}")
    a0, b0 = as_[0], bs[0]
    c0 = None if cs is None else cs[0]
    out_dtype = a0.dtype if c0 is None else c0.dtype
    _, m, n, k = _check(a0, b0, c0, out_dtype, trans_b)
    if a0.dim() != 2:
        raise ValueError("gemm: tile lists hold 2-D tiles")
    cols = [(as_, a0), (bs, b0)] + ([] if cs is None else [(cs, c0)])
    for col, t0 in cols:
        for t in col:
            if not isinstance(t, torch.Tensor) or t.shape != t0.shape \
                    or t.dtype != t0.dtype or t.device != t0.device \
                    or not t.is_contiguous():
                raise ValueError("gemm: the tiles of a list must share "
                                 "shape, dtype and device, and be "
                                 "contiguous")
    batch = len(as_)
    if out is not None and (tuple(out.shape) != (batch, m, n)
                            or out.dtype != out_dtype
                            or out.device != a0.device
                            or not out.is_contiguous()):
        raise ValueError(f"gemm: out {tuple(out.shape)} {out.dtype} for "
                         f"{batch} tiles {m}x{n} {out_dtype}")
    if a0.device.type == "cpu":
        res = [gemm_update_plain(a, b, c, trans_b=trans_b, subtract=subtract)
               for a, b, c in zip(as_, bs, cs or [None] * batch)]
        if out is None:
            return res
        torch.stack(res, out=out)
        return list(out.unbind(0))
    _require_cuda(a0)
    if batch > _MAX_BATCH:
        raise ValueError(f"gemm: {batch} tiles in one launch, at most "
                         f"{_MAX_BATCH}")
    # no C: null C pointers, which the kernel never reads
    ptrs = [t.data_ptr() for col in (as_, bs) for t in col] \
        + ([0] * batch if cs is None else [t.data_ptr() for t in cs])
    variant = k1_variant(a0.dtype, out_dtype, m, n, k,
                         all(p % 16 == 0 for p in ptrs), precision, trans_b,
                         subtract)
    outs = list(out.unbind(0)) if out is not None else \
        [a0.new_empty((m, n), dtype=out_dtype) for _ in range(batch)]
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
            maps=dev.data_ptr() + maps_at if nmaps else None,
            trans_b=trans_b, subtract=subtract)
    _count(variant, k1_form(trans_b, subtract, cs is not None))
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
                        c: torch.Tensor | None = None, *,
                        trans_b: bool = False,
                        subtract: bool = False) -> torch.Tensor:
    """``c + a@b`` over a leading group axis ``[G, ...]``, in one launch
    (``trans_b``, ``subtract`` and ``c=None`` as in :func:`gemm_update`).
    A tile shared by the group arrives as a broadcast view (batch stride
    0): the group then goes as tile lists in which that tile's pointer
    repeats (:func:`gemm_update_tiles`), and no copy of it is made."""
    ops = (a, b) if c is None else (a, b, c)
    if not any(t.dim() == 3 and t.shape[0] > 1 and t.stride(0) == 0
               for t in ops):
        return gemm_update(a.contiguous(), b.contiguous(),
                           None if c is None else c.contiguous(),
                           trans_b=trans_b, subtract=subtract)

    def rows(t):
        if t.stride(0) == 0:
            return [t[0].contiguous()] * t.shape[0]
        return list(t.contiguous().unbind(0))

    g, m = a.shape[0], a.shape[1]
    n = b.shape[1] if trans_b else b.shape[2]
    out = a.new_empty((g, m, n), dtype=a.dtype if c is None else c.dtype)
    gemm_update_tiles(rows(a), rows(b), None if c is None else rows(c),
                      trans_b=trans_b, subtract=subtract, out=out)
    return out


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
                   chain_combine=gemm_chain, stacked=gemm_update_stacked,
                   libs=("gemm",))

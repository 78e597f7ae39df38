"""1-D stencil: the stencil task bodies' tap loop and its Hopper kernel (K3).

Port of ``parsec_tpu/ops/stencil.py``, which holds two incarnations of one
function, ``stencil1d_xla`` (the jnp tap loop) and ``stencil1d_pallas``
(the TPU kernel).  The port keeps one of each role:

- :func:`stencil1d_plain` ``(padded, weights)``, the counterpart of
  ``stencil1d_xla``: the tap loop in PyTorch.  What the CPU path runs and
  what the card's kernel is held against.
- :func:`stencil1d` ``(padded, weights)``, the counterpart of
  ``stencil1d_pallas``: on a CUDA tensor it launches ``csrc/stencil.cu``
  (``stencil1d.launches`` counts launches) or raises; on a CPU tensor it
  takes :func:`stencil1d_plain`.

Both compute ``out[..., i] = sum_j w[j] * padded[..., i + j]`` over the
interior (the last dim carries ``len(weights) - 1`` halo elements), with
any leading dims, accumulating in fp32 for fp32 and bf16 inputs (fp64
stays fp64) over the taps in order, and cast back to ``padded``'s dtype.
The kernel tiles along the row, so any row length runs on it: the TPU
kernel's 8-row sublane padding and its 2^17-element VMEM fallback to XLA
have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any

import torch

MAX_TAPS = 64          # csrc/stencil.cu: weights travel in the launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _weights(weights: Any) -> list[float]:
    if isinstance(weights, (list, tuple)):
        w = [float(x) for x in weights]
    else:
        w = torch.as_tensor(weights, dtype=torch.float64).reshape(-1).tolist()
    if not w:
        raise ValueError("stencil1d: no weights")
    return w


def _check(padded: torch.Tensor, taps: int) -> None:
    if not isinstance(padded, torch.Tensor):
        raise TypeError("stencil1d: padded must be a torch tensor")
    if padded.dim() < 1 or padded.shape[-1] < taps:
        raise ValueError(f"stencil1d: rows of {tuple(padded.shape)} are "
                         f"shorter than {taps} taps")


@functools.cache
def _entry() -> Any:
    """The kernel's C entry point, built at first use."""
    from ._build import load
    fn = load("stencil").parsec_stencil1d
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def _launch(padded: torch.Tensor, out: torch.Tensor, rows: int, npad: int,
            host_w: Any) -> int:
    """One launch on the current stream of the current device."""
    stream = torch.cuda.current_stream().cuda_stream
    return _entry()(padded.data_ptr(), out.data_ptr(), rows, npad,
                    len(host_w), host_w, _DTYPE_CODE[padded.dtype], stream)


def stencil1d_plain(padded: torch.Tensor, weights: Any) -> torch.Tensor:
    """The tap loop: fp32 accumulation for fp32/bf16 (fp64 stays fp64),
    taps added in order j = 0..taps-1, each weight rounded to the
    accumulation type first, then cast back to ``padded.dtype``."""
    w = _weights(weights)
    _check(padded, len(w))
    ct = torch.float64 if padded.dtype == torch.float64 else torch.float32
    wt = torch.tensor(w, dtype=ct, device=padded.device)
    n = padded.shape[-1] - len(w) + 1
    out = torch.zeros(padded.shape[:-1] + (n,), dtype=ct,
                      device=padded.device)
    for j in range(len(w)):
        out = out + wt[j] * padded[..., j:j + n].to(ct)
    return out.to(padded.dtype)


def stencil1d(padded: torch.Tensor, weights: Any) -> torch.Tensor:
    """``stencil1d_pallas``'s counterpart: K3 on a CUDA tensor, the plain
    tap loop on a CPU tensor.  Returns a new tensor of shape
    ``padded.shape[:-1] + (n,)``."""
    w = _weights(weights)
    _check(padded, len(w))
    if padded.device.type == "cpu":
        return stencil1d_plain(padded, w)
    if padded.device.type != "cuda":
        raise ValueError(f"stencil1d: no kernel for device {padded.device}")
    if padded.dtype not in _DTYPE_CODE:
        raise TypeError(f"stencil1d: the kernel takes float32 or bfloat16, "
                        f"got {padded.dtype}")
    if len(w) > MAX_TAPS:
        raise ValueError(f"stencil1d: {len(w)} taps, the kernel takes at "
                         f"most {MAX_TAPS}")
    if not padded.is_contiguous():
        raise ValueError("stencil1d: padded must be contiguous")
    npad = padded.shape[-1]
    n = npad - len(w) + 1
    out = padded.new_empty(padded.shape[:-1] + (n,))
    rows = padded.numel() // npad
    if rows == 0:
        return out
    host_w = (ctypes.c_float * len(w))(*w)
    dev = padded.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            rc = _launch(padded, out, rows, npad, host_w)
    else:
        rc = _launch(padded, out, rows, npad, host_w)
    if rc != 0:
        raise RuntimeError(f"stencil1d: kernel launch failed (cudaError "
                           f"{rc}) at rows={rows} npad={npad} "
                           f"taps={len(w)} {padded.dtype}")
    stencil1d.launches += 1
    return out


stencil1d.launches = 0

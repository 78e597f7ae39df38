"""1-D stencil: the stencil task bodies' tap loop and its Hopper kernel (K3).

Port of ``parsec_tpu/ops/stencil.py``, which holds two incarnations of one
function, ``stencil1d_xla`` (the jnp tap loop) and ``stencil1d_pallas``
(the TPU kernel), both over padded rows.  The port keeps one kernel,
``csrc/stencil.cu``, and two entries to it, each beside its plain version:

- :func:`stencil1d` ``(padded, weights)``, the counterpart of
  ``stencil1d_pallas``, and :func:`stencil1d_plain`, the counterpart of
  ``stencil1d_xla`` (the tap loop in PyTorch): over rows that carry
  ``len(weights) - 1`` halo elements, with any leading dims;
- :func:`stencil1d_rows` ``(c, c_rows, l, l_rows, r, r_rows, weights)``
  and :func:`stencil1d_rows_plain`: over a group of store rows read where
  they lie, each extended by the last R cells of a left neighbour row and
  the first R cells of a right one (zeros where a neighbour is -1), with
  ``len(weights) = 2R + 1``: what the lowered stencil's level computes,
  with no padded copy of its rows.

On a CUDA tensor each entry launches the kernel (``stencil1d.launches``
counts every launch of both) or raises; on a CPU tensor it takes its
plain version.  Both compute ``out[..., i] = sum_j w[j] * padded[..., i +
j]``, accumulating in fp32 for fp32 and bf16 inputs (fp64 stays fp64) over
the taps in order, each weight rounded to the accumulation type first,
and round once to the input dtype.  The kernel tiles along the row, so
any row length runs on it: the TPU kernel's 8-row sublane padding and its
2^17-element VMEM fallback to XLA have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Any

import torch

MAX_TAPS = 64          # csrc/stencil.cu: weights travel in the launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NO_ROWS = (None, None, -1, 0, 0)     # a flow with no rows: zeros


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
    flow = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong]
    fn.argtypes = (flow * 3 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_void_p])
    return fn


def _launch(c: tuple, lft: tuple, rgt: tuple, out: torch.Tensor, G: int,
            hl: int, hr: int, w: list[float], dtype: torch.dtype,
            what: str) -> None:
    """One launch on the current stream of ``out``'s device; each flow is
    ``(base, idx, r0, pitch, len)`` (pointers as ints or None)."""
    host_w = (ctypes.c_float * len(w))(*w)
    dev = out.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            rc = _launch_here(c, lft, rgt, out, G, hl, hr, host_w, dtype)
    else:
        rc = _launch_here(c, lft, rgt, out, G, hl, hr, host_w, dtype)
    if rc != 0:
        raise RuntimeError(f"stencil1d: kernel launch failed (cudaError "
                           f"{rc}) at {what} taps={len(w)} {dtype}")
    stencil1d.launches += 1


def _launch_here(c, lft, rgt, out, G, hl, hr, host_w, dtype) -> int:
    stream = torch.cuda.current_stream().cuda_stream
    return _entry()(*c, *lft, *rgt, out.data_ptr(), G, hl, hr, len(host_w),
                    host_w, _DTYPE_CODE[dtype], stream)


def _kernel_checks(t: torch.Tensor, w: list[float]) -> None:
    """Raise on what the kernel does not take (a tensor off the CPU)."""
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"stencil1d: the kernel takes float32 or bfloat16, "
                        f"got {t.dtype}")
    if len(w) > MAX_TAPS:
        raise ValueError(f"stencil1d: {len(w)} taps, the kernel takes at "
                         f"most {MAX_TAPS}")
    if t.device.type != "cuda":
        raise ValueError(f"stencil1d: no kernel for device {t.device}")


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
    ``padded.shape[:-1] + (n,)``; on the card ``padded`` is contiguous."""
    w = _weights(weights)
    _check(padded, len(w))
    if padded.device.type == "cpu":
        return stencil1d_plain(padded, w)
    _kernel_checks(padded, w)
    if not padded.is_contiguous():
        raise ValueError("stencil1d: padded must be contiguous")
    npad = padded.shape[-1]
    n = npad - len(w) + 1
    out = padded.new_empty(padded.shape[:-1] + (n,))
    rows = padded.numel() // npad
    if rows == 0:
        return out
    c = (padded.data_ptr(), None, 0, npad, npad)
    _launch(c, _NO_ROWS, _NO_ROWS, out, rows, 0, 0, w, padded.dtype,
            f"rows={rows} npad={npad}")
    return out


# ---------------------------------------------------------------------------
# the rows entry: a group of store rows with their neighbours' ghosts
# ---------------------------------------------------------------------------

def _group_size(c_rows: Any) -> int:
    if isinstance(c_rows, slice):
        return (c_rows.stop or 0) - (c_rows.start or 0)
    return c_rows.numel() if isinstance(c_rows, torch.Tensor) else -1


def _norm_rows(store: torch.Tensor | None, rows: Any, G: int,
               name: str) -> Any:
    """``rows`` checked against ``store`` (2-D, unit stride along the
    row) and the group size: a slice of step 1 inside the store, a 1-D
    int64 tensor of G rows (-1: zeros), or None (no rows: zeros)."""
    if rows is None:
        return None
    if not isinstance(store, torch.Tensor) or store.dim() != 2 \
            or store.stride(1) != 1:
        raise ValueError(f"stencil1d_rows: store {name} must be a 2-D "
                         f"tensor of unit stride along the row")
    if isinstance(rows, slice):
        if rows.step not in (None, 1) or rows.start is None \
                or rows.stop is None or not 0 <= rows.start <= rows.stop \
                <= store.shape[0]:
            raise ValueError(f"stencil1d_rows: rows {rows} of {name} are "
                             f"not a run inside its {store.shape[0]} rows")
        if rows.stop - rows.start != G:
            raise ValueError(f"stencil1d_rows: {rows.stop - rows.start} "
                             f"rows of {name} for a group of {G}")
        return rows
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int64 \
            or rows.dim() != 1 or rows.numel() != G \
            or not rows.is_contiguous():
        raise ValueError(f"stencil1d_rows: rows of {name} must be a slice "
                         f"or a contiguous 1-D int64 tensor of {G}")
    return rows


# index tensors already found inside their stores: id -> (ref, version,
# rows), so a lowered step's persistent indices are read back once
_IN_RANGE: dict[int, tuple] = {}


def _check_range(rows: torch.Tensor, nrows: int, name: str) -> None:
    """Raise where a row is below -1 or past the store; a tensor is read
    (back from the device) once a version (:data:`_IN_RANGE`)."""
    seen = _IN_RANGE.get(id(rows))
    if seen is not None and seen[0]() is rows \
            and seen[1:] == (rows._version, nrows):
        return
    if rows.numel() and (int(rows.min()) < -1 or int(rows.max()) >= nrows):
        raise ValueError(f"stencil1d_rows: a row of {name} is out of range "
                         f"(-1 .. {nrows - 1})")
    key = id(rows)
    _IN_RANGE[key] = (weakref.ref(rows, lambda _r, k=key:
                                  _IN_RANGE.pop(k, None)),
                      rows._version, nrows)


def _rows_args(c, c_rows, lft, l_rows, rgt, r_rows, weights):
    w = _weights(weights)
    taps = len(w)
    if taps % 2 != 1:
        raise ValueError(f"stencil1d_rows: {taps} taps, the rows entry "
                         f"takes 2R + 1")
    R = (taps - 1) // 2
    if c_rows is None:
        raise ValueError("stencil1d_rows: the group has no rows")
    G = _group_size(c_rows)
    flows = [(c, _norm_rows(c, c_rows, G, "c"), "c"),
             (lft, _norm_rows(lft, l_rows, G, "l"), "l"),
             (rgt, _norm_rows(rgt, r_rows, G, "r"), "r")]
    for st, rows, name in flows:
        if rows is None:
            continue
        if isinstance(rows, torch.Tensor):
            if rows.device != st.device:
                raise ValueError(f"stencil1d_rows: rows of {name} on "
                                 f"{rows.device}, its store on {st.device}")
            _check_range(rows, st.shape[0], name)
        if st.dtype != c.dtype or st.device != c.device:
            raise ValueError(f"stencil1d_rows: store {name} is {st.dtype} "
                             f"on {st.device}, c {c.dtype} on {c.device}")
        if name != "c" and st.shape[1] < R:
            raise ValueError(f"stencil1d_rows: rows of {name} are shorter "
                             f"than the radius {R}")
    if c.shape[1] + 2 * R < taps:
        raise ValueError("stencil1d_rows: rows shorter than the taps")
    return w, R, G, flows


def stencil1d_rows_plain(c: torch.Tensor, c_rows: Any,
                         lft: torch.Tensor | None, l_rows: Any,
                         rgt: torch.Tensor | None, r_rows: Any,
                         weights: Any) -> torch.Tensor:
    """The rows entry's plain version: gathers rows ``c_rows`` of ``c``,
    takes the last R cells of rows ``l_rows`` of ``lft`` and the first R
    of rows ``r_rows`` of ``rgt`` as ghosts (zeros where a row is -1 or
    the flow has no rows), and runs :func:`stencil1d_plain` over the
    padded rows.  Returns ``[G, c.shape[1]]`` in ``c.dtype``."""
    w, R, G, flows = _rows_args(c, c_rows, lft, l_rows, rgt, r_rows,
                                weights)

    def gather(st, rows, cells):
        if rows is None:
            return c.new_zeros((G, cells.stop - cells.start))
        if isinstance(rows, slice):
            return st[rows, cells]
        taken = st[rows.clamp(min=0), cells]
        return torch.where((rows >= 0)[:, None], taken,
                           torch.zeros((), dtype=st.dtype, device=st.device))

    (_, cr, _), (_, lr, _), (_, rr, _) = flows
    mid = gather(c, cr, slice(0, c.shape[1]))
    lg = gather(lft, lr, slice(lft.shape[1] - R, lft.shape[1])
                if lr is not None else slice(0, R))
    rg = gather(rgt, rr, slice(0, R))
    return stencil1d_plain(torch.cat([lg, mid, rg], dim=1), w)


def stencil1d_rows(c: torch.Tensor, c_rows: Any,
                   lft: torch.Tensor | None, l_rows: Any,
                   rgt: torch.Tensor | None, r_rows: Any,
                   weights: Any) -> torch.Tensor:
    """The rows entry: ``out[g, i] = sum_j w[j] * x_g[i + j]`` over
    ``x_g = [lft[l_rows[g], -R:] | c[c_rows[g]] | rgt[r_rows[g], :R]]``,
    a ghost zero where its row is -1 or its flow has no rows (None).  Rows
    are a slice (consecutive rows) or a 1-D int64 tensor on the store's
    device; stores are 2-D, unit stride along the row, any row pitch.
    K3 reads every row in place on a CUDA tensor (or raises), the plain
    version runs on a CPU tensor.  Returns a fresh ``[G, c.shape[1]]``
    tensor in ``c.dtype``: the rows read are never written."""
    w, R, G, flows = _rows_args(c, c_rows, lft, l_rows, rgt, r_rows,
                                weights)
    if c.device.type == "cpu":
        return stencil1d_rows_plain(c, c_rows, lft, l_rows, rgt, r_rows, w)
    _kernel_checks(c, w)
    out = c.new_empty((G, c.shape[1]))
    if G == 0:
        return out
    args = []
    for st, rows, _name in flows:
        if rows is None:
            args.append(_NO_ROWS)
        elif isinstance(rows, slice):
            args.append((st.data_ptr(), None, rows.start, st.stride(0),
                         st.shape[1]))
        else:
            args.append((st.data_ptr(), rows.data_ptr(), 0, st.stride(0),
                         st.shape[1]))
    _launch(*args, out, G, R, R, w, c.dtype,
            f"G={G} len={c.shape[1]} R={R}")
    return out


stencil1d.launches = 0

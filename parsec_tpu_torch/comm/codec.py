"""The wire codec: structured binary encoding with out-of-band buffers.

Port of ``parsec_tpu/comm/codec.py``, the encoding the socket fabric
(:mod:`.socket_fabric`) puts on the wire:

- :func:`encode` walks a payload once and returns ``(meta, segments)``:
  ``meta`` is a small blob describing the structure, ``segments`` the raw
  buffers (array and tensor bodies, large bytes) it references **in
  order**.  Segments are not copied: the fabric hands them to
  ``socket.sendmsg`` (scatter-gather).
- :func:`decode` parses the meta and calls ``fill(view)`` once per
  segment, in order, with a preallocated writable destination (the final
  array's or tensor's flat bytes); the socket receive loop passes a
  ``recv_into`` closure, so payload bytes land socket -> final buffer.

The tags ``T_NONE`` .. ``T_BIGBYTES`` and their byte layouts are the JAX
package's, so for every structured value and numpy array the meta and the
segments are byte for byte the JAX codec's, and each package decodes the
other's bytes (a JAX ``T_JAX`` array decodes here as a numpy array).

Added: ``T_TENSOR`` (14) for a ``torch.Tensor``.  Its header is the
``T_NDARRAY`` one with the torch dtype's name in place of the numpy
dtype string (numpy has no bfloat16); its bytes ride as the next segment
through a flat ``uint8`` view, and decode lands a CPU tensor of that
dtype.  A CUDA tensor is copied to the host first, on the current stream
of the encoding thread: the stream its producer wrote it on.

Trust boundary: decoding the structured tags can only make those types.
A payload node outside them rides as a ``T_PICKLE`` blob decoded through
:class:`RestrictedUnpickler`, whose allowlist is numpy, this package and
a few harmless builtins, never ``torch``: a torch object that is not a
tensor (a dtype, a device) is refused at the sender.

The socket fabric's legacy framing (``comm_wire_binary=False``) pickles
whole frames instead (:func:`legacy_dumps`): a tensor there reduces to a
call of :func:`tensor_from_wire` on its bytes, a function of this package,
so the same restricted unpickler reads it back.

Left out: nothing the port ships needs more.
"""

from __future__ import annotations

import io
import pickle
import struct
from typing import Any, Callable

import numpy as np
import torch

from ..core.params import params as _params

_params.register("comm_codec_pickle_fallback", True,
                 "allow payload nodes outside the structured tag set to "
                 "ride as restricted-pickle blobs; off makes an "
                 "unencodable payload a send-time TypeError")

# type tags ------------------------------------------------------------------
T_NONE = 0
T_TRUE = 1
T_FALSE = 2
T_INT = 3          # <q
T_FLOAT = 4        # <d
T_STR = 5          # <I len + utf8
T_BYTES = 6        # <I len + raw, inline in the meta (small)
T_LIST = 7         # <I count
T_TUPLE = 8        # <I count
T_DICT = 9         # <I count, then key/value pairs
T_NDARRAY = 10     # dtype + shape header; bytes ride as the next segment
T_JAX = 11         # the JAX package's device array; decodes as numpy here
T_PICKLE = 12      # <I len + restricted-pickle blob
T_BIGBYTES = 13    # <Q len; bytes ride as the next segment
T_TENSOR = 14      # torch dtype name + shape header; bytes as a segment

_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# bytes payloads at least this large ride out-of-band as segments
_BIG_BYTES = 512

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def wire_dtype(dtype: Any) -> str:
    """The on-the-wire numpy dtype name (round-trips through ``np.dtype``)."""
    return np.dtype(dtype).str


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's wire name (``"float32"``, ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def torch_dtype_of(name: str) -> torch.dtype:
    """The torch dtype named ``name`` (a wire name); anything else is an
    error, not an attribute lookup of the wire's choosing."""
    dt = getattr(torch, name, None) if name.isidentifier() else None
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"wire names no torch dtype: {name!r}")
    return dt


def _byte_view(t: torch.Tensor) -> np.ndarray:
    """A contiguous CPU tensor's bytes as a flat uint8 numpy view (any
    dtype, bf16 included)."""
    return t.reshape(-1).view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _encode_shape(out: bytearray, shape: tuple, nbytes: int) -> None:
    out.append(len(shape))
    for d in shape:
        out += _I64.pack(d)
    out += _U64.pack(nbytes)


def _encode_array_header(out: bytearray, tag: int, arr: np.ndarray) -> None:
    ds = wire_dtype(arr.dtype).encode()
    out.append(tag)
    out.append(len(ds))
    out += ds
    _encode_shape(out, arr.shape, arr.nbytes)


def _encode_tensor(out: bytearray, segs: list, t: torch.Tensor) -> None:
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()      # the D2H, ordered after the writer's stream
    t = t.contiguous()
    ds = dtype_name(t.dtype).encode()
    nbytes = t.numel() * t.element_size()
    out.append(T_TENSOR)
    out.append(len(ds))
    out += ds
    _encode_shape(out, tuple(t.shape), nbytes)
    if nbytes:
        segs.append(_byte_view(t))


def _encode(out: bytearray, segs: list, obj: Any) -> None:
    if obj is None:
        out.append(T_NONE)
    elif obj is True:
        out.append(T_TRUE)
    elif obj is False:
        out.append(T_FALSE)
    elif type(obj) is int:
        if _I64_MIN <= obj <= _I64_MAX:
            out.append(T_INT)
            out += _I64.pack(obj)
        else:
            _encode_fallback(out, obj)
    elif type(obj) is float:
        out.append(T_FLOAT)
        out += _F64.pack(obj)
    elif type(obj) is str:
        b = obj.encode()
        out.append(T_STR)
        out += _U32.pack(len(b))
        out += b
    elif type(obj) is bytes or type(obj) is bytearray:
        if len(obj) >= _BIG_BYTES:
            out.append(T_BIGBYTES)
            out += _U64.pack(len(obj))
            segs.append(obj)
        else:
            out.append(T_BYTES)
            out += _U32.pack(len(obj))
            out += obj
    elif type(obj) is list:
        out.append(T_LIST)
        out += _U32.pack(len(obj))
        for v in obj:
            _encode(out, segs, v)
    elif type(obj) is tuple:
        out.append(T_TUPLE)
        out += _U32.pack(len(obj))
        for v in obj:
            _encode(out, segs, v)
    elif type(obj) is dict:
        out.append(T_DICT)
        out += _U32.pack(len(obj))
        for k, v in obj.items():
            _encode(out, segs, k)
            _encode(out, segs, v)
    elif isinstance(obj, np.ndarray):
        if obj.dtype == object:
            _encode_fallback(out, obj)
            return
        if not obj.flags.c_contiguous:
            obj = np.ascontiguousarray(obj)
        _encode_array_header(out, T_NDARRAY, obj)
        if obj.nbytes:
            segs.append(obj)
    elif isinstance(obj, (np.bool_, np.integer, np.floating)):
        # numpy scalars ride as their Python kin
        _encode(out, segs, obj.item())
    elif isinstance(obj, torch.Tensor):
        _encode_tensor(out, segs, obj)
    else:
        _encode_fallback(out, obj)


def _encode_fallback(out: bytearray, obj: Any) -> None:
    if not _params.get("comm_codec_pickle_fallback"):
        raise TypeError(
            f"payload node of type {type(obj).__name__} is outside the "
            f"structured wire tags and comm_codec_pickle_fallback is off")
    if type(obj).__module__.split(".", 1)[0] == "torch":
        raise TypeError(
            f"payload node {obj!r} is a torch object other than a tensor: "
            f"it has no wire tag, and the receiver's pickle allowlist "
            f"refuses torch")
    b = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    out.append(T_PICKLE)
    out += _U32.pack(len(b))
    out += b


def encode(obj: Any) -> tuple[bytearray, list]:
    """Encode ``obj`` -> ``(meta, segments)``.  Segments are zero-copy
    views of the payload's own buffers (the caller transmits them before
    the payload may change)."""
    out = bytearray()
    segs: list = []
    _encode(out, segs, obj)
    return out, segs


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("mv", "pos", "pin")

    def __init__(self, buf: Any, pin: bool = False) -> None:
        self.mv = memoryview(buf)
        self.pos = 0
        self.pin = pin      # decoded tensors land in pinned host memory

    def take(self, n: int) -> memoryview:
        p = self.pos
        self.pos = p + n
        return self.mv[p:p + n]

    def u8(self) -> int:
        p = self.pos
        self.pos = p + 1
        return self.mv[p]


def _decode_shape(r: _Reader) -> tuple[tuple, int]:
    ndim = r.u8()
    shape = tuple(_I64.unpack(r.take(8))[0] for _ in range(ndim))
    return shape, _U64.unpack(r.take(8))[0]


def _decode_array(r: _Reader, fill: Callable) -> np.ndarray:
    dlen = r.u8()
    dtype = np.dtype(bytes(r.take(dlen)).decode())
    shape, nbytes = _decode_shape(r)
    arr = np.empty(shape, dtype)
    if arr.nbytes != nbytes:
        raise ValueError(f"wire array {shape} {dtype} claims {nbytes} bytes")
    if nbytes:
        fill(memoryview(arr).cast("B"))
    return arr


def _decode_tensor(r: _Reader, fill: Callable) -> torch.Tensor:
    dlen = r.u8()
    dtype = torch_dtype_of(bytes(r.take(dlen)).decode())
    shape, nbytes = _decode_shape(r)
    t = torch.empty(shape, dtype=dtype, pin_memory=r.pin)
    if t.numel() * t.element_size() != nbytes:
        raise ValueError(f"wire tensor {shape} {dtype} claims {nbytes} "
                         f"bytes")
    if nbytes:
        fill(memoryview(_byte_view(t)))
    return t


def _decode(r: _Reader, fill: Callable) -> Any:
    tag = r.u8()
    if tag == T_NONE:
        return None
    if tag == T_TRUE:
        return True
    if tag == T_FALSE:
        return False
    if tag == T_INT:
        return _I64.unpack(r.take(8))[0]
    if tag == T_FLOAT:
        return _F64.unpack(r.take(8))[0]
    if tag == T_STR:
        n = _U32.unpack(r.take(4))[0]
        return bytes(r.take(n)).decode()
    if tag == T_BYTES:
        n = _U32.unpack(r.take(4))[0]
        return bytes(r.take(n))
    if tag == T_LIST:
        n = _U32.unpack(r.take(4))[0]
        return [_decode(r, fill) for _ in range(n)]
    if tag == T_TUPLE:
        n = _U32.unpack(r.take(4))[0]
        return tuple(_decode(r, fill) for _ in range(n))
    if tag == T_DICT:
        n = _U32.unpack(r.take(4))[0]
        return {_decode(r, fill): _decode(r, fill) for _ in range(n)}
    if tag in (T_NDARRAY, T_JAX):
        return _decode_array(r, fill)
    if tag == T_TENSOR:
        return _decode_tensor(r, fill)
    if tag == T_BIGBYTES:
        n = _U64.unpack(r.take(8))[0]
        buf = bytearray(n)
        fill(memoryview(buf))
        return bytes(buf)
    if tag == T_PICKLE:
        n = _U32.unpack(r.take(4))[0]
        return restricted_loads(bytes(r.take(n)))
    raise ValueError(f"unknown wire tag {tag}")


def decode(meta: Any, fill: Callable[[memoryview], None],
           pin_tensors: bool = False) -> Any:
    """Decode a meta blob, pulling segment bytes through ``fill(view)``
    (once per segment, in encode order, with the destination).  With
    ``pin_tensors`` every tensor is decoded into pinned host memory, the
    source of an asynchronous H2D."""
    return _decode(_Reader(meta, pin_tensors), fill)


def decode_with_segments(meta: Any, segments: list) -> Any:
    """Decode from in-memory segments (tests, loopback)."""
    it = iter(segments)

    def fill(view: memoryview) -> None:
        view[:] = memoryview(next(it)).cast("B")
    return decode(meta, fill)


def roundtrip(obj: Any) -> Any:
    """encode -> decode through memory."""
    meta, segs = encode(obj)
    return decode_with_segments(meta, segs)


# ---------------------------------------------------------------------------
# the restricted pickle seam
# ---------------------------------------------------------------------------

# (module, name) pairs outside the prefix allowlist that are safe to
# reconstruct
_SAFE_GLOBALS = {
    ("builtins", "complex"), ("builtins", "slice"), ("builtins", "range"),
    ("builtins", "set"), ("builtins", "frozenset"),
    ("builtins", "bytearray"),
    ("collections", "OrderedDict"), ("collections", "deque"),
}

# module prefixes whose globals may be reconstructed: numpy (arrays and
# dtypes) and this package's own records; never torch (tensors take their
# own tag)
_SAFE_PREFIXES = ("numpy", "parsec_tpu_torch")


class RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):  # noqa: D102
        if (module, name) in _SAFE_GLOBALS or \
                module.split(".", 1)[0] in _SAFE_PREFIXES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"wire pickle blob references {module}.{name}, which is "
            f"outside the allowlist")


def restricted_loads(data: bytes) -> Any:
    """``pickle.loads`` through the allowlist."""
    return RestrictedUnpickler(io.BytesIO(data)).load()


def tensor_from_wire(dtype: str, shape: tuple, data: bytes) -> torch.Tensor:
    """A CPU tensor from its legacy-pickled bytes."""
    dt = torch_dtype_of(dtype)
    if not data:
        return torch.empty(shape, dtype=dt)
    flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return flat.view(dt).reshape(shape)


class _LegacyPickler(pickle.Pickler):
    def reducer_override(self, obj: Any):  # noqa: D102
        if isinstance(obj, torch.Tensor):
            return tensor_from_wire, (dtype_name(obj.dtype),
                                      tuple(obj.shape),
                                      _byte_view(obj.detach().to("cpu")
                                                 .contiguous()).tobytes())
        return NotImplemented


def legacy_dumps(obj: Any) -> bytes:
    """Pickle a legacy frame: tensors (a CUDA one is copied to the host)
    ride as :func:`tensor_from_wire` calls the restricted unpickler
    admits."""
    buf = io.BytesIO()
    _LegacyPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()

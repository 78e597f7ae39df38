"""ctypes bindings for the port's native runtime core.

Port of ``parsec_tpu/native/__init__.py``: the dispatch hot-path
structures of the foundation tier in C++ behind a C ABI
(``parsec_tpu_torch/csrc/native_core.cpp``, the port's own copy of the
JAX package's ``core.cpp``): the ABA-counted lock-free LIFO, the
spinlocked deque and maxheap, the hashed dependency table with the
satisfied-mask protocol (``parsec_update_deps_with_mask``,
``parsec.c:1577``), the compiled-DAG executor's indegree/CSR core and
the zero-detecting counter.

:func:`ensure_built` compiles the source with the host ``g++`` at first
use, never at import, into the git-ignored ``csrc/build/`` under a name
that hashes the source and the flags (an edited source rebuilds).  The
build writes a temporary file and renames it over the target, so
processes that build at once each see a whole library.  Loading is
best-effort: without a toolchain the runtime keeps its Python
structures, and the ``runtime_native`` param turns the native tier off.

Users: :mod:`parsec_tpu_torch.runtime.deps` (the native dep table, keyed
by an exact 64-bit packing of the task identity),
:mod:`parsec_tpu_torch.runtime.dagrun` (:class:`NativeDag`) and the
``ll`` scheduler (:class:`NativeLifo`).  Nothing of the original is left
out; the build differs (hashed name, atomic rename, the port's own
directory).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any

from ..core.params import params as _params

_params.register("runtime_native", True,
                 "use the native (C++) dep table / queues when buildable")

SRC = Path(__file__).resolve().parent.parent / "csrc" / "native_core.cpp"
BUILD_DIR = SRC.parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-mcx16", "-pthread",
             "-shared")

_lock = threading.Lock()
_lib: Any = None
_tried = False
build_error: str | None = None   # why the last build failed, if it did


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libparsec_tpu_torch_native-{h.hexdigest()[:16]}.so"


def ensure_built(force: bool = False) -> str | None:
    """Compile ``native_core.cpp`` unless its library is current.
    Returns the library path, or None when the build fails (the reason
    is kept in :data:`build_error`)."""
    global build_error
    out = lib_path()
    if out.is_file() and not force:
        return str(out)
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC),
                            "-latomic"], check=True, capture_output=True,
                           text=True, timeout=120)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"{type(e).__name__}: {getattr(e, 'stderr', '') or e}"
        return None
    return str(out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, i64, vp = ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p
    i32, pi32 = ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    sigs = {
        "pt_lifo_new": ([], vp),
        "pt_lifo_free": ([vp], None),
        "pt_lifo_push": ([vp, u64], None),
        "pt_lifo_pop": ([vp, pu64], ctypes.c_int),
        "pt_lifo_size": ([vp], ctypes.c_long),
        "pt_deque_new": ([], vp),
        "pt_deque_free": ([vp], None),
        "pt_deque_push_back": ([vp, u64], None),
        "pt_deque_push_front": ([vp, u64], None),
        "pt_deque_pop_front": ([vp, pu64], ctypes.c_int),
        "pt_deque_pop_back": ([vp, pu64], ctypes.c_int),
        "pt_deque_size": ([vp], ctypes.c_long),
        "pt_heap_new": ([], vp),
        "pt_heap_free": ([vp], None),
        "pt_heap_push": ([vp, i64, u64], None),
        "pt_heap_pop": ([vp, pu64], ctypes.c_int),
        "pt_heap_size": ([vp], ctypes.c_long),
        "pt_deptable_new": ([u64], vp),
        "pt_deptable_free": ([vp], None),
        "pt_deptable_release": ([vp, u64, u64, u64], ctypes.c_int),
        "pt_deptable_count": ([vp], ctypes.c_long),
        "pt_dag_new": ([i32, pi32, pi32, pi32,
                        ctypes.POINTER(ctypes.c_int64)], vp),
        "pt_dag_free": ([vp], None),
        "pt_dag_fetch": ([vp, pi32, i32], i32),
        "pt_dag_complete": ([vp, pi32, i32], i64),
        "pt_dag_remaining": ([vp], i64),
        "pt_counter_new": ([i64], vp),
        "pt_counter_free": ([vp], None),
        "pt_counter_add": ([vp, i64], i64),
        "pt_counter_get": ([vp], i64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load() -> Any:
    """The loaded library, or None when it cannot be built.  The
    ``runtime_native`` param is enforced at the users, not here."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = ensure_built()
        if so is None:
            return None
        try:
            _lib = _bind(ctypes.CDLL(so))
        except OSError as e:
            global build_error
            build_error = f"load: {e}"
            _lib = None
        return _lib


def available() -> bool:
    return load() is not None


def loaded_path() -> str | None:
    """The file the loaded library came from (None before a load)."""
    return None if _lib is None else _lib._name


class _Handle:
    """Owns one native object; frees it on GC."""

    __slots__ = ("_lib", "_h", "_free")

    def __init__(self, lib, h, free_name: str) -> None:
        self._lib = lib
        self._h = h
        self._free = getattr(lib, free_name)

    def __del__(self):
        h, self._h = self._h, None
        if h:
            self._free(h)


class NativeLifo(_Handle):
    def __init__(self) -> None:
        lib = load()
        super().__init__(lib, lib.pt_lifo_new(), "pt_lifo_free")

    def push(self, value: int) -> None:
        self._lib.pt_lifo_push(self._h, value)

    def pop(self) -> int | None:
        out = ctypes.c_uint64()   # per call: ctypes drops the GIL
        if self._lib.pt_lifo_pop(self._h, ctypes.byref(out)):
            return out.value
        return None

    def __len__(self) -> int:
        return self._lib.pt_lifo_size(self._h)


class NativeDeque(_Handle):
    def __init__(self) -> None:
        lib = load()
        super().__init__(lib, lib.pt_deque_new(), "pt_deque_free")

    def push_back(self, v: int) -> None:
        self._lib.pt_deque_push_back(self._h, v)

    def push_front(self, v: int) -> None:
        self._lib.pt_deque_push_front(self._h, v)

    def pop_front(self) -> int | None:
        out = ctypes.c_uint64()
        if self._lib.pt_deque_pop_front(self._h, ctypes.byref(out)):
            return out.value
        return None

    def pop_back(self) -> int | None:
        out = ctypes.c_uint64()
        if self._lib.pt_deque_pop_back(self._h, ctypes.byref(out)):
            return out.value
        return None

    def __len__(self) -> int:
        return self._lib.pt_deque_size(self._h)


class NativeHeap(_Handle):
    def __init__(self) -> None:
        lib = load()
        super().__init__(lib, lib.pt_heap_new(), "pt_heap_free")

    def push(self, priority: int, v: int) -> None:
        self._lib.pt_heap_push(self._h, priority, v)

    def pop(self) -> int | None:
        out = ctypes.c_uint64()
        if self._lib.pt_heap_pop(self._h, ctypes.byref(out)):
            return out.value
        return None

    def __len__(self) -> int:
        return self._lib.pt_heap_size(self._h)


class NativeDepTable(_Handle):
    """key64 -> {required, satisfied} with removal-on-ready.

    ``release`` returns True when the key just became ready, False
    otherwise, and raises on a bit satisfied twice."""

    def __init__(self, nbuckets: int = 1 << 14) -> None:
        lib = load()
        super().__init__(lib, lib.pt_deptable_new(nbuckets),
                         "pt_deptable_free")
        self._release = lib.pt_deptable_release

    def release(self, key64: int, bits: int, required_mask: int) -> bool:
        rc = self._release(self._h, key64, bits, required_mask)
        if rc < 0:
            raise AssertionError(
                f"dep key {key64:#x}: bits {bits:#x} satisfied twice")
        return bool(rc)

    def __len__(self) -> int:
        return self._lib.pt_deptable_count(self._h)


class NativeDag(_Handle):
    """Compiled-DAG executor: indegree counters and CSR successors on the
    native side.

    ``fetch(buf, cap)`` fills a caller-owned ``(ctypes.c_int32 * cap)``
    buffer with ready task ids; ``complete(buf, n)`` releases every
    successor of the batch and returns the count still outstanding.  The
    two calls are the whole select→release loop; Python runs only the
    bodies in between."""

    def __init__(self, indeg, succ_off, succ, prio=None) -> None:
        import numpy as np
        lib = load()
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        indeg = np.ascontiguousarray(indeg, dtype=np.int32)
        succ_off = np.ascontiguousarray(succ_off, dtype=np.int32)
        succ = np.ascontiguousarray(succ, dtype=np.int32)
        self.ntasks = int(indeg.shape[0])
        if succ_off.shape != (self.ntasks + 1,) \
                or succ.shape[0] < int(succ_off[-1]):
            raise ValueError("NativeDag: CSR arrays do not match the "
                             "task count")
        pprio = None
        if prio is not None:
            prio = np.ascontiguousarray(prio, dtype=np.int64)
            pprio = prio.ctypes.data_as(i64p)
        h = lib.pt_dag_new(self.ntasks, indeg.ctypes.data_as(i32p),
                           succ_off.ctypes.data_as(i32p),
                           succ.ctypes.data_as(i32p), pprio)
        super().__init__(lib, h, "pt_dag_free")
        self._fetch = lib.pt_dag_fetch
        self._complete = lib.pt_dag_complete

    def fetch(self, buf, cap: int) -> int:
        return self._fetch(self._h, buf, cap)

    def complete(self, buf, n: int) -> int:
        rem = self._complete(self._h, buf, n)
        if rem < 0:
            raise RuntimeError("compiled DAG successor counter underflow "
                               "(inconsistent task graph)")
        return rem

    def remaining(self) -> int:
        return self._lib.pt_dag_remaining(self._h)


class NativeCounter(_Handle):
    def __init__(self, init: int = 0) -> None:
        lib = load()
        super().__init__(lib, lib.pt_counter_new(init), "pt_counter_free")

    def add(self, delta: int) -> int:
        return self._lib.pt_counter_add(self._h, delta)

    def get(self) -> int:
        return self._lib.pt_counter_get(self._h)

"""Kernel incarnation registry.

Port of ``parsec_tpu/device/kernels.py`` (the reference's ``dyld=``
body resolution, ``find_incarnation``): device bodies are registered by
name and device type; PTG chores resolve them at dispatch.  Registration
happens at import of :mod:`parsec_tpu_torch.ops`.  Left out: the lazy
loader seam — CUDA kernels already build lazily, at their first launch
(:mod:`parsec_tpu_torch.ops._build`).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

_lock = threading.Lock()
_kernels: dict[tuple[str, str], Callable] = {}


def register_kernel(name: str, device_type: str, fn: Callable) -> Callable:
    with _lock:
        _kernels[(name, device_type)] = fn
    return fn


def find_incarnation(name: str, device: Any) -> Callable | None:
    with _lock:
        return _kernels.get((name, device.type)) or _kernels.get((name, "*"))


def registered() -> list[tuple[str, str]]:
    with _lock:
        return sorted(_kernels)

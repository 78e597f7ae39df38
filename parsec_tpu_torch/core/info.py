"""Key -> object stores attachable to runtime entities.

Port of ``parsec_tpu/core/info.py`` (the reference's ``class/info.{c,h}``):
named slots registered once (``parsec_info_register``), each instantiated
per attached object on first read, from the slot's constructor; the
reference keeps per-device and per-stream library handles in them (a
cuBLAS handle a CUDA stream).  :data:`per_device_infos` and
:data:`per_stream_infos` are the process's two registries.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class Info:
    """A registry of named slots; each slot has an optional constructor."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slots: dict[str, Callable[[Any], Any]] = {}

    def register(self, name: str,
                 constructor: Callable[[Any], Any] | None = None) -> str:
        with self._lock:
            self._slots[name] = constructor or (lambda obj: None)
        return name

    def unregister(self, name: str) -> None:
        with self._lock:
            self._slots.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._slots)

    def get(self, obj: "InfoObjectArray", name: str) -> Any:
        with self._lock:
            ctor = self._slots.get(name)
        if ctor is None:
            raise KeyError(f"info slot {name!r} not registered")
        return obj._get_or_make(name, ctor)


class InfoObjectArray:
    """One object's instances of an :class:`Info` registry's slots."""

    def __init__(self, owner: Any = None) -> None:
        self._owner = owner
        self._lock = threading.Lock()
        self._values: dict[str, Any] = {}

    def _get_or_make(self, name: str, ctor: Callable[[Any], Any]) -> Any:
        with self._lock:
            if name not in self._values:
                self._values[name] = ctor(self._owner)
            return self._values[name]


per_device_infos = Info()
per_stream_infos = Info()

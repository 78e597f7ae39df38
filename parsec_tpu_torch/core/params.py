"""Typed runtime parameters ("MCA params").

Port of ``parsec_tpu/core/params.py``: parameters are registered at point
of use with a type, default and help text, and resolved from the
environment (``PARSEC_MCA_<name>``) or else the registered default;
``set`` overrides either.

Left out of this copy: ``--mca`` command-line parsing, the param file,
the autotuner's knob declarations (``declare_knob``/``knob_space``),
scoped ``overrides``, ``snapshot``, ``lookup`` and ``dump`` — nothing on
the port's path reads them yet.  The registry is the port's
own; it shares the ``PARSEC_MCA_`` environment namespace with the JAX
package but no state.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable

_TYPES: dict[str, Callable[[str], Any]] = {
    "int": int,
    "float": float,
    "bool": lambda s: s.strip().lower() in ("1", "true", "yes", "on"),
    "string": str,
}


@dataclass
class Param:
    name: str
    type: str
    default: Any
    help: str = ""
    read_only: bool = False
    # where the current value came from: default/env/set
    source: str = "default"
    value: Any = None


class ParamRegistry:
    """Process-global registry of typed parameters."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._params: dict[str, Param] = {}

    def register(self, name: str, default: Any, help: str = "",
                 type: str | None = None, read_only: bool = False) -> Param:
        if type is None:
            type = ("bool" if isinstance(default, bool)
                    else "int" if isinstance(default, int)
                    else "float" if isinstance(default, float)
                    else "string")
        with self._lock:
            p = self._params.get(name)
            if p is None:
                p = Param(name=name, type=type, default=default, help=help,
                          read_only=read_only)
                p.value, p.source = self._resolve(p)
                self._params[name] = p
            return p

    def _resolve(self, p: Param) -> tuple[Any, str]:
        env = os.environ.get(f"PARSEC_MCA_{p.name}")
        if env is not None:
            return _TYPES[p.type](env), "env"
        return p.default, "default"

    def get(self, name: str, default: Any = None) -> Any:
        with self._lock:
            p = self._params.get(name)
            if p is None:
                if default is None:
                    raise KeyError(f"unregistered param: {name}")
                return default
            return p.value

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            p = self._params.get(name)
            if p is None:
                raise KeyError(f"unregistered param: {name}")
            if p.read_only:
                raise PermissionError(f"param {name} is read-only")
            p.value, p.source = _TYPES[p.type](str(value)), "set"


params = ParamRegistry()

"""Modular component architecture (MCA): the pluggable policy registry.

Port of ``parsec_tpu/core/mca.py`` (the reference's ``mca.h`` and
``mca_repository.c``), trimmed to what the port's PINS modules use:
components grouped by type, registered at import by :func:`component`
and found by name; :func:`parsec_tpu_torch.prof.acquire_pins_modules`
opens the ones the ``pins`` param names.

Left out: the priority-ordered automatic selection (``query``,
``components_of_type``, a component's ``priority`` and ``query``: every
PINS module is opened by name), and the ``sched``, ``termdet``,
``device`` and ``comm`` component families. The port's schedulers and
detectors keep registries of their own
(:func:`~parsec_tpu_torch.sched.open_scheduler`,
:func:`~parsec_tpu_torch.runtime.termdet.open_termdet`).
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class Component:
    """Base class of an MCA component: ``type_name`` names its family,
    ``name`` the component."""

    type_name: str = ""
    name: str = ""

    def open(self, context: Any = None) -> Any:
        """Instantiate the component's module."""
        raise NotImplementedError

    def close(self, module: Any) -> None:
        pass


class ComponentRepository:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_type: dict[str, dict[str, Component]] = {}

    def register(self, component: Component) -> Component:
        with self._lock:
            self._by_type.setdefault(component.type_name, {})[
                component.name] = component
        return component

    def find(self, type_name: str, name: str) -> Component | None:
        with self._lock:
            return self._by_type.get(type_name, {}).get(name)


repository = ComponentRepository()


def component(cls: type | None = None) -> Callable[[type], type] | type:
    """Class decorator registering a :class:`Component` subclass."""

    def wrap(klass: type) -> type:
        repository.register(klass())
        return klass

    return wrap(cls) if cls is not None else wrap

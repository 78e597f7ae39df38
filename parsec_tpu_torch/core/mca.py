"""Modular component architecture (MCA): the pluggable policy registry.

Port of ``parsec_tpu/core/mca.py`` (the reference's ``mca.h`` and
``mca_repository.c``): components grouped by type, registered at import
by :func:`component`, found by name, listed by priority
(:meth:`ComponentRepository.components_of_type`) and selected by
:meth:`ComponentRepository.query`: an explicit request, else the
``<type>`` param when it names one, else the highest-priority component
whose ``query`` accepts the context.
:func:`parsec_tpu_torch.prof.acquire_pins_modules` opens the ones the
``pins`` param names.  The port's schedulers and detectors keep
registries of their own (:func:`~parsec_tpu_torch.sched.open_scheduler`,
:func:`~parsec_tpu_torch.runtime.termdet.open_termdet`), so only the
PINS family registers here.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class Component:
    """Base class of an MCA component: ``type_name`` names its family,
    ``name`` the component."""

    type_name: str = ""
    name: str = ""
    priority: int = 0

    def query(self, context: Any = None) -> bool:
        """Whether this component can serve ``context``."""
        return True

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

    def components_of_type(self, type_name: str) -> list[Component]:
        """A family's components, the highest priority first."""
        with self._lock:
            return sorted(self._by_type.get(type_name, {}).values(),
                          key=lambda c: -c.priority)

    def query(self, type_name: str, context: Any = None,
              requested: str | None = None) -> Component:
        """The component to open: ``requested``, else the one the
        ``<type_name>`` param names, else the highest-priority one whose
        ``query`` accepts ``context``."""
        from .params import params
        if requested is None:
            requested = params.get(type_name, default="")
        if requested:
            c = self.find(type_name, requested)
            if c is None:
                raise LookupError(
                    f"no MCA component '{requested}' of type '{type_name}'")
            return c
        for c in self.components_of_type(type_name):
            if c.query(context):
                return c
        raise LookupError(f"no usable MCA component of type '{type_name}'")


repository = ComponentRepository()


def component(cls: type | None = None) -> Callable[[type], type] | type:
    """Class decorator registering a :class:`Component` subclass."""

    def wrap(klass: type) -> type:
        repository.register(klass())
        return klass

    return wrap(cls) if cls is not None else wrap

"""iterators_checker: validate successor iterators against the dep graph.

Port of ``parsec_tpu/prof/iterators_checker.py`` (the reference's
``mca/pins/iterators_checker``): after every task executes, walk its
successor iterator and check each claimed edge: the successor class
exists in the taskpool, and the successor's input deps hold a matching
active arrow back at this class.  A PTG whose output and input arrows
disagree fails at its first executed task instead of hanging at the dep
table.  :func:`parsec_tpu_torch.analysis.graphcheck.check_ptg` is its
static twin over the whole execution space; this module validates each
execution (``PARSEC_MCA_pins=iterators_checker``).  The check runs from
EXEC_END on the host and reads no tile.

Nothing is left out.
"""

from __future__ import annotations

from typing import Any

from ..core.mca import Component, component
from . import pins
from .pins import PinsEvent


class IteratorsCheckerError(AssertionError):
    pass


def check_task(task: Any) -> int:
    """Walk one task's successor iterator; returns the edges checked."""
    from ..runtime.scheduling import _find_input_dep
    tc = task.task_class
    tp = task.taskpool
    count = 0

    def visitor(t, flow, dep) -> None:
        nonlocal count
        if dep.target_class is None:
            return
        if dep.target_class not in tp.task_classes_by_name:
            raise IteratorsCheckerError(
                f"{t}: out-arrow names unknown class {dep.target_class!r}")
        succ_tc = tp.task_class(dep.target_class)
        for succ_locals in dep.each_target(t.locals):
            try:
                _find_input_dep(succ_tc, dep.target_flow, tc.name,
                                succ_locals)
            except (KeyError, LookupError) as e:
                raise IteratorsCheckerError(
                    f"{t}: arrow to {dep.target_class}({succ_locals})."
                    f"{dep.target_flow} has no matching active input dep "
                    f"({e})") from e
            count += 1

    tc.iterate_successors(task, visitor)
    return count


class IteratorsCheckerModule:
    def __init__(self) -> None:
        self._cb = None
        self.checked_edges = 0

    def install(self) -> None:
        def cb(es, task):
            if task is not None and hasattr(task, "task_class"):
                self.checked_edges += check_task(task)
        self._cb = cb
        pins.register(PinsEvent.EXEC_END, cb)

    def uninstall(self) -> None:
        if self._cb is not None:
            pins.unregister(PinsEvent.EXEC_END, self._cb)
            self._cb = None


@component
class IteratorsCheckerComponent(Component):
    type_name = "pins"
    name = "iterators_checker"

    def open(self, context: Any = None) -> IteratorsCheckerModule:
        mod = IteratorsCheckerModule()
        mod.install()
        return mod

    def close(self, module: IteratorsCheckerModule) -> None:
        module.uninstall()

"""DAG grapher: the executed task graph as DOT.

Port of ``parsec_tpu/prof/grapher.py`` (the reference's
``parsec_prof_grapher.c``): a PINS module (``grapher``) that records
every executed task as a node at COMPLETE_EXEC_BEGIN and re-runs its
class's successor iterator to emit the realized dependency edges.
:meth:`GrapherModule.write_dot` renders Graphviz text coloured by task
class, in the JAX package's DOT subset, so :mod:`.dotmerge` of either
package merges the fragments of both.  Open it through the ``pins``
param (``pins=grapher``) or ``repository.find("pins", "grapher")``.

Left out: the component's priority query (the port opens PINS modules by
name only).
"""

from __future__ import annotations

import threading
from typing import Any

from ..core.mca import Component, component
from . import pins
from .pins import PinsEvent


class GrapherModule:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.nodes: list[tuple[str, str, str]] = []   # (id, label, class)
        self.edges: list[tuple[str, str, str]] = []   # (src, dst, flowname)
        self._cb = None

    # -- collection ----------------------------------------------------------
    def install(self) -> None:
        def on_complete(es, task):
            if task is None or not hasattr(task, "task_class"):
                return
            tc = task.task_class
            nid = self._node_id(tc.name, task.key)
            with self._lock:
                self.nodes.append((nid, f"{tc.name}{task.key}", tc.name))

            def visitor(t, flow, dep):
                if dep.target_class is None:
                    return
                succ_tc = t.taskpool.task_class(dep.target_class)
                for succ_locals in dep.each_target(t.locals):
                    dst = self._node_id(succ_tc.name,
                                        succ_tc.make_key(succ_locals))
                    with self._lock:
                        self.edges.append((nid, dst, flow.name))

            try:
                tc.iterate_successors(task, visitor)
            except Exception:
                pass   # dynamic classes may not re-iterate after release

        self._cb = on_complete
        pins.register(PinsEvent.COMPLETE_EXEC_BEGIN, on_complete)

    def uninstall(self) -> None:
        if self._cb is not None:
            pins.unregister(PinsEvent.COMPLETE_EXEC_BEGIN, self._cb)
            self._cb = None

    @staticmethod
    def _node_id(cls_name: str, key: tuple) -> str:
        flat = "_".join(str(k) for k in key)
        return f"{cls_name}_{flat}" if flat else cls_name

    # -- output --------------------------------------------------------------
    def write_dot(self, path: str, name: str = "dag") -> None:
        palette = ["#e6194b", "#3cb44b", "#4363d8", "#f58231", "#911eb4",
                   "#46f0f0", "#f032e6", "#bcf60c", "#fabebe", "#008080"]
        with self._lock:
            classes = sorted({c for _, _, c in self.nodes})
            color = {c: palette[i % len(palette)]
                     for i, c in enumerate(classes)}
            with open(path, "w") as f:
                f.write(f"digraph {name} {{\n")
                for nid, label, cls in self.nodes:
                    # quoted IDs: keys may contain '-', '.', spaces
                    f.write(f'  "{nid}" [label="{label}" '
                            f'color="{color[cls]}"];\n')
                for src, dst, flow in self.edges:
                    f.write(f'  "{src}" -> "{dst}" [label="{flow}"];\n')
                f.write("}\n")


@component
class GrapherComponent(Component):
    type_name = "pins"
    name = "grapher"

    def open(self, context: Any = None) -> GrapherModule:
        m = GrapherModule()
        m.install()
        return m

    def close(self, module: GrapherModule) -> None:
        module.uninstall()

"""task_profiler: the PINS module that writes runtime events to the trace.

Port of ``parsec_tpu/prof/task_profiler.py`` (the reference's
``mca/pins/task_profiler``): registers on the PINS chains and writes
begin/end trace events for task execution, prepare-input, release and
completion, with the task's class, key and pool as the begin event's
info, plus the compiled-DAG executor's batch spans (``dag_fetch``,
``dag_complete``, info: the batch size).  Turn it on for every context
of a process with ``PARSEC_MCA_pins=task_profiler`` (or
``params.set("pins", "task_profiler")`` before the context is built);
the events land in :data:`parsec_tpu_torch.prof.trace_state`, which
``trace_state.dump(path)`` writes as a ``PTPB`` file.

**Device tasks.**  Every callback runs on the host and never waits on
the card.  A device task's ``task_exec`` span covers its hand-off to the
device manager (the chore's enqueue, or the manager's pull of a ready
task into its batch; for the task whose thread becomes the manager, the
batches that thread then drives), not the kernel: the kernel's time is
the device's, read from ``torch.profiler`` or CUDA events.  Its ``task_complete`` span
is the manager's host-side completion after the batch's launches were
enqueued (the kernel may still be running then); the manager fires it
with the stream of the thread that enqueued the task, and the event is
written to the manager thread's own stream.

Nothing is left out.
"""

from __future__ import annotations

from typing import Any

from ..core.mca import Component, component
from . import pins
from .pins import PinsEvent
from .profiling import profiling


class TaskProfilerModule:
    """Install and uninstall the event bridge (one instance per enable)."""

    PHASES = {
        "exec": (PinsEvent.EXEC_BEGIN, PinsEvent.EXEC_END),
        "prepare_input": (PinsEvent.PREPARE_INPUT_BEGIN,
                          PinsEvent.PREPARE_INPUT_END),
        "release_deps": (PinsEvent.RELEASE_DEPS_BEGIN,
                         PinsEvent.RELEASE_DEPS_END),
        "complete": (PinsEvent.COMPLETE_EXEC_BEGIN,
                     PinsEvent.COMPLETE_EXEC_END),
    }

    def __init__(self) -> None:
        self._keys: dict[str, tuple[int, int]] = {}
        self._cbs: list[tuple[PinsEvent, Any]] = []

    def _register(self, event: PinsEvent, cb: Any) -> None:
        pins.register(event, cb)
        self._cbs.append((event, cb))

    def install(self) -> None:
        colors = {"exec": "#00ff00", "prepare_input": "#8888ff",
                  "release_deps": "#ff8800", "complete": "#888888"}
        for phase, (b, e) in self.PHASES.items():
            self._keys[phase] = profiling.add_dictionary_keyword(
                f"task_{phase}", colors[phase], ("task", "key", "taskpool"))

            def mk(phase, start):
                key_pair = self._keys[phase]

                def cb(es, task):
                    if task is None:
                        return
                    t = task[0] if isinstance(task, list) and task else task
                    tc = getattr(t, "task_class", None)
                    info = None
                    if start and tc is not None:
                        info = {"task": tc.name,
                                "key": str(getattr(t, "key", "")),
                                "taskpool": t.taskpool.name}
                    profiling.trace(key_pair[0 if start else 1],
                                    event_id=getattr(t, "uid", 0),
                                    object_id=id(t), info=info)
                return cb

            for start, event in ((True, b), (False, e)):
                self._register(event, mk(phase, start))

        for phase, (b, e), color in (
                ("dag_fetch", (PinsEvent.DAG_FETCH_BEGIN,
                               PinsEvent.DAG_FETCH_END), "#00cccc"),
                ("dag_complete", (PinsEvent.DAG_COMPLETE_BEGIN,
                                  PinsEvent.DAG_COMPLETE_END), "#cc00cc")):
            self._keys[phase] = profiling.add_dictionary_keyword(
                phase, color, ("batch",))

            def mk_batch(phase, start):
                key_pair = self._keys[phase]

                def cb(es, payload):
                    info = ({"batch": int(payload)}
                            if isinstance(payload, int) else None)
                    profiling.trace(key_pair[0 if start else 1],
                                    event_id=0, object_id=0, info=info)
                return cb

            for start, event in ((True, b), (False, e)):
                self._register(event, mk_batch(phase, start))

    def uninstall(self) -> None:
        for event, cb in self._cbs:
            pins.unregister(event, cb)
        self._cbs.clear()


@component
class TaskProfilerComponent(Component):
    type_name = "pins"
    name = "task_profiler"

    def open(self, context: Any = None) -> TaskProfilerModule:
        m = TaskProfilerModule()
        m.install()
        return m

    def close(self, module: TaskProfilerModule) -> None:
        module.uninstall()

"""Recursive task bodies: re-enter the runtime with a nested taskpool.

Port of ``parsec_tpu/runtime/recursive.py`` (the reference's
``parsec/recursive.h`` and its ``PARSEC_DEV_RECURSIVE`` device kind): a
body that finds its tile too coarse spawns a *nested* pool over a finer
tiling (a :class:`~parsec_tpu_torch.data_dist.matrix.SubtileCollection`
view of its tiles), detaches (``HOOK_RETURN_ASYNC``), and the runtime
completes the outer task when the nested pool drains.

Nested pools may carry any chore kind.  On the card the recursive tiled
GEMM's nested pools carry the CUDA chore, so each sub-GEMM is a K1
launch, and the last inner task usually retires on the device manager's
thread: that thread then runs the drain chain below and the outer
task's ``complete_execution``, the cross-thread completion the device
module already uses.

The nested pool is enqueued **local-only**: it takes no comm id, so
ranks may each spawn a different number of nested pools without
desynchronizing the rank-agreed pool ids.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from .scheduling import ExecutionStream, complete_execution
from .task import HOOK_RETURN_ASYNC, Task
from .taskpool import Taskpool


def recursive_call(es: ExecutionStream, task: Task, inner_tp: Taskpool,
                   callback: Callable[[Taskpool, Task], None] | None = None,
                   collections: Sequence[Any] = ()) -> int:
    """Run ``inner_tp`` in place of ``task``'s body
    (``parsec_recursivecall``).

    Enqueues the nested pool on the outer task's context and chains, in
    order: the pool's own ``on_complete``, ``callback(inner_tp,
    outer_task)``, ``sync_parent()`` on every entry of ``collections``
    that has one (it writes the sub-tiles into the outer flow tile and
    releases their device copies), and last ``complete_execution`` of
    the detached outer task, whose successors then see the sub-DAG's
    writes.  Returns ``HOOK_RETURN_ASYNC``, so a body may ``return
    recursive_call(...)``."""
    ctx = task.taskpool.context
    if ctx is None:
        raise RuntimeError(f"{task}: recursive_call before taskpool enqueue")
    prev = inner_tp.on_complete

    def _drained(tp: Taskpool) -> None:
        if prev is not None:
            prev(tp)
        if callback is not None:
            callback(tp, task)
        for dc in collections:
            sync = getattr(dc, "sync_parent", None)
            if sync is not None:
                sync()
        complete_execution(es, task)

    inner_tp.on_complete = _drained
    ctx.add_taskpool(inner_tp, local_only=True)
    return HOOK_RETURN_ASYNC

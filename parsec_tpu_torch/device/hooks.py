"""Device chore hooks: route task bodies to device modules.

Port of ``parsec_tpu/device/hooks.py`` (the reference's generated GPU
hook): a device chore resolves the best device of its type, finds the
body (``dyld=`` name or an explicit callable) and hands the task to the
device's kernel scheduler.  With no device of that type the hook returns
``HOOK_RETURN_NEXT`` — the class's next chore runs, and a class that
carries only the device chore then fails with no runnable chore instead
of running anywhere else.  Nothing of the original is left out.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable

from ..runtime.task import HOOK_RETURN_DONE, HOOK_RETURN_NEXT
from .device import registry


def make_device_hook(device_type: str, body: Callable | None,
                     dyld: str | None, ptg: Any = None) -> Callable:
    def hook(es: Any, task: Any) -> int:
        dev = registry.best_device(task, device_type)
        if dev is None:
            return HOOK_RETURN_NEXT
        task.selected_device = dev
        submit = body
        if submit is None and dyld is not None:
            from .kernels import find_incarnation
            submit = find_incarnation(dyld, dev)
            if submit is None:
                return HOOK_RETURN_NEXT
        sched = getattr(dev, "kernel_scheduler", None)
        if sched is not None:
            return sched(es, task, submit)
        # synchronous path for devices without a manager
        if ptg is not None:
            rc = submit(es, task, SimpleNamespace(**ptg.globals),
                        SimpleNamespace(**task.locals))
        else:
            rc = submit(es, task)
        dev.executed_tasks += 1
        return HOOK_RETURN_DONE if rc is None else rc

    return hook

"""Runtime core: tasks, dependencies, scheduling loop, context."""

from .context import Context, ContextWaitTimeout
from .scheduling import complete_execution, prepare_input, schedule_tasks
from .task import (DEV_CPU, DEV_CUDA, FLOW_CTL, HOOK_RETURN_ASYNC,
                   HOOK_RETURN_DONE, HOOK_RETURN_NEXT, Chore, Dep, Flow,
                   KeyHashStruct, Task, TaskClass, UDKey)
from .taskpool import Taskpool
from .termdet import UserTriggerTermDet

__all__ = [
    "Chore", "Context", "ContextWaitTimeout", "DEV_CPU", "DEV_CUDA", "Dep",
    "FLOW_CTL", "Flow", "HOOK_RETURN_ASYNC", "HOOK_RETURN_DONE",
    "HOOK_RETURN_NEXT", "KeyHashStruct", "Task", "TaskClass", "Taskpool",
    "UDKey", "UserTriggerTermDet",
    "complete_execution", "prepare_input", "schedule_tasks",
]

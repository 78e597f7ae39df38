"""PTG DSL front-end (port of ``parsec_tpu/ptg``)."""

from .dsl import (CTL, READ, RW, WRITE, FlowBuilder, PTGBuilder, PTGTaskpool,
                  TaskClassBuilder, span)
from .lowering import (LoweredTaskpool, LoweringError, Traceable,
                       find_traceable, lower_taskpool, register_traceable)

__all__ = ["CTL", "READ", "RW", "WRITE", "FlowBuilder", "PTGBuilder",
           "PTGTaskpool", "TaskClassBuilder", "LoweredTaskpool",
           "LoweringError", "Traceable", "find_traceable", "lower_taskpool",
           "register_traceable", "span"]

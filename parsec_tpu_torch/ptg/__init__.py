"""PTG DSL front-end (port of ``parsec_tpu/ptg``)."""

from .dsl import (CTL, READ, RW, WRITE, FlowBuilder, PTGBuilder, PTGTaskpool,
                  TaskClassBuilder, span)
from .lowering import Traceable, find_traceable, register_traceable

__all__ = ["CTL", "READ", "RW", "WRITE", "FlowBuilder", "PTGBuilder",
           "PTGTaskpool", "TaskClassBuilder", "Traceable", "find_traceable",
           "register_traceable", "span"]

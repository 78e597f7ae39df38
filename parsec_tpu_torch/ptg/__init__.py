"""PTG DSL front-end (port of ``parsec_tpu/ptg``)."""

from .dsl import (CTL, READ, RW, WRITE, FlowBuilder, PTGBuilder, PTGTaskpool,
                  TaskClassBuilder, span)
from .jdf import JDF, JDFError, load_jdf, parse_jdf, unparse_jdf
from .jdf_c import convert_c_jdf, load_c_jdf
from .lowering import (LoweredTaskpool, LoweringError, Traceable,
                       find_traceable, lower_taskpool, register_traceable)

__all__ = ["CTL", "READ", "RW", "WRITE", "FlowBuilder", "PTGBuilder",
           "PTGTaskpool", "TaskClassBuilder", "JDF", "JDFError",
           "load_jdf", "parse_jdf", "unparse_jdf", "convert_c_jdf",
           "load_c_jdf", "LoweredTaskpool",
           "LoweringError", "Traceable", "find_traceable", "lower_taskpool",
           "register_traceable", "span"]

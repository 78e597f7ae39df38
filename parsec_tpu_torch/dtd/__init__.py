"""DTD: Dynamic Task Discovery (port of ``parsec_tpu/dtd``).

Tasks are inserted at run time (``parsec_dtd_insert_task``) and the
dependency graph is discovered from per-tile last-user / last-writer
access chains (RAW/WAR/WAW), with a sliding insertion window; across
ranks, ``AFFINITY`` routes each task and tiles cross as pushes
(:mod:`.insert`, :mod:`.multirank_check`).
"""

from .from_ptg import ptg_to_dtd
from .insert import (AFFINITY, DONT_TRACK, INOUT, INPUT, OUTPUT, PULLIN,
                     PUSHOUT, REF, SCRATCH, VALUE, DTDTaskpool, DTDTile,
                     Scratch, unpack_args)

__all__ = [
    "DTDTaskpool", "DTDTile", "Scratch", "unpack_args",
    "INPUT", "OUTPUT", "INOUT", "VALUE", "SCRATCH", "REF",
    "AFFINITY", "DONT_TRACK", "PUSHOUT", "PULLIN", "ptg_to_dtd",
]

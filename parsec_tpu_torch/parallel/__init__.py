"""Parallelism recipes: DP, TP, SP, PP and EP, on the dataflow core and
on a mesh of ``torch.distributed`` ranks.

Port of ``parsec_tpu/parallel/``: :mod:`.train` (the dp x tp MLP step and
the dp x tp x sp transformer step), :mod:`.ring` (ring attention),
:mod:`.alltoall` (Ulysses), :mod:`.pipeline` and :mod:`.expert` (each a
PTG pool over ranks and a mesh step), over :mod:`.mesh`.  The JAX
package's ``_compat.py`` is a JAX-version shim with nothing to port.
"""

from . import alltoall, expert, mesh, pipeline, ring, train

__all__ = ["alltoall", "expert", "mesh", "pipeline", "ring", "train"]

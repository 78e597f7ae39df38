"""Static analysis: graph verification of the port's taskpools.

Port of ``parsec_tpu/analysis`` (the verification half of the reference's
``parsec_ptgpp`` compiler), trimmed to its graph prong:

- :mod:`.graphcheck`: given a built
  :class:`~parsec_tpu_torch.ptg.dsl.PTGTaskpool` or a populated
  :class:`~parsec_tpu_torch.dtd.insert.DTDTaskpool`, enumerate the
  concrete execution space and verify the dataflow without executing a
  body: edge symmetry both ways, access and CTL consistency, WAR/WAW
  ordering, cycles, tile and rank bounds, dead flows and edge functions
  that raise.  Findings carry task-class, flow and instance provenance;
  :func:`check_taskpool` raises :class:`GraphCheckError` in gate mode.

Run it from the CLI (``python -m parsec_tpu_torch.analysis``), through
``tp.validate()``, or at enqueue with the ``analysis_check`` param
(``Context.add_taskpool`` then raises :class:`GraphCheckError` before any
side effect; ``DTDTaskpool.close`` checks a DTD pool).  The per-task
dynamic twin, :mod:`parsec_tpu_torch.prof.iterators_checker`, is
re-exported here (``check_task``, ``IteratorsCheckerError``), lazily, so
importing the checker never loads the profiling stack.

Left out until later slices: ``regions`` (queue item 6), ``runtimelint``
and ``commcheck`` (queue item 7), and the JDF prong ``check_jdf`` (queue
item 9).
"""

from .graphcheck import (Finding, GraphCheckError, GraphReport, check_dtd,
                         check_ptg, check_taskpool)

__all__ = ["Finding", "GraphCheckError", "GraphReport", "check_taskpool",
           "check_ptg", "check_dtd", "IteratorsCheckerError", "check_task"]


def __getattr__(name):
    if name in ("IteratorsCheckerError", "check_task"):
        from ..prof import iterators_checker
        return getattr(iterators_checker, name)
    raise AttributeError(name)

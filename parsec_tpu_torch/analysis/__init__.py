"""Static analysis: graph verification and the runtime's concurrency lint.

Port of ``parsec_tpu/analysis`` (the verification half of the reference's
``parsec_ptgpp`` compiler plus a lint over the runtime's own source):

- :mod:`.graphcheck`: given a built
  :class:`~parsec_tpu_torch.ptg.dsl.PTGTaskpool` or a populated
  :class:`~parsec_tpu_torch.dtd.insert.DTDTaskpool`, enumerate the
  concrete execution space and verify the dataflow without executing a
  body: edge symmetry both ways, access and CTL consistency, WAR/WAW
  ordering, cycles, tile and rank bounds, dead flows and edge functions
  that raise.  Findings carry task-class, flow and instance provenance;
  :func:`check_taskpool` raises :class:`GraphCheckError` in gate mode.
- :mod:`.regions`: the verified graph carved into convex, size-bounded
  megakernel regions (``GraphReport.select_regions``), which
  ``ptg.lowering.lower_regions`` prepares one step each.
- :mod:`.commcheck`: the retained graph replayed against each
  collection's ``rank_of`` to derive, without executing, every pool's
  cross-rank traffic: bytes per edge class (flow name x pow-2 size tier,
  the ``prof/critpath`` keying), fan-out and fan-in, a pattern
  (broadcast, reduce, halo, point-to-point, all-to-all, none), static
  comm hazards and :func:`recommend_tree`.
- :mod:`.runtimelint`: an AST lint over ``parsec_tpu_torch/`` itself:
  attributes a module declares lock-protected (``_LOCK_PROTECTED``) are
  mutated only under their lock, nested acquisitions follow the module's
  ``_LOCK_ORDER``, no bare ``except:``, no ``pickle.loads`` outside the
  codec seam, no unused import.

Run them from the CLI (``python -m parsec_tpu_torch.analysis``, with
``--self-lint`` and ``--comm``), through ``tp.validate()``, or at enqueue
with the ``analysis_check`` param (``Context.add_taskpool`` then raises
:class:`GraphCheckError` before any side effect; ``DTDTaskpool.close``
checks a DTD pool).  The per-task dynamic twin,
:mod:`parsec_tpu_torch.prof.iterators_checker`, is re-exported here
(``check_task``, ``IteratorsCheckerError``), lazily, so importing the
checker never loads the profiling stack; commcheck is lazy too, so the
``comm_pattern`` block of ``runtime_report()`` appears only in processes
that ran it.

Left out: the JDF prong ``check_jdf`` (queue item 9).
"""

from .graphcheck import (Finding, GraphCheckError, GraphReport, check_dtd,
                         check_ptg, check_taskpool)
from .regions import Region, select_regions, task_levels
from .runtimelint import LintReport, lint_file, lint_paths, lint_self

__all__ = ["Finding", "GraphCheckError", "GraphReport", "check_taskpool",
           "check_ptg", "check_dtd", "Region", "select_regions",
           "task_levels", "LintReport", "lint_file", "lint_paths",
           "lint_self", "CommReport", "check_comm", "recommend_tree",
           "predict_collective_traffic", "IteratorsCheckerError",
           "check_task"]

_COMMCHECK = ("CommReport", "check_comm", "recommend_tree",
              "predict_collective_traffic")


def __getattr__(name):
    if name in ("IteratorsCheckerError", "check_task"):
        from ..prof import iterators_checker
        return getattr(iterators_checker, name)
    if name in _COMMCHECK:
        from . import commcheck
        return getattr(commcheck, name)
    raise AttributeError(name)

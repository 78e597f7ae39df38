"""Diagnostic output: informational and warning messages.

Port of ``parsec_tpu/core/output.py`` (the reference's
``utils/output.c``), trimmed to the two messages the port's PINS perf
modules write (:func:`inform`, :func:`warning`), through the
``parsec_tpu_torch`` logger, which writes to stderr at the WARNING
level like the JAX package's.

Left out: named verbosity-levelled streams (``output_open``,
``debug_verbose`` and the ``debug_verbose*`` params), ``fatal`` with
``FatalError``, and ``show_help`` with its repeat counts.
"""

from __future__ import annotations

import logging
import sys

_log = logging.getLogger("parsec_tpu_torch")
if not _log.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[parsec-tpu-torch] %(message)s"))
    _log.addHandler(_h)
    _log.setLevel(logging.WARNING)
    _log.propagate = False


def inform(msg: str, *args) -> None:
    _log.warning(msg, *args)


def warning(msg: str, *args) -> None:
    _log.warning("WARNING: " + msg, *args)

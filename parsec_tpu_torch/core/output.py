"""Diagnostic output: leveled streams, warnings, fatal errors, show_help.

Port of ``parsec_tpu/core/output.py`` (the reference's ``utils/output.c``,
``utils/debug.c`` and ``utils/show_help.c``), on :mod:`logging` through
the ``parsec_tpu_torch`` logger, which writes to stderr at the WARNING
level like the JAX package's: named verbosity-levelled streams
(:func:`output_open`, whose level comes from the ``debug_verbose`` and
``debug_verbose_<name>`` params), :func:`inform`, :func:`warning`,
:func:`fatal` raising :class:`FatalError`, and :func:`show_help`, which
prints a topic once and counts its repeats (:func:`show_help_flush`).
"""

from __future__ import annotations

import logging
import sys
import threading

_lock = threading.Lock()
_streams: dict[str, "OutputStream"] = {}

_log = logging.getLogger("parsec_tpu_torch")
if not _log.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[parsec-tpu-torch] %(message)s"))
    _log.addHandler(_h)
    _log.setLevel(logging.WARNING)
    _log.propagate = False


class FatalError(RuntimeError):
    """Raised by :func:`fatal` (the reference's ``parsec_fatal`` aborts the
    process; a library raises)."""


class OutputStream:
    """A named, verbosity-levelled output stream (``parsec_output_open``)."""

    def __init__(self, name: str, verbose: int = 0) -> None:
        self.name = name
        self.verbose = verbose
        self._log = _log.getChild(name)
        self._log.setLevel(logging.DEBUG)

    def verbose_out(self, level: int, msg: str, *args) -> None:
        """Emit ``msg`` when this stream's verbosity is >= ``level``."""
        if self.verbose >= level:
            self._log.warning(msg, *args)

    def inform(self, msg: str, *args) -> None:
        self._log.warning(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self._log.warning("WARNING: " + msg, *args)


def output_open(name: str, verbose: int | None = None) -> OutputStream:
    """Open (or fetch) the named stream; ``verbose`` defaults to the
    ``debug_verbose_<name>`` param, itself defaulting to ``debug_verbose``."""
    from .params import params

    with _lock:
        st = _streams.get(name)
        if st is None:
            if verbose is None:
                default = params.register(
                    "debug_verbose", 0, "global debug verbosity level").value
                verbose = params.register(
                    f"debug_verbose_{name}", default,
                    f"debug verbosity for the '{name}' stream").value
            st = OutputStream(name, verbose)
            _streams[name] = st
        elif verbose is not None:
            st.verbose = verbose
        return st


def _debug() -> OutputStream:
    st = _streams.get("debug")
    return st if st is not None else output_open("debug")


def debug_verbose(level: int, stream: OutputStream | str, msg: str,
                  *args) -> None:
    if isinstance(stream, str):
        stream = output_open(stream)
    stream.verbose_out(level, msg, *args)


def inform(msg: str, *args) -> None:
    _log.warning(msg, *args)


def warning(msg: str, *args) -> None:
    _log.warning("WARNING: " + msg, *args)


def fatal(msg: str, *args) -> None:
    _log.error("FATAL: " + msg, *args)
    raise FatalError(msg % args if args else msg)


_help_lock = threading.Lock()
_help_seen: dict[tuple[str, str], int] = {}


def show_help(topic: str, section: str, msg: str, *args) -> bool:
    """Emit a long-form diagnostic once per (topic, section); later calls
    only count.  Returns True when the message was printed."""
    key = (topic, section)
    with _help_lock:
        n = _help_seen.get(key, 0)
        _help_seen[key] = n + 1
        if n:
            return False
    _debug().inform(f"[help: {topic}:{section}] {msg}", *args)
    return True


def show_help_flush() -> dict[tuple[str, str], int]:
    """Report and reset the suppressed-repeat counts."""
    with _help_lock:
        counts = dict(_help_seen)
        _help_seen.clear()
    for (topic, section), n in counts.items():
        if n > 1:
            _debug().inform(f"[help: {topic}:{section}] shown once; "
                            f"{n - 1} repeat(s) suppressed")
    return counts

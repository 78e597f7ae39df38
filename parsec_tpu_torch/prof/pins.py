"""PINS: instrumentation callback chains on runtime events.

Port of ``parsec_tpu/prof/pins.py`` (the reference's
``mca/pins/pins.h``): modules register callbacks on runtime events and
the runtime fires them from fixed points of its loops.

Dispatch is a table of **precompiled per-event slots** (:data:`hooks`):
slot ``i`` is ``None`` (nothing attached to event ``i``) or a closure
that delivers ``(es, payload)`` to the recorder and the registered
chains.  A hot fire site is::

    h = _hooks[_EXEC_BEGIN]          # _hooks = pins.hooks, bound at import
    if h is not None:
        h(es, task)

one index load and a falsy branch, with no allocation, when the site is
disabled.  The :data:`hooks` list never changes identity; slots are
swapped in place, so call sites bind it once at import.  :func:`fire` is
the slow-path entry of warm sites.  ``pins.recorder`` is assignable: the
module intercepts the assignment and retargets every slot.

Callbacks run on the thread that fires: a worker, the caller-driven
loop, the device manager (which fires its device events with
``es=None``) or a comm thread.  A callback must never wait on the card
(no ``.item()``, no synchronize): the device module fires on the host
side of each step.

:class:`PinsEvent` keeps the JAX package's numbers for every event, so
an event stream reads the same in both packages: the serving lifecycle
(``SERVE_*``, 31-36, ``serve/server.py``), the activation callback span
(``ACTIVATE_CB_*``, 12-13, ``comm/remote_dep.py``) and the fragment
events (``COMM_GET_FRAG_*``, ``COMM_GET_DONE``, 37-39,
``comm/engine.py``) fire where the JAX package fires them.  The data
flush span (14-15) is declared and fired by no site, in both packages.
``TASKPOOL_FINI`` is declared by the JAX package but fired by none of
its sites; the port fires it when a pool terminates.

The always-on flight recorder (:mod:`.flight_recorder`) installs itself
as the recorder when the first context is built, so with its default
every slot is compiled, recorder attached; with ``prof_flightrec_size``
0 a site without a chain stays on the disabled branch.
"""

from __future__ import annotations

import sys
import threading
import types
from enum import IntEnum
from typing import Any, Callable


class PinsEvent(IntEnum):
    SELECT_BEGIN = 0
    SELECT_END = 1
    PREPARE_INPUT_BEGIN = 2
    PREPARE_INPUT_END = 3
    EXEC_BEGIN = 4
    EXEC_END = 5
    COMPLETE_EXEC_BEGIN = 6
    COMPLETE_EXEC_END = 7
    SCHEDULE_BEGIN = 8
    SCHEDULE_END = 9
    RELEASE_DEPS_BEGIN = 10
    RELEASE_DEPS_END = 11
    # the activation callback (comm/remote_dep.py; payload: (src, seq))
    ACTIVATE_CB_BEGIN = 12
    ACTIVATE_CB_END = 13
    DATA_FLUSH_BEGIN = 14
    DATA_FLUSH_END = 15
    TASKPOOL_INIT = 16
    TASKPOOL_FINI = 17
    # compiled-DAG executor batch spans (payload: batch size)
    DAG_FETCH_BEGIN = 18
    DAG_FETCH_END = 19
    DAG_COMPLETE_BEGIN = 20
    DAG_COMPLETE_END = 21
    # a select that pulled work from beyond the stream's own queue
    # (payload: (task, distance))
    SELECT_STEAL = 22
    # device-module sites (device/cuda.py)
    DEVICE_ENQUEUE = 23            # payload: task handed to the manager
    DEVICE_BATCH_BEGIN = 24        # payload: batch size
    DEVICE_BATCH_END = 25          # payload: batch size
    DEVICE_STAGE_IN = 26           # payload: H2D bytes of one batched put
    DEVICE_EVICT = 27              # payload: victims written back in a drain
    DEVICE_STAGE_MIXED_VERSIONS = 28   # payload: (key, kept_ver, other_ver)
    # comm sites (comm/remote_dep.py, comm/engine.py)
    COMM_ACTIVATE_SEND = 29        # payload: (dst_rank, seq)
    COMM_ACK_RECV = 30             # payload: seq
    # serving lifecycle (serve/server.py; payload: (tenant, pool name)):
    # SUBMIT -> {ADMIT -> START -> COMPLETE | REJECT}; DRAIN once a drain
    SERVE_SUBMIT = 31
    SERVE_ADMIT = 32
    SERVE_REJECT = 33
    SERVE_START = 34
    SERVE_COMPLETE = 35
    SERVE_DRAIN = 36
    # fragmented rendezvous (comm/engine.py; integer payloads are bytes)
    COMM_GET_FRAG_SENT = 37        # payload: fragment bytes served
    COMM_GET_FRAG_RECV = 38        # payload: fragment bytes landed
    COMM_GET_DONE = 39             # payload: bytes of a finished fragmented GET
    COMM_GET_PREFETCH = 40         # payload: owner rank of a lookahead GET


Callback = Callable[[Any, Any], None]   # (execution_stream_or_none, payload)

N_EVENTS = max(int(e) for e in PinsEvent) + 1

_lock = threading.Lock()
_chains: dict[int, list[Callback]] = {}
enabled = False

# the recorder hook: a callable ``(event, payload) -> None`` or None,
# exposed as the assignable ``pins.recorder`` attribute (see below).  It
# does not flip ``enabled``, which gates the compiled executor's per-task
# EXEC fires.
_recorder: Callable[[Any, Any], None] | None = None

# the per-event dispatch table.  IDENTITY-STABLE: hot call sites bind
# this list once at import; _rebuild() swaps slots in place.
hooks: list[Callable[[Any, Any], None] | None] = [None] * N_EVENTS


def _slot(event: int) -> Callable[[Any, Any], None] | None:
    """Compile one event's dispatch slot from the recorder and chains."""
    rec = _recorder
    chain = _chains.get(event) or None
    if rec is None and chain is None:
        return None
    ev = PinsEvent(event)
    if chain is None:
        def h(es: Any, payload: Any, _r=rec, _e=ev) -> None:
            _r(_e, payload)
        return h
    if rec is None:
        def h(es: Any, payload: Any, _c=chain) -> None:
            for cb in _c:               # copy-on-write lists: no snapshot
                cb(es, payload)
        return h

    def h(es: Any, payload: Any, _r=rec, _c=chain, _e=ev) -> None:
        _r(_e, payload)
        for cb in _c:
            cb(es, payload)
    return h


def _rebuild() -> None:
    """Recompile every slot in place (caller holds ``_lock``)."""
    for i in range(N_EVENTS):
        hooks[i] = _slot(i)


def set_recorder(value: Callable[[Any, Any], None] | None) -> None:
    """Install or clear the recorder and retarget every slot;
    ``pins.recorder = fn`` routes here."""
    global _recorder
    with _lock:
        _recorder = value
        _rebuild()


def register(event: PinsEvent, cb: Callback) -> None:
    global enabled
    with _lock:
        # copy-on-write: slots iterate these lists unlocked
        _chains[int(event)] = [*_chains.get(int(event), ()), cb]
        enabled = True
        _rebuild()


def unregister(event: PinsEvent, cb: Callback) -> None:
    global enabled
    with _lock:
        lst = _chains.get(int(event), [])
        if cb in lst:
            _chains[int(event)] = [c for c in lst if c is not cb]
        enabled = any(_chains.values())
        _rebuild()


def fire(event: PinsEvent, es: Any = None, payload: Any = None) -> None:
    h = hooks[event]
    if h is not None:
        h(es, payload)


class _PinsModule(types.ModuleType):
    """Intercepts ``pins.recorder`` assignment, so a recorder installed by
    plain attribute write retargets the precompiled slots."""

    @property
    def recorder(self) -> Callable[[Any, Any], None] | None:
        return _recorder

    @recorder.setter
    def recorder(self, value: Callable[[Any, Any], None] | None) -> None:
        set_recorder(value)


sys.modules[__name__].__class__ = _PinsModule

"""The comm-engine abstraction and the in-process fabric backend.

Port of ``parsec_tpu/comm/engine.py`` (the reference's
``parsec_comm_engine.h``): a transport exposes

- **active messages**: ``tag_register(tag, cb)`` and ``send_am(tag, dst,
  payload)``; the callback runs on the receiver during its ``progress()``;
- **registered memory and one-sided GET**: ``mem_register`` publishes a
  local buffer under a :class:`MemHandle`; a peer pulls it with
  :meth:`CommEngine.get` (the rendezvous protocol), completion running a
  local callback;
- **progress**, never run concurrently for one engine (the funnelled
  discipline: a thread that finds it busy skips).

:class:`InprocCommEngine` over :class:`InprocFabric` runs N ranks inside
one process with per-rank inboxes (the analog of the reference's
oversubscribed-MPI test runs): the protocol layer above it
(:mod:`.remote_dep`) runs unchanged, only the byte transport is local.
A GET larger than ``comm_get_frag_bytes`` is served as a window of
``comm_get_window`` fragments, each landed fragment returning a credit,
into a landing zone the receiver allocates for the whole payload.
:class:`~parsec_tpu_torch.comm.device_fabric.DeviceCommEngine` is the
device-backed transport.

**Mutable payloads, a deliberate departure.**  The JAX engine copies only
host ``np.ndarray`` payloads at registration, because JAX arrays are
immutable and alias safely.  Every ``torch.Tensor`` is mutable, on the
CPU or on the card, and a local successor may write a tile in place after
its producer registered it.  So :meth:`CommEngine.mem_register` snapshots
every tensor (``clone``) unless the caller passes ``owned=True`` for a
tensor nobody else holds, and a GET serves each consumer its own tensor:
a copy while other consumers are still to pull, the registered snapshot
itself to the last one.

The socket tier's hooks live here too: ``_serve_value`` (what a GET
serves; the device socket tier stages its D2H there), ``_transport_frag``
(how one fragment travels), ``landing_view``/``landing_commit`` (the
socket receive thread lands a fragment's bytes by ``recv_into`` straight
into the landing zone's flat host buffer), ``on_peer_failed`` (a dead peer's
registration shares, send windows and landing zones are released) and
``mem_release(peer=)``.  A fragment's meta names its dtype as a string
(:func:`~parsec_tpu_torch.comm.codec.dtype_name`), so it rides the wire.

:meth:`CommEngine.prefetch_get` is a GET issued ahead of demand (the KV
tier pulling a page back from a peer one superpool early): the same
protocol, fragments and credit window included, counted apart in
``prefetch_gets``.  A handle's ``on_drained`` callback, where its owner
sets one, runs once the registration drops (the peer KV store's
custody ledger, ``data_dist/kv_tiers.py``).

PINS: a lookahead GET fires ``COMM_GET_PREFETCH`` (payload: the owner
rank); each fragment served fires ``COMM_GET_FRAG_SENT`` and each
fragment landed ``COMM_GET_FRAG_RECV`` (payload: its bytes), and a
fragmented GET that completes fires ``COMM_GET_DONE`` (payload: its
bytes).

**Traces.**  ``send_am(..., trace_id=)`` hands a request's 8-byte trace
to the transport (the socket fabric packs it into the CTRL header's
``u2`` word; the in-process fabric has no header).  ``get(...,
trace=)`` carries it in the GET request, and the first DATA fragment's
meta carries it too.  With the span recorder installed
(:mod:`parsec_tpu_torch.prof.spans`) the requester records ``comm.get``
(request to payload landed) and the owner ``comm.get_serve`` (its reply
or its fragment window), both flow-keyed ``get:<requester>:<get_id>``
for :mod:`~parsec_tpu_torch.prof.tracemerge`; the requester's open span
lives in ``_get_spans``, which the disabled path never touches.

**Resumed GETs.**  :meth:`InprocCommEngine.resume_get` is the mid-tree
fault path: when a staging parent dies with a transfer partly landed, the
requester re-issues the same GET against a surviving holder (the
grandparent).  The landing zone is retargeted to the new owner before any
``on_peer_failed`` sweep of the dead one, the offsets already landed ride
a ``resume`` list that the new owner skips, and a zombie fragment of the
dead parent deduplicates against ``zone.landed`` (``dup_frags``), so each
offset lands exactly once.  :class:`Capabilities` is the backend record
(``parsec_comm_engine_capabilities_t``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable

import torch

from ..core.backoff import Backoff
from ..core.params import params as _params
from ..data.data import nbytes_of
from ..prof import pins, spans as _spans
from ..prof.pins import PinsEvent
from .codec import dtype_name, torch_dtype_of

# Reserved AM tags (cf. parsec_comm_engine.h:24-40).
AM_TAG_GET_REQ = 1       # internal: rendezvous pull request
AM_TAG_GET_REPLY = 2     # internal: rendezvous payload delivery
AM_TAG_GET_ACK = 3       # remote-completion notification (activation ack)
AM_TAG_ACTIVATE = 4      # remote-dep activation
AM_TAG_TERMDET = 5       # termination-detection waves (fourcounter)
AM_TAG_BARRIER = 6       # context-level sync barrier
AM_TAG_DTD = 7           # DTD cross-rank tile pushes and flushes
AM_TAG_GET_FRAG = 8      # internal: one rendezvous payload fragment
AM_TAG_GET_FRAG_ACK = 9  # internal: fragment credit (windowed pipelining)
AM_TAG_USER_BASE = 16    # first tag available to applications and DSLs

_params.register("comm_get_frag_bytes", 4 << 20,
                 "rendezvous GETs above this many bytes are split into "
                 "fragments of this size and pipelined (0 = monolithic)")
_params.register("comm_get_window", 4,
                 "max in-flight unacked fragments per GET (each landed "
                 "fragment returns one credit)")
# the autotuner's declared domain: fragment sizes and windows in powers
# of two
_params.declare_knob("comm_get_frag_bytes", lo=256 << 10, hi=16 << 20,
                     scale="log2")
_params.declare_knob("comm_get_window", lo=1, hi=16, scale="log2")

_now_ns = time.perf_counter_ns


class Capabilities:
    """What a backend supports (cf. ``parsec_comm_engine_capabilities_t``)."""

    __slots__ = ("sided", "multithreaded", "supports_noncontiguous")

    def __init__(self, sided: int = 1, multithreaded: bool = True,
                 supports_noncontiguous: bool = True) -> None:
        self.sided = sided
        self.multithreaded = multithreaded
        self.supports_noncontiguous = supports_noncontiguous


class MemHandle:
    """A published local buffer.  ``refcount`` counts the peers still
    expected to pull; the registration drops when it reaches zero.
    ``peers`` optionally names the consumer ranks, so a peer that dies
    before its GET releases its share (:meth:`CommEngine.on_peer_failed`).
    ``ready`` is the CUDA event after which a device tier's value is
    complete (None elsewhere).  ``on_drained``, when set, runs (outside
    the engine's lock) once the registration drops."""

    __slots__ = ("handle_id", "rank", "value", "refcount", "peers", "ready",
                 "on_drained")

    _ids = itertools.count(1)

    def __init__(self, rank: int, value: Any, refcount: int = 1,
                 peers: set[int] | None = None) -> None:
        self.handle_id = next(MemHandle._ids)
        self.rank = rank
        self.value = value
        self.refcount = refcount
        self.peers = set(peers) if peers is not None else None
        self.ready = None
        self.on_drained: Callable[[], None] | None = None

    def wire(self) -> tuple[int, int]:
        """The on-the-wire form: (owner rank, handle id)."""
        return (self.rank, self.handle_id)


class _FragSend:
    """Sender side of one fragmented reply: the pieces and the cursor the
    credit window advances."""

    __slots__ = ("dst", "get_id", "handle_id", "pieces", "meta", "next",
                 "trace", "t0")

    def __init__(self, dst: int, get_id: int, handle_id: int,
                 pieces: list, meta: dict, trace: int = 0,
                 t0: int = 0) -> None:
        self.dst = dst
        self.get_id = get_id
        self.handle_id = handle_id
        self.pieces = pieces        # [(byte_offset, nbytes, tensor), ...]
        self.meta = meta
        self.next = 0
        self.trace = trace          # the request's 8-byte trace (0: none)
        self.t0 = t0                # the serve span's start (ns)


class _LandingZone:
    """Receiver side of one fragmented GET: the final destination the
    fragments are copied into (host tier) or the device pieces kept for
    one concatenation (device tier), and the offsets landed so far."""

    __slots__ = ("get_id", "src", "meta", "dest", "flat", "remaining",
                 "landed", "frags")

    def __init__(self, get_id: int, src: int, meta: dict) -> None:
        self.get_id = get_id
        self.src = src
        self.meta = meta
        self.dest: torch.Tensor | None = None
        self.flat: torch.Tensor | None = None    # its flat uint8 view
        self.remaining = int(meta["nbytes"])
        self.landed: set[int] = set()
        self.frags: dict[int, torch.Tensor] | None = None


class InprocFabric:
    """N ranks of one process: per-rank inboxes."""

    def __init__(self, nranks: int) -> None:
        self.nranks = nranks
        self._inboxes: list[deque] = [deque() for _ in range(nranks)]
        self._locks = [threading.Lock() for _ in range(nranks)]
        # each rank's engine, once attached: a caller driving a peer that
        # lives in this process progresses them all (data_dist/kv_tiers.py)
        self.engines: list["InprocCommEngine | None"] = [None] * nranks

    def attach(self, rank: int) -> "InprocCommEngine":
        eng = InprocCommEngine(self, rank)
        self.engines[rank] = eng
        return eng

    def deliver(self, dst: int, tag: int, src: int, payload: Any,
                trace_id: int = 0) -> None:
        # the trace word is a frame header's (the socket fabric's u2); in
        # process the payload-level trace fields carry it
        with self._locks[dst]:
            self._inboxes[dst].append((tag, src, payload))

    def drain(self, rank: int, limit: int = 64) -> list[tuple]:
        out = []
        with self._locks[rank]:
            while self._inboxes[rank] and len(out) < limit:
                out.append(self._inboxes[rank].popleft())
        return out

    def pending(self, rank: int) -> int:
        with self._locks[rank]:
            return len(self._inboxes[rank])


class CommEngine:
    """The abstract vtable (``parsec_comm_engine.h:176-199``)."""

    capabilities = Capabilities()
    frag_active = 0      # open landing zones and send windows

    def __init__(self, nranks: int, rank: int) -> None:
        self.nranks = nranks
        self.rank = rank
        self.prefetch_gets = 0   # GETs issued ahead of demand
        self._am_callbacks: dict[int, Callable] = {}
        self._mem: dict[int, MemHandle] = {}
        self._mem_lock = threading.Lock()
        self._enabled = False
        # the upper layer's flush of its staged sends: every progress()
        # drives it, so loops spinning on raw progress (sync, quiesce)
        # never strand a staged activation
        self.flush_hook: Callable[[], int] | None = None

    # -- active messages ----------------------------------------------------
    def tag_register(self, tag: int, cb: Callable[[Any, int, Any], None]) -> None:
        """``cb(engine, src_rank, payload)`` runs during ``progress``."""
        self._am_callbacks[tag] = cb

    def send_am(self, tag: int, dst: int, payload: Any,
                trace_id: int = 0) -> None:
        """``trace_id``, a request's 8-byte trace, rides the transport's
        frame header where it has one; the payload is untouched."""
        raise NotImplementedError

    # -- registered memory / one-sided ---------------------------------------
    def mem_register(self, value: Any, refcount: int = 1,
                     owned: bool = False,
                     peers: set[int] | None = None) -> MemHandle:
        """Publish a buffer for one-sided GETs.  A tensor is snapshotted
        (see the module docstring) unless ``owned``."""
        if not owned and isinstance(value, torch.Tensor):
            value = value.clone()
        h = MemHandle(self.rank, value, refcount, peers=peers)
        with self._mem_lock:
            self._mem[h.handle_id] = h
        return h

    def mem_retrieve(self, handle_id: int) -> MemHandle | None:
        with self._mem_lock:
            return self._mem.get(handle_id)

    def mem_release(self, handle_id: int, peer: int | None = None) -> None:
        """Drop one reference (``peer``'s, which leaves the expected-peer
        set, so its later death releases nothing); unregister when
        drained."""
        with self._mem_lock:
            h = self._mem.get(handle_id)
            if h is None:
                return
            h.refcount -= 1
            if peer is not None and h.peers is not None:
                h.peers.discard(peer)
            if h.refcount > 0:
                return
            del self._mem[handle_id]
        if h.on_drained is not None:
            h.on_drained()

    def on_peer_failed(self, rank: int) -> int:
        """Release every registration share held for the dead peer
        ``rank``; returns the number of registrations that drained."""
        drained = []
        with self._mem_lock:
            for hid in list(self._mem):
                h = self._mem[hid]
                if h.peers is None or rank not in h.peers:
                    continue
                h.peers.discard(rank)
                h.refcount -= 1
                if h.refcount <= 0:
                    del self._mem[hid]
                    drained.append(h)
        for h in drained:
            if h.on_drained is not None:
                h.on_drained()
        return len(drained)

    def snapshot_value(self, value: Any) -> Any:
        """A stable copy of ``value`` to send in a message (a DTD push):
        a tensor of its own, on the device it lies on."""
        return value.clone() if isinstance(value, torch.Tensor) else value

    def get(self, rwire: tuple[int, int],
            on_complete: Callable[[Any], None],
            trace: int | None = None) -> int:
        """One-sided pull of the remote buffer named by ``rwire``;
        ``on_complete(value)`` runs locally when the payload has landed.
        ``trace`` rides the request, so both ends record the transfer
        under the request's trace."""
        raise NotImplementedError

    def prefetch_get(self, rwire: tuple[int, int],
                     on_complete: Callable[[Any], None],
                     trace: int | None = None) -> int:
        """A GET issued ahead of demand: the same protocol (fragmented
        under the credit window past ``comm_get_frag_bytes``), counted in
        ``prefetch_gets`` so a lookahead pull is told apart from an
        on-demand one."""
        self.prefetch_gets += 1
        pins.fire(PinsEvent.COMM_GET_PREFETCH, None, rwire[0])
        return self.get(rwire, on_complete, trace=trace)

    # -- lifecycle / progress -------------------------------------------------
    def enable(self) -> None:
        self._enabled = True

    def progress(self) -> int:
        """Drain incoming traffic; returns the number of events handled."""
        raise NotImplementedError

    def pending(self) -> int:
        """Number of undelivered incoming events."""
        return 0

    def sync(self) -> None:
        """Barrier across ranks (collective)."""
        raise NotImplementedError

    def fini(self) -> None:
        """Teardown: drop every live registration."""
        with self._mem_lock:
            self._mem = {}


class InprocCommEngine(CommEngine):
    """N ranks in one process (the oversubscribed-MPI analog)."""

    def __init__(self, fabric: InprocFabric, rank: int) -> None:
        super().__init__(fabric.nranks, rank)
        self.fabric = fabric
        self._pending_gets: dict[int, Callable] = {}
        self._get_ids = itertools.count(1)
        self.dup_get_replies = 0
        self._barrier_seen: dict[int, set] = {}
        self._barrier_gen = 0
        self._progress_lock = threading.Lock()
        self._landing: dict[int, _LandingZone] = {}
        self._frag_sends: dict[tuple[int, int], _FragSend] = {}
        self._frag_lock = threading.Lock()
        self.frag_active = 0
        # the requester's open comm.get spans by get id: (trace, t0_ns),
        # only while the span recorder is installed
        self._get_spans: dict[int, tuple[int, int]] = {}
        self.gets = 0            # GETs this rank issued
        self.frags_in = 0
        self.frag_bytes_in = 0
        self.frags_out = 0
        self.frag_bytes_out = 0
        self.dup_frags = 0
        self.tag_register(AM_TAG_GET_REQ, self._serve_get)
        self.tag_register(AM_TAG_GET_REPLY, self._finish_get)
        self.tag_register(AM_TAG_GET_FRAG, self._on_frag)
        self.tag_register(AM_TAG_GET_FRAG_ACK, self._on_frag_ack)
        self.tag_register(AM_TAG_BARRIER, self._on_barrier)

    # -- AM -------------------------------------------------------------------
    def send_am(self, tag: int, dst: int, payload: Any,
                trace_id: int = 0) -> None:
        # self-sends also go through the inbox: the callback runs from
        # progress(), never from the sender's stack
        self.fabric.deliver(dst, tag, self.rank, payload, trace_id=trace_id)

    # -- one-sided get: rendezvous through internal AMs ----------------------
    def get(self, rwire: tuple[int, int],
            on_complete: Callable[[Any], None],
            trace: int | None = None) -> int:
        owner, handle_id = rwire
        get_id = next(self._get_ids)
        self._pending_gets[get_id] = on_complete
        self.gets += 1
        msg = {"handle": handle_id, "get_id": get_id, "reply_to": self.rank}
        if _spans.recorder is not None:
            self._get_spans[get_id] = (trace or 0, _now_ns())
        if trace:
            msg["trace"] = trace
        self.send_am(AM_TAG_GET_REQ, owner, msg, trace_id=trace or 0)
        return get_id

    def resume_get(self, rwire: tuple[int, int], get_id: int,
                   trace: int | None = None) -> bool:
        """Re-issue a still-pending GET against another owner (a staging
        parent died mid-transfer): the offsets already landed ride a
        ``resume`` list the new owner skips.  False when the GET already
        completed."""
        owner, handle_id = rwire
        if get_id not in self._pending_gets:
            return False
        with self._frag_lock:
            zone = self._landing.get(get_id)
            resume = sorted(zone.landed) if zone is not None else []
            if zone is not None:
                # retarget before any on_peer_failed(dead parent) sweep,
                # which would reap a zone still pointing at the dead rank
                zone.src = owner
        msg = {"handle": handle_id, "get_id": get_id, "reply_to": self.rank}
        if resume:
            msg["resume"] = resume
        if trace:
            msg["trace"] = trace
        self.send_am(AM_TAG_GET_REQ, owner, msg, trace_id=trace or 0)
        return True

    def _record_get_span(self, get_id: int, nbytes: int) -> None:
        """The requester's ``comm.get`` span, request sent to payload
        landed, flow-keyed ``get:<requester>:<get_id>``."""
        ent = self._get_spans.pop(get_id, None)
        r = _spans.recorder
        if ent is None or r is None:
            return
        tr, t0 = ent
        r.record("comm.get", tr, t0, _now_ns(),
                 args={"flow": f"get:{self.rank}:{get_id}",
                       "flow_side": "recv", "bytes": nbytes})

    def _serve_get(self, eng: CommEngine, src: int, msg: dict) -> None:
        h = self.mem_retrieve(msg["handle"])
        if h is None:
            raise RuntimeError(
                f"rank {self.rank}: GET for unknown handle {msg['handle']}")
        t0 = _now_ns() if _spans.recorder is not None else 0
        value = self._serve_value(h)
        plan = self._plan_frags(value)
        trace = msg.get("trace") or 0
        landed = set(msg.get("resume") or ())
        if plan is not None and landed:
            # a resumed pull: serve only the offsets still missing
            pieces, meta = plan
            pieces = [p for p in pieces if p[0] not in landed]
            if not pieces:
                # all landed already: the requester's zone completes off
                # the fragments in flight; drop this pull's share
                self.mem_release(msg["handle"], peer=msg["reply_to"])
                return
            plan = (pieces, meta)
        if plan is not None:
            # the receiver copies each fragment into a destination of its
            # own, so the pieces may be views of the registered snapshot
            self._start_frag_send(msg["reply_to"], msg["get_id"],
                                  msg["handle"], plan, trace=trace, t0=t0)
            return
        # each consumer receives a tensor of its own; the snapshot is
        # private to the engine, so the LAST consumer takes it as is
        if value is h.value and isinstance(value, torch.Tensor) \
                and h.refcount > 1:
            value = value.clone()
        self.send_am(AM_TAG_GET_REPLY, msg["reply_to"],
                     {"get_id": msg["get_id"], "value": value},
                     trace_id=trace)
        r = _spans.recorder
        if r is not None:
            r.record("comm.get_serve", trace, t0, _now_ns(),
                     args={"flow": f"get:{msg['reply_to']}:"
                                   f"{msg['get_id']}",
                           "flow_side": "emit",
                           "bytes": nbytes_of(value)})
        self.mem_release(msg["handle"], peer=msg["reply_to"])

    def _finish_get(self, eng: CommEngine, src: int, msg: dict) -> None:
        with self._frag_lock:
            # a resumed GET answered whole supersedes a half-landed zone
            if self._landing.pop(msg["get_id"], None) is not None:
                self.frag_active -= 1
        cb = self._pending_gets.pop(msg["get_id"], None)
        if cb is None:
            self.dup_get_replies += 1     # a replayed reply: idempotent
            return
        value = self._land_value(msg["value"])
        self._record_get_span(msg["get_id"], nbytes_of(value))
        cb(value)

    # -- fragmentation hooks (overridden by the device tiers) -----------------
    def _serve_value(self, h: MemHandle) -> Any:
        """What a GET of ``h`` serves (the device socket tier's D2H)."""
        return h.value

    def _land_value(self, value: Any) -> Any:
        """Final landing of every completed GET (the device tier moves it
        to its device and counts it)."""
        return value

    def _plan_frags(self, value: Any) -> tuple[list, dict] | None:
        """``(pieces, meta)`` for a payload above ``comm_get_frag_bytes``,
        ``pieces = [(byte_offset, nbytes, flat uint8 view), ...]``; None
        for the monolithic reply.  The host tier fragments CPU tensors."""
        fb = _params.get("comm_get_frag_bytes")
        if not fb or not isinstance(value, torch.Tensor) \
                or value.device.type != "cpu" or nbytes_of(value) <= fb:
            return None
        flat = value.contiguous().reshape(-1).view(torch.uint8)
        n = flat.numel()
        pieces = [(off, min(fb, n - off), flat[off:off + fb])
                  for off in range(0, n, fb)]
        meta = {"shape": tuple(value.shape),
                "dtype": dtype_name(value.dtype), "nbytes": n,
                "nfrags": len(pieces), "tier": "host"}
        return pieces, meta

    def _transport_frag(self, dst: int, get_id: int, offset: int,
                        nbytes: int, data: Any, meta: dict | None,
                        last: bool) -> None:
        """Ship one fragment: in process, the inbox carries a view of the
        registered buffer (the socket tier sends a DATA frame)."""
        self.fabric.deliver(dst, AM_TAG_GET_FRAG, self.rank,
                            (get_id, offset, nbytes, meta, data))

    # -- fragmentation: sender side -------------------------------------------
    def _start_frag_send(self, dst: int, get_id: int, handle_id: int,
                         plan: tuple[list, dict], trace: int = 0,
                         t0: int = 0) -> None:
        pieces, meta = plan
        if trace:
            # the first DATA frame's meta carries the trace; the later
            # fragments resolve through their get id
            meta = dict(meta, trace=trace)
        fs = _FragSend(dst, get_id, handle_id, pieces, meta, trace, t0)
        with self._frag_lock:
            self._frag_sends[(dst, get_id)] = fs
            self.frag_active += 1
        for _ in range(max(int(_params.get("comm_get_window")), 1)):
            if not self._send_next_frag(fs):
                break

    def _send_next_frag(self, fs: _FragSend) -> bool:
        i = fs.next
        if i >= len(fs.pieces):
            return False
        fs.next = i + 1
        off, n, data = fs.pieces[i]
        last = fs.next == len(fs.pieces)
        self._transport_frag(fs.dst, fs.get_id, off, n, data,
                             fs.meta if i == 0 else None, last)
        self.frags_out += 1
        self.frag_bytes_out += n
        pins.fire(PinsEvent.COMM_GET_FRAG_SENT, None, n)
        if last:
            with self._frag_lock:
                self._frag_sends.pop((fs.dst, fs.get_id), None)
                self.frag_active -= 1
            r = _spans.recorder
            if r is not None:
                r.record("comm.get_serve", fs.trace, fs.t0 or _now_ns(),
                         _now_ns(),
                         args={"flow": f"get:{fs.dst}:{fs.get_id}",
                               "flow_side": "emit",
                               "bytes": int(fs.meta.get("nbytes", 0)),
                               "frags": len(fs.pieces)})
            self.mem_release(fs.handle_id, peer=fs.dst)
        return True

    def _on_frag_ack(self, eng: CommEngine, src: int, payload: Any) -> None:
        with self._frag_lock:
            fs = self._frag_sends.get((src, payload[0]))
        if fs is not None:
            self._send_next_frag(fs)

    # -- fragmentation: receiver side -----------------------------------------
    def _zone_alloc(self, get_id: int, src: int, meta: dict) -> _LandingZone:
        zone = _LandingZone(get_id, src, meta)
        if meta["tier"] == "device":
            zone.frags = {}
        else:
            zone.dest = self._host_buffer(meta["shape"],
                                          torch_dtype_of(meta["dtype"]))
            zone.flat = zone.dest.view(-1).view(torch.uint8)
        return zone

    def _host_buffer(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """A host landing zone's destination (the device socket tier pins
        it, for an asynchronous H2D)."""
        return torch.empty(shape, dtype=dtype)

    def landing_view(self, get_id: int, src: int, offset: int, nbytes: int,
                     meta: dict | None) -> memoryview | None:
        """The writable destination slice of a DATA frame's bytes, for the
        socket receive thread's ``recv_into``; None for a fragment of a
        finished GET or one already landed (the caller discards it).

        The offset is marked landed only by :meth:`landing_commit`, after
        the bytes arrived: a receive that dies mid-body leaves no mark,
        and a replay on a fresh connection may be handed the same slice
        (identical bytes; exactly one commit wins)."""
        with self._frag_lock:
            zone = self._landing.get(get_id)
            if zone is None:
                if meta is None:
                    return None
                zone = self._zone_alloc(get_id, src, meta)
                self._landing[get_id] = zone
                self.frag_active += 1
            if offset in zone.landed:
                return None
        return memoryview(zone.flat[offset:offset + nbytes].numpy())

    def landing_commit(self, get_id: int, offset: int) -> bool:
        """Mark a fully received fragment landed; False when another
        delivery already committed it or the zone is gone."""
        with self._frag_lock:
            zone = self._landing.get(get_id)
            if zone is None or offset in zone.landed:
                return False
            zone.landed.add(offset)
            return True

    def _zone_write(self, zone: _LandingZone, offset: int,
                    data: torch.Tensor) -> None:
        zone.flat[offset:offset + data.numel()].copy_(data)

    def _zone_finish(self, zone: _LandingZone) -> torch.Tensor:
        return zone.dest

    def _on_frag(self, eng: CommEngine, src: int, payload: tuple) -> None:
        get_id, offset, nbytes, meta, data = payload
        with self._frag_lock:
            zone = self._landing.get(get_id)
            if zone is None:
                if data is None or meta is None:
                    # a fragment of a finished GET (in process), or one
                    # the socket receive thread landed into a zone that
                    # has retired since
                    self.dup_frags += 1
                    return
                zone = self._zone_alloc(get_id, src, meta)
                self._landing[get_id] = zone
                self.frag_active += 1
            if data is not None:
                if offset in zone.landed:
                    self.dup_frags += 1
                    return
                zone.landed.add(offset)
        if data is not None:
            # in process, the copy into the final destination, interleaved
            # with tasks; on the socket tier the receive thread landed it
            self._zone_write(zone, offset, data)
        zone.remaining -= nbytes
        self.frags_in += 1
        self.frag_bytes_in += nbytes
        pins.fire(PinsEvent.COMM_GET_FRAG_RECV, None, nbytes)
        self.send_am(AM_TAG_GET_FRAG_ACK, src, (get_id,))
        if zone.remaining > 0:
            return
        with self._frag_lock:
            self._landing.pop(get_id, None)
            self.frag_active -= 1
        value = self._land_value(self._zone_finish(zone))
        pins.fire(PinsEvent.COMM_GET_DONE, None, int(zone.meta["nbytes"]))
        self._record_get_span(get_id, int(zone.meta["nbytes"]))
        cb = self._pending_gets.pop(get_id, None)
        if cb is None:
            self.dup_get_replies += 1
            return
        cb(value)

    def on_peer_failed(self, rank: int) -> int:
        # a dead consumer's send windows never see their credits, and a
        # dead owner's landing zones never fill: drop both, or frag_active
        # stays up for good
        with self._frag_lock:
            for key in [k for k in self._frag_sends if k[0] == rank]:
                del self._frag_sends[key]
                self.frag_active -= 1
            for gid in [g for g, z in self._landing.items()
                        if z.src == rank]:
                del self._landing[gid]
                self.frag_active -= 1
        return super().on_peer_failed(rank)

    # -- progress -------------------------------------------------------------
    def pending(self) -> int:
        return self.fabric.pending(self.rank)

    def progress(self) -> int:
        # funnelled: one thread drives the engine at a time; the others
        # skip, so AM callbacks never interleave
        if not self._progress_lock.acquire(blocking=False):
            return 0
        try:
            n = 0
            if self.flush_hook is not None:
                n += self.flush_hook()
            for tag, src, payload in self.fabric.drain(self.rank):
                cb = self._am_callbacks.get(tag)
                if cb is None:
                    raise RuntimeError(f"no callback for AM tag {tag}")
                cb(self, src, payload)
                n += 1
            return n
        finally:
            self._progress_lock.release()

    def _on_barrier(self, eng: CommEngine, src: int, msg: dict) -> None:
        self._barrier_seen.setdefault(msg["gen"], set()).add(src)

    def sync(self, timeout: float = 30.0,
             failed: Callable[[], BaseException | None] | None = None
             ) -> None:
        """All-ranks barrier over AMs, progressing while waiting; raises
        at once when ``failed()`` returns an exception (a rank that
        failed never arrives)."""
        gen = self._barrier_gen = self._barrier_gen + 1
        seen = self._barrier_seen.setdefault(gen, set())
        for r in range(self.nranks):
            if r != self.rank:
                self.send_am(AM_TAG_BARRIER, r, {"gen": gen})
        deadline = time.monotonic() + timeout
        backoff = Backoff()
        while len(seen) < self.nranks - 1:
            if self.progress():
                backoff.reset()
            else:
                backoff.wait()      # leave the interpreter to busy ranks
            err = failed() if failed is not None else None
            if err is not None:
                raise RuntimeError(f"rank {self.rank}: barrier abandoned, "
                                   f"the run failed") from err
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {self.rank} barrier timeout")
        del self._barrier_seen[gen]

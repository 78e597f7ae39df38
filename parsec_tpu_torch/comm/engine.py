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

Left out: PINS events and trace spans (the port has no ``prof/``), the
socket tier's receive-thread landings (``landing_view``/``landing_commit``),
resumed and prefetch GETs, and per-peer failure handling
(``on_peer_failed``), which only the multi-process tier needs.
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

# Reserved AM tags (cf. parsec_comm_engine.h:24-40).
AM_TAG_GET_REQ = 1       # internal: rendezvous pull request
AM_TAG_GET_REPLY = 2     # internal: rendezvous payload delivery
AM_TAG_GET_ACK = 3       # remote-completion notification (activation ack)
AM_TAG_ACTIVATE = 4      # remote-dep activation
AM_TAG_TERMDET = 5       # termination-detection waves (fourcounter)
AM_TAG_BARRIER = 6       # context-level sync barrier
AM_TAG_GET_FRAG = 8      # internal: one rendezvous payload fragment
AM_TAG_GET_FRAG_ACK = 9  # internal: fragment credit (windowed pipelining)

_params.register("comm_get_frag_bytes", 4 << 20,
                 "rendezvous GETs above this many bytes are split into "
                 "fragments of this size and pipelined (0 = monolithic)")
_params.register("comm_get_window", 4,
                 "max in-flight unacked fragments per GET (each landed "
                 "fragment returns one credit)")


class MemHandle:
    """A published local buffer.  ``refcount`` counts the peers still
    expected to pull; the registration drops when it reaches zero."""

    __slots__ = ("handle_id", "rank", "value", "refcount")

    _ids = itertools.count(1)

    def __init__(self, rank: int, value: Any, refcount: int = 1) -> None:
        self.handle_id = next(MemHandle._ids)
        self.rank = rank
        self.value = value
        self.refcount = refcount

    def wire(self) -> tuple[int, int]:
        """The on-the-wire form: (owner rank, handle id)."""
        return (self.rank, self.handle_id)


class _FragSend:
    """Sender side of one fragmented reply: the pieces and the cursor the
    credit window advances."""

    __slots__ = ("dst", "get_id", "handle_id", "pieces", "meta", "next")

    def __init__(self, dst: int, get_id: int, handle_id: int,
                 pieces: list, meta: dict) -> None:
        self.dst = dst
        self.get_id = get_id
        self.handle_id = handle_id
        self.pieces = pieces        # [(byte_offset, nbytes, tensor), ...]
        self.meta = meta
        self.next = 0


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

    def attach(self, rank: int) -> "InprocCommEngine":
        return InprocCommEngine(self, rank)

    def deliver(self, dst: int, tag: int, src: int, payload: Any) -> None:
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

    frag_active = 0      # open landing zones and send windows

    def __init__(self, nranks: int, rank: int) -> None:
        self.nranks = nranks
        self.rank = rank
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

    def send_am(self, tag: int, dst: int, payload: Any) -> None:
        raise NotImplementedError

    # -- registered memory / one-sided ---------------------------------------
    def mem_register(self, value: Any, refcount: int = 1,
                     owned: bool = False) -> MemHandle:
        """Publish a buffer for one-sided GETs.  A tensor is snapshotted
        (see the module docstring) unless ``owned``."""
        if not owned and isinstance(value, torch.Tensor):
            value = value.clone()
        h = MemHandle(self.rank, value, refcount)
        with self._mem_lock:
            self._mem[h.handle_id] = h
        return h

    def mem_retrieve(self, handle_id: int) -> MemHandle | None:
        with self._mem_lock:
            return self._mem.get(handle_id)

    def mem_release(self, handle_id: int) -> None:
        """Drop one reference; unregister when drained."""
        with self._mem_lock:
            h = self._mem.get(handle_id)
            if h is None:
                return
            h.refcount -= 1
            if h.refcount <= 0:
                del self._mem[handle_id]

    def get(self, rwire: tuple[int, int],
            on_complete: Callable[[Any], None]) -> int:
        """One-sided pull of the remote buffer named by ``rwire``;
        ``on_complete(value)`` runs locally when the payload has landed."""
        raise NotImplementedError

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
    def send_am(self, tag: int, dst: int, payload: Any) -> None:
        # self-sends also go through the inbox: the callback runs from
        # progress(), never from the sender's stack
        self.fabric.deliver(dst, tag, self.rank, payload)

    # -- one-sided get: rendezvous through internal AMs ----------------------
    def get(self, rwire: tuple[int, int],
            on_complete: Callable[[Any], None]) -> int:
        owner, handle_id = rwire
        get_id = next(self._get_ids)
        self._pending_gets[get_id] = on_complete
        self.gets += 1
        self.send_am(AM_TAG_GET_REQ, owner,
                     {"handle": handle_id, "get_id": get_id,
                      "reply_to": self.rank})
        return get_id

    def _serve_get(self, eng: CommEngine, src: int, msg: dict) -> None:
        h = self.mem_retrieve(msg["handle"])
        if h is None:
            raise RuntimeError(
                f"rank {self.rank}: GET for unknown handle {msg['handle']}")
        plan = self._plan_frags(h.value)
        if plan is not None:
            # the receiver copies each fragment into a destination of its
            # own, so the pieces may be views of the registered snapshot
            self._start_frag_send(msg["reply_to"], msg["get_id"],
                                  msg["handle"], plan)
            return
        self.send_am(AM_TAG_GET_REPLY, msg["reply_to"],
                     {"get_id": msg["get_id"], "value": self._reply_value(h)})
        self.mem_release(msg["handle"])

    def _reply_value(self, h: MemHandle) -> Any:
        """What one consumer receives: a tensor of its own.  The snapshot
        is private to the engine, so the LAST consumer takes it as is."""
        value = h.value
        if isinstance(value, torch.Tensor) and h.refcount > 1:
            value = value.clone()
        return value

    def _finish_get(self, eng: CommEngine, src: int, msg: dict) -> None:
        cb = self._pending_gets.pop(msg["get_id"], None)
        if cb is None:
            self.dup_get_replies += 1     # a replayed reply: idempotent
            return
        cb(self._land_value(msg["value"]))

    # -- fragmentation hooks (overridden by the device tier) ------------------
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
        meta = {"shape": tuple(value.shape), "dtype": value.dtype,
                "nbytes": n, "nfrags": len(pieces), "tier": "host"}
        return pieces, meta

    # -- fragmentation: sender side -------------------------------------------
    def _start_frag_send(self, dst: int, get_id: int, handle_id: int,
                         plan: tuple[list, dict]) -> None:
        pieces, meta = plan
        fs = _FragSend(dst, get_id, handle_id, pieces, meta)
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
        self.fabric.deliver(fs.dst, AM_TAG_GET_FRAG, self.rank,
                            (fs.get_id, off, n, fs.meta if i == 0 else None,
                             data))
        self.frags_out += 1
        self.frag_bytes_out += n
        if last:
            with self._frag_lock:
                self._frag_sends.pop((fs.dst, fs.get_id), None)
                self.frag_active -= 1
            self.mem_release(fs.handle_id)
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
            zone.dest = torch.empty(meta["shape"], dtype=meta["dtype"])
            zone.flat = zone.dest.view(-1).view(torch.uint8)
        return zone

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
                if meta is None:
                    self.dup_frags += 1    # a fragment of a finished GET
                    return
                zone = self._zone_alloc(get_id, src, meta)
                self._landing[get_id] = zone
                self.frag_active += 1
            if offset in zone.landed:
                self.dup_frags += 1
                return
            zone.landed.add(offset)
        # the copy into the final destination, interleaved with tasks
        self._zone_write(zone, offset, data)
        zone.remaining -= nbytes
        self.frags_in += 1
        self.frag_bytes_in += nbytes
        self.send_am(AM_TAG_GET_FRAG_ACK, src, (get_id,))
        if zone.remaining > 0:
            return
        with self._frag_lock:
            self._landing.pop(get_id, None)
            self.frag_active -= 1
        value = self._land_value(self._zone_finish(zone))
        cb = self._pending_gets.pop(get_id, None)
        if cb is None:
            self.dup_get_replies += 1
            return
        cb(value)

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

"""Socket transport: ranks as separate processes over TCP.

Port of ``parsec_tpu/comm/socket_fabric.py``: each rank is its own OS
process, active messages and rendezvous payloads move over TCP, and the
protocol above the engine vtable (activations, propagation trees,
coalescing, termination waves, DTD pushes) runs unchanged.

Wire format, the JAX package's byte for byte: every frame is a 40-byte
header ``<BBHIQQQQ`` = (kind, flags, tag, src, seq, u0, u1, u2) and a
body by kind:

- ``CTRL``, an active message: u0 = meta length, u1 = the raw segments'
  bytes, u2 = the trace-context word (always 0 here).  Body = the codec
  meta (:mod:`.codec`) and the raw segments, sent with ``sendmsg``
  scatter-gather from the payload's own buffers and received with
  ``recv_into`` into the decoded values' final buffers.
- ``ACK``, a cumulative receive ack: header only, seq = acked up to.
- ``DATA``, one rendezvous GET fragment: u0 = get id, u1 = byte offset,
  u2 = fragment length; flag bit 0 marks the first fragment (its body
  starts with the codec-encoded shape/dtype meta).  The receive thread
  asks the engine for the fragment's destination slice
  (:meth:`~parsec_tpu_torch.comm.engine.InprocCommEngine.landing_view`)
  and ``recv_into``\\ s it there.

Rank *i* listens on ``base_port + i``; connections are made lazily with
connect-retry (ranks boot in any order).  The host list is localhost
unless ``PARSEC_TPU_HOSTS=h0,h1,...`` names one host a rank.

Fault model: TCP delivers in order on one connection, but a broken
connection loses what it had in flight.  Each peer channel carries a
rising ``seq``; the sender keeps every unacked frame in a bounded replay
window and, when a send fails, reconnects and replays the window; the
receiver acks cumulatively every ``comm_socket_ack_every`` frames and
drops duplicates by seq, so a reset between two ranks is invisible above
the fabric.  ``comm_socket_fault_p`` breaks connections on purpose
(tests).

Use :func:`parsec_tpu_torch.comm.multiproc.run_multiproc` to launch N
rank processes (the ``mpiexec -np N`` analog).

Left out: the legacy length-prefixed pickle framing
(``comm_wire_binary=False``), trace spans and the pooled wire buffers of
the JAX package's ``data/arena.py`` (a plain buffer per meta here).
"""

from __future__ import annotations

import logging
import os
import random
import socket
import struct
import threading
import time
from collections import deque
from typing import Any

from ..core.params import params as _params
from . import codec
from .engine import AM_TAG_GET_FRAG, InprocCommEngine

_params.register("comm_socket_ack_every", 16,
                 "receiver sends a cumulative ack after this many frames "
                 "(bounds the sender's replay window)")
_params.register("comm_socket_fault_p", 0.0,
                 "fault injection: probability per outgoing frame of "
                 "breaking the connection first (0 disables)")
_params.register("comm_socket_fault_seed", 0,
                 "seed for the fault-injection RNG (the rank is added)")

# unacked frames kept per peer for reconnect replay: far above what one
# ack period leaves in flight, so a full window means the peer stopped
# acking, which is an error rather than a wait
_REPLAY_WINDOW = 4096
# SO_SNDBUF/SO_RCVBUF hint per connection: a 4 MiB buffer holds a whole
# default-size GET fragment in flight (the kernel clamps it to its cap)
_SOCK_BUF_BYTES = 1 << 22

_log = logging.getLogger(__name__)

# binary frame header: kind, flags, tag, src, seq, u0, u1, u2
_HDR = struct.Struct("<BBHIQQQQ")
K_CTRL = 1
K_ACK = 2
K_DATA = 3
F_FIRST = 1       # DATA: first fragment (body carries the shape/dtype meta)
F_LAST = 2        # DATA: last fragment of its GET
_U32 = struct.Struct("<I")

# Linux caps one sendmsg at UIO_MAXIOV iovecs; stay under it
_IOV_MAX = 512


def _tune_socket(s: socket.socket) -> None:
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF_BYTES)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF_BYTES)
    except OSError:
        pass        # a capped kernel clamps silently anyway


def _hosts(nranks: int) -> list[str]:
    spec = os.environ.get("PARSEC_TPU_HOSTS", "")
    hosts = [h.strip() for h in spec.split(",") if h.strip()]
    if not hosts:
        hosts = ["127.0.0.1"]
    return [hosts[r % len(hosts)] for r in range(nranks)]


def _recv_exact_into(sock: socket.socket, mv: memoryview) -> bool:
    """Fill ``mv`` from the socket; False on EOF."""
    while mv.nbytes:
        n = sock.recv_into(mv)
        if n == 0:
            return False
        mv = mv[n:]
    return True


def _drain(sock: socket.socket, n: int) -> bool:
    """Consume and discard ``n`` body bytes (a duplicate or stale frame's
    payload, which has nowhere to land)."""
    mv = memoryview(bytearray(min(n, 1 << 16)))
    while n:
        take = mv[:min(n, mv.nbytes)]
        if not _recv_exact_into(sock, take):
            return False
        n -= take.nbytes
    return True


def _sendmsg_all(sock: socket.socket, bufs: list) -> None:
    """``sendmsg`` the scatter-gather list fully, resuming after short
    writes and chunking to the iovec limit."""
    views = []
    for b in bufs:
        v = memoryview(b).cast("B")
        if v.nbytes:
            views.append(v)
    while views:
        chunk = views[:_IOV_MAX]
        chunk_total = sum(v.nbytes for v in chunk)
        n = sock.sendmsg(chunk)
        if n >= chunk_total:
            del views[:len(chunk)]
            continue
        while n:
            if n >= views[0].nbytes:
                n -= views[0].nbytes
                views.pop(0)
            else:
                views[0] = views[0][n:]
                n = 0


class SocketFabric:
    """One process's endpoint of the TCP mesh (the in-process fabric's
    ``deliver``/``drain``/``pending`` for the local rank).

    Receive-side channel state (``_inbox``, ``_seen``, ``_unacked_in``,
    ``peer_rx``, ``bytes_recv``, ``dup_frames``, ``recv_s``) changes under
    ``_ilock``, which every receive thread shares; the peer table and the
    send ledgers (``_peers``, ``_accepted``, ``bytes_sent``, ``peer_tx``,
    ``send_s``) under ``_plock``; a peer entry's connection, seq and
    window under that entry's own send lock.  No site holds ``_plock``
    and ``_ilock`` together."""

    def __init__(self, nranks: int, rank: int, base_port: int) -> None:
        self.nranks = nranks
        self.rank = rank
        self.base_port = base_port
        self.hosts = _hosts(nranks)
        self._inbox: deque = deque()
        self._ilock = threading.Lock()
        # dst -> [sock|None, send lock, next seq, unacked deque[(seq, bufs)]]
        self._peers: dict[int, list] = {}
        self._plock = threading.Lock()
        # highest seq seen per src (duplicate drops), frames since last ack
        self._seen: dict[int, int] = {}
        self._unacked_in: dict[int, int] = {}
        self.replays = 0          # reconnect-and-replay events
        self.dup_frames = 0       # duplicate frames dropped
        self.bytes_sent = 0       # framed bytes sent
        self.bytes_recv = 0       # framed bytes received
        # seconds spent sending frames (the replay window's copy and the
        # sendmsg) and receiving frame bodies (their bytes arriving)
        self.send_s = 0.0
        self.recv_s = 0.0
        # per-peer ledgers: rank -> [bytes, frames, frags]
        self.peer_tx: dict[int, list] = {}
        self.peer_rx: dict[int, list] = {}
        # engine hook: DATA-frame bytes land through it (None until an
        # engine attaches: earlier frames drain to scratch)
        self.landing_view = None
        # engine setting: CTRL payloads' tensors decode into pinned host
        # memory (the device socket tier's H2D source)
        self.pin_tensors = False
        self._fault_p = float(_params.get("comm_socket_fault_p"))
        self._fault_rng = random.Random(
            _params.get("comm_socket_fault_seed") + rank) \
            if self._fault_p > 0.0 else None
        # engine hook: called with a rank that stays unreachable past the
        # reconnect budget (SocketCommEngine points it at on_peer_failed)
        self.on_peer_dead = None
        self._accepted: list[socket.socket] = []   # inbound conns, for close
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", self.base_port + rank))
        self._listener.listen(nranks)
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_main, daemon=True,
            name=f"parsec-sock-accept-r{rank}")
        self._accept_thread.start()

    # ------------------------------------------------------------ receive
    def _accept_main(self) -> None:
        while not self._stop.is_set():
            try:
                self._listener.settimeout(0.2)
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._plock:
                self._accepted.append(conn)
            if self._stop.is_set():
                # raced with close(), which may have cleared _accepted
                # before the append: close the connection here
                _close(conn)
                return
            threading.Thread(target=self._recv_main, args=(conn,),
                             daemon=True).start()

    def _recv_main(self, conn: socket.socket) -> None:
        _tune_socket(conn)
        ack_every = _params.get("comm_socket_ack_every")
        hdr = bytearray(_HDR.size)
        while not self._stop.is_set():
            try:
                if not _recv_exact_into(conn, memoryview(hdr)):
                    return
                kind, flags, tag, src, seq, u0, u1, u2 = _HDR.unpack(hdr)
                if kind == K_ACK:
                    self._prune_unacked(src, seq)
                elif kind == K_CTRL:
                    self._recv_ctrl(conn, tag, src, seq, u0, u1, ack_every)
                elif kind == K_DATA:
                    self._recv_data(conn, flags, src, seq, u0, u1, u2,
                                    ack_every)
                else:
                    raise ValueError(f"unknown wire frame kind {kind}")
            except OSError:
                return
            except Exception as e:
                # a corrupt frame kills only this connection, visibly; the
                # peer's replay window re-sends what it had in flight
                _log.warning("socket fabric rank %d: dropping connection "
                             "on undecodable frame: %r", self.rank, e)
                _close(conn)
                return

    def _rx_account(self, src: int, nbytes: int, frag: bool) -> None:
        """Caller holds ``_ilock``."""
        self.bytes_recv += nbytes
        rx = self.peer_rx.get(src)
        if rx is None:
            rx = self.peer_rx[src] = [0, 0, 0]
        rx[0] += nbytes
        rx[1] += 1
        if frag:
            rx[2] += 1

    def _recv_ctrl(self, conn: socket.socket, tag: int, src: int, seq: int,
                   meta_len: int, seg_bytes: int, ack_every: int) -> None:
        t0 = time.perf_counter()
        meta = bytearray(meta_len)
        if not _recv_exact_into(conn, memoryview(meta)):
            raise OSError("peer closed mid-frame (meta)")

        def fill(view: memoryview) -> None:
            # segment bytes land in the decoded payload's final buffers
            if not _recv_exact_into(conn, view):
                raise OSError("peer closed mid-frame (segment)")

        payload = codec.decode(meta, fill, pin_tensors=self.pin_tensors)
        with self._ilock:
            self.recv_s += time.perf_counter() - t0
            self._rx_account(src, _HDR.size + meta_len + seg_bytes, False)
            if seq <= self._seen.get(src, 0):
                self.dup_frames += 1         # replay overlap: drop
            else:
                self._seen[src] = seq
                self._inbox.append((tag, src, payload))
            ack_now = self._ack_bookkeeping(src, ack_every)
        if ack_now is not None:
            self._send_ack(src, ack_now)

    def _recv_data(self, conn: socket.socket, flags: int, src: int,
                   seq: int, get_id: int, offset: int, nbytes: int,
                   ack_every: int) -> None:
        t0 = time.perf_counter()
        meta = None
        extra = 0
        if flags & F_FIRST:
            mlen_buf = bytearray(4)
            if not _recv_exact_into(conn, memoryview(mlen_buf)):
                raise OSError("peer closed mid-frame (frag meta len)")
            mlen = _U32.unpack(mlen_buf)[0]
            mbuf = bytearray(mlen)
            if not _recv_exact_into(conn, memoryview(mbuf)):
                raise OSError("peer closed mid-frame (frag meta)")
            meta = codec.decode_with_segments(mbuf, [])
            extra = 4 + mlen
        with self._ilock:
            dup = seq <= self._seen.get(src, 0)
        committed = False
        dups = 0    # published under _ilock below
        if dup:
            dups += 1
            if not _drain(conn, nbytes):
                raise OSError("peer closed mid-frame (dup frag)")
        else:
            lv = self.landing_view
            mv = lv(get_id, src, offset, nbytes, meta) if lv else None
            if mv is None:
                # stale fragment (its GET completed, or no engine yet)
                if not _drain(conn, nbytes):
                    raise OSError("peer closed mid-frame (stale frag)")
            else:
                # a receive that dies here leaves no landed mark, so the
                # peer's replay re-lands it; if a replay committed first,
                # these identical bytes stand down
                if not _recv_exact_into(conn, mv):
                    raise OSError("peer closed mid-frame (frag body)")
                committed = lv.__self__.landing_commit(get_id, offset)
                if not committed:
                    dups += 1
        with self._ilock:
            self.recv_s += time.perf_counter() - t0
            self.dup_frames += dups
            self._rx_account(src, _HDR.size + extra + nbytes, True)
            if not dup:
                self._seen[src] = max(self._seen.get(src, 0), seq)
                if committed:
                    self._inbox.append((AM_TAG_GET_FRAG, src,
                                        (get_id, offset, nbytes, None,
                                         None)))
            ack_now = self._ack_bookkeeping(src, ack_every)
        if ack_now is not None:
            self._send_ack(src, ack_now)

    def _ack_bookkeeping(self, src: int, ack_every: int) -> int | None:
        """Caller holds ``_ilock``; the seq to ack now, if due."""
        n = self._unacked_in.get(src, 0) + 1
        if n >= ack_every:
            self._unacked_in[src] = 0
            return self._seen.get(src, 0)
        self._unacked_in[src] = n
        return None

    def _prune_unacked(self, src: int, upto: int) -> None:
        with self._plock:
            ent = self._peers.get(src)
        if ent is None:
            return
        with ent[1]:
            q = ent[3]
            while q and q[0][0] <= upto:
                q.popleft()

    def _peer_entry(self, dst: int) -> list:
        with self._plock:
            ent = self._peers.get(dst)
            if ent is None:
                ent = self._peers[dst] = [None, threading.Lock(), 0, deque()]
            return ent

    def _send_ack(self, src: int, upto: int) -> None:
        """Best-effort cumulative ack, never replayed (a lost ack leaves
        the peer's window larger until the next).  It runs on a receive
        thread, so a missing reverse connection gets a short connect
        budget; a failed send drops the socket (the next ack reconnects)
        and never declares the peer dead."""
        ent = self._peer_entry(src)
        ack = _HDR.pack(K_ACK, 0, 0, self.rank, upto, 0, 0, 0)
        with ent[1]:
            try:
                if ent[0] is None:
                    ent[0] = self._connect(src, retry_s=2.0,
                                           report_dead=False)
                ent[0].sendall(ack)
            except OSError:
                if ent[0] is not None:
                    _close(ent[0], shutdown=False)
                    ent[0] = None

    # --------------------------------------------------------------- send
    def _connect(self, dst: int, retry_s: float = 30.0,
                 report_dead: bool = True) -> socket.socket:
        """Connect to ``dst``, retrying refusals for up to ``retry_s``
        (peers still booting); bails at once on teardown.  Past the budget
        the peer is reported dead unless ``report_dead`` is False."""
        deadline = time.monotonic() + retry_s
        while True:
            if self._stop.is_set():
                raise OSError("fabric is shutting down")
            try:
                s = socket.create_connection(
                    (self.hosts[dst], self.base_port + dst), timeout=2.0)
                break
            except OSError:
                if time.monotonic() > deadline:
                    if report_dead:
                        self._peer_dead(dst)
                    raise
                time.sleep(0.05)   # peer still booting
        # connected: blocking from here (the timeout was for the connect)
        s.settimeout(None)
        _tune_socket(s)
        return s

    def _peer_dead(self, dst: int) -> None:
        """Tell the engine that ``dst`` stayed unreachable, so it releases
        what it holds for that rank."""
        cb = self.on_peer_dead
        if cb is not None:
            try:
                cb(dst)
            except Exception:       # a GC hook must never mask the OSError
                pass

    def deliver(self, dst: int, tag: int, src: int, payload: Any) -> None:
        if dst == self.rank:
            with self._ilock:
                self._inbox.append((tag, src, payload))
            return
        # encoding runs outside the send lock; only the seq-stamped header
        # is built inside
        meta, segs = codec.encode(payload)
        seg_bytes = sum(memoryview(s).nbytes for s in segs)

        def frame(seq: int) -> list:
            return [_HDR.pack(K_CTRL, 0, tag, src, seq, len(meta), seg_bytes,
                              0), meta, *segs]
        self._send_frame(dst, frame, _HDR.size + len(meta) + seg_bytes,
                         frag=False, snapshot=True)

    def deliver_data(self, dst: int, get_id: int, offset: int, nbytes: int,
                     data: Any, meta: dict | None, last: bool) -> None:
        """Ship one GET fragment as a DATA frame, its bytes sent
        scatter-gather from the registered buffer."""
        flags = (F_FIRST if meta is not None else 0) | (F_LAST if last else 0)
        head: list = []
        if meta is not None:
            mblob, msegs = codec.encode(meta)
            if msegs:
                raise ValueError("fragment meta must be segment-free")
            head = [_U32.pack(len(mblob)), mblob]
        extra = sum(len(b) for b in head)

        def frame(seq: int) -> list:
            return [_HDR.pack(K_DATA, flags, 0, self.rank, seq,
                              get_id, offset, nbytes), *head, data]
        self._send_frame(dst, frame, _HDR.size + extra + nbytes, frag=True)

    def _send_frame(self, dst: int, frame, nbytes: int, frag: bool,
                    snapshot: bool = False) -> None:
        """Seq-stamp, window, account and transmit one frame.

        ``snapshot=True`` keeps byte copies of the frame's buffers in the
        replay window while the zero-copy views go out: a CTRL payload
        may change after ``send_am`` returns, and a replay must resend it
        as it was.  DATA frames skip it: their source is a registered
        buffer the engine keeps unchanged until the GET completes."""
        t0 = time.perf_counter()
        ent = self._peer_entry(dst)
        with ent[1]:     # frames must not interleave on one connection
            if len(ent[3]) >= _REPLAY_WINDOW:
                raise RuntimeError(
                    f"rank {self.rank}: replay window to rank {dst} full "
                    f"({len(ent[3])} unacked frames): peer stopped acking")
            ent[2] += 1
            seq = ent[2]
            bufs = frame(seq)
            with self._plock:
                self.bytes_sent += nbytes
                tx = self.peer_tx.get(dst)
                if tx is None:
                    tx = self.peer_tx[dst] = [0, 0, 0]
                tx[0] += nbytes
                tx[1] += 1
                if frag:
                    tx[2] += 1
            if snapshot:
                ent[3].append((seq, [bytes(memoryview(b).cast("B"))
                                     for b in bufs]))
            else:
                ent[3].append((seq, bufs))
            if ent[0] is None:
                ent[0] = self._connect(dst)
            if (self._fault_rng is not None
                    and self._fault_rng.random() < self._fault_p):
                # injected fault: break the live connection so this send
                # fails and takes the reconnect-and-replay path
                try:
                    ent[0].shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            try:
                _sendmsg_all(ent[0], bufs)
            except OSError:
                self._reconnect_and_replay(dst, ent)
        with self._plock:
            self.send_s += time.perf_counter() - t0

    def _reconnect_and_replay(self, dst: int, ent: list) -> None:
        """Reconnect and resend the whole unacked window in order (caller
        holds the send lock); the receiver's seq check drops the overlap."""
        if ent[0] is not None:
            _close(ent[0], shutdown=False)
        ent[0] = None
        self.replays += 1
        ent[0] = self._connect(dst, retry_s=5.0)
        for _seq, bufs in list(ent[3]):
            _sendmsg_all(ent[0], bufs)   # a second failure here is fatal

    def peer_stats(self) -> dict:
        """Per-peer ledgers: ``{"tx"|"rx": {rank: {bytes, frames,
        frags}}}``."""
        with self._plock:
            tx = {d: {"bytes": v[0], "frames": v[1], "frags": v[2]}
                  for d, v in self.peer_tx.items()}
        with self._ilock:
            rx = {s: {"bytes": v[0], "frames": v[1], "frags": v[2]}
                  for s, v in self.peer_rx.items()}
        return {"tx": tx, "rx": rx}

    # ----------------------------------------------------- drain (local)
    def drain(self, rank: int, limit: int = 64) -> list[tuple]:
        assert rank == self.rank
        out = []
        with self._ilock:
            while self._inbox and len(out) < limit:
                out.append(self._inbox.popleft())
        return out

    def pending(self, rank: int) -> int:
        assert rank == self.rank
        with self._ilock:
            return len(self._inbox)

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._plock:
            for ent in self._peers.values():
                if ent[0] is not None:
                    _close(ent[0])
            self._peers.clear()
            # shutdown (not close alone) wakes receive threads parked in
            # recv(2), so no thread or fd outlives the fabric
            for conn in self._accepted:
                _close(conn)
            self._accepted.clear()


def _close(conn: socket.socket, shutdown: bool = True) -> None:
    """Shut down (which raises ENOTCONN on a dead peer) and close, each
    on its own."""
    if shutdown:
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    try:
        conn.close()
    except OSError:
        pass


class SocketCommEngine(InprocCommEngine):
    """The engine vtable over :class:`SocketFabric`: the fabric offers the
    in-process fabric's surface, so the AM, rendezvous-GET and barrier
    protocol is inherited whole; fragments travel as DATA frames."""

    def __init__(self, fabric: SocketFabric) -> None:
        super().__init__(fabric, fabric.rank)
        # a rank unreachable past the reconnect budget releases its
        # registration shares
        fabric.on_peer_dead = self.on_peer_failed
        # DATA-frame bytes land through the engine's zones from the
        # fabric's receive threads
        fabric.landing_view = self.landing_view

    def snapshot_value(self, value: Any) -> Any:
        """A message's payload is encoded and sent (its bytes copied into
        the replay window) before ``send_am`` returns, so a host tensor
        needs no copy of its own; a CUDA tensor comes to the host here,
        once (the D2H on the current stream, after its writer)."""
        if getattr(value, "is_cuda", False):
            return value.cpu()
        return value

    def _transport_frag(self, dst: int, get_id: int, offset: int,
                        nbytes: int, data: Any, meta: dict | None,
                        last: bool) -> None:
        if dst == self.rank:
            super()._transport_frag(dst, get_id, offset, nbytes, data,
                                    meta, last)
            return
        if not isinstance(data, memoryview):
            data = memoryview(data.numpy())      # a flat uint8 CPU view
        self.fabric.deliver_data(dst, get_id, offset, nbytes, data, meta,
                                 last)

    def fini(self) -> None:
        super().fini()          # drop leftover registrations first
        self.fabric.close()

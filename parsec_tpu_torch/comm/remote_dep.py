"""Remote dependency activation: ``release_deps`` across ranks.

Port of ``parsec_tpu/comm/remote_dep.py`` (the reference's
``remote_dep.c`` / ``remote_dep_mpi.c``):

- the producer's ``release_deps`` accumulates, per output flow, the ranks
  that need it into a :class:`RemoteDeps` record instead of releasing
  locally;
- :meth:`RemoteDepEngine.activate` packs one activation {taskpool comm
  id, task class id, locals, output descriptors}, **inlines payloads** of
  at most ``comm_short_limit`` bytes, registers larger ones for a
  rendezvous GET, and sends it down a **propagation tree** (binomial,
  chain or star) that every hop re-derives from the sorted participant
  list;
- the receiver rebuilds the producer as a *ghost task*, re-runs its
  successor walk restricted to this rank to learn where each payload
  lands, pulls the registered payloads, releases its local successors
  into the scheduler, re-registers what it landed for its tree children,
  and acknowledges;
- every activation in flight holds a **pending action** on the producing
  pool's termination detector until its consumer acknowledges it, and
  counts in the four-counter detector's message totals.

Activations to one peer are staged and flushed as one message per peer,
highest priority first.  A write-back edge whose home tile lies on
another rank rides the same activation; only the home rank applies it.
A ``wire=`` sub-view of an output is cut before the send.

**Mutable payloads** (see :mod:`.engine`): the JAX engine copies host
slices only; here a wire sub-view is always cut into a tensor of its own
(:func:`_slice_view`), an inlined payload is cloned at the send and again
by each receiver, and the registration snapshots the tile, so no later
in-place write by a local successor reaches a remote consumer.  The
output registered is the producing task's own copy of the flow, which
after a device task is its device copy, the newest version.

The counters ``payload_bytes_staged`` (payload bytes this rank sent as a
tree root, once per receiving peer) and ``payload_bytes_received`` stay
plain attributes.

The DTD message channel (:meth:`RemoteDepEngine.dtd_send`, tag
``AM_TAG_DTD``) carries the tile pushes and flushes of multi-rank DTD
(:mod:`parsec_tpu_torch.dtd.insert`); each message holds a pending action
of its pool until acknowledged, and a message for a pool not registered
here yet waits for its registration, as an activation does.

**The comm thread** (``comm_thread``, off by default as in the JAX
package; the reference's ``remote_dep_dequeue_main``): with it on,
:meth:`RemoteDepEngine.enable` starts one thread per rank that runs
``flush_outgoing()`` and the engine's ``progress()`` under a backoff, so
a GET or an activation is served while every worker runs a task.  The
workers' opportunistic progress stays: the engine's non-blocking
progress lock lets one driver at a time drain a queue, whichever thread
it is.  The outgoing stage becomes the thread's mailbox (senders stop
flushing at the end of each send batch, ``_flush_if_unthreaded``).  A
failure in the thread is recorded on the context
(``ctx.record_failure``), so a dead comm thread fails the run instead of
hanging it; :meth:`RemoteDepEngine.stop_thread` stops and joins it, from
``fini`` and from the context's ``abort``.  The thread
touches only the comm engine: with ``run_multiproc(distributed=True)``
the ranks' gloo group serves discovery alone, and the thread never calls
it.  :meth:`RemoteDepEngine.debug_state` reports it.

PINS: ``COMM_ACTIVATE_SEND`` (payload: ``(dst_rank, seq)``) for each
activation sent down a tree, ``COMM_ACK_RECV`` (payload: the seq) for each
acknowledgement, and the activation callback span ``ACTIVATE_CB_BEGIN``
/ ``_END`` (payload: ``(src, seq)``) around a received activation's
handling.

**Traces.**  An activation carries its pool's trace (``tp._trace``, 0
when untraced) as the last element of its wire tuple
(:func:`pack_activation`, the JAX package's 11-element form), through
every hop of the tree; a lone activation also carries it in the frame
header, and its GETs carry it to the owner.  With the span recorder on,
a traced hop records ``comm.activate`` on both ends, flow-keyed
``act:<src>:<seq>`` (``emit`` at the send, ``recv`` over the landing).  The engine registers its live gauges
(``comm::rank<r>::inflight``, ``bytes_out``, ``bytes_in``,
``wire_bytes_out``, ``wire_bytes_in``, ``frags_in``, ``frag_bytes_in``)
in :data:`parsec_tpu_torch.prof.sde` and the ``comm`` / ``rank<r>``
property (fragment state and per-peer ledgers) in
:data:`parsec_tpu_torch.prof.properties`, and drops them at ``fini``.

The wire carries the producer's type; a typed edge repacks on the
receiving side (:mod:`parsec_tpu_torch.data.reshape`): a successor's input
dep type wins over the output dep's, and a write-back converts to the
dep's type or back to the home tile's.

Left out: the switches that turn coalescing and wire views off
(``comm_coalesce``, ``comm_wire_datatypes``: nothing in the port turns
them off).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any

import torch

from ..core.backoff import Backoff
from ..core.params import MCAParamValueError
from ..core.params import params as _params
from ..data.data import data_create, nbytes_of
from ..data.reshape import reshape_for_edge, reshape_for_writeback
from ..data.datatype import to_tensor, wire_slice_key
from ..prof import pins, spans as _spans
from ..prof.counters import properties, sde
from ..prof.pins import PinsEvent
from ..runtime.scheduling import (ExecutionStream, _find_input_dep,
                                  _rank_of_task, apply_writeback_to_home,
                                  schedule_tasks)
from ..runtime.task import Task
from .codec import dtype_name
from .engine import (AM_TAG_ACTIVATE, AM_TAG_DTD, AM_TAG_GET_ACK,
                     AM_TAG_TERMDET, CommEngine)

_now_ns = time.perf_counter_ns

_params.register("comm_short_limit", 4096,
                 "payloads at most this many bytes ride inside the "
                 "activation message (short-message inlining)")
_params.register("comm_thread", False,
                 "run a dedicated comm-progress thread per rank "
                 "(remote_dep_dequeue_main)")
_params.register("comm_bcast_tree", "binomial",
                 "multi-peer activation propagation: binomial|chain|star, "
                 "or auto (per payload: resolve_tree_kind)")
_params.declare_knob("comm_bcast_tree",
                     values=("binomial", "chain", "star", "auto"))


def _wire_value(value: Any) -> torch.Tensor:
    """A payload as a tensor (the port's tiles already are)."""
    return value if isinstance(value, torch.Tensor) else to_tensor(value)


def _slice_view(value: torch.Tensor, view_key: tuple) -> torch.Tensor:
    """Cut the wire view out of a tile, as a tensor of its own: a slice
    is a view, and the wire must not alias a tile a local successor may
    write.  An out-of-range view is an error, not a silent clamp."""
    sl = []
    for axis, s in enumerate(view_key):
        s = slice(*s) if isinstance(s, (tuple, list)) else s
        if isinstance(s, slice) and s.stop is not None \
                and s.stop > value.shape[axis]:
            raise ValueError(
                f"wire view {view_key} exceeds tile shape "
                f"{tuple(value.shape)} on axis {axis}")
        sl.append(s)
    return value[tuple(sl)].clone()


# ---------------------------------------------------------------------------
# the activation's positional wire form (no nested per-message dicts)
# ---------------------------------------------------------------------------

_OPT_DESC_KEYS = ("version", "inline", "wire", "shape", "dtype", "wire_view")


def _pack_desc(d: dict) -> tuple:
    flags = 0
    vals = []
    for i, k in enumerate(_OPT_DESC_KEYS):
        if k in d:
            flags |= 1 << i
            vals.append(d[k])
    return (d["flow_index"], 1 if d.get("writeback") else 0, flags, *vals)


def _unpack_desc(t: tuple) -> dict:
    d = {"flow_index": t[0], "writeback": bool(t[1])}
    flags, j = t[2], 3
    for i, k in enumerate(_OPT_DESC_KEYS):
        if flags & (1 << i):
            d[k] = t[j]
            j += 1
    return d


def pack_activation(msg: dict) -> tuple:
    """dict activation -> positional wire tuple (tag ``"A"``); the last
    element is the request's 8-byte trace (0 = untraced)."""
    return ("A", msg["tp"], msg["tc"], msg["locals"],
            [_pack_desc(d) for d in msg["outputs"]], msg["ranks"],
            msg["tree"], msg["priority"], msg["seq"], msg["pos"],
            msg.get("trace") or 0)


def unpack_activation(t: tuple) -> dict:
    return {"tp": t[1], "tc": t[2], "locals": t[3],
            "outputs": [_unpack_desc(x) for x in t[4]], "ranks": t[5],
            "tree": t[6], "priority": t[7], "seq": t[8], "pos": t[9],
            # a 10-element tuple (no trace) still reads
            "trace": t[10] if len(t) > 10 else 0}


def _packed_trace(m: Any) -> int:
    """The trace of one staged activation (0 when it carries none)."""
    if type(m) is tuple and len(m) > 10 and type(m[10]) is int:
        return m[10]
    return 0


# ---------------------------------------------------------------------------
# propagation trees: positions index the sorted participant list, position
# 0 the root; children are re-derived identically at every hop
# ---------------------------------------------------------------------------

TREE_KINDS = ("binomial", "chain", "star")


def _check_tree_kind(kind: str) -> None:
    if kind not in TREE_KINDS:
        raise MCAParamValueError("comm_bcast_tree", kind, TREE_KINDS)


def resolve_tree_kind(kind: str | None = None, *,
                      nbytes: int | None = None,
                      n: int | None = None) -> str:
    """A tree-shape request (the ``comm_bcast_tree`` param when ``kind``
    is None) as a member of :data:`TREE_KINDS`.  ``auto`` takes the star
    for payloads that ride inline on at most 8 participants, else the
    binomial tree (the root re-serves at most ceil(log2 n) copies).  The
    wire never carries ``auto``."""
    if kind is None:
        kind = _params.get("comm_bcast_tree")
    if kind == "auto":
        if nbytes is not None \
                and 0 < nbytes <= _params.get("comm_short_limit") \
                and (n if n is not None else 2) <= 8:
            return "star"
        return "binomial"
    _check_tree_kind(kind)
    return kind


def tree_children(kind: str, position: int, n: int) -> list[int]:
    _check_tree_kind(kind)
    if n <= 1:
        return []
    if kind == "star":
        return list(range(1, n)) if position == 0 else []
    if kind == "chain":
        return [position + 1] if position + 1 < n else []
    # binomial: the children of p are p + 2^j for 2^j > p
    out = []
    j = 1
    while j <= position:
        j <<= 1
    while position + j < n:
        out.append(position + j)
        j <<= 1
    return out


def tree_parent(kind: str, position: int, n: int) -> int | None:
    """The inverse of :func:`tree_children` (None for the root): the
    binomial parent is the position with its highest set bit cleared."""
    _check_tree_kind(kind)
    if position <= 0 or n <= 1:
        return None
    if kind == "star":
        return 0
    if kind == "chain":
        return position - 1
    return position & ~(1 << (position.bit_length() - 1))


# ---------------------------------------------------------------------------
# producer-side accumulation
# ---------------------------------------------------------------------------

class _RemoteOutput:
    __slots__ = ("flow_index", "copy", "ranks", "writeback_ranks", "views")

    def __init__(self, flow_index: int) -> None:
        self.flow_index = flow_index
        self.copy = None              # producing DataCopy (None for CTL)
        self.ranks: set[int] = set()  # ranks with consumer successors
        self.writeback_ranks: set[int] = set()  # remote home-tile ranks
        # rank -> wire view key | None (full tile); a rank reached by
        # edges with different views takes the full tile
        self.views: dict[int, tuple | None] = {}


class RemoteDeps:
    """Per-completed-task record of which peers need which outputs."""

    __slots__ = ("task", "outputs")

    def __init__(self, task: Task) -> None:
        self.task = task
        self.outputs: dict[int, _RemoteOutput] = {}

    def output(self, flow_index: int) -> _RemoteOutput:
        o = self.outputs.get(flow_index)
        if o is None:
            o = self.outputs[flow_index] = _RemoteOutput(flow_index)
        return o


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class RemoteDepEngine:
    """One rank's activation protocol over its comm engine, installed as
    ``context.comm_engine``: the context delegates ``remote_dep_*`` here
    and calls :meth:`progress` from its idle loops."""

    def __init__(self, context: Any, ce: CommEngine) -> None:
        self.ctx = context
        self.ce = ce
        context.comm_engine = self
        self.my_rank = ce.rank
        self.nranks = ce.nranks
        self._es = ExecutionStream(-2, context.virtual_processes[0], context)
        self._seq = itertools.count(1)
        # outgoing stage: per-peer lists flushed as ONE message per peer,
        # highest priority first (remote_dep_mpi.c:1066-1194)
        self._outq: dict[int, list] = {}
        self._outq_lock = threading.Lock()
        # whole drains are serialized, so the priority order holds across
        # concurrent flushers (a worker, the engine's flush hook)
        self._flush_serial = threading.Lock()
        self._outseq = itertools.count()
        # activation seq -> taskpool, until its ack lands; the lock also
        # guards the send counters: a rank's tasks may complete on another
        # rank's thread (the one managing a shared device)
        self._inflight: dict[int, Any] = {}
        self._iflock = threading.Lock()
        self.dup_acks = 0
        self.activations_sent = 0
        self.activations_received = 0
        self.payload_bytes_staged = 0
        self.payload_bytes_received = 0
        # activations whose pool is not registered here yet, replayed at
        # registration; entries are (handler, src, msg)
        self._pending_unknown_tp: list[tuple[Any, int, dict]] = []
        self._pending_lock = threading.Lock()
        # distributed detectors by comm id, and tokens that came first
        self._termdet: dict[int, Any] = {}
        self._pending_termdet: list[dict] = []
        ce.tag_register(AM_TAG_ACTIVATE, self._on_activate)
        ce.tag_register(AM_TAG_GET_ACK, self._on_ack)
        ce.tag_register(AM_TAG_TERMDET, self._on_termdet)
        ce.tag_register(AM_TAG_DTD, self._on_dtd)
        ce.flush_hook = self.flush_outgoing
        self._comm_thread: threading.Thread | None = None
        self._comm_stop = threading.Event()
        r = self.my_rank
        fabric = getattr(ce, "fabric", None)
        self._gauges = {
            "inflight": self.inflight,
            "bytes_out": lambda: self.payload_bytes_staged,
            "bytes_in": lambda: self.payload_bytes_received,
            # the wire-level twins: framed bytes the fabric moved
            "wire_bytes_out": lambda: getattr(fabric, "bytes_sent", 0),
            "wire_bytes_in": lambda: getattr(fabric, "bytes_recv", 0),
            "frags_in": lambda: ce.frags_in,
            "frag_bytes_in": lambda: ce.frag_bytes_in}
        for g, fn in self._gauges.items():
            sde.register_gauge(f"comm::rank{r}::{g}", fn)
        properties.register("comm", f"rank{r}", self._comm_property)

    # ------------------------------------------------------------ lifecycle
    def enable(self) -> None:
        self.ce.enable()
        if _params.get("comm_thread") and self._comm_thread is None:
            self._comm_stop.clear()
            self._comm_thread = threading.Thread(
                target=self._comm_main, daemon=True,
                name=f"parsec-comm-r{self.my_rank}")
            self._comm_thread.start()

    def _comm_main(self) -> None:
        backoff = Backoff()
        while not self._comm_stop.is_set():
            try:
                n = self.flush_outgoing() + self.ce.progress()
            except BaseException as e:   # a dead comm thread is a failed
                self.ctx.record_failure(e)   # run, never a hang
                return
            if n:
                backoff.reset()
            else:
                backoff.wait()

    def stop_thread(self) -> None:
        """Stop and join the comm thread, if one runs (the context's
        ``abort`` calls it; ``fini`` does too)."""
        th, self._comm_thread = self._comm_thread, None
        if th is not None:
            self._comm_stop.set()
            th.join(timeout=5)

    def fini(self) -> None:
        self.stop_thread()
        self.flush_outgoing()
        self.ce.fini()
        for g in self._gauges:
            sde.unregister_gauge(f"comm::rank{self.my_rank}::{g}")
        properties.unregister("comm", f"rank{self.my_rank}")

    def _comm_property(self) -> dict:
        """The ``comm`` property: fragment-pipeline state and the
        fabric's per-peer ledgers where it keeps them."""
        out: dict = {"frag_active": self.ce.frag_active,
                     "frags_in": self.ce.frags_in,
                     "frags_out": self.ce.frags_out}
        ps = getattr(getattr(self.ce, "fabric", None), "peer_stats", None)
        if ps is not None:
            out["peers"] = ps()
        return out

    def debug_state(self) -> dict:
        """In-flight comm operations, for a stall report."""
        with self._outq_lock:
            staged = {dst: len(items) for dst, items in self._outq.items()}
        with self._iflock:
            inflight = len(self._inflight)
        with self._pending_lock:
            unknown = len(self._pending_unknown_tp)
            pending_td = len(self._pending_termdet)
        return {"rank": self.my_rank, "inflight_activations": inflight,
                "staged_sends": staged, "pending_unknown_taskpool": unknown,
                "pending_termdet_tokens": pending_td,
                "dup_acks": self.dup_acks,
                "payload_bytes_staged": self.payload_bytes_staged,
                "payload_bytes_received": self.payload_bytes_received,
                "engine_pending": self.ce.pending(),
                "comm_thread": self._comm_thread is not None,
                **self._comm_property()}

    def progress(self) -> int:
        # the engine's progress runs flush_outgoing through its hook
        return self.ce.progress()

    def stats(self) -> dict:
        """This rank's comm counters."""
        ce = self.ce
        return {"activations_sent": self.activations_sent,
                "activations_received": self.activations_received,
                "gets": ce.gets,
                "bytes_put": getattr(ce, "bytes_put", 0),
                "bytes_got": getattr(ce, "bytes_got", 0),
                "payload_bytes_staged": self.payload_bytes_staged,
                "payload_bytes_received": self.payload_bytes_received,
                "frags_in": ce.frags_in, "frags_out": ce.frags_out}

    # -------------------------------------------- outgoing stage (coalescing)
    def _post_activate(self, dst: int, msg: dict) -> None:
        with self._outq_lock:
            self._outq.setdefault(dst, []).append(
                (-msg.get("priority", 0), next(self._outseq),
                 pack_activation(msg)))

    def _flush_if_unthreaded(self) -> None:
        """The outgoing stage is the comm thread's mailbox; without one,
        flush at the end of each send batch so busy workers never starve
        outgoing sends (coalescing still aggregates within the batch)."""
        if self._comm_thread is None:
            self.flush_outgoing()

    def flush_outgoing(self) -> int:
        """Drain the outgoing stage: one message per peer, its
        activations highest priority first."""
        if not self._outq:
            return 0
        with self._flush_serial:
            with self._outq_lock:
                batches, self._outq = self._outq, {}
            n = 0
            for dst, items in batches.items():
                items.sort(key=lambda it: it[:2])
                msgs = [m for _, _, m in items]
                if len(msgs) == 1:
                    # a lone activation's trace rides the frame header
                    # too; an aggregate mixes requests, so its header
                    # word stays 0 and each message carries its own
                    self.ce.send_am(AM_TAG_ACTIVATE, dst, msgs[0],
                                    trace_id=_packed_trace(msgs[0]))
                else:
                    self.ce.send_am(AM_TAG_ACTIVATE, dst, ("B", msgs))
                n += len(msgs)
        return n

    def inflight(self) -> int:
        with self._iflock:
            return len(self._inflight)

    def quiesce(self, timeout: float = 60.0) -> None:
        """Progress until this rank has no activation in flight and an
        all-ranks barrier passes twice with silence in between; raises at
        once if the context is poisoned (a failed rank never acks)."""
        deadline = time.monotonic() + timeout
        backoff = Backoff()

        def failed():
            return self.ctx._worker_error

        for _round in range(2):
            while self.inflight() or self.ce.pending() or self._outq:
                if self.progress():
                    backoff.reset()
                else:
                    backoff.wait()
                if failed() is not None:
                    raise RuntimeError(f"rank {self.my_rank}: quiesce "
                                       f"abandoned") from failed()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"rank {self.my_rank} quiesce timeout")
            self.ce.sync(failed=failed)

    # ------------------------------------------------- producer (sender) side
    def accumulate(self, remote: RemoteDeps | None, task: Task, flow, dep,
                   succ_tc, succ_locals, rank: int) -> RemoteDeps:
        """One remote successor edge (or remote write-back, ``succ_tc``
        None) found by ``release_deps``."""
        if remote is None:
            remote = RemoteDeps(task)
        out = remote.output(flow.flow_index)
        if not flow.is_ctl:
            out.copy = task.data[flow.flow_index]
        if succ_tc is None:
            out.writeback_ranks.add(rank)     # the whole tile goes home
            out.views[rank] = None
        else:
            out.ranks.add(rank)
            vk = wire_slice_key(dep.wire_slices(task.locals))
            if rank in out.views and out.views[rank] != vk:
                out.views[rank] = None        # conflicting views
            else:
                out.views.setdefault(rank, vk)
        return remote

    def activate(self, es: Any, task: Task, remote: RemoteDeps) -> None:
        """Send the activations (``parsec_remote_dep_activate``).  Peers
        that receive the same flows with the same views share one
        propagation tree."""
        tp = task.taskpool
        by_mask: dict[tuple, list[int]] = {}
        all_ranks: dict[int, set[int]] = {}
        for fi, out in remote.outputs.items():
            for r in out.ranks | out.writeback_ranks:
                all_ranks.setdefault(r, set()).add(fi)
        for r, flows in all_ranks.items():
            key = tuple((fi, remote.outputs[fi].views.get(r))
                        for fi in sorted(flows))
            by_mask.setdefault(key, []).append(r)

        tr = getattr(tp, "_trace", None)
        for flows, ranks in by_mask.items():
            ranks.sort()
            hint = max((nbytes_of(remote.outputs[fi].copy.value)
                        for fi, _v in flows
                        if remote.outputs[fi].copy is not None), default=0)
            tree_kind = resolve_tree_kind(nbytes=hint, n=len(ranks) + 1)
            outputs = []
            for fi, view in flows:
                out = remote.outputs[fi]
                desc = {"flow_index": fi,
                        "writeback": bool(out.writeback_ranks)}
                if out.copy is not None:
                    value = _wire_value(out.copy.value)
                    owned = False
                    if view is not None:
                        value = _slice_view(value, view)   # its own tensor
                        desc["wire_view"] = view
                        owned = True
                    nbytes = nbytes_of(value)
                    with self._iflock:
                        self.payload_bytes_staged += nbytes * len(ranks)
                    desc["version"] = out.copy.version
                    if nbytes <= _params.get("comm_short_limit"):
                        desc["inline"] = value if owned else value.clone()
                    else:
                        parts = [self.my_rank] + ranks
                        children = tree_children(tree_kind, 0, len(parts))
                        # peers= lets a dead child's share be released
                        h = self.ce.mem_register(
                            value, refcount=len(children), owned=owned,
                            peers={parts[c] for c in children})
                        desc["wire"] = h.wire()
                        desc["shape"] = tuple(value.shape)
                        desc["dtype"] = dtype_name(value.dtype)
                outputs.append(desc)
            msg = {"tp": tp.comm_id, "tc": task.task_class.task_class_id,
                   "locals": dict(task.locals), "outputs": outputs,
                   # the producer at position 0, consumers after: every
                   # hop re-derives its children from this list
                   "ranks": [self.my_rank] + ranks, "tree": tree_kind,
                   "priority": task.priority,
                   # the request's trace rides every hop of the tree
                   "trace": tr.trace_id if tr is not None else 0}
            self._send_to_children(tp, msg, my_pos=0)
        self._flush_if_unthreaded()

    def _send_to_children(self, tp: Any, msg: dict, my_pos: int) -> None:
        ranks = msg["ranks"]
        for child_pos in tree_children(msg["tree"], my_pos, len(ranks)):
            seq = next(self._seq)
            with self._iflock:
                self._inflight[seq] = tp
                self.activations_sent += 1
            # an activation in flight is a pending action of the pool
            tp.tdm.taskpool_addto_nb_pa(+1)
            tp.tdm.on_comm_sent()
            pins.fire(PinsEvent.COMM_ACTIVATE_SEND, None,
                      (ranks[child_pos], seq))
            r = _spans.recorder
            if r is not None and msg.get("trace"):
                # the emit half of one hop; tracemerge stitches it to the
                # child's recv span by flow id
                t = _now_ns()
                r.record("comm.activate", msg["trace"], t, t,
                         args={"flow": f"act:{self.my_rank}:{seq}",
                               "flow_side": "emit",
                               "dst": ranks[child_pos]})
            self._post_activate(ranks[child_pos],
                                dict(msg, seq=seq, pos=child_pos))

    def _on_ack(self, eng, src: int, msg: dict) -> None:
        pins.fire(PinsEvent.COMM_ACK_RECV, None, int(msg["seq"]))
        with self._iflock:
            tp = self._inflight.pop(msg["seq"], None)
        if tp is None:
            self.dup_acks += 1      # a replayed ack: already settled
            return
        tp.tdm.taskpool_addto_nb_pa(-1)

    # --------------------------------------------------- distributed termdet
    def send_termdet(self, dst: int, token: dict) -> None:
        """Ship a termination-detection token."""
        self.ce.send_am(AM_TAG_TERMDET, dst, token)

    def _on_termdet(self, eng, src: int, token: dict) -> None:
        mon = self._termdet.get(token["tp"])
        if mon is None:
            with self._pending_lock:
                # re-check under the lock that publishes pools
                mon = self._termdet.get(token["tp"])
                if mon is None:
                    tp = self.ctx._tp_by_comm_id.get(token["tp"])
                    if tp is not None:
                        raise RuntimeError(
                            f"rank {self.my_rank}: wave token for taskpool "
                            f"{tp.name} whose detector ({tp.tdm.name}) is "
                            f"not distributed: the ranks chose different "
                            f"detectors")
                    self._pending_termdet.append(token)
                    return
        mon.on_token(token)

    def taskpool_registered(self, tp: Any) -> None:
        """Publish a counted pool under its comm id and replay the
        activations and tokens that raced ahead of its enqueue."""
        distributed = hasattr(tp.tdm, "on_token")
        with self._pending_lock:
            self.ctx._tp_by_comm_id[tp.comm_id] = tp
            if distributed:
                self._termdet[tp.comm_id] = tp.tdm
            replay_td = [t for t in self._pending_termdet
                         if t["tp"] == tp.comm_id]
            self._pending_termdet = [
                t for t in self._pending_termdet if t["tp"] != tp.comm_id]
            replay = [m for m in self._pending_unknown_tp
                      if m[2]["tp"] == tp.comm_id]
            self._pending_unknown_tp = [
                m for m in self._pending_unknown_tp
                if m[2]["tp"] != tp.comm_id]
        if replay_td and not distributed:
            raise RuntimeError(
                f"rank {self.my_rank}: wave tokens for taskpool {tp.name} "
                f"whose detector ({tp.tdm.name}) is not distributed: the "
                f"ranks chose different detectors")
        for token in replay_td:
            tp.tdm.on_token(token)
        for handler, src, msg in replay:
            handler(self.ce, src, msg)

    def _lookup_or_pend(self, handler, src: int, msg: dict):
        tp = self.ctx._tp_by_comm_id.get(msg["tp"])
        if tp is None:
            with self._pending_lock:
                # re-check under the lock: registration may have landed
                tp = self.ctx._tp_by_comm_id.get(msg["tp"])
                if tp is None:
                    self._pending_unknown_tp.append((handler, src, msg))
        return tp

    # ------------------------------------------------ DTD cross-rank channel
    def dtd_send(self, tp: Any, dst: int, msg: dict) -> None:
        """Ship a DTD message (a tile push or flush) to ``dst``, holding a
        pending action of ``tp`` until its ack lands."""
        seq = next(self._seq)
        with self._iflock:
            self._inflight[seq] = tp
        tp.tdm.taskpool_addto_nb_pa(+1)
        tp.tdm.on_comm_sent()
        self.ce.send_am(AM_TAG_DTD, dst, dict(msg, tp=tp.comm_id, seq=seq))

    def _on_dtd(self, eng, src: int, msg: dict) -> None:
        tp = self._lookup_or_pend(self._on_dtd, src, msg)
        if tp is None:
            return
        tp.tdm.on_comm_recv()
        tp._on_dtd_message(self, src, msg)
        self.ce.send_am(AM_TAG_GET_ACK, src, {"seq": msg["seq"]})

    # ------------------------------------------------- consumer (receiver) side
    def _on_activate(self, eng, src: int, msg: Any) -> None:
        if type(msg) is tuple:
            if msg[0] == "B":          # one peer's coalesced activations
                for m in msg[1]:
                    self._on_activate(eng, src, m)
                return
            msg = unpack_activation(msg)
        tp = self._lookup_or_pend(self._on_activate, src, msg)
        if tp is None:
            return
        pins.fire(PinsEvent.ACTIVATE_CB_BEGIN, None, (src, msg["seq"]))
        want = [d for d in msg["outputs"] if "wire" in d]
        # each receiver owns its bytes: an inline payload is forwarded
        # down the tree in the same message
        landed: dict[int, Any] = {d["flow_index"]: d["inline"].clone()
                                  for d in msg["outputs"] if "inline" in d}
        if not want:
            self._complete_incoming(tp, src, msg, landed)
            return
        remaining = [len(want)]

        def make_cb(d):
            def cb(value):
                landed[d["flow_index"]] = value
                remaining[0] -= 1
                if remaining[0] == 0:
                    self._complete_incoming(tp, src, msg, landed)
            return cb

        for d in want:
            # the GET inherits the activation's trace
            self.ce.get(tuple(d["wire"]), make_cb(d),
                        trace=msg.get("trace") or None)

    def _complete_incoming(self, tp: Any, src: int, msg: dict,
                           landed: dict[int, Any]) -> None:
        """Every payload present: release local successors, apply home
        write-backs, forward down the tree, ack the parent."""
        t0 = _now_ns() if _spans.recorder is not None else 0
        self.activations_received += 1
        for v in landed.values():
            self.payload_bytes_received += nbytes_of(v)
        tp.tdm.on_comm_recv()
        tc = tp.task_classes[msg["tc"]]
        ghost = Task(tp, tc, dict(msg["locals"]),
                     priority=msg.get("priority", 0))
        copies = {}
        for d in msg["outputs"]:
            fi = d["flow_index"]
            if fi in landed:
                datum = data_create(
                    landed[fi], key=("remote", self.my_rank, tp.comm_id,
                                     tc.name,
                                     tuple(sorted(msg["locals"].items())),
                                     fi))
                copy = datum.get_copy(0)
                copy.version = d.get("version", 1)
                copies[fi] = copy
                ghost.data[fi] = copy

        ready: list[Task] = []
        out_mask = {d["flow_index"] for d in msg["outputs"]}
        wb = {d["flow_index"]: d.get("writeback", False)
              for d in msg["outputs"]}

        def visitor(t: Task, flow, dep) -> None:
            if flow.flow_index not in out_mask:
                return
            copy = copies.get(flow.flow_index)
            if dep.target_class is None:
                # only the home rank applies it: other ranks sharing this
                # activation must not make master copies
                if wb.get(flow.flow_index) and dep.data_ref is not None:
                    dc, key = dep.data_ref(t.locals)
                    if copy is not None and dc.rank_of(*key) == self.my_rank:
                        apply_writeback_to_home(
                            dc, key,
                            reshape_for_writeback(copy, dep, dc, key))
                return
            succ_tc = tp.task_class(dep.target_class)
            for succ_locals in dep.each_target(t.locals):
                if succ_tc.in_space is not None \
                        and not succ_tc.in_space(succ_locals):
                    continue
                rank = _rank_of_task(succ_tc, succ_locals)
                if rank is not None and rank != self.my_rank:
                    continue
                fi, di = _find_input_dep(succ_tc, dep.target_flow, tc.name,
                                         succ_locals)
                # a typed edge: a lazy shared repack of the landed copy
                send = reshape_for_edge(copy, dep,
                                        succ_tc.flows[fi].deps_in[di])
                rt = self.ctx.deps.release_dep(tp, succ_tc, succ_locals, fi,
                                               di, send, None)
                if rt is not None:
                    ready.append(rt)

        tc.iterate_successors(ghost, visitor)

        # an interior tree node re-registers what it landed and forwards
        my_pos = msg["pos"]
        children = tree_children(msg["tree"], my_pos, len(msg["ranks"]))
        if children:
            fwd = dict(msg)
            fwd["outputs"] = [dict(d) for d in msg["outputs"]]
            for d in fwd["outputs"]:
                if "wire" in d:
                    # a snapshot: the landed tensor is also handed to the
                    # local successors, which may write it in place
                    h = self.ce.mem_register(
                        landed[d["flow_index"]], refcount=len(children),
                        peers={msg["ranks"][p] for p in children})
                    d["wire"] = h.wire()
            self._send_to_children(tp, fwd, my_pos=my_pos)
            self._flush_if_unthreaded()

        self.ce.send_am(AM_TAG_GET_ACK, src, {"seq": msg["seq"]})
        pins.fire(PinsEvent.ACTIVATE_CB_END, None, (src, msg["seq"]))
        r = _spans.recorder
        if r is not None and msg.get("trace"):
            # the recv half of the hop, keyed by the SENDING rank's seq
            r.record("comm.activate", msg["trace"], t0 or _now_ns(),
                     _now_ns(),
                     args={"flow": f"act:{src}:{msg['seq']}",
                           "flow_side": "recv", "released": len(ready)})
        if ready:
            schedule_tasks(self._es, ready, 0)

"""One logical serving plane across ranks: the sharded RuntimeServer.

Port of ``parsec_tpu/serve/sharded.py``.  Every rank constructs a
:class:`ShardedRuntimeServer` around its own (already multi-rank)
:class:`~parsec_tpu_torch.runtime.context.Context`; rank 0 is the
**frontend**, the rank clients talk to, and every other rank runs
:meth:`serve_forever`, a worker loop that admits forwarded streams into
its local :class:`~parsec_tpu_torch.serve.server.RuntimeServer` and
ships token deltas back.  The control channel is a reserved
active-message tag on the comm engine (``AM_TAG_SERVE``), so serving
control rides the same fabric as data.  On one card the ranks are
threads of :func:`~parsec_tpu_torch.comm.run_multirank` sharing it, and
each rank's batcher pins its tiles to its rank.

Placement (:meth:`submit_stream` on the frontend) maximizes KV/prefix
residency: the local batcher answers exactly
(:meth:`~parsec_tpu_torch.llm.batcher.ContinuousBatcher.residency_len`);
for a remote rank the frontend scores the prompts it placed there by
longest common prefix, the same signal one hop stale.  No residency
anywhere falls back to the least-loaded rank.

Config (tenant WFQ weights, admission budgets) is broadcast along the
collective tree (``comm_bcast_tree``, :func:`~parsec_tpu_torch.comm.
remote_dep.tree_children`): the frontend sends CONFIG to its tree
children only, and every interior rank re-forwards to its own.

Metrics (:meth:`metrics`) merge exactly: every rank serializes its
per-tenant :class:`~parsec_tpu_torch.prof.histogram.SLOPlane` (bucket
arrays, not summaries) and the frontend bucket-merges them
(:func:`merge_planes`), so the merged quantiles are those of the union
of the per-rank planes.

Fault handling (:meth:`fail_rank`): a dead rank's live streams requeue on
a survivor as ``prompt + tokens-shipped-so-far`` with the remaining
budget (greedy decode makes the splice oracle-exact), and the handle's
index-deduped token ledger drops any late duplicate a zombie rank still
ships.

The runtimelint contract table (``_LOCK_PROTECTED``) holds the rule:
the live-stream table mutates only under ``_lock``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Sequence

from ..comm.engine import AM_TAG_USER_BASE
from ..comm.remote_dep import resolve_tree_kind, tree_children
from ..core.future import Future
from ..core.params import params as _params
from ..prof import spans as _spans
from ..prof.histogram import LogHistogram, _summarize
from .server import RuntimeServer

# the runtime lint's contract (analysis/runtimelint.py): the live-stream
# table mutates only under ``_lock``
_LOCK_PROTECTED = {
    "ShardedRuntimeServer._live": "_lock",
}
_LOCK_ORDER = ("_lock",)

_now = time.perf_counter_ns

AM_TAG_SERVE = AM_TAG_USER_BASE + 8      # the sharded-serve control tag

_params.register("serve_shard_poll_s", 0.002,
                 "worker-loop poll interval of a non-frontend sharded "
                 "serving rank (serve_forever)")


class ShardedStreamTicket:
    """The frontend-side handle of a placed stream.  ``tokens`` grows
    live exactly like a local StreamTicket's; duplicate deltas (zombie
    rank, post-requeue replay) are dropped by token INDEX — the
    serving-plane mirror of the landing zones' per-offset dedup."""

    def __init__(self, sid: int, tenant: str, prompt: list[int],
                 max_new: int, eos: int | None) -> None:
        self.sid = sid
        self.tenant = tenant
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        self.priority = 0
        self.trace = 0                   # span trace id (0 = untraced)
        self.rank: int = -1              # current placement
        self.ranks: list[int] = []       # every rank that served a slice
        self.tokens: list[int] = []
        self.requeues = 0
        self.dup_tokens = 0              # deltas dropped by the dedup
        self._future: Future = Future()

    # -- client API (StreamTicket-shaped) -------------------------------
    def generated(self) -> list[int]:
        return list(self.tokens)

    def result(self, timeout: float | None = None) -> dict:
        kind, v = self._future.get(timeout)
        if kind == "err":
            raise v
        return v

    def done(self) -> bool:
        return self._future.is_ready()

    # -- plane side ------------------------------------------------------
    def _land(self, base: int, toks: Sequence[int]) -> None:
        """Apply one delta: tokens [base, base+len) of the stream.  Only
        the contiguous extension beyond ``len(self.tokens)`` lands;
        anything below is a replayed offset and is counted, not applied."""
        sealed = self._future.is_ready()
        for i, tok in enumerate(toks):
            idx = base + i
            if idx < len(self.tokens):
                self.dup_tokens += 1     # replayed offset: counted only
            elif idx == len(self.tokens) and not sealed:
                self.tokens.append(tok)
            # idx > len (a gap) or a sealed handle: drop — deltas ship
            # in order per stream, so a gap only means a zombie rank
            # racing ahead of a settled result
    def _resolve(self) -> None:
        if not self._future.is_ready():
            self._future.set(("ok", {"tokens": list(self.tokens),
                                     "requeues": self.requeues,
                                     "ranks": list(self.ranks)}))

    def _fail(self, e: BaseException) -> None:
        if not self._future.is_ready():
            self._future.set(("err", e))


class _Local:
    """A stream this rank is decoding: the underlying local ticket plus
    the shipping cursor (how many tokens the frontend has seen)."""

    __slots__ = ("sid", "ticket", "base", "shipped", "reply_to", "trace")

    def __init__(self, sid: int, ticket: Any, base: int,
                 reply_to: int, trace: int = 0) -> None:
        self.sid = sid
        self.ticket = ticket
        self.base = base                 # stream index of local token 0
        self.shipped = 0                 # local tokens already shipped
        self.reply_to = reply_to
        self.trace = trace               # the stream's span trace id


class ShardedRuntimeServer:
    """One logical serving plane spanning every rank of ``context``.

    Construct on EVERY rank (same constructor args); rank 0 is the
    frontend.  Worker ranks call :meth:`serve_forever`; the frontend
    calls :meth:`submit_stream` / :meth:`wait` / :meth:`metrics` and
    finally :meth:`shutdown` (which releases the workers' loops).
    Teardown stops the local batchers but NEVER drains the context —
    the multirank harness owns context lifetime."""

    def __init__(self, context, *,
                 tenant_weights: dict[str, float] | None = None,
                 admission=None, llm_model=None) -> None:
        self._ctx = context
        self.rank = context.my_rank
        self.nranks = context.nb_ranks
        self._local = RuntimeServer(context=context,
                                    tenant_weights=tenant_weights,
                                    admission=admission,
                                    llm_model=llm_model)
        self._inbox: deque[tuple[int, dict]] = deque()
        self._live: dict[int, _Local] = {}
        self._lock = threading.Lock()
        self._stopped = False
        self.zombie = False          # test hook: stop shipping (rank death)
        # frontend books
        self._handles: dict[int, ShardedStreamTicket] = {}
        self._next_sid = 1
        self._rank_load: dict[int, int] = {r: 0 for r in range(self.nranks)}
        self._router_hist: dict[int, list[list[int]]] = {}
        self._dead: set[int] = set()
        self._metrics_replies: dict[int, dict] = {}
        self.config_forwards = 0     # CONFIG frames this rank re-served
        ce = context.comm_engine.ce if context.comm_engine is not None \
            else None
        self._ce = ce
        if ce is not None:
            ce.tag_register(AM_TAG_SERVE, self._on_am)

    # -- control channel -------------------------------------------------
    def _on_am(self, _eng, src: int, payload: dict) -> None:
        # runs inside engine progress (under its lock): enqueue only,
        # act from step()/serve_step() on the caller's thread
        self._inbox.append((src, payload))

    def _send(self, dst: int, msg: dict, trace: int = 0) -> None:
        if dst == self.rank:
            self._inbox.append((self.rank, msg))
        elif self._ce is not None:
            self._ce.send_am(AM_TAG_SERVE, dst, msg, trace_id=trace)

    # -- placement (frontend) -------------------------------------------
    def _residency(self, rank: int, prompt: list[int]) -> int:
        if rank == self.rank:
            llm = self._local._llm
            return llm.residency_len(prompt) if llm is not None else 0
        best = 0
        for prev in self._router_hist.get(rank, ()):
            n = 0
            for a, b in zip(prev, prompt):
                if a != b:
                    break
                n += 1
            best = max(best, n)
        return best

    def _place(self, prompt: list[int],
               exclude: set[int] = frozenset()) -> int:
        ranks = [r for r in range(self.nranks)
                 if r not in self._dead and r not in exclude]
        if not ranks:
            raise RuntimeError("no live ranks left to place on")
        scored = [(self._residency(r, prompt), -self._rank_load[r], -r)
                  for r in ranks]
        best = max(range(len(ranks)), key=lambda i: scored[i])
        return ranks[best]

    def submit_stream(self, prompt_tokens: Sequence[int], *,
                      max_new_tokens: int = 16, tenant: str = "default",
                      priority: int = 0, eos: int | None = None
                      ) -> ShardedStreamTicket:
        """Place one generation stream somewhere on the plane (frontend
        only).  Returns a handle whose ``tokens`` grow as deltas arrive;
        pump with :meth:`step` / :meth:`wait`."""
        if self.rank != 0:
            raise RuntimeError("submit_stream is a frontend (rank 0) call")
        prompt = list(prompt_tokens)
        sid = self._next_sid
        self._next_sid += 1
        h = ShardedStreamTicket(sid, tenant, prompt, max_new_tokens, eos)
        h.priority = priority
        # one-branch disabled cost: a trace is minted only when the span
        # recorder is installed, and rides every control-plane frame so
        # critpath can attribute the SUBMIT/TOKENS hops to this stream
        if _spans.recorder is not None:
            h.trace = _spans.new_trace().trace_id
        self._handles[sid] = h
        rank = self._place(prompt)
        self._dispatch(h, rank, prompt, max_new_tokens, base=0)
        return h

    def _dispatch(self, h: ShardedStreamTicket, rank: int,
                  prompt: list[int], max_new: int, base: int) -> None:
        h.rank = rank
        h.ranks.append(rank)
        self._rank_load[rank] += 1
        self._router_hist.setdefault(rank, []).append(list(prompt))
        seq = len(h.ranks)               # distinguishes requeue re-submits
        msg = {"op": "SUBMIT", "sid": h.sid, "prompt": prompt,
               "max_new": max_new, "tenant": h.tenant,
               "priority": h.priority, "eos": h.eos,
               "base": base, "reply_to": self.rank,
               "trace": h.trace, "seq": seq}
        r = _spans.recorder
        if r is not None and rank != self.rank:
            t0 = _now()
            self._send(rank, msg, trace=h.trace)
            r.record("serve.submit", h.trace, t0, _now(), h.tenant,
                     {"flow": f"ssub:{h.sid}:{seq}", "flow_side": "emit"})
        else:
            self._send(rank, msg, trace=h.trace)

    # -- config broadcast (collective tree) ------------------------------
    def broadcast_config(self, *, weights: dict[str, float] | None = None,
                         max_inflight: int | None = None,
                         max_tenant_inflight: int | None = None) -> None:
        """Push tenant WFQ weights / admission budgets to EVERY rank,
        staged along the ``comm_bcast_tree`` shape: this rank serves its
        tree children only; interior ranks re-forward."""
        cfg = {"op": "CONFIG", "weights": weights or {},
               "max_inflight": max_inflight,
               "max_tenant_inflight": max_tenant_inflight}
        self._apply_config(cfg)
        self._forward_config(cfg)

    def _forward_config(self, cfg: dict) -> None:
        # every hop must derive the SAME concrete tree: resolve with no
        # payload hint ("auto" -> binomial deterministically at any rank)
        kind = resolve_tree_kind(n=self.nranks)
        for child in tree_children(kind, self.rank, self.nranks):
            self._send(child, cfg)
            self.config_forwards += 1

    def _apply_config(self, cfg: dict) -> None:
        for tenant, w in (cfg.get("weights") or {}).items():
            self._local._fair.set_weight(tenant, float(w))
        adm = self._local._adm
        if cfg.get("max_inflight") is not None:
            adm.max_inflight = int(cfg["max_inflight"])
        if cfg.get("max_tenant_inflight") is not None:
            adm.max_tenant_inflight = int(cfg["max_tenant_inflight"])

    # -- the pump --------------------------------------------------------
    def step(self) -> int:
        """One frontend/worker pump: act on queued control messages and
        ship/land token deltas.  Returns the number of events handled."""
        n = 0
        while True:
            try:
                src, msg = self._inbox.popleft()
            except IndexError:
                break
            self._handle(src, msg)
            n += 1
        n += self._pump_local()
        return n

    def _handle(self, src: int, msg: dict) -> None:
        op = msg["op"]
        r = _spans.recorder
        if op == "SUBMIT":
            t0 = _now() if r is not None else 0
            t = self._local.submit_stream(
                msg["prompt"], max_new_tokens=msg["max_new"],
                tenant=msg["tenant"], priority=msg.get("priority", 0),
                eos=msg["eos"])
            with self._lock:
                self._live[msg["sid"]] = _Local(
                    msg["sid"], t, msg["base"], msg["reply_to"],
                    trace=msg.get("trace", 0))
            if r is not None and src != self.rank:
                r.record("serve.submit", msg.get("trace", 0), t0, _now(),
                         msg.get("tenant"),
                         {"flow": f"ssub:{msg['sid']}:{msg.get('seq', 0)}",
                          "flow_side": "recv"})
        elif op == "TOKENS":
            h = self._handles.get(msg["sid"])
            if h is not None:
                # a settled handle still LANDS the delta: the dedup
                # ledger must see (and count) a zombie rank's replays
                t0 = _now() if r is not None else 0
                h._land(msg["base"], msg["toks"])
                if r is not None and src != self.rank:
                    r.record("serve.tokens", h.trace, t0, _now(), h.tenant,
                             {"flow": f"stok:{msg['sid']}:{msg['base']}",
                              "flow_side": "recv"})
        elif op == "DONE":
            h = self._handles.get(msg["sid"])
            if h is not None and r is not None and src != self.rank:
                t0 = _now()
                r.record("serve.tokens", h.trace, t0, _now(), h.tenant,
                         {"flow": f"stok:{msg['sid']}:d{msg['base']}",
                          "flow_side": "recv"})
            if h is not None and not h.done():
                if msg["sid"] in self._handles:
                    self._rank_load[h.rank] = \
                        max(0, self._rank_load[h.rank] - 1)
                if msg.get("error") is not None:
                    h._fail(RuntimeError(msg["error"]))
                else:
                    h._land(msg["base"], msg["toks"])
                    h._resolve()
        elif op == "CONFIG":
            self._apply_config(msg)
            self._forward_config(msg)
        elif op == "METRICS_REQ":
            self._send(src, {"op": "METRICS_REPLY", "rank": self.rank,
                             "plane": self._plane_dict(),
                             "inflight": len(self._live)})
        elif op == "METRICS_REPLY":
            self._metrics_replies[msg["rank"]] = msg
        elif op == "SHUTDOWN":
            self._stopped = True

    def _pump_local(self) -> int:
        """Ship this rank's live streams' new tokens to their frontends
        (index-contiguous deltas, so the handle's dedup is total)."""
        if self.zombie:
            return 0
        with self._lock:
            entries = list(self._live.values())
        n = 0
        for e in entries:
            toks = e.ticket.generated()
            if len(toks) > e.shipped:
                delta = toks[e.shipped:]
                if e.reply_to != self.rank:
                    base = e.base + e.shipped
                    r = _spans.recorder
                    t0 = _now() if r is not None else 0
                    self._send(e.reply_to,
                               {"op": "TOKENS", "sid": e.sid,
                                "base": base, "toks": delta},
                               trace=e.trace)
                    if r is not None:
                        r.record("serve.tokens", e.trace, t0, _now(), None,
                                 {"flow": f"stok:{e.sid}:{base}",
                                  "flow_side": "emit"})
                else:
                    h = self._handles.get(e.sid)
                    if h is not None:
                        h._land(e.base + e.shipped, delta)
                e.shipped = len(toks)
                n += 1
            if e.ticket.done():
                with self._lock:
                    self._live.pop(e.sid, None)
                try:
                    e.ticket.result(timeout=0)
                    err = None
                except BaseException as exc:   # ship the failure, not hang
                    err = f"{type(exc).__name__}: {exc}"
                if e.reply_to != self.rank:
                    base = e.base + e.shipped
                    r = _spans.recorder
                    t0 = _now() if r is not None else 0
                    self._send(e.reply_to,
                               {"op": "DONE", "sid": e.sid,
                                "base": base, "toks": [],
                                "error": err}, trace=e.trace)
                    if r is not None:
                        r.record("serve.tokens", e.trace, t0, _now(), None,
                                 {"flow": f"stok:{e.sid}:d{base}",
                                  "flow_side": "emit"})
                else:
                    h = self._handles.get(e.sid)
                    if h is not None:
                        if err is not None:
                            h._fail(RuntimeError(err))
                        else:
                            self._rank_load[self.rank] = \
                                max(0, self._rank_load[self.rank] - 1)
                            h._resolve()
                n += 1
        return n

    def wait(self, handles: Sequence[ShardedStreamTicket],
             timeout: float = 60.0) -> None:
        """Frontend: pump until every handle settles (or raise)."""
        deadline = time.monotonic() + timeout
        while True:
            self.step()
            if all(h.done() for h in handles):
                return
            if time.monotonic() > deadline:
                pend = [h.sid for h in handles if not h.done()]
                raise TimeoutError(f"sharded wait: streams {pend} "
                                   f"still in flight after {timeout}s")
            time.sleep(0.001)

    def serve_forever(self, *, idle_timeout: float = 120.0) -> None:
        """Worker-rank loop: pump until SHUTDOWN (or idle_timeout)."""
        poll = float(_params.get("serve_shard_poll_s"))
        deadline = time.monotonic() + idle_timeout
        while not self._stopped:
            if self.step():
                deadline = time.monotonic() + idle_timeout
            if time.monotonic() > deadline:
                raise TimeoutError("sharded worker idle_timeout expired "
                                   "without SHUTDOWN")
            time.sleep(poll)

    # -- fault path ------------------------------------------------------
    def fail_rank(self, rank: int, *, timeout: float = 60.0) -> None:
        """Declare ``rank`` dead (frontend).  Its live streams requeue on
        survivors from the last shipped token: the continuation prompt is
        ``prompt + tokens-so-far`` with the remaining budget, and its
        deltas land at the original stream offsets — any late duplicates
        a zombie still ships are dropped by the handle's index dedup."""
        self._dead.add(rank)
        victims = [h for h in self._handles.values()
                   if not h.done() and h.rank == rank]
        for h in victims:
            h.requeues += 1
            done = len(h.tokens)
            if h.eos is not None and done and h.tokens[-1] == h.eos:
                self._rank_load[rank] = max(0, self._rank_load[rank] - 1)
                h._resolve()
                continue
            remaining = h.max_new - done
            if remaining <= 0:
                self._rank_load[rank] = max(0, self._rank_load[rank] - 1)
                h._resolve()
                continue
            self._rank_load[rank] = max(0, self._rank_load[rank] - 1)
            nxt = self._place(h.prompt, exclude={rank})
            self._dispatch(h, nxt, h.prompt + h.tokens, remaining,
                           base=done)

    # -- metrics ---------------------------------------------------------
    def _plane_dict(self) -> dict:
        d = self._local._slo.to_dict()
        llm = self._local._llm
        if llm is not None:
            d.setdefault("_counters", {}).setdefault("_rank", {})[
                "tokens_generated"] = llm.tokens_generated
        return d

    def metrics(self, timeout: float = 30.0) -> dict:
        """Cross-rank SLO snapshot (frontend): every rank ships its
        serialized plane; histograms bucket-merge EXACTLY, so the merged
        quantiles are those of the union of the per-rank planes."""
        if self.rank != 0 or self.nranks == 1:
            return {"tenants": self._local._slo.summary(),
                    "ranks": 1, "rank_inflight": {self.rank:
                                                  len(self._live)}}
        self._metrics_replies = {}
        want = [r for r in range(self.nranks)
                if r != self.rank and r not in self._dead]
        for r in want:
            self._send(r, {"op": "METRICS_REQ"})
        deadline = time.monotonic() + timeout
        while set(self._metrics_replies) < set(want):
            self.step()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"metrics: no reply from ranks "
                    f"{sorted(set(want) - set(self._metrics_replies))}")
            time.sleep(0.001)
        planes = [self._plane_dict()] + \
            [self._metrics_replies[r]["plane"] for r in want]
        return {"tenants": merge_planes(planes),
                "ranks": 1 + len(want),
                "rank_inflight": {self.rank: len(self._live),
                                  **{r: self._metrics_replies[r]["inflight"]
                                     for r in want}}}

    # -- lifecycle -------------------------------------------------------
    def shutdown(self, timeout: float = 30.0) -> None:
        """Frontend: release every worker loop, then :meth:`close` the
        local half.  NEVER drains the context."""
        if self.rank == 0:
            for r in range(self.nranks):
                if r != self.rank:
                    self._send(r, {"op": "SHUTDOWN"})
        self.close(timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Stop this rank's batcher (bounded) and deregister.  The
        context stays up — the harness (or the caller) finis it."""
        self._stopped = True
        llm = self._local._llm
        if llm is not None:
            llm.stop(timeout=timeout)
        if self._ce is not None:
            self._ce.tag_register(AM_TAG_SERVE, lambda *a: None)
        # the local server never runs drain() here (the harness owns the
        # context), so its stall section must deregister explicitly — a
        # closed shard lingering in the registry would shadow later
        # servers' sections in stall dumps
        from ..prof import flight_recorder as _flightrec
        _flightrec.unregister_stall_section(self._local._stall_key)


def merge_planes(planes: Sequence[dict]) -> dict:
    """Bucket-merge serialized SLO planes (``SLOPlane.to_dict`` shape)
    into one per-tenant quantile summary.  Exact: LogHistogram merge is
    bucket-wise addition, so a quantile of the merge equals the quantile
    over the union of the samples (same geometry everywhere)."""
    hists: dict[tuple[str, str], LogHistogram] = {}
    counters: dict[tuple[str, str], int] = {}
    for plane in planes:
        for tenant, metrics in plane.items():
            if tenant == "_counters":
                for t, cs in metrics.items():
                    for name, v in cs.items():
                        counters[(t, name)] = counters.get((t, name), 0) + v
                continue
            for metric, hd in metrics.items():
                h = LogHistogram.from_dict(hd)
                if (tenant, metric) in hists:
                    hists[(tenant, metric)].merge(h)
                else:
                    hists[(tenant, metric)] = h
    return _summarize(list(hists.items()), list(counters.items()))

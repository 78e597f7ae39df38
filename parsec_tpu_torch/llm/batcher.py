"""Continuous batching: the LLM session layer over a RuntimeServer.

Port of ``parsec_tpu/llm/batcher.py``.  Clients open *streams*
(:meth:`ContinuousBatcher.submit_stream`, surfaced as
``RuntimeServer.submit_stream``), and one batcher thread runs the decode
loop::

    each iteration:
      admit newly-arrived streams   -> submit prefill pools (PF tasks)
      group live streams by tenant  -> ONE k-step decode SUPERPOOL per
                                       tenant (llm_steps_per_pool)
      await decode, read TOK tiles  -> k tokens per stream per submit
      await prefill (it overlapped the decode superpool), join streams
      retire finished streams       -> kv.free_seq (pages recycle)

Sampling runs in-graph (the SAMPLE class), so one pool spans k
autoregressive steps and the host loop runs once per k tokens.  EOS is
handled by predicated SAMPLE bodies.  ``fork_from=`` forks a stream's
prompt KV copy-on-write from an admitted stream with the same prompt.
A failure is contained to the streams it hit: one stream's page budget,
one tenant's pool.

The pools run on the card: ``devices`` defaults to ``"cuda"``, and when
no CUDA device is registered the batcher registers the card itself
(:func:`~parsec_tpu_torch.device.cuda.init_cuda_devices`, which raises
without one).  The TOK tiles a pool leaves on the card come back in one
transfer per pool.

Left out: speculative decode (``llm_spec_k``), the prefix cache, KV
tiers and prefetch, region lowering, adaptive k (``tune_adaptive``), the
SLO plane and spans, the sharded placement hooks (``residency_len``,
``load``) and the process-wide report aggregate.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Sequence

import torch

from ..core.future import Future
from ..core.params import params as _params
from ..data.datatype import TileType
from ..data_dist.collection import DictCollection
from ..data_dist.paged_kv import PagedKVCollection
from ..device.cuda import init_cuda_devices
from ..device.device import registry
from .decode import (decode_superpool_ptg, preallocate_decode_steps,
                     prefill_chunks, prefill_ptg, read_token_chains,
                     seed_emb_table, seed_stream_step)
from .model import ToyLM

_params.register("llm_page_size", 16,
                 "tokens per KV page (PagedKVCollection block size)")
_params.register("llm_max_batch", 32,
                 "live decode streams a batcher serves concurrently; "
                 "arrivals beyond it queue for the next free slot")
_params.register("llm_max_pages", 4096,
                 "physical KV pages the batcher's cache may hold")
_params.register("llm_step_timeout", 60.0,
                 "seconds the batcher waits for one decode pool before "
                 "failing the streams riding it")
_params.register("llm_steps_per_pool", 8,
                 "autoregressive decode steps one superpool spans (the "
                 "in-graph SAMPLE class carries token -> next query "
                 "between steps)")

_F32 = torch.float32


class StreamTicket:
    """One generation stream's handle.  ``tokens`` grows live — snapshot
    with :meth:`generated`; ``result()`` blocks for the finished
    transcript."""

    def __init__(self, name: str, tenant: str) -> None:
        self.name = name
        self.tenant = tenant
        self.state = "queued"
        self.submitted_at = time.monotonic()
        self.tokens: list[int] = []
        self.per_token_s: list[float] = []
        # monotonic stamp of each token's delivery: a superpool's tokens
        # reach the client together, in one burst of up to k
        self.token_at: list[float] = []
        self.prefill_s: float | None = None
        self.first_token_at: float | None = None   # monotonic TTFT stamp
        self._future = Future()

    def generated(self) -> list[int]:
        """Snapshot of the tokens generated so far."""
        return list(self.tokens)

    def result(self, timeout: float | None = None) -> dict:
        """Block for completion; returns ``{"tokens": [...],
        "per_token_s": [...], "prefill_s": ...}``.  ``per_token_s`` holds
        each token's share of the wall of the decode iteration that
        produced it (the iteration's wall over the tokens its superpool
        gave the stream), not the gap a client sees between tokens: the
        tokens arrive in bursts (:attr:`token_at`).  ``prefill_s`` is the
        prefill pool's wall (0 for a fork or a one-token prompt)."""
        kind, v = self._future.get(timeout)
        if kind == "err":
            raise v
        return v

    def done(self) -> bool:
        return self._future.is_ready()

    def _resolve(self) -> None:
        self.state = "done"
        self._future.set(("ok", {"tokens": list(self.tokens),
                                 "per_token_s": list(self.per_token_s),
                                 "prefill_s": self.prefill_s}))

    def _fail(self, e: BaseException) -> None:
        self.state = "failed"
        self._future.set(("err", e))


class _Stream:
    __slots__ = ("seq", "tenant", "priority", "prompt", "max_new",
                 "ticket", "cur", "eos", "fork_from", "k")

    def __init__(self, seq: Any, tenant: str, priority: int,
                 prompt: Sequence[int], max_new: int,
                 ticket: StreamTicket, eos: int | None = None,
                 fork_from: "_Stream | None" = None) -> None:
        self.seq = seq
        self.tenant = tenant
        self.priority = priority
        self.prompt = list(prompt)
        self.max_new = max_new
        self.ticket = ticket
        self.cur = int(prompt[-1])
        self.eos = None if eos is None else int(eos)
        self.fork_from = fork_from      # CoW prompt-KV parent (or None)
        self.k = 1                      # steps the current superpool runs


class ContinuousBatcher:
    """The decode loop.  Owns the paged KV cache plus the Q/O/TOK/EMB
    side collections; rides an existing :class:`RuntimeServer` for
    admission, fairness and the hot context."""

    def __init__(self, server: Any, model: ToyLM | None = None,
                 kv: PagedKVCollection | None = None,
                 max_batch: int | None = None,
                 devices: str = "cuda") -> None:
        if devices not in ("cuda", "cpu"):
            raise ValueError(f"devices must be 'cuda' or 'cpu', got "
                             f"{devices!r}")
        if devices == "cuda" and not registry.by_type("cuda"):
            init_cuda_devices()          # cuda:0; raises without a card
        self._server = server
        self.model = model or ToyLM()
        H, D = self.model.num_heads, self.model.head_dim
        self.kv = kv or PagedKVCollection(
            "llmKV", page_size=_params.get("llm_page_size"),
            num_heads=H, head_dim=D, max_pages=_params.get("llm_max_pages"))
        if (self.kv.num_heads, self.kv.head_dim) != (H, D):
            raise ValueError("model and KV cache disagree on head geometry")
        self.Q = DictCollection("llmQ", dtt=TileType((3, H, D), _F32))
        self.O = DictCollection("llmO", dtt=TileType((H, D), _F32))
        self.TOK = DictCollection("llmTOK", dtt=TileType((3,), _F32))
        self.EMB = DictCollection(
            "llmEMB", dtt=TileType(tuple(self.model.q3_table().shape), _F32))
        seed_emb_table(self.model, self.EMB)
        self.max_batch = max_batch or _params.get("llm_max_batch")
        self.devices = devices
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._pending: deque[_Stream] = deque()
        self._live: list[_Stream] = []
        self._seq_ids = itertools.count()
        self._stop = False
        self._abort: BaseException | None = None
        self.steps = 0
        self.tokens_generated = 0
        self.streams_completed = 0
        self.decode_submits = 0         # superpool submits (1/k per token)
        self.prefill_submits = 0
        self.forked_streams = 0
        self._pool_seq = itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-batcher")
        self._thread.start()

    # -- client API ------------------------------------------------------
    def submit_stream(self, prompt_tokens: Sequence[int],
                      max_new_tokens: int = 16, tenant: str = "default",
                      priority: int = 0, eos: int | None = None,
                      fork_from: StreamTicket | None = None
                      ) -> StreamTicket:
        """Open one generation stream; it joins the running batch at the
        next iteration boundary.  ``eos`` stops generation early when
        sampled (the EOS token is the last one kept).  ``fork_from``
        names an earlier stream's ticket with the SAME prompt: the new
        stream forks its prompt KV copy-on-write instead of re-prefilling
        — or, when the parent already advanced past its prompt or
        retired, silently prefills on its own."""
        if not prompt_tokens:
            raise ValueError("prompt_tokens must be non-empty")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        parent = None
        if fork_from is not None:
            parent = getattr(fork_from, "_stream", None)
            # identity, not shape: another batcher's seq ids collide
            if parent is None or getattr(fork_from, "_batcher",
                                         None) is not self:
                raise ValueError("fork_from must be a StreamTicket from "
                                 "this batcher")
            if parent.prompt != list(prompt_tokens):
                raise ValueError("fork_from requires an identical prompt "
                                 "(the shared-prefix pages ARE the fork)")
        seq = next(self._seq_ids)
        ticket = StreamTicket(f"stream{seq}", tenant)
        st = _Stream(seq, tenant, priority, prompt_tokens,
                     max_new_tokens, ticket, eos=eos, fork_from=parent)
        ticket._stream = st
        ticket._batcher = self
        with self._lock:
            if self._stop:
                from ..serve.admission import AdmissionRejected
                raise AdmissionRejected("llm batcher is stopped")
            self._pending.append(st)
        self._wake.set()
        return ticket

    def stats(self) -> dict:
        with self._lock:
            out = {
                "live_streams": len(self._live),
                "queued_streams": len(self._pending),
                "steps": self.steps,
                "tokens_generated": self.tokens_generated,
                "streams_completed": self.streams_completed,
                "decode_submits": self.decode_submits,
                "prefill_submits": self.prefill_submits,
                "forked_streams": self.forked_streams,
            }
        out["kv"] = self.kv.stats()
        return out

    def stop(self, timeout: float | None = 60.0) -> None:
        """Graceful: no new streams, finish the live ones, join.  On
        timeout the loop is aborted and leftover streams fail."""
        with self._lock:
            self._stop = True
        self._wake.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            self._abort = RuntimeError("batcher stop timed out")
            self._wake.set()
            self._thread.join(5.0)

    # -- the iteration loop ---------------------------------------------
    def _loop(self) -> None:
        try:
            while True:
                if self._abort is not None:
                    self._fail_all(self._abort)
                    return
                with self._lock:
                    room = self.max_batch - len(self._live)
                    fresh = [self._pending.popleft()
                             for _ in range(min(room, len(self._pending)))]
                    live = list(self._live)
                    stopping = self._stop
                if not fresh and not live:
                    if stopping:
                        return
                    self._wake.wait(0.05)
                    self._wake.clear()
                    continue
                # chunked-prefill interleave: arrivals' prefill pools are
                # SUBMITTED first, the live streams' decode superpools run
                # while prefill is in flight, and only then are the
                # prefill tickets awaited.  Fresh streams join at the
                # NEXT boundary.
                pf = self._prefill_submit(fresh) if fresh else None
                if live:
                    self._decode_step(live)
                if pf is not None:
                    ok = self._prefill_await(pf)
                    with self._lock:
                        self._live.extend(ok)
        except BaseException as e:      # noqa: BLE001 — fail the streams,
            self._fail_all(e)           # never leave clients blocked

    def _retire_failed(self, streams: list[_Stream], e: BaseException,
                       defer_pool: Any = None) -> None:
        """Contain a failure to the streams it hit.  ``defer_pool`` is
        the pool that may STILL BE RUNNING (a step timeout): the streams'
        pages release only when it terminates, so no new stream is handed
        pages a zombie pool can still write."""
        with self._lock:
            for st in streams:
                if st in self._live:
                    self._live.remove(st)
        seqs = [st.seq for st in streams]
        for st in streams:
            st.ticket._fail(e)
        if defer_pool is None:
            for s in seqs:
                self._release_stream_state(s)
        else:
            defer_pool.add_completion_listener(
                lambda _tp: [self._release_stream_state(s) for s in seqs])

    def _release_stream_state(self, seq: Any) -> None:
        """Everything a retired sequence held: KV pages back to the free
        list, its Q/O side tiles and TOK chain tiles dropped."""
        self.kv.free_seq(seq)
        self.Q.discard(seq)
        self.O.discard(seq)
        for key in self.TOK.known_keys():
            if key and key[0] == seq:
                self.TOK.discard(*key)

    def _fail_all(self, e: BaseException) -> None:
        with self._lock:
            victims = self._live + list(self._pending)
            self._live = []
            self._pending.clear()
        for st in victims:
            st.ticket._fail(e)
            self._release_stream_state(st.seq)

    def _fork_ready(self, parent: _Stream) -> bool:
        """Whether a fork parent's cache is EXACTLY its prompt prefix
        (prefilled, not yet decoded).  A retired parent is never ready:
        its page release may be deferred behind a zombie pool."""
        if parent.ticket.done():
            return False
        try:
            return self.kv.seq_len(parent.seq) == len(parent.prompt) - 1
        except KeyError:                 # parent retired / never admitted
            return False

    def _prefill_submit(self, fresh: list[_Stream]) -> dict:
        """Phase 1 of the chunked-prefill interleave: allocate pages and
        SUBMIT one PF pool per tenant, without awaiting.  A fork child of
        an admitted parent at its prompt boundary forks here; a child
        whose parent arrives in the same batch resolves in
        :meth:`_prefill_await`."""
        stream_chunks: dict[Any, dict[tuple, torch.Tensor]] = {}
        by_tenant: dict[str, list[_Stream]] = {}
        forks: list[_Stream] = []
        ok: list[_Stream] = []
        fresh_ids = {id(st) for st in fresh}
        for st in fresh:
            parent = st.fork_from
            if parent is not None and id(parent) in fresh_ids:
                st.ticket.state = "prefill"
                forks.append(st)
                continue
            if parent is not None and self._fork_ready(parent):
                try:
                    self.kv.fork(parent.seq, st.seq)
                except BaseException as e:   # noqa: BLE001 — contain
                    self._retire_failed([st], e)
                    continue
                st.fork_from = None
                st.ticket.state = "prefill"
                with self._lock:
                    self.forked_streams += 1
                ok.append(st)
                continue
            st.fork_from = None          # parent advanced: plain prefill
            try:
                self.kv.alloc_seq(st.seq)
                stream_chunks[st.seq] = prefill_chunks(
                    self.model, self.kv, st.seq, st.prompt[:-1])
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed([st], e)
                continue
            st.ticket.state = "prefill"
            by_tenant.setdefault(st.tenant, []).append(st)
        t0 = time.perf_counter()
        tickets: list[tuple[Any, Any, list[_Stream]]] = []
        done_t: dict[int, float] = {}
        for tenant, group in by_tenant.items():
            # single-token prompts cache nothing: they join with
            # prefill_s = 0 instead of awaiting a pool
            ok.extend(st for st in group if not stream_chunks[st.seq])
            group = [st for st in group if stream_chunks[st.seq]]
            if not group:
                continue
            chunks: dict[tuple, torch.Tensor] = {}
            for st in group:
                chunks.update(stream_chunks[st.seq])
            try:
                T = DictCollection(
                    f"llmT{next(self._pool_seq)}",
                    dtt=self.kv.default_dtt,
                    init_fn=lambda *k, _c=chunks: _c[k],
                    keys=list(chunks))
                tp = prefill_ptg(self.kv, T, [st.seq for st in group],
                                 devices=self.devices,
                                 name=f"llm_prefill{next(self._pool_seq)}")
                # the pool's own completion stamp: it is awaited only
                # after the decode superpools
                tp.add_completion_listener(
                    lambda _tp, _d=done_t, _k=id(tp):
                    _d.setdefault(_k, time.perf_counter()))
                tickets.append((self._server.submit(
                    tp, tenant=tenant,
                    priority=max(st.priority for st in group)), tp, group))
                with self._lock:
                    self.prefill_submits += 1
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed(group, e)
        return {"t0": t0, "tickets": tickets, "ok": ok, "forks": forks,
                "done_t": done_t}

    def _prefill_await(self, state: dict) -> list[_Stream]:
        """Phase 2: await the PF tickets, then resolve fork children —
        their parent's pages are real now.  Returns the streams that
        join the live batch."""
        ok: list[_Stream] = list(state["ok"])
        for st in ok:
            st.ticket.prefill_s = 0.0
        for tk, tp, group in state["tickets"]:
            try:
                tk.result(timeout=_params.get("llm_step_timeout"))
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed(group, e, defer_pool=tp)
                continue
            dt = state["done_t"].get(
                id(tp), time.perf_counter()) - state["t0"]
            for st in group:
                st.ticket.prefill_s = dt
            ok.extend(group)
        ok_ids = {id(st) for st in ok}
        fallback: list[_Stream] = []
        for st in state["forks"]:
            parent = st.fork_from
            # an in-batch parent must have COMPLETED its PF pool: the
            # ledger advances at chunk time, before the pool runs
            if id(parent) not in ok_ids:
                st.fork_from = None
                fallback.append(st)
                continue
            try:
                self.kv.fork(parent.seq, st.seq)
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed([st], e)
                continue
            st.fork_from = None
            st.ticket.prefill_s = 0.0     # CoW share: no bytes moved
            with self._lock:
                self.forked_streams += 1
            ok_ids.add(id(st))
            ok.append(st)
        if fallback:
            # fork_from is cleared: one level of recursion at most
            ok.extend(self._prefill_await(self._prefill_submit(fallback)))
        for st in ok:
            st.ticket.state = "decoding"
        return ok

    def _collect(self, group: list[_Stream], dt: float) -> list[_Stream]:
        """Read a completed superpool's TOK chains (one transfer for the
        pool) into its streams' tickets; returns the streams that
        finished (EOS or budget)."""
        chains = read_token_chains(self.TOK, {st.seq: st.k for st in group})
        finished = []
        for st in group:
            toks, done = chains[st.seq]
            for t_i in range(st.k):
                self.TOK.discard(st.seq, t_i)
            # the ledger advances by the FULL k: the OUT bodies appended
            # every step's k/v (predication holds tokens, not appends)
            self.kv.note_appended(st.seq, st.k)
            st.cur = toks[-1]
            now = time.monotonic()
            if not st.ticket.tokens:
                st.ticket.first_token_at = now
            with self._lock:
                st.ticket.tokens.extend(toks)
                st.ticket.token_at.extend([now] * len(toks))
                st.ticket.per_token_s.extend([dt / len(toks)] * len(toks))
                self.tokens_generated += len(toks)
            if done or len(st.ticket.tokens) >= st.max_new:
                finished.append(st)
        return finished

    def _decode_step(self, live: list[_Stream]) -> None:
        """One continuous-batching iteration: ONE k-step decode superpool
        per tenant over its live streams, k = ``llm_steps_per_pool``
        clipped to each stream's remaining budget.  Failures are
        contained per stream (slot allocation) or per tenant (pool)."""
        k_max = max(1, int(_params.get("llm_steps_per_pool")))
        by_tenant: dict[str, list[_Stream]] = {}
        for st in live:
            st.k = max(1, min(k_max, st.max_new - len(st.ticket.tokens)))
            try:
                preallocate_decode_steps(self.kv, st.seq, st.k)
                seed_stream_step(self.model, self.Q, self.TOK, st.seq,
                                 st.cur, eos=st.eos)
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed([st], e)
                continue
            by_tenant.setdefault(st.tenant, []).append(st)
        t0 = time.perf_counter()
        submitted: list[tuple[Any, Any, list[_Stream]]] = []
        for tenant, group in by_tenant.items():
            try:
                tp = decode_superpool_ptg(
                    self.kv, self.Q, self.O, self.TOK, self.EMB,
                    [st.seq for st in group], [st.k for st in group],
                    devices=self.devices,
                    name=f"llm_decode{next(self._pool_seq)}")
                submitted.append((self._server.submit(
                    tp, tenant=tenant,
                    priority=max(st.priority for st in group)), tp, group))
                with self._lock:
                    self.decode_submits += 1
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed(group, e)
        finished: list[_Stream] = []
        for tk, tp, group in submitted:
            try:
                tk.result(timeout=_params.get("llm_step_timeout"))
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed(group, e, defer_pool=tp)
                continue
            try:
                finished.extend(self._collect(group,
                                              time.perf_counter() - t0))
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed(group, e)
        with self._lock:
            self.steps += 1
            for st in finished:
                self._live.remove(st)
                self.streams_completed += 1
        for st in finished:
            self._release_stream_state(st.seq)
            st.ticket._resolve()

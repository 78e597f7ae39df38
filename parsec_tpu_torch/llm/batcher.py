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

**Speculative decode** (``llm_spec_k``): a stream whose n-gram drafter
has a proposal rides the batched speculative pool
(:func:`~parsec_tpu_torch.llm.decode.spec_batched_ptg`) instead: its
1+k positions verify in one pass, SVERIFY emits the accepted prefix, and
the rejected tail's staged k/v roll back
(``PagedKVCollection.rollback_tail``) before its next pool.  Each
stream's draft cap adapts from its acceptance (``llm_spec_adaptive``),
starting from its tenant's prior, and a stream converged off probes
again every ``_SPEC_PROBE_EVERY`` iterations.  Spec and plain streams of
a tenant ride separate pools in the same iteration.

**The memory hierarchy**: with ``llm_prefix_cache`` an arrival adopts
the longest retained full-page prefix of its prompt from the
:class:`~parsec_tpu_torch.llm.prefix_tree.PrefixTree` and prefills only
its tail, and a stream that retires cleanly donates its prompt pages.  A
:class:`~parsec_tpu_torch.data_dist.kv_tiers.KVTierMap` keeps the books
of pages the card evicted and stages the live streams' pages back
before each iteration's pools (at once a no-op while nothing spilled).

The pools run on the card: ``devices`` defaults to ``"cuda"``, and when
no CUDA device is registered the batcher registers the card itself
(:func:`~parsec_tpu_torch.device.cuda.init_cuda_devices`, which raises
without one).  The TOK or VOUT tiles a pool leaves on the card come back
in one transfer per pool.  :func:`aggregate_report` sums every batcher's
counters, live and retired: it is the ``llm`` block of
``runtime_report()``.

**Observability.**  Each stream mints a trace
(``StreamTicket.trace``).  The batcher records into its server's SLO
plane (``RuntimeServer.metrics()``): per tenant ``ttft_ms`` at a
stream's first token, ``tok_latency_ms`` for every token (the
iteration's wall over its tokens), ``prefix_hits`` and
``prefix_pages_reused`` at a cache hit, ``spec_accept_rate`` and
``spec_tokens_per_submit`` after each spec pool; and
``kv_prefetched_pages`` under ``_server``.

**Adaptive k** (``tune_adaptive``, off by default): each tenant's pool
depth follows a :class:`~parsec_tpu_torch.tune.adaptive.KnobController`
fed the tenant's inter-token latency (the value its ``tok_latency_ms``
histogram records), started from the tenant's vector in the tuning DB
when the server's consult found one (:meth:`seed_tenant_knobs`); a
converged adoption is written back once.  Adaptation moves batching,
never tokens.  ``owner_rank`` pins every collection of the batcher to
one rank of a multi-rank context (the sharded server's ranks each run a
batcher), and :meth:`residency_len` and :meth:`load` are its placement
hooks.

**Region-lowered pools** (``llm_lower_regions``, off by default): each
decode or spec pool is lowered to megakernel regions
(:func:`~parsec_tpu_torch.ptg.lowering.lower_regions`: the per-sequence
chains become parallel regions, one prepared step each, on the card)
and the region pool is submitted instead; a pool the lowering refuses
(``LoweringError``) runs task by task on the card as before.
``stats()["regions"]`` counts the pools lowered, the fallbacks and the
regions.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque
from typing import Any, Sequence

import torch

from ..core.future import Future
from ..core.params import params as _params
from ..data.datatype import TileType
from ..data_dist.collection import DictCollection
from ..data_dist.kv_tiers import KVTierMap
from ..data_dist.paged_kv import PagedKVCollection
from ..device.cuda import init_cuda_devices
from ..device.device import registry
from ..prof import spans as _spans
from .decode import (decode_superpool_ptg, preallocate_decode_steps,
                     prefill_chunks, prefill_ptg, read_spec_batched,
                     read_token_chains, seed_emb_table, seed_spec_batched,
                     seed_stream_step, spec_batched_ptg)
from .model import NgramDrafter, ToyLM
from ..tune.adaptive import steps_controller, writeback
from .prefix_tree import PrefixTree

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
# the autotuner's declared domain: superpool depth in powers of two
_params.declare_knob("llm_steps_per_pool", lo=1, hi=32, scale="log2")
_params.register("llm_lower_regions", False,
                 "region-lower each decode superpool and spec pool "
                 "(ptg.lowering.lower_regions) before submission: one "
                 "prepared step per verified region instead of a task "
                 "per page and step; a pool the lowering refuses runs "
                 "task by task")
_params.register("llm_spec_k", 0,
                 "speculative decode: draft tokens the per-stream n-gram "
                 "drafter proposes per pool (0 = off); a spec pool "
                 "verifies 1+k positions at once and rolls the rejected "
                 "tail's k/v back")
_params.register("llm_spec_adaptive", True,
                 "adapt each stream's draft length within [0, llm_spec_k] "
                 "from its acceptance EWMA; a stream converged to 0 rides "
                 "the plain superpool and probes again periodically")

_F32 = torch.float32

# iterations a stream converged off speculation waits before it probes
# again with a 2-token draft
_SPEC_PROBE_EVERY = 64

# live batchers, weakly held, and the folded counters of stopped ones:
# aggregate_report() stays cumulative over the process
_live_batchers: "weakref.WeakSet[ContinuousBatcher]" = weakref.WeakSet()
_retired_totals: dict[str, int] = {}
_retired_lock = threading.Lock()

_REPORT_KEYS = ("tokens_generated", "streams_completed", "decode_submits",
                "forked_streams", "prefill_tokens_total",
                "prefill_tokens_skipped", "spec_submits", "spec_tokens",
                "spec_drafted", "spec_drafts_accepted")
_REPORT_KV_KEYS = ("prefix_hits", "prefix_pages_reused", "host_tier_bytes",
                   "prefetch_inflight", "physical_pages", "cow_copies",
                   "tail_rollbacks", "slots_rolled_back")


def _fold_stats(out: dict, s: dict) -> None:
    for k in _REPORT_KEYS:
        out[k] = out.get(k, 0) + s.get(k, 0)
    for k in _REPORT_KV_KEYS:
        out[k] = out.get(k, 0) + s.get("kv", {}).get(k, 0)


def aggregate_report() -> dict:
    """The counters of every live batcher summed with the folded totals of
    stopped ones, with the prefill-skip fraction, the spec acceptance
    rate and the tokens per spec submit derived from them."""
    with _retired_lock:
        out: dict[str, Any] = dict(_retired_totals)
    for b in list(_live_batchers):
        if not getattr(b, "_folded", False):
            _fold_stats(out, b.stats())
    if out:
        total = out.get("prefill_tokens_total", 0)
        out["prefill_skipped_frac"] = round(
            out.get("prefill_tokens_skipped", 0) / total, 4) if total \
            else 0.0
        if out.get("spec_drafted"):
            out["spec_accept_rate"] = round(
                out.get("spec_drafts_accepted", 0) / out["spec_drafted"], 4)
        if out.get("spec_submits"):
            out["spec_tokens_per_submit"] = round(
                out.get("spec_tokens", 0) / out["spec_submits"], 4)
    return out


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
        self.prefix_pages_reused = 0   # trie pages this stream skipped
        # the stream's current (adapted) draft cap and acceptance EWMA,
        # updated after every spec pool it rides
        self.spec_k: int | None = None
        self.spec_accept_ewma: float | None = None
        # the stream's trace context, named by stall dumps
        self.trace = _spans.new_trace()
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
                 "ticket", "cur", "eos", "fork_from", "k", "spec",
                 "drafter", "spec_k", "spec_ewma", "spec_probe")

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
        self.k = 1                      # steps (positions) of its pool
        self.spec = False               # the current pool is speculative
        # built in the batcher thread at the first speculative look
        self.drafter: NgramDrafter | None = None
        self.spec_k = -1                # adaptive draft cap (-1 = unset)
        self.spec_ewma = -1.0           # acceptance EWMA (-1 = unset)
        self.spec_probe = 0             # iterations since converged off


class ContinuousBatcher:
    """The decode loop.  Owns the paged KV cache, its prefix tree and
    tier map, and the side collections (Q/O/TOK for the plain superpool,
    QS/LIM/DTOKS/VOUT for the speculative one, EMB); rides an existing
    :class:`RuntimeServer` for admission, fairness and the hot
    context."""

    def __init__(self, server: Any, model: ToyLM | None = None,
                 kv: PagedKVCollection | None = None,
                 max_batch: int | None = None,
                 devices: str = "cuda",
                 owner_rank: int | None = None) -> None:
        if devices not in ("cuda", "cpu"):
            raise ValueError(f"devices must be 'cuda' or 'cpu', got "
                             f"{devices!r}")
        if devices == "cuda" and not registry.by_type("cuda"):
            init_cuda_devices()          # cuda:0; raises without a card
        self._server = server
        # the server's per-tenant SLO plane (TTFT, token latency)
        self._slo = getattr(server, "_slo", None)
        self.model = model or ToyLM()
        H, D = self.model.num_heads, self.model.head_dim
        # owner_rank pins EVERY tile to one rank of a multi-rank context:
        # this rank alone enqueues the batcher's pools, so a tile owned
        # elsewhere would ship the work to a rank that never sees the pool
        self.owner_rank = owner_rank
        self._pin = pin = (None if owner_rank is None
                           else (lambda *k: owner_rank))

        def _dc(name: str, dtt: TileType) -> DictCollection:
            return DictCollection(name, dtt=dtt, rank_of_fn=pin)

        self.kv = kv or PagedKVCollection(
            "llmKV", page_size=_params.get("llm_page_size"),
            num_heads=H, head_dim=D, max_pages=_params.get("llm_max_pages"),
            rank_of_fn=pin)
        if (self.kv.num_heads, self.kv.head_dim) != (H, D):
            raise ValueError("model and KV cache disagree on head geometry")
        self.Q = _dc("llmQ", dtt=TileType((3, H, D), _F32))
        self.O = _dc("llmO", dtt=TileType((H, D), _F32))
        self.TOK = _dc("llmTOK", dtt=TileType((3,), _F32))
        # the batched spec pool's side collections: QS the positions' q3
        # stacks, LIM the per-(seq, page) causal limits, DTOKS the packed
        # draft chain, VOUT the accepted prefix the host reads once a
        # pool.  Their shapes are per pool (padded to llm_spec_k + 1);
        # the declared types only serve a tile read before its first seed
        sp0 = max(1, int(_params.get("llm_spec_k"))) + 1
        self.QS = _dc("llmQS", dtt=TileType((sp0, 3, H, D), _F32))
        self.LIM = _dc("llmLIM", dtt=TileType((sp0,), _F32))
        self.DTOKS = _dc("llmDTOKS", dtt=TileType((sp0 + 2,), _F32))
        self.VOUT = _dc("llmVOUT", dtt=TileType((sp0 + 2,), _F32))
        self.EMB = _dc(
            "llmEMB", dtt=TileType(tuple(self.model.q3_table().shape), _F32))
        seed_emb_table(self.model, self.EMB)
        self.max_batch = max_batch or _params.get("llm_max_batch")
        self.devices = devices
        # llm_lower_regions: pools lowered, pools that fell back, regions
        self.region_pools = 0
        self.region_fallbacks = 0
        self.regions_lowered = 0
        self.prefix = (PrefixTree(self.kv)
                       if _params.get("llm_prefix_cache") else None)
        self.tiers = KVTierMap(self.kv)
        self.prefill_tokens_total = 0     # cacheable tokens admitted
        self.prefill_tokens_skipped = 0   # of those, served by the trie
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
        # speculative tallies: spec_submits counts a stream's ride on a
        # spec pool, the unit spec_tokens_per_submit divides by
        self.spec_submits = 0
        self.spec_tokens = 0
        self.spec_drafted = 0
        self.spec_drafts_accepted = 0
        # per-tenant acceptance prior (batcher thread only): a new
        # stream starts its draft cap where its tenant's traffic settled
        self._spec_prior: dict[str, float] = {}
        # adaptive k (``tune_adaptive``): one controller per tenant, on
        # the batcher thread; _k_seed holds the tuning DB's start points
        # the server's consult hands over before a controller exists
        self._k_ctl: dict[str, Any] = {}
        self._k_seed: dict[str, int] = {}
        self._pool_seq = itertools.count()
        _live_batchers.add(self)
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

    def seed_tenant_knobs(self, tenant: str, knobs: dict) -> None:
        """Seed a tenant's adaptive start point from a persisted knob
        vector (the server's per-tenant tuning-DB consult), used when the
        tenant's controller is made."""
        k = knobs.get("llm_steps_per_pool")
        if isinstance(k, (int, float)) and not isinstance(k, bool) \
                and k >= 1:
            self._k_seed[tenant] = int(k)

    def _tenant_k(self, tenant: str, k_max: int) -> int:
        """The tenant's pool depth this iteration: ``llm_steps_per_pool``
        unless adaptation is on, then its controller's value (seeded from
        the tuning DB when a vector was stored).  Batcher thread only."""
        if not _params.get("tune_adaptive"):
            return k_max
        ctl = self._k_ctl.get(tenant)
        if ctl is None:
            ctl = steps_controller(tenant, self._k_seed.get(tenant, k_max))
            self._k_ctl[tenant] = ctl
        return max(1, int(ctl.value))

    # -- placement hooks ------------------------------------------------
    def residency_len(self, prompt_tokens: Sequence[int]) -> int:
        """Leading tokens of a prospective prompt already held by this
        batcher's prefix tree (full pages only); 0 with the cache off."""
        if self.prefix is None:
            return 0
        _seq, pages = self.prefix.match(list(prompt_tokens))
        return pages * self.kv.page_size

    def load(self) -> dict:
        """Live and queued stream counts."""
        with self._lock:
            return {"live": len(self._live), "queued": len(self._pending)}

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
                "prefill_tokens_total": self.prefill_tokens_total,
                "prefill_tokens_skipped": self.prefill_tokens_skipped,
                "spec_submits": self.spec_submits,
                "spec_tokens": self.spec_tokens,
                "spec_drafted": self.spec_drafted,
                "spec_drafts_accepted": self.spec_drafts_accepted,
            }
        if out["spec_drafted"]:
            out["spec_accept_rate"] = round(
                out["spec_drafts_accepted"] / out["spec_drafted"], 4)
        if out["spec_submits"]:
            out["spec_tokens_per_submit"] = round(
                out["spec_tokens"] / out["spec_submits"], 4)
        if self.region_pools or self.region_fallbacks:
            with self._lock:
                out["regions"] = {"pools": self.region_pools,
                                  "fallbacks": self.region_fallbacks,
                                  "regions": self.regions_lowered}
        if self._k_ctl:
            # each controller's start too: the tuning DB's seed or the
            # configured depth
            out["adaptive_k"] = {t: {**c.stats(), "start": c.default}
                                 for t, c in list(self._k_ctl.items())}
        if self._k_seed:
            out["adaptive_k_seed"] = dict(self._k_seed)
        out["kv"] = self.kv.stats()
        out["tiers"] = self.tiers.stats()
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
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
        # fold the final counters into the process aggregate, once
        with _retired_lock:
            if not getattr(self, "_folded", False):
                self._folded = True
                _fold_stats(_retired_totals, self.stats())

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
        for coll in (self.TOK, self.QS, self.LIM, self.DTOKS, self.VOUT):
            for key in coll.known_keys():
                if key and key[0] == seq:
                    coll.discard(*key)

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

    def _admit_via_prefix(self, st: _Stream) -> int:
        """Materialize a fresh stream's sequence, through the prefix cache
        when it is on: the trie matches ``prompt[:-1]`` (the cacheable
        run) and forks the longest retained full-page prefix, so only the
        tail prefills.  Returns the pages reused (0: a miss, or no
        cache)."""
        if self.prefix is None:
            self.kv.alloc_seq(st.seq)
            reused = 0
        else:
            reused = self.prefix.adopt(st.seq, st.prompt[:-1])
        with self._lock:
            self.prefill_tokens_total += len(st.prompt) - 1
            self.prefill_tokens_skipped += reused * self.kv.page_size
        st.ticket.prefix_pages_reused = reused
        if reused and self._slo is not None:
            # hit rates beside the TTFT quantiles they should move
            self._slo.inc(st.tenant, "prefix_hits")
            self._slo.inc(st.tenant, "prefix_pages_reused", reused)
        return reused

    def _prefill_submit(self, fresh: list[_Stream]) -> dict:
        """Phase 1 of the chunked-prefill interleave: allocate pages and
        SUBMIT one PF pool per tenant, without awaiting.  A fork child of
        an admitted parent at its prompt boundary forks here; a child
        whose parent arrives in the same batch resolves in
        :meth:`_prefill_await`."""
        stream_chunks: dict[Any, dict[tuple, torch.Tensor]] = {}
        chunk_starts: dict[Any, int] = {}
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
                reused = self._admit_via_prefix(st)
                # tail-only prefill: chunks continue past the trie's pages
                stream_chunks[st.seq] = prefill_chunks(
                    self.model, self.kv, st.seq,
                    st.prompt[reused * self.kv.page_size:-1])
                chunk_starts[st.seq] = reused
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed([st], e)
                continue
            st.ticket.state = "prefill"
            by_tenant.setdefault(st.tenant, []).append(st)
        t0 = time.perf_counter()
        tickets: list[tuple[Any, Any, list[_Stream]]] = []
        done_t: dict[int, float] = {}
        for tenant, group in by_tenant.items():
            # single-token prompts cache nothing, and a full-prefix trie
            # hit holds every cacheable page already: both join with
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
                    rank_of_fn=self._pin,
                    init_fn=lambda *k, _c=chunks: _c[k],
                    keys=list(chunks))
                tp = prefill_ptg(self.kv, T, [st.seq for st in group],
                                 devices=self.devices,
                                 name=f"llm_prefill{next(self._pool_seq)}",
                                 starts=[chunk_starts[st.seq]
                                         for st in group])
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

    def _spec_draft(self, st: _Stream, spec_cap: int,
                    adaptive: bool) -> list[int] | None:
        """This stream's draft for its next pool, or None to ride the
        plain superpool (spec off, no budget left to draft into, no
        proposal, or the adaptive cap converged to 0).  A stream converged
        off probes again every ``_SPEC_PROBE_EVERY`` iterations with a
        2-token draft and a neutral EWMA."""
        remaining = st.max_new - len(st.ticket.tokens)
        if spec_cap <= 0 or remaining <= 1:
            return None
        if st.drafter is None:
            # the drafter sees every token the stream kept, whatever mode
            # produced it
            st.drafter = NgramDrafter()
            for t in st.prompt:
                st.drafter.observe(int(t))
            for t in st.ticket.tokens:
                st.drafter.observe(int(t))
        cap = min(spec_cap, remaining - 1)
        if adaptive:
            if st.spec_k < 0:
                # start at the cap, unless the tenant's traffic proved
                # undraftable: then start off, probes staggered
                prior = self._spec_prior.get(st.tenant)
                if prior is not None and prior < 0.35:
                    st.spec_k = 0
                    st.spec_probe = hash(st.seq) % _SPEC_PROBE_EVERY
                else:
                    st.spec_k = spec_cap
            if st.spec_k == 0:
                st.spec_probe += 1
                if st.spec_probe < _SPEC_PROBE_EVERY:
                    return None
                st.spec_probe = 0
                st.spec_k = 2
                st.spec_ewma = 0.5
            cap = min(cap, st.spec_k)
        if cap < 1:
            return None
        return st.drafter.draft(st.cur, cap) or None

    def _note_spec(self, st: _Stream, toks: list[int], done: bool) -> None:
        """Fold one spec pool's result into the stream's adaptive cap, its
        tenant's prior and the counters.  An EOS finish scores 1.0: the
        stream cut the chain, not a draft miss."""
        drafted = st.k - 1
        accepted = len(toks) - 1
        rate = 1.0 if done else accepted / max(1, drafted)
        st.spec_ewma = rate if st.spec_ewma < 0.0 else \
            0.5 * st.spec_ewma + 0.5 * rate
        prior = self._spec_prior.get(st.tenant)
        self._spec_prior[st.tenant] = rate if prior is None else \
            0.5 * prior + 0.5 * rate
        adaptive = bool(_params.get("llm_spec_adaptive"))
        spec_cap = max(0, int(_params.get("llm_spec_k")))
        if adaptive:
            # double toward the cap while drafts land, halve toward 0 (the
            # plain superpool) while they miss
            if st.spec_ewma >= 0.6:
                st.spec_k = min(spec_cap, max(2, st.spec_k * 2))
            elif st.spec_ewma < 0.35:
                st.spec_k //= 2
        st.ticket.spec_k = st.spec_k if adaptive else spec_cap
        st.ticket.spec_accept_ewma = round(st.spec_ewma, 4)
        with self._lock:
            self.spec_submits += 1
            self.spec_tokens += len(toks)
            self.spec_drafted += drafted
            self.spec_drafts_accepted += accepted
        if self._slo is not None:
            self._slo.observe(st.tenant, "spec_accept_rate", rate)
            self._slo.observe(st.tenant, "spec_tokens_per_submit",
                              len(toks))

    def _read_pool(self, group: list[_Stream], spec: bool
                   ) -> dict[Any, tuple[list[int], bool]]:
        """A completed pool's tokens, in one transfer for the pool: the
        accepted prefixes (VOUT) of a spec pool, the TOK chains of a
        plain one."""
        if spec:
            return read_spec_batched(self.VOUT, [st.seq for st in group])
        chains = read_token_chains(self.TOK, {st.seq: st.k for st in group})
        for st in group:
            for t_i in range(st.k):
                self.TOK.discard(st.seq, t_i)
        return chains

    def _collect_stream(self, st: _Stream, toks: list[int], done: bool,
                        dt: float) -> bool:
        """Fold one stream's tokens into its ticket and the ledger;
        returns whether it finished (EOS or budget).  The ledger advances
        by the pool's full k (every step's or position's k/v was
        appended); a spec stream's rejected tail then rolls back, so no
        stale k/v reaches its next pool."""
        self.kv.note_appended(st.seq, st.k)
        if st.spec:
            rejected = st.k - len(toks)
            if rejected:
                self.kv.rollback_tail(st.seq,
                                      self.kv.seq_len(st.seq) - rejected)
            self._note_spec(st, toks, done)
        if st.drafter is not None:
            for t_i in toks:
                st.drafter.observe(t_i)
        st.cur = toks[-1]
        now = time.monotonic()
        slo = self._slo
        if not st.ticket.tokens:
            st.ticket.first_token_at = now
            if slo is not None:
                slo.observe(st.tenant, "ttft_ms",
                            (now - st.ticket.submitted_at) * 1e3)
        tok_ms = dt / len(toks) * 1e3
        if slo is not None:
            for _ in toks:
                slo.observe(st.tenant, "tok_latency_ms", tok_ms)
        ctl = self._k_ctl.get(st.tenant)
        if ctl is not None:
            # the controller folds the same signal; a converged adoption
            # persists to the tuning DB exactly once
            ctl.observe(tok_ms)
            wb = ctl.take_writeback()
            if wb is not None:
                writeback(st.tenant, wb, ctl.ewma_of(wb) or tok_ms)
        with self._lock:
            st.ticket.tokens.extend(toks)
            st.ticket.token_at.extend([now] * len(toks))
            st.ticket.per_token_s.extend([dt / len(toks)] * len(toks))
            self.tokens_generated += len(toks)
        return done or len(st.ticket.tokens) >= st.max_new

    def _seed(self, st: _Stream, spec_cap: int, adaptive: bool,
              k_max: int) -> None:
        """Choose the stream's mode for this iteration and seed its pool
        inputs.  The slots are preallocated first, so the staged draft
        k/v land in private pages."""
        draft = self._spec_draft(st, spec_cap, adaptive)
        st.spec = draft is not None
        if st.spec:
            st.k = 1 + len(draft)
            preallocate_decode_steps(self.kv, st.seq, st.k)
            seed_spec_batched(self.model, self.kv, self.QS, self.LIM,
                              self.DTOKS, st.seq, st.cur, draft,
                              spec_cap + 1, eos=st.eos)
        else:
            st.k = max(1, min(self._tenant_k(st.tenant, k_max),
                              st.max_new - len(st.ticket.tokens)))
            preallocate_decode_steps(self.kv, st.seq, st.k)
            seed_stream_step(self.model, self.Q, self.TOK, st.seq, st.cur,
                             eos=st.eos)

    def _maybe_lower_regions(self, tp: Any) -> Any:
        """Opt-in (``llm_lower_regions``): lower the pool to megakernel
        regions on the batcher's device, prepare them and submit the
        REGION pool instead.  The lowering cache makes repeat geometries
        free to prepare; a pool the lowering refuses runs task by task,
        on the card all the same."""
        if not _params.get("llm_lower_regions"):
            return tp
        from ..ptg.lowering import LoweringError, lower_regions
        cards = registry.by_type("cuda")
        device = (cards[0].torch_device if self.devices == "cuda" and cards
                  else torch.device("cpu"))
        try:
            plan = lower_regions(tp, device=device)
            plan.compile()
            pool = plan.taskpool(plan.materialize_table())
        except LoweringError:
            with self._lock:
                self.region_fallbacks += 1
            return tp
        with self._lock:
            self.region_pools += 1
            self.regions_lowered += len(plan.regions)
        return pool

    def _decode_step(self, live: list[_Stream]) -> None:
        """One continuous-batching iteration: ONE pool per (tenant, mode)
        over its live streams: the batched speculative pool for streams
        with a draft, the k-step superpool for the rest, k =
        ``llm_steps_per_pool`` clipped to each stream's remaining budget.
        Failures are contained per stream (seeding, collection) or per
        tenant and mode (the pool)."""
        k_max = max(1, int(_params.get("llm_steps_per_pool")))
        spec_cap = max(0, int(_params.get("llm_spec_k")))
        adaptive = bool(_params.get("llm_spec_adaptive"))
        # the tier's way back, ahead of the pools: pages the previous
        # iteration's eviction pushed to the host (or a peer) return
        # while this thread seeds and builds (advisory: a failure is
        # counted in the tier map's stats)
        n = self.tiers.prefetch_seqs([st.seq for st in live])
        if n and self._slo is not None:
            self._slo.inc("_server", "kv_prefetched_pages", n)
        by_group: dict[tuple[str, bool], list[_Stream]] = {}
        for st in live:
            try:
                self._seed(st, spec_cap, adaptive, k_max)
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed([st], e)
                continue
            by_group.setdefault((st.tenant, st.spec), []).append(st)
        t0 = time.perf_counter()
        submitted: list[tuple[Any, Any, list[_Stream], bool]] = []
        for (tenant, spec), group in by_group.items():
            seqs, ks = [st.seq for st in group], [st.k for st in group]
            name = f"llm_{'spec' if spec else 'decode'}{next(self._pool_seq)}"
            try:
                if spec:
                    tp = spec_batched_ptg(
                        self.kv, self.QS, self.LIM, self.DTOKS, self.VOUT,
                        self.EMB, seqs, ks, pad=spec_cap + 1,
                        devices=self.devices, name=name)
                else:
                    tp = decode_superpool_ptg(
                        self.kv, self.Q, self.O, self.TOK, self.EMB, seqs,
                        ks, devices=self.devices, name=name)
                tp = self._maybe_lower_regions(tp)
                submitted.append((self._server.submit(
                    tp, tenant=tenant,
                    priority=max(st.priority for st in group)), tp, group,
                    spec))
                with self._lock:
                    self.decode_submits += 1
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed(group, e)
        finished: list[_Stream] = []
        for tk, tp, group, spec in submitted:
            try:
                tk.result(timeout=_params.get("llm_step_timeout"))
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed(group, e, defer_pool=tp)
                continue
            dt = time.perf_counter() - t0
            try:
                got = self._read_pool(group, spec)
            except BaseException as e:       # noqa: BLE001 — contain
                self._retire_failed(group, e)
                continue
            for st in group:
                try:
                    if self._collect_stream(st, *got[st.seq], dt):
                        finished.append(st)
                except BaseException as e:   # noqa: BLE001 — contain
                    self._retire_failed([st], e)
        with self._lock:
            self.steps += 1
            for st in finished:
                self._live.remove(st)
                self.streams_completed += 1
        for st in finished:
            if self.prefix is not None:
                # donate the prompt pages before free_seq: the trie's
                # retained fork keeps them out of the recycle path.  An
                # optimization: its failure never fails the stream
                try:
                    self.prefix.donate(st.seq, st.prompt)
                except Exception:        # noqa: BLE001 — contain
                    pass
            self._release_stream_state(st.seq)
            st.ticket._resolve()

"""Prefill and ragged-decode task classes over the paged KV cache.

Port of ``parsec_tpu/llm/decode.py``: the LLM workload as plain PTG
taskpools.

**PF(s, c)** — prefill: copy prompt chunk ``c`` of sequence ``s`` into
its KV page.

**ATTN(s, p)** — one query against one KV page, online-softmax state
threading along the sequence's ragged page list::

    ATTN(s,0) -> ATTN(s,1) -> ... -> ATTN(s, NP[s]-1) -> OUT(s)

Page tiles are uniform ``(3, page_size, H, D)`` (the fill count rides in
the tensor), so every live sequence's ATTN tasks are one class with one
shape: the CUDA device module's fused dispatch runs a batch of them as
one launch of K2 (``csrc/ragged_attn.cu``).

**OUT(s)** — finalize the attention output into the O collection and
append the query token's k/v into the tail page, ordered after the last
ATTN's read of that page by the ACC chain.

The k-step **superpool** (:func:`decode_superpool_ptg`) adds the
in-graph **SAMPLE(s, t)** class, so one pool spans k autoregressive
steps.

Speculative decode has two pools.  :func:`spec_superpool_ptg` verifies
every draft position with ATTN per position and page (on K2, like the
plain superpool), OUT and an in-graph VERIFY chain; every position's
query is known when the pool is built, so the page reads of all
positions run at once.  :func:`spec_batched_ptg`, the batcher's, stages
the whole draft chain's k/v into the tail slots first
(:func:`seed_spec_batched`) and collapses to SATTN (all positions against
one page, under per-position causal limits) and SVERIFY (the accepted
prefix).  The host reads a pool's STOK or VOUT tiles in one transfer
(:func:`read_spec_chains`, :func:`read_spec_batched`).

:func:`prefill_ptg` takes ``starts=``, the tail-only prefill of a stream
admitted through the prefix cache, and :func:`prefill_chunks` numbers its
chunks from the sequence's current page count.

Every builder takes ``devices="cuda"`` (the default: the class carries
only the device chore, resolved by ``dyld`` name, so a missing card fails
instead of running on the host) or ``"cpu"`` (only the host body).

:func:`decode_step_ptg` is one decode iteration with no in-graph
sampling (ATTN chains and OUT; the caller samples from ``O``), the pool
of the analysis CLI's ``llm_decode`` and of a host-driven step loop.
:func:`generate_by_steps` drives it step by step.
:func:`seed_decode_superpool` is the superpool's input contract in one
call (prefill in place, preallocate every step's slot, seed Q, TOK and
EMB), and :func:`read_token_chain` reads one stream's chain.  The spec
readers read several streams at once.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from .. import ptg
from ..data.datatype import TileType
from ..data_dist.collection import DictCollection
from ..data_dist.paged_kv import META_CH, PagedKVCollection
from ..device.device import registry
from ..device.kernels import find_incarnation
from ..ops import ragged_attention  # noqa: F401  # lint: keep-import

_F32 = torch.float32


def _check_devices(devices: str) -> None:
    if devices not in ("cuda", "cpu"):
        raise ValueError(f"devices must be 'cuda' or 'cpu', got {devices!r}")


def _attach(t: ptg.TaskClassBuilder, dyld: str, devices: str) -> None:
    """The class's body: the CUDA device chore by name, or the host body
    registered under the same name."""
    if devices == "cuda":
        t.body(device="cuda", dyld=dyld)
        return
    fn = find_incarnation(dyld, registry.by_type("cpu")[0])

    def host(es: Any, task: Any, g: Any, l: Any) -> None:
        fn(es, task)

    t.body(host)


def prefill_ptg(kv: PagedKVCollection, T: DictCollection,
                seqs: Sequence[Any], devices: str = "cuda",
                name: str = "llm_prefill",
                starts: Sequence[int] | None = None) -> ptg.PTGTaskpool:
    """PF(s, c) over every allocated page of every listed sequence.
    ``T`` holds the prompt chunk tiles, keyed ``(seq, chunk)``, in the
    page layout.  ``starts[i]`` is sequence ``i``'s first chunk to fill
    (default 0): a stream admitted through the prefix cache shares its
    first pages with the trie, and PF neither redoes nor overwrites
    them."""
    _check_devices(devices)
    NP = tuple(kv.npages(s) for s in seqs)
    C0 = (tuple(0 for _ in seqs) if starts is None
          else tuple(int(c) for c in starts))
    if len(C0) != len(seqs) or any(not 0 <= c <= n
                                   for c, n in zip(C0, NP)):
        raise ValueError(f"starts {C0} out of range for page counts {NP}")
    p = ptg.PTGBuilder(name, KV=kv, T=T, SEQS=tuple(seqs), NP=NP,
                       C0=C0, NS=len(seqs))
    t = p.task("PF",
               s=ptg.span(0, lambda g, l: g.NS - 1),
               c=lambda g, l: range(g.C0[l.s], g.NP[l.s]))
    t.affinity("KV", lambda g, l: (g.SEQS[l.s], l.c))
    ft = t.flow("T", ptg.READ)
    ft.input(data=("T", lambda g, l: (g.SEQS[l.s], l.c)))
    fkv = t.flow("KV", ptg.RW)
    fkv.input(data=("KV", lambda g, l: (g.SEQS[l.s], l.c)))
    fkv.output(data=("KV", lambda g, l: (g.SEQS[l.s], l.c)))
    _attach(t, "llm_prefill_copy", devices)
    return p.build()


def decode_step_ptg(kv: PagedKVCollection, Q: DictCollection,
                    O: DictCollection, seqs: Sequence[Any],
                    devices: str = "cuda",
                    name: str = "llm_decode") -> ptg.PTGTaskpool:
    """One decode iteration for every listed sequence::

        ATTN(s,0) -> ... -> ATTN(s, NP[s]-1) -> OUT(s)

    ATTN folds page p into the online-softmax state (K2 on the card, one
    launch a same-class batch); OUT finalizes into ``O(s)`` and appends
    the query token's k/v into the tail page.  Callers must have made the
    write slot real first (:meth:`PagedKVCollection.ensure_tail_slot`),
    so ``NP[s] >= 1``; the builder snapshots the page counts."""
    _check_devices(devices)
    NP = tuple(kv.npages(s) for s in seqs)
    if not all(n >= 1 for n in NP):
        raise ValueError("decode needs ensure_tail_slot() first (NP >= 1)")
    H, D = kv.num_heads, kv.head_dim
    p = ptg.PTGBuilder(name, KV=kv, Q=Q, O=O, SEQS=tuple(seqs), NP=NP,
                       NS=len(seqs))

    t = p.task("ATTN",
               s=ptg.span(0, lambda g, l: g.NS - 1),
               p=lambda g, l: range(g.NP[l.s]))
    t.affinity("KV", lambda g, l: (g.SEQS[l.s], l.p))
    # long page chains first: the step's critical path
    t.priority(lambda g, l: g.NP[l.s] - l.p)
    fq = t.flow("Q", ptg.READ)
    fq.input(data=("Q", lambda g, l: (g.SEQS[l.s],)))
    fkv = t.flow("KV", ptg.READ)
    fkv.input(data=("KV", lambda g, l: (g.SEQS[l.s], l.p)))
    facc = t.flow("ACC", ptg.RW, dtt=TileType((H, D + 2), _F32))
    facc.input(new=True, guard=lambda g, l: l.p == 0)
    facc.input(pred=("ATTN", "ACC", lambda g, l: {"s": l.s, "p": l.p - 1}),
               guard=lambda g, l: l.p > 0)
    facc.output(succ=("ATTN", "ACC",
                      lambda g, l: {"s": l.s, "p": l.p + 1}),
                guard=lambda g, l: l.p < g.NP[l.s] - 1)
    facc.output(succ=("OUT", "ACC", lambda g, l: {"s": l.s}),
                guard=lambda g, l: l.p == g.NP[l.s] - 1)
    _attach(t, "ragged_attn_page", devices)

    o = p.task("OUT", s=ptg.span(0, lambda g, l: g.NS - 1))
    o.affinity("KV", lambda g, l: (g.SEQS[l.s], g.NP[l.s] - 1))
    foacc = o.flow("ACC", ptg.READ)
    foacc.input(pred=("ATTN", "ACC",
                      lambda g, l: {"s": l.s, "p": g.NP[l.s] - 1}))
    foq = o.flow("Q", ptg.READ)
    foq.input(data=("Q", lambda g, l: (g.SEQS[l.s],)))
    fkvw = o.flow("KVW", ptg.RW)
    fkvw.input(data=("KV", lambda g, l: (g.SEQS[l.s], g.NP[l.s] - 1)))
    fkvw.output(data=("KV", lambda g, l: (g.SEQS[l.s], g.NP[l.s] - 1)))
    fo = o.flow("O", ptg.WRITE, dtt=TileType((H, D), _F32))
    fo.input(new=True)
    fo.output(data=("O", lambda g, l: (g.SEQS[l.s],)))
    _attach(o, "ragged_attn_out", devices)
    return p.build()


def preallocate_decode_steps(kv: PagedKVCollection, seq: Any,
                             k: int) -> None:
    """Make ``k`` autoregressive write slots real before the superpool is
    built: token positions are deterministic, so every tail page the k
    steps touch is allocated, and a fork-shared tail privatized, here."""
    if k < 1:
        raise ValueError("k must be >= 1")
    P = kv.page_size
    L0 = kv.seq_len(seq)
    kv.ensure_tail_slot(seq)
    last_page = (L0 + k - 1) // P
    while kv.npages(seq) <= last_page:
        kv.alloc_page(seq)


def _superpool_schedule(kv: PagedKVCollection, seqs: Sequence[Any],
                        steps: Sequence[int], kind: str = "superpool"):
    """The per-(seq, step) page schedule both superpools share (the
    k-step pool and the per-position spec pool append the same token
    positions): ``NP[t]`` pages attended, ``WP[t]`` the append page,
    ``LW[t][p]`` the last step < t writing page p (-1: read straight from
    the collection), ``RD[t]`` the later steps whose ATTN re-reads the
    page step t wrote."""
    P = kv.page_size
    NP, WP, LW, RD = [], [], [], []
    for si, s in enumerate(seqs):
        L0 = kv.seq_len(s)
        wp_s = tuple((L0 + t) // P for t in range(steps[si]))
        np_s = tuple(w + 1 for w in wp_s)
        if kv.npages(s) < np_s[-1]:
            raise ValueError(
                f"{kind} needs preallocate_decode_steps() first: seq "
                f"{s!r} has {kv.npages(s)} pages, its {steps[si]}-step "
                f"schedule needs {np_s[-1]}")
        lw_s = tuple(
            tuple(max((tp_ for tp_ in range(t) if wp_s[tp_] == p),
                      default=-1) for p in range(np_s[t]))
            for t in range(steps[si]))
        rd_s = tuple(tuple(tt for tt in range(t + 1, steps[si])
                           if lw_s[tt][wp_s[t]] == t)
                     for t in range(steps[si]))
        NP.append(np_s)
        WP.append(wp_s)
        LW.append(lw_s)
        RD.append(rd_s)
    return tuple(NP), tuple(WP), tuple(LW), tuple(RD)


def decode_superpool_ptg(kv: PagedKVCollection, Q: DictCollection,
                         O: DictCollection, TOK: DictCollection,
                         EMB: DictCollection, seqs: Sequence[Any],
                         steps: Sequence[int], devices: str = "cuda",
                         name: str = "llm_superpool") -> ptg.PTGTaskpool:
    """ONE PTG pool spanning ``steps[i]`` autoregressive decode
    iterations for each listed sequence.  Per step t of sequence s::

        ATTN(s,t,p)  online-softmax of q(s,t) over page p, ACC threading
        OUT(s,t)     finalize -> SAMPLE; append q-token k/v to the tail
        SAMPLE(s,t)  in-graph greedy argmax over OUT's output: writes
                     TOK(s,t) (the token the host reads) and feeds the
                     NEXT step's query to ATTN/OUT(s,t+1)

    Callers must have preallocated every step's write slot
    (:func:`preallocate_decode_steps`), seeded ``Q(seq)`` and
    ``TOK(seq, -1)`` (:func:`seed_stream_step`) and ``EMB(0,)``
    (:func:`seed_emb_table`).  A stream that sampled EOS holds its token
    through the rest of the pool (predicated SAMPLE bodies)."""
    _check_devices(devices)
    NS = len(seqs)
    S = tuple(int(k) for k in steps)
    if len(S) != NS or any(k < 1 for k in S):
        raise ValueError("steps must give every sequence >= 1 step")
    NP, WP, LW, RD = _superpool_schedule(kv, seqs, S)
    H, D = kv.num_heads, kv.head_dim
    p = ptg.PTGBuilder(name, KV=kv, Q=Q, O=O, TOK=TOK, EMB=EMB,
                       SEQS=tuple(seqs), NS=NS, S=S, NP=NP,
                       WP=WP, LW=LW, RD=RD)

    t = p.task("ATTN",
               s=ptg.span(0, lambda g, l: g.NS - 1),
               t=lambda g, l: range(g.S[l.s]),
               p=lambda g, l: range(g.NP[l.s][l.t]))
    t.affinity("KV", lambda g, l: (g.SEQS[l.s], l.p))
    # earlier steps and long page chains first: the critical path
    t.priority(lambda g, l: (g.S[l.s] - l.t) * 1024
               + g.NP[l.s][l.t] - l.p)
    fq = t.flow("Q", ptg.READ)
    fq.input(data=("Q", lambda g, l: (g.SEQS[l.s],)),
             guard=lambda g, l: l.t == 0)
    fq.input(pred=("SAMPLE", "QN",
                   lambda g, l: {"s": l.s, "t": l.t - 1}),
             guard=lambda g, l: l.t > 0)
    fkv = t.flow("KV", ptg.READ)
    fkv.input(data=("KV", lambda g, l: (g.SEQS[l.s], l.p)),
              guard=lambda g, l: g.LW[l.s][l.t][l.p] < 0)
    fkv.input(pred=("OUT", "KVW",
                    lambda g, l: {"s": l.s, "t": g.LW[l.s][l.t][l.p]}),
              guard=lambda g, l: g.LW[l.s][l.t][l.p] >= 0)
    facc = t.flow("ACC", ptg.RW, dtt=TileType((H, D + 2), _F32))
    facc.input(new=True, guard=lambda g, l: l.p == 0)
    facc.input(pred=("ATTN", "ACC",
                     lambda g, l: {"s": l.s, "t": l.t, "p": l.p - 1}),
               guard=lambda g, l: l.p > 0)
    facc.output(succ=("ATTN", "ACC",
                      lambda g, l: {"s": l.s, "t": l.t, "p": l.p + 1}),
                guard=lambda g, l: l.p < g.NP[l.s][l.t] - 1)
    facc.output(succ=("OUT", "ACC", lambda g, l: {"s": l.s, "t": l.t}),
                guard=lambda g, l: l.p == g.NP[l.s][l.t] - 1)
    _attach(t, "ragged_attn_page", devices)

    o = p.task("OUT", s=ptg.span(0, lambda g, l: g.NS - 1),
               t=lambda g, l: range(g.S[l.s]))
    o.affinity("KV", lambda g, l: (g.SEQS[l.s], g.WP[l.s][l.t]))
    o.priority(lambda g, l: (g.S[l.s] - l.t) * 1024)
    foacc = o.flow("ACC", ptg.READ)
    foacc.input(pred=("ATTN", "ACC",
                      lambda g, l: {"s": l.s, "t": l.t,
                                    "p": g.NP[l.s][l.t] - 1}))
    foq = o.flow("Q", ptg.READ)
    foq.input(data=("Q", lambda g, l: (g.SEQS[l.s],)),
              guard=lambda g, l: l.t == 0)
    foq.input(pred=("SAMPLE", "QN",
                    lambda g, l: {"s": l.s, "t": l.t - 1}),
              guard=lambda g, l: l.t > 0)
    fkvw = o.flow("KVW", ptg.RW)
    fkvw.input(data=("KV", lambda g, l: (g.SEQS[l.s], g.WP[l.s][l.t])),
               guard=lambda g, l: l.t == 0
               or g.WP[l.s][l.t] != g.WP[l.s][l.t - 1])
    fkvw.input(pred=("OUT", "KVW",
                     lambda g, l: {"s": l.s, "t": l.t - 1}),
               guard=lambda g, l: l.t > 0
               and g.WP[l.s][l.t] == g.WP[l.s][l.t - 1])
    fkvw.output(data=("KV", lambda g, l: (g.SEQS[l.s], g.WP[l.s][l.t])))
    fkvw.output(succ=("OUT", "KVW",
                      lambda g, l: {"s": l.s, "t": l.t + 1}),
                guard=lambda g, l: l.t + 1 < g.S[l.s]
                and g.WP[l.s][l.t + 1] == g.WP[l.s][l.t])
    fkvw.output(succ=("ATTN", "KV",
                      lambda g, l: [{"s": l.s, "t": tt,
                                     "p": g.WP[l.s][l.t]}
                                    for tt in g.RD[l.s][l.t]]),
                guard=lambda g, l: bool(g.RD[l.s][l.t]))
    fo = o.flow("O", ptg.WRITE, dtt=TileType((H, D), _F32))
    fo.input(new=True)
    fo.output(succ=("SAMPLE", "O", lambda g, l: {"s": l.s, "t": l.t}))
    fo.output(data=("O", lambda g, l: (g.SEQS[l.s],)),
              guard=lambda g, l: l.t == g.S[l.s] - 1)
    _attach(o, "ragged_attn_out", devices)

    sm = p.task("SAMPLE", s=ptg.span(0, lambda g, l: g.NS - 1),
                t=lambda g, l: range(g.S[l.s]))
    sm.affinity("KV", lambda g, l: (g.SEQS[l.s], g.WP[l.s][l.t]))
    sm.priority(lambda g, l: (g.S[l.s] - l.t) * 1024)
    fso = sm.flow("O", ptg.READ)
    fso.input(pred=("OUT", "O", lambda g, l: {"s": l.s, "t": l.t}))
    fst = sm.flow("TOK", ptg.RW, dtt=TileType((3,), _F32))
    fst.input(data=("TOK", lambda g, l: (g.SEQS[l.s], -1)),
              guard=lambda g, l: l.t == 0)
    fst.input(pred=("SAMPLE", "TOK",
                    lambda g, l: {"s": l.s, "t": l.t - 1}),
              guard=lambda g, l: l.t > 0)
    fst.output(data=("TOK", lambda g, l: (g.SEQS[l.s], l.t)))
    fst.output(succ=("SAMPLE", "TOK",
                     lambda g, l: {"s": l.s, "t": l.t + 1}),
               guard=lambda g, l: l.t < g.S[l.s] - 1)
    fse = sm.flow("EMB", ptg.READ)
    fse.input(data=("EMB", lambda g, l: (0,)))
    fsq = sm.flow("QN", ptg.WRITE, dtt=TileType((3, H, D), _F32))
    fsq.input(new=True)
    fsq.output(succ=("ATTN", "Q",
                     lambda g, l: [{"s": l.s, "t": l.t + 1, "p": pp}
                                   for pp in range(g.NP[l.s][l.t + 1])]),
               guard=lambda g, l: l.t < g.S[l.s] - 1)
    fsq.output(succ=("OUT", "Q",
                     lambda g, l: {"s": l.s, "t": l.t + 1}),
               guard=lambda g, l: l.t < g.S[l.s] - 1)
    _attach(sm, "llm_sample", devices)
    return p.build()


def spec_superpool_ptg(kv: PagedKVCollection, DRAFT: DictCollection,
                       O: DictCollection, STOK: DictCollection,
                       DTOK: DictCollection, EMB: DictCollection,
                       seqs: Sequence[Any], positions: Sequence[int],
                       devices: str = "cuda",
                       name: str = "llm_spec") -> ptg.PTGTaskpool:
    """ONE PTG pool verifying ``positions[i]`` speculative draft positions
    for each listed sequence: the draft-k-verify form of
    :func:`decode_superpool_ptg`.  Position 0's query is the stream's real
    current token, positions 1.. the drafter's proposals, all known when
    the pool is built, so the Q edges are plain data reads::

        ATTN(s,t,p)   q3(draft_t) over page p (K2), ACC threading; only
                      the tail page serializes through OUT's appends
        OUT(s,t)      finalize -> VERIFY; append draft_t's k/v to the
                      tail page (speculative: rolled back on reject)
        VERIFY(s,t)   the in-graph accept decision: the target's token at
                      live positions, the chain dead after the first
                      draft mismatch (ops/ragged_attention.verify_step)

    Callers must have preallocated every position's write slot
    (:func:`preallocate_decode_steps`) and seeded DRAFT, DTOK and STOK
    (:func:`seed_spec_stream`) and ``EMB(0,)``.  The page schedule and
    its WAR/WAW edges are the k-step superpool's."""
    _check_devices(devices)
    NS = len(seqs)
    S = tuple(int(n) for n in positions)
    if len(S) != NS or any(n < 1 for n in S):
        raise ValueError("positions must give every sequence >= 1 "
                         "speculative position")
    NP, WP, LW, RD = _superpool_schedule(kv, seqs, S, "spec superpool")
    H, D = kv.num_heads, kv.head_dim
    p = ptg.PTGBuilder(name, KV=kv, DRAFT=DRAFT, O=O, STOK=STOK,
                       DTOK=DTOK, EMB=EMB, SEQS=tuple(seqs), NS=NS, S=S,
                       NP=NP, WP=WP, LW=LW, RD=RD)

    t = p.task("ATTN",
               s=ptg.span(0, lambda g, l: g.NS - 1),
               t=lambda g, l: range(g.S[l.s]),
               p=lambda g, l: range(g.NP[l.s][l.t]))
    t.affinity("KV", lambda g, l: (g.SEQS[l.s], l.p))
    t.priority(lambda g, l: (g.S[l.s] - l.t) * 1024
               + g.NP[l.s][l.t] - l.p)
    fq = t.flow("Q", ptg.READ)
    fq.input(data=("DRAFT", lambda g, l: (g.SEQS[l.s], l.t)))
    fkv = t.flow("KV", ptg.READ)
    fkv.input(data=("KV", lambda g, l: (g.SEQS[l.s], l.p)),
              guard=lambda g, l: g.LW[l.s][l.t][l.p] < 0)
    fkv.input(pred=("OUT", "KVW",
                    lambda g, l: {"s": l.s, "t": g.LW[l.s][l.t][l.p]}),
              guard=lambda g, l: g.LW[l.s][l.t][l.p] >= 0)
    facc = t.flow("ACC", ptg.RW, dtt=TileType((H, D + 2), _F32))
    facc.input(new=True, guard=lambda g, l: l.p == 0)
    facc.input(pred=("ATTN", "ACC",
                     lambda g, l: {"s": l.s, "t": l.t, "p": l.p - 1}),
               guard=lambda g, l: l.p > 0)
    facc.output(succ=("ATTN", "ACC",
                      lambda g, l: {"s": l.s, "t": l.t, "p": l.p + 1}),
                guard=lambda g, l: l.p < g.NP[l.s][l.t] - 1)
    facc.output(succ=("OUT", "ACC", lambda g, l: {"s": l.s, "t": l.t}),
                guard=lambda g, l: l.p == g.NP[l.s][l.t] - 1)
    _attach(t, "ragged_attn_page", devices)

    o = p.task("OUT", s=ptg.span(0, lambda g, l: g.NS - 1),
               t=lambda g, l: range(g.S[l.s]))
    o.affinity("KV", lambda g, l: (g.SEQS[l.s], g.WP[l.s][l.t]))
    o.priority(lambda g, l: (g.S[l.s] - l.t) * 1024)
    foacc = o.flow("ACC", ptg.READ)
    foacc.input(pred=("ATTN", "ACC",
                      lambda g, l: {"s": l.s, "t": l.t,
                                    "p": g.NP[l.s][l.t] - 1}))
    foq = o.flow("Q", ptg.READ)
    foq.input(data=("DRAFT", lambda g, l: (g.SEQS[l.s], l.t)))
    fkvw = o.flow("KVW", ptg.RW)
    fkvw.input(data=("KV", lambda g, l: (g.SEQS[l.s], g.WP[l.s][l.t])),
               guard=lambda g, l: l.t == 0
               or g.WP[l.s][l.t] != g.WP[l.s][l.t - 1])
    fkvw.input(pred=("OUT", "KVW",
                     lambda g, l: {"s": l.s, "t": l.t - 1}),
               guard=lambda g, l: l.t > 0
               and g.WP[l.s][l.t] == g.WP[l.s][l.t - 1])
    fkvw.output(data=("KV", lambda g, l: (g.SEQS[l.s], g.WP[l.s][l.t])))
    fkvw.output(succ=("OUT", "KVW",
                      lambda g, l: {"s": l.s, "t": l.t + 1}),
                guard=lambda g, l: l.t + 1 < g.S[l.s]
                and g.WP[l.s][l.t + 1] == g.WP[l.s][l.t])
    fkvw.output(succ=("ATTN", "KV",
                      lambda g, l: [{"s": l.s, "t": tt,
                                     "p": g.WP[l.s][l.t]}
                                    for tt in g.RD[l.s][l.t]]),
                guard=lambda g, l: bool(g.RD[l.s][l.t]))
    fo = o.flow("O", ptg.WRITE, dtt=TileType((H, D), _F32))
    fo.input(new=True)
    fo.output(succ=("VERIFY", "O", lambda g, l: {"s": l.s, "t": l.t}))
    fo.output(data=("O", lambda g, l: (g.SEQS[l.s],)),
              guard=lambda g, l: l.t == g.S[l.s] - 1)
    _attach(o, "ragged_attn_out", devices)

    vf = p.task("VERIFY", s=ptg.span(0, lambda g, l: g.NS - 1),
                t=lambda g, l: range(g.S[l.s]))
    vf.affinity("KV", lambda g, l: (g.SEQS[l.s], g.WP[l.s][l.t]))
    vf.priority(lambda g, l: (g.S[l.s] - l.t) * 1024)
    fvo = vf.flow("O", ptg.READ)
    fvo.input(pred=("OUT", "O", lambda g, l: {"s": l.s, "t": l.t}))
    fvs = vf.flow("STOK", ptg.RW, dtt=TileType((4,), _F32))
    fvs.input(data=("STOK", lambda g, l: (g.SEQS[l.s], -1)),
              guard=lambda g, l: l.t == 0)
    fvs.input(pred=("VERIFY", "STOK",
                    lambda g, l: {"s": l.s, "t": l.t - 1}),
              guard=lambda g, l: l.t > 0)
    fvs.output(data=("STOK", lambda g, l: (g.SEQS[l.s], l.t)))
    fvs.output(succ=("VERIFY", "STOK",
                     lambda g, l: {"s": l.s, "t": l.t + 1}),
               guard=lambda g, l: l.t < g.S[l.s] - 1)
    fvd = vf.flow("DTOK", ptg.READ)
    fvd.input(data=("DTOK", lambda g, l: (g.SEQS[l.s], l.t)))
    fve = vf.flow("EMB", ptg.READ)
    fve.input(data=("EMB", lambda g, l: (0,)))
    _attach(vf, "llm_verify", devices)
    return p.build()


def _spec_attend_pages(L0: int, n: int, P: int) -> int:
    """Pages the batched spec pool's LAST position attends: position t
    sees tokens ``[0, L0+t)``, so the deepest read ends at token
    ``L0+n-2``.  At least 1: an empty cache still runs one fully masked
    page task."""
    return max(1, (L0 + n - 2) // P + 1)


def spec_batched_ptg(kv: PagedKVCollection, QS: DictCollection,
                     LIM: DictCollection, DTOKS: DictCollection,
                     VOUT: DictCollection, EMB: DictCollection,
                     seqs: Sequence[Any], positions: Sequence[int],
                     pad: int | None = None, devices: str = "cuda",
                     name: str = "llm_spec_batched") -> ptg.PTGTaskpool:
    """The batched speculative superpool, the batcher's draft-k-verify
    pool.  The host has staged the whole draft chain's k/v into the tail
    slots (:func:`seed_spec_batched`), so the pool is::

        SATTN(s, p)   ALL positions' queries against page p in one body
                      (ops/ragged_attention.spec_attn_page), causal
                      per-position limits from the LIM tile; ACC is the
                      (S, H, D+2) flash-state stack along the page chain
        SVERIFY(s)    finalize every position, sample, emit the accepted
                      prefix into VOUT(seq)

    ``NP + 1`` tasks a stream.  The pool only reads KV pages; the writes
    are the seed and the rollback, which the batcher orders around it.
    ``pad`` pads every stream's position axis to one count (default: the
    pool's max), so the tiles of every stream share one shape and the
    device batches them; padded rows carry zero limits and a zero query."""
    _check_devices(devices)
    P = kv.page_size
    NS = len(seqs)
    S = tuple(int(n) for n in positions)
    if len(S) != NS or any(n < 1 for n in S):
        raise ValueError("positions must give every sequence >= 1 "
                         "speculative position")
    SP = max(S) if pad is None else int(pad)
    if SP < max(S):
        raise ValueError(f"pad {SP} below the pool's max positions "
                         f"{max(S)}")
    NP = []
    for s, n in zip(seqs, S):
        L0 = kv.seq_len(s)
        need = (L0 + n - 1) // P + 1
        if kv.npages(s) < need:
            raise ValueError(
                f"spec batched pool needs preallocate_decode_steps() "
                f"first: seq {s!r} has {kv.npages(s)} pages, its "
                f"{n}-position schedule needs {need}")
        NP.append(_spec_attend_pages(L0, n, P))
    NP = tuple(NP)
    H, D = kv.num_heads, kv.head_dim
    p = ptg.PTGBuilder(name, KV=kv, QS=QS, LIM=LIM, DTOKS=DTOKS,
                       VOUT=VOUT, EMB=EMB, SEQS=tuple(seqs), NS=NS,
                       S=S, SP=SP, NP=NP)

    t = p.task("SATTN",
               s=ptg.span(0, lambda g, l: g.NS - 1),
               p=lambda g, l: range(g.NP[l.s]))
    t.affinity("KV", lambda g, l: (g.SEQS[l.s], l.p))
    t.priority(lambda g, l: g.NP[l.s] - l.p)
    fq = t.flow("QS", ptg.READ)
    fq.input(data=("QS", lambda g, l: (g.SEQS[l.s],)))
    fkv = t.flow("KV", ptg.READ)
    fkv.input(data=("KV", lambda g, l: (g.SEQS[l.s], l.p)))
    fl = t.flow("LIM", ptg.READ)
    fl.input(data=("LIM", lambda g, l: (g.SEQS[l.s], l.p)))
    facc = t.flow("ACC", ptg.RW, dtt=TileType((SP, H, D + 2), _F32))
    facc.input(new=True, guard=lambda g, l: l.p == 0)
    facc.input(pred=("SATTN", "ACC",
                     lambda g, l: {"s": l.s, "p": l.p - 1}),
               guard=lambda g, l: l.p > 0)
    facc.output(succ=("SATTN", "ACC",
                      lambda g, l: {"s": l.s, "p": l.p + 1}),
                guard=lambda g, l: l.p < g.NP[l.s] - 1)
    facc.output(succ=("SVERIFY", "ACC", lambda g, l: {"s": l.s}),
                guard=lambda g, l: l.p == g.NP[l.s] - 1)
    _attach(t, "llm_spec_attn", devices)

    vf = p.task("SVERIFY", s=ptg.span(0, lambda g, l: g.NS - 1))
    vf.affinity("KV", lambda g, l: (g.SEQS[l.s], g.NP[l.s] - 1))
    fva = vf.flow("ACC", ptg.READ)
    fva.input(pred=("SATTN", "ACC",
                    lambda g, l: {"s": l.s, "p": g.NP[l.s] - 1}))
    fvd = vf.flow("DTOKS", ptg.READ)
    fvd.input(data=("DTOKS", lambda g, l: (g.SEQS[l.s],)))
    fve = vf.flow("EMB", ptg.READ)
    fve.input(data=("EMB", lambda g, l: (0,)))
    fvo = vf.flow("VOUT", ptg.WRITE, dtt=TileType((SP + 2,), _F32))
    fvo.input(new=True)
    fvo.output(data=("VOUT", lambda g, l: (g.SEQS[l.s],)))
    _attach(vf, "llm_spec_verify", devices)
    return p.build()


# ---------------------------------------------------------------------------
# host-side prep and readers: the seeding contract the batcher runs
# ---------------------------------------------------------------------------

def prefill_chunks(model: Any, kv: PagedKVCollection, seq: Any,
                   tokens: Sequence[int]) -> dict[tuple, torch.Tensor]:
    """Allocate ``seq``'s pages for ``tokens`` and return the
    ``(seq, chunk) -> tile`` map the T collection serves.  Advances the
    length ledger; the PF tasks only move the bytes."""
    P = kv.page_size
    chunks: dict[tuple, torch.Tensor] = {}
    n = len(tokens)
    c0 = kv.npages(seq)
    table = model.q3_table()
    for j in range((n + P - 1) // P):
        kv.alloc_page(seq)
        part = torch.tensor([int(t) % model.vocab
                             for t in tokens[j * P:(j + 1) * P]],
                            dtype=torch.int64)
        tile = torch.zeros(kv.default_dtt.shape, dtype=kv.dtype)
        rows = table.index_select(0, part)                 # (m, 3, H, D)
        tile[0, :len(part)] = rows[:, 1].to(kv.dtype)
        tile[1, :len(part)] = rows[:, 2].to(kv.dtype)
        tile[META_CH, 0, 0, 0] = len(part)
        chunks[(seq, c0 + j)] = tile
    kv.note_appended(seq, n)
    return chunks


def seed_emb_table(model: Any, EMB: DictCollection) -> None:
    """Load ``EMB(0,)`` with the model's ``(V, 3, H, D)`` q3 stack table,
    the tile the in-graph SAMPLE class reads."""
    ec = EMB.data_of(0).get_copy(0)
    ec.value = model.q3_table().clone()
    ec.version += 1


def seed_stream_step(model: Any, Q: DictCollection, TOK: DictCollection,
                     seq: Any, token: int, *,
                     eos: int | None = None) -> None:
    """Seed one stream's per-iteration inputs: ``Q(seq)`` with the current
    token's q3 stack and ``TOK(seq, -1)`` with the ``[token, done=0,
    eos]`` chain seed (``eos < 0`` disables EOS)."""
    qc = Q.data_of(seq).get_copy(0)
    qc.value = model.q3(token)
    qc.version += 1
    t0 = TOK.data_of(seq, -1).get_copy(0)
    t0.value = torch.tensor([float(token), 0.0,
                             -1.0 if eos is None else float(eos)],
                            dtype=_F32)
    t0.version += 1


def _set(coll: DictCollection, key: tuple, value: torch.Tensor) -> None:
    """Seed one tile of a side collection: a new host value at a new
    version, so a copy staged from the old one misses at the next
    stage-in (a reseeded tile may change shape from pool to pool)."""
    c = coll.data_of(*key).get_copy(0)
    c.value = value
    c.version += 1


def _stage_page(kv: PagedKVCollection, seq: Any, page: int,
                rows: list[tuple[int, torch.Tensor]], fill: int) -> None:
    """Write draft k/v rows ``[(slot, q3), ...]`` into one page through
    ``update_page_host`` (newest bytes, device copies detached, version
    jumped past them) and set its fill."""
    def stage(val: torch.Tensor) -> torch.Tensor:
        for slot, q3 in rows:
            val[0, slot] = q3[1]
            val[1, slot] = q3[2]
        val[META_CH, 0, 0, 0] = fill
        return val

    kv.update_page_host(seq, page, stage)


def seed_spec_batched(model: Any, kv: PagedKVCollection,
                      QS: DictCollection, LIM: DictCollection,
                      DTOKS: DictCollection, seq: Any, token: int,
                      draft: Sequence[int], pad: int, *,
                      eos: int | None = None) -> int:
    """Seed one stream's batched-spec-pool inputs and stage the draft
    chain's k/v into its tail slots (the appends the pool's causal limits
    reveal position by position, and ``rollback_tail`` scrubs on
    reject).  Callers must have run :func:`preallocate_decode_steps`, so
    the staged slots are private.  Returns the position count
    ``1 + len(draft)``.

    Tiles: ``QS(seq)`` ``(pad, 3, H, D)`` the positions' q3 stacks;
    ``LIM(seq, p)`` ``(pad,)`` each position's valid slots on page p;
    ``DTOKS(seq)`` ``(pad+2,)`` ``[n, eos, chain..., 0 pad]``."""
    chain = [int(token)] + [int(d) for d in draft]
    n = len(chain)
    if n > pad:
        raise ValueError(f"{n} positions exceed pad {pad}")
    P = kv.page_size
    L0 = kv.seq_len(seq)
    q3s = [model.q3(t) for t in chain]
    by_page: dict[int, list[tuple[int, torch.Tensor]]] = {}
    for t in range(n):
        pg, slot = divmod(L0 + t, P)
        by_page.setdefault(pg, []).append((slot, q3s[t]))
    for pg, rows in by_page.items():
        _stage_page(kv, seq, pg, rows, min(P, L0 + n - pg * P))
    H, D = kv.num_heads, kv.head_dim
    qs = torch.zeros((pad, 3, H, D), dtype=_F32)
    qs[:n] = torch.stack(q3s)
    _set(QS, (seq,), qs)
    pos = torch.arange(pad, dtype=_F32)
    for p in range(_spec_attend_pages(L0, n, P)):
        lim = torch.clamp(L0 + pos - p * P, 0, P)
        lim[n:] = 0.0
        _set(LIM, (seq, p), lim)
    dt = torch.zeros(pad + 2, dtype=_F32)
    dt[0] = n
    dt[1] = -1.0 if eos is None else float(eos)
    dt[2:2 + n] = torch.tensor(chain, dtype=_F32)
    _set(DTOKS, (seq,), dt)
    return n


def seed_spec_stream(model: Any, DRAFT: DictCollection,
                     DTOK: DictCollection, STOK: DictCollection,
                     seq: Any, token: int, draft: Sequence[int], *,
                     eos: int | None = None) -> int:
    """Seed one stream's per-position spec-pool inputs: ``DRAFT(seq, t)``
    the positions' q3 stacks (position 0 the real current ``token``),
    ``DTOK(seq, t)`` their token ids, ``STOK(seq, -1)`` the ``[token,
    live=1, done=0, eos]`` accept-chain seed.  Returns the position
    count ``1 + len(draft)``."""
    chain = [int(token)] + [int(d) for d in draft]
    for t, tok in enumerate(chain):
        _set(DRAFT, (seq, t), model.q3(tok))
        _set(DTOK, (seq, t), torch.tensor([float(tok)], dtype=_F32))
    _set(STOK, (seq, -1), torch.tensor(
        [float(token), 1.0, 0.0, -1.0 if eos is None else float(eos)],
        dtype=_F32))
    return len(chain)


def _prefill_in_place(model: Any, kv: PagedKVCollection, seq: Any,
                      prompt: Sequence[int]) -> None:
    """Allocate ``seq`` and write its prompt's pages on the host (no
    runtime): the pool-level seeders' prefill."""
    kv.alloc_seq(seq)
    for key, tile in prefill_chunks(model, kv, seq, prompt[:-1]).items():
        _set(kv, key, tile)


def seed_spec_batched_pool(model: Any, kv: PagedKVCollection,
                           QS: DictCollection, LIM: DictCollection,
                           DTOKS: DictCollection, EMB: DictCollection,
                           prompts: dict[Any, Sequence[int]],
                           drafts: dict[Any, Sequence[int]], *,
                           pad: int | None = None,
                           eos: int | None = None
                           ) -> tuple[dict[Any, int], int]:
    """Make :func:`spec_batched_ptg`'s input contract real with drafts the
    caller chooses: prefill each prompt in place, preallocate every
    position's slot, stage the chains.  Returns ``(positions, pad)``."""
    seed_emb_table(model, EMB)
    if pad is None:
        pad = max(len(d) for d in drafts.values()) + 1
    npos: dict[Any, int] = {}
    for seq, prompt in prompts.items():
        _prefill_in_place(model, kv, seq, prompt)
        npos[seq] = 1 + len(drafts[seq])
        preallocate_decode_steps(kv, seq, npos[seq])
        seed_spec_batched(model, kv, QS, LIM, DTOKS, seq, prompt[-1],
                          drafts[seq], pad, eos=eos)
    return npos, pad


def seed_spec_superpool(model: Any, kv: PagedKVCollection,
                        DRAFT: DictCollection, DTOK: DictCollection,
                        STOK: DictCollection, EMB: DictCollection,
                        prompts: dict[Any, Sequence[int]],
                        drafts: dict[Any, Sequence[int]], *,
                        eos: int | None = None) -> dict[Any, int]:
    """Make :func:`spec_superpool_ptg`'s input contract real with drafts
    the caller chooses (the acceptance is then exactly the drafts'
    correctness).  Returns the position count of each sequence."""
    seed_emb_table(model, EMB)
    npos: dict[Any, int] = {}
    for seq, prompt in prompts.items():
        _prefill_in_place(model, kv, seq, prompt)
        npos[seq] = 1 + len(drafts[seq])
        preallocate_decode_steps(kv, seq, npos[seq])
        seed_spec_stream(model, DRAFT, DTOK, STOK, seq, prompt[-1],
                         drafts[seq], eos=eos)
    return npos


def seed_decode_superpool(model: Any, kv: PagedKVCollection,
                          Q: DictCollection, TOK: DictCollection,
                          EMB: DictCollection,
                          prompts: dict[Any, Sequence[int]],
                          steps: dict[Any, int], *,
                          eos: int | None = None) -> None:
    """The input contract of :func:`decode_superpool_ptg` in one call:
    prefill each prompt's pages in place (no runtime), preallocate every
    step's write slot, and seed EMB, Q and TOK through
    :func:`seed_emb_table` and :func:`seed_stream_step`, as the batcher
    does."""
    seed_emb_table(model, EMB)
    for seq, prompt in prompts.items():
        kv.alloc_seq(seq)
        for key, tile in prefill_chunks(model, kv, seq,
                                        prompt[:-1]).items():
            _set(kv, key, tile)
        preallocate_decode_steps(kv, seq, steps[seq])
        seed_stream_step(model, Q, TOK, seq, prompt[-1], eos=eos)


def generate_by_steps(model: Any, kv: PagedKVCollection, Q: DictCollection,
                      O: DictCollection, prompts: dict[Any, Sequence[int]],
                      steps: int, run: Any,
                      devices: str = "cuda") -> dict[Any, list[int]]:
    """Greedy generation one :func:`decode_step_ptg` pool a step: prefill
    each prompt's pages in place, then per step make every stream's write
    slot real, seed ``Q(seq)`` with its current token's query stack, run
    the pool through ``run(taskpool)`` (the caller's context), advance the
    length ledger, and sample each stream's next token from ``O(seq)`` on
    the host (``model.sample``, one D2H a stream).  Returns ``{seq:
    tokens}``; the k-step superpool gives the same tokens in one pool."""
    cur = {}
    for seq, prompt in prompts.items():
        kv.alloc_seq(seq)
        for key, tile in prefill_chunks(model, kv, seq,
                                        prompt[:-1]).items():
            _set(kv, key, tile)
        cur[seq] = int(prompt[-1])
    out: dict[Any, list[int]] = {seq: [] for seq in prompts}
    seqs = list(prompts)
    for _ in range(steps):
        for seq in seqs:
            kv.ensure_tail_slot(seq)
            _set(Q, (seq,), model.q3(cur[seq]))
        run(decode_step_ptg(kv, Q, O, seqs, devices=devices))
        for seq in seqs:
            kv.note_appended(seq, 1)
            cur[seq] = model.sample(O.data_of(seq).newest_copy().value.cpu())
            out[seq].append(cur[seq])
    return out


def read_token_chain(TOK: DictCollection, seq: Any,
                     k: int) -> tuple[list[int], bool]:
    """One stream's k-step TOK chain, read as the batcher reads it: the
    tokens after the step whose done flag fired are the predicated tail
    and are not surfaced.  Returns ``(tokens, done)``."""
    rows = _to_host([TOK.data_of(seq, t).newest_copy().value
                     for t in range(k)])
    toks: list[int] = []
    done = False
    for v in rows:
        if not done:
            toks.append(int(round(float(v[0]))))
            done = bool(v[1] > 0.5)
    return toks, done


def read_token_chains(TOK: DictCollection,
                      chains: dict[Any, int]) -> dict[Any, tuple[list[int],
                                                                 bool]]:
    """Read several sequences' k-step TOK chains, ``{seq: k}``, the way the
    batcher does: tokens past the step whose done flag fired are the
    predicated tail and are never surfaced.  Tiles on the card come back
    in ONE transfer for the whole call.  Returns ``{seq: (tokens, done)}``
    — ``done`` is the last surfaced step's flag."""
    keys = [(seq, t) for seq, k in chains.items() for t in range(k)]
    tiles = [TOK.data_of(*key).newest_copy().value for key in keys]
    vals = dict(zip(keys, _to_host(tiles).tolist()))
    out: dict[Any, tuple[list[int], bool]] = {}
    for seq, k in chains.items():
        toks: list[int] = []
        done = False
        for t in range(k):
            if not done:
                tok, flag, _ = vals[(seq, t)]
                toks.append(int(round(tok)))
                done = flag > 0.5
        out[seq] = (toks, done)
    return out


def read_spec_chains(STOK: DictCollection, chains: dict[Any, int]
                     ) -> dict[Any, tuple[list[int], bool]]:
    """Read several sequences' n-position VERIFY chains, ``{seq: n}``, in
    one transfer: only live positions' tokens surface, and a live EOS
    finishes the stream.  Returns ``{seq: (tokens, done)}``."""
    keys = [(seq, t) for seq, n in chains.items() for t in range(n)]
    tiles = [STOK.data_of(*key).newest_copy().value for key in keys]
    vals = dict(zip(keys, _to_host(tiles).tolist()))
    out: dict[Any, tuple[list[int], bool]] = {}
    for seq, n in chains.items():
        toks: list[int] = []
        done = False
        for t in range(n):
            tok, live, fin, _ = vals[(seq, t)]
            if live > 0.5:
                toks.append(int(round(tok)))
                done = done or fin > 0.5
        out[seq] = (toks, done)
    return out


def read_spec_batched(VOUT: DictCollection, seqs: Sequence[Any]
                      ) -> dict[Any, tuple[list[int], bool]]:
    """Read several streams' batched-spec results in one transfer: the
    accepted prefix's tokens and whether a live position sampled EOS.
    Returns ``{seq: (tokens, done)}``."""
    tiles = [VOUT.data_of(seq).newest_copy().value for seq in seqs]
    out: dict[Any, tuple[list[int], bool]] = {}
    for seq, v in zip(seqs, _to_host(tiles).tolist()):
        m = int(round(v[0]))
        out[seq] = ([int(round(x)) for x in v[2:2 + m]], v[1] > 0.5)
    return out


def _to_host(tiles: list[torch.Tensor]) -> torch.Tensor:
    """Stack same-shaped tiles, wherever each lies, on the host: the
    tiles on a card are stacked there and cross in one copy."""
    if not tiles:
        return torch.zeros((0, 3), dtype=_F32)
    out = torch.empty((len(tiles), *tiles[0].shape), dtype=_F32)
    by_dev: dict[torch.device, list[int]] = {}
    for i, t in enumerate(tiles):
        by_dev.setdefault(t.device, []).append(i)
    for dev, idx in by_dev.items():
        block = torch.stack([tiles[i] for i in idx]).float()
        out[torch.tensor(idx)] = block.cpu() if dev.type != "cpu" else block
    return out

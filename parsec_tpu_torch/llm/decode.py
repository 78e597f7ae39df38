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

Every builder takes ``devices="cuda"`` (the default: the class carries
only the device chore, resolved by ``dyld`` name, so a missing card fails
instead of running on the host) or ``"cpu"`` (only the host body).

Left out: the speculative pools (``spec_superpool_ptg``,
``spec_batched_ptg`` and their seeding and readers), the tail-only
prefill ``starts`` of the prefix cache, and three helpers nothing of the
port calls: ``decode_step_ptg`` (a one-step superpool builds the same
ATTN -> OUT chain, with SAMPLE after it), ``seed_decode_superpool`` (the
batcher seeds stream by stream) and ``read_token_chain`` (one entry of
:func:`read_token_chains`).
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
from ..ops import ragged_attention  # noqa: F401  (registers the bodies)

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
                name: str = "llm_prefill") -> ptg.PTGTaskpool:
    """PF(s, c) over every allocated page of every listed sequence.
    ``T`` holds the prompt chunk tiles, keyed ``(seq, chunk)``, in the
    page layout."""
    _check_devices(devices)
    NP = tuple(kv.npages(s) for s in seqs)
    p = ptg.PTGBuilder(name, KV=kv, T=T, SEQS=tuple(seqs), NP=NP,
                       NS=len(seqs))
    t = p.task("PF",
               s=ptg.span(0, lambda g, l: g.NS - 1),
               c=lambda g, l: range(g.NP[l.s]))
    t.affinity("KV", lambda g, l: (g.SEQS[l.s], l.c))
    ft = t.flow("T", ptg.READ)
    ft.input(data=("T", lambda g, l: (g.SEQS[l.s], l.c)))
    fkv = t.flow("KV", ptg.RW)
    fkv.input(data=("KV", lambda g, l: (g.SEQS[l.s], l.c)))
    fkv.output(data=("KV", lambda g, l: (g.SEQS[l.s], l.c)))
    _attach(t, "llm_prefill_copy", devices)
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
                        steps: Sequence[int]):
    """The per-(seq, step) page schedule: ``NP[t]`` pages attended,
    ``WP[t]`` the append page, ``LW[t][p]`` the last step < t writing
    page p (-1: read straight from the collection), ``RD[t]`` the later
    steps whose ATTN re-reads the page step t wrote."""
    P = kv.page_size
    NP, WP, LW, RD = [], [], [], []
    for si, s in enumerate(seqs):
        L0 = kv.seq_len(s)
        wp_s = tuple((L0 + t) // P for t in range(steps[si]))
        np_s = tuple(w + 1 for w in wp_s)
        if kv.npages(s) < np_s[-1]:
            raise ValueError(
                f"superpool needs preallocate_decode_steps() first: seq "
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

"""The toy language model the serving path generates with.

Port of :class:`ToyLM` from ``parsec_tpu/llm/model.py``: a fixed random
embedding table, single-layer multi-head attention over the KV cache,
greedy argmax sampling.  The table comes from the same
``np.random.default_rng(seed)`` draw as the JAX model's, so both models
hold the same bits; :meth:`ToyLM.from_numpy` carries another model's
table across.  :meth:`ToyLM.reference_generate` (dense float64
attention, no paging, no runtime) is the oracle the paged decode pools
must match token for token.

Decode semantics (shared by the pools and the oracle): the cache holds
K/V of every token strictly before the query token; a step attends the
query over the cache, samples the next token and appends the query
token's own K/V — so prefill caches ``prompt[:-1]`` and the first decode
query is ``prompt[-1]``.

:class:`NgramDrafter` is the speculative decode's drafter, a copy of the
JAX package's: the same history drafts the same chain.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..ops.ragged_attention import ragged_attention_reference


class ToyLM:
    """One attention layer over a fixed embedding table.

    For token ``t`` with embedding ``e``: ``q = e``, ``k = roll(e, 1)``,
    ``v = e[..., ::-1]``; logits are ``o . E^T`` over the flattened heads.
    """

    def __init__(self, vocab: int = 64, num_heads: int = 4,
                 head_dim: int = 8, seed: int = 1234) -> None:
        rng = np.random.default_rng(seed)
        self._set_emb(torch.from_numpy(rng.standard_normal(
            (int(vocab), int(num_heads), int(head_dim))).astype(np.float32)))

    @classmethod
    def from_numpy(cls, emb: Any) -> "ToyLM":
        """A model over a given ``(vocab, H, D)`` embedding table, e.g. the
        JAX model's ``emb``."""
        m = cls.__new__(cls)
        m._set_emb(torch.tensor(np.asarray(emb, np.float32)))
        return m

    def _set_emb(self, emb: torch.Tensor) -> None:
        self.emb = emb.contiguous()
        self.vocab, self.num_heads, self.head_dim = (int(s)
                                                     for s in emb.shape)
        e = self.emb
        self._q3_table = torch.stack(
            [e, torch.roll(e, 1, dims=-1), torch.flip(e, dims=[-1])],
            dim=1).contiguous()

    def q3(self, token: int) -> torch.Tensor:
        """The ``(3, H, D)`` q/k/v stack of one token (a fresh tensor)."""
        return self._q3_table[int(token) % self.vocab].clone()

    def q3_table(self) -> torch.Tensor:
        """The ``(vocab, 3, H, D)`` q/k/v stack table the in-graph SAMPLE
        class reads: logits from channel 0, the next query by one
        gather."""
        return self._q3_table

    def sample(self, o: Any) -> int:
        """Greedy: argmax of ``o . E^T`` in fp32."""
        return int(torch.argmax(self.logits(o)))

    def logits(self, o: Any) -> torch.Tensor:
        """The fp32 logits ``o . E^T``."""
        return self.emb.reshape(self.vocab, -1) @ torch.as_tensor(
            o, dtype=torch.float32).reshape(-1)

    def reference_generate(self, prompt: Sequence[int], max_new_tokens: int,
                           eos: int | None = None,
                           margins: list[float] | None = None) -> list[int]:
        """Dense, unpaged decode loop with float64 attention: the oracle.
        ``eos`` stops the stream early (the EOS token is the last one
        kept).  ``margins``, when given, receives each step's gap between
        the top two logits."""
        if not prompt:
            raise ValueError("prompt must be non-empty")
        ks = [self.q3(t)[1] for t in prompt[:-1]]
        vs = [self.q3(t)[2] for t in prompt[:-1]]
        cur = int(prompt[-1])
        out: list[int] = []
        for _ in range(max_new_tokens):
            q3 = self.q3(cur)
            o = ragged_attention_reference(
                q3[0], torch.stack(ks) if ks else [],
                torch.stack(vs) if vs else [])
            ks.append(q3[1])
            vs.append(q3[2])
            lg = self.logits(o)
            if margins is not None:
                top = torch.topk(lg, 2).values
                margins.append(float(top[0] - top[1]))
            cur = self.sample(o)
            out.append(cur)
            if eos is not None and cur == int(eos):
                break
        return out


class NgramDrafter:
    """Last-wins bigram proposal table: the drafter behind speculative
    decode.  The batcher feeds it every token a stream keeps (prompt, then
    each surfaced token) through :meth:`observe`; :meth:`draft` walks the
    table greedily from the current token.  Deterministic: the same
    history always drafts the same chain."""

    __slots__ = ("_next", "_prev")

    def __init__(self) -> None:
        self._next: dict[int, int] = {}
        self._prev: int | None = None

    def observe(self, token: int) -> None:
        """Fold one kept token into the table (in stream order)."""
        token = int(token)
        if self._prev is not None:
            self._next[self._prev] = token
        self._prev = token

    def draft(self, cur: int, k: int) -> list[int]:
        """Up to ``k`` proposed continuations of ``cur``: shorter (or
        empty) where the chain runs off the table's known transitions."""
        out: list[int] = []
        t = int(cur)
        for _ in range(max(0, k)):
            nt = self._next.get(t)
            if nt is None:
                break
            out.append(nt)
            t = nt
        return out

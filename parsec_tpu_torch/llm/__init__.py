"""LLM decode serving (port of ``parsec_tpu/llm``): the toy model, the
prefill/decode task pools and the continuous batcher."""

from .batcher import ContinuousBatcher, StreamTicket
from .decode import (decode_superpool_ptg, preallocate_decode_steps,
                     prefill_chunks, prefill_ptg, read_token_chains,
                     seed_emb_table, seed_stream_step)
from .model import ToyLM

__all__ = [
    "ContinuousBatcher", "StreamTicket", "ToyLM", "decode_superpool_ptg",
    "preallocate_decode_steps", "prefill_chunks", "prefill_ptg",
    "read_token_chains", "seed_emb_table", "seed_stream_step",
]

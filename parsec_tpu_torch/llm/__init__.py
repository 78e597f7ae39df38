"""LLM decode serving (port of ``parsec_tpu/llm``): the toy model and its
drafter, the prefill/decode and speculative task pools, the prefix tree
and the continuous batcher."""

from .batcher import ContinuousBatcher, StreamTicket, aggregate_report
from .decode import (decode_step_ptg, decode_superpool_ptg, generate_by_steps,
                     preallocate_decode_steps, prefill_chunks, prefill_ptg,
                     read_spec_batched, read_spec_chains, read_token_chain,
                     read_token_chains, seed_decode_superpool,
                     seed_emb_table, seed_spec_batched,
                     seed_spec_batched_pool, seed_spec_stream,
                     seed_spec_superpool, seed_stream_step,
                     spec_batched_ptg, spec_superpool_ptg)
from .model import NgramDrafter, ToyLM
from .prefix_tree import PrefixTree

__all__ = [
    "ContinuousBatcher", "NgramDrafter", "PrefixTree", "StreamTicket",
    "ToyLM", "aggregate_report", "decode_step_ptg", "decode_superpool_ptg",
    "generate_by_steps", "preallocate_decode_steps", "prefill_chunks",
    "prefill_ptg", "read_spec_batched", "read_spec_chains",
    "read_token_chain", "read_token_chains", "seed_decode_superpool",
    "seed_emb_table", "seed_spec_batched", "seed_spec_batched_pool",
    "seed_spec_stream", "seed_spec_superpool", "seed_stream_step",
    "spec_batched_ptg", "spec_superpool_ptg",
]

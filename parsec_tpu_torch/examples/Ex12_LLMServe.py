"""Ex12: LLM inference serving: continuous batching on the runtime.

Port of the JAX package's ``examples/Ex12_LLMServe.py``: generation
streams ride a hot :class:`~parsec_tpu_torch.serve.RuntimeServer` through
``submit_stream``.  Each decode iteration is a PTG taskpool, a ragged
per-page attention chain per live sequence over the paged KV cache,
submitted under the stream's tenant.  On the card the attention bodies
run K2 (``csrc/ragged_attn.cu``); ``main(device="cpu")`` registers the
device module around the host and runs the plain versions.

Self-check: every stream's tokens equal the dense oracle
(:meth:`ToyLM.reference_generate`) token for token.
"""

from typing import Any

from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.llm import ToyLM
from parsec_tpu_torch.serve import RuntimeServer

MODEL = ToyLM()
PROMPTS = {
    "pro": [[3, 7, 11, 5], [40, 2, 9, 9, 30]],
    "free": [[1, 22], [8, 30, 22, 8]],
}
NEW_TOKENS = 8


def main(device: Any = None) -> dict:
    """Serve the four streams on ``device`` (the card when None)."""
    init_cuda_devices(device=device)
    with RuntimeServer(nb_cores=2,
                       tenant_weights={"pro": 4.0, "free": 1.0}) as server:
        tickets = [(tenant, prompt,
                    server.submit_stream(prompt,
                                         max_new_tokens=NEW_TOKENS,
                                         tenant=tenant))
                   for tenant, prompts in PROMPTS.items()
                   for prompt in prompts]
        for tenant, prompt, tk in tickets:
            r = tk.result(timeout=120)
            want = MODEL.reference_generate(prompt, NEW_TOKENS)
            assert r["tokens"] == want, (tenant, prompt, r["tokens"], want)
        stats = server.stats()
        llm = stats["llm"]
        assert llm["streams_completed"] == 4, llm
        assert llm["tokens_generated"] == 4 * NEW_TOKENS, llm
        # every retired stream's pages went back to the free list
        assert llm["kv"]["physical_pages"] == 0, llm["kv"]
    return stats


if __name__ == "__main__":
    s = main()
    llm = s["llm"]
    print(f"served {llm['streams_completed']} streams / "
          f"{llm['tokens_generated']} tokens in {llm['steps']} batched "
          f"decode iterations; KV pages recycled: "
          f"{llm['kv']['pages_allocated']} allocated -> "
          f"{llm['kv']['free_pages']} free")

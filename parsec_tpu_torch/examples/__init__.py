"""The examples ladder, ported: ``Ex00_StartStop`` through
``Ex12_LLMServe``.

Port of the JAX package's ``examples/`` (the reference's
``examples/Ex00…Ex07`` tutorial sequence).  Each module runs as
``python -m parsec_tpu_torch.examples.Ex02_Chain``; its ``main()``
self-checks (raising on a wrong result), returns the value the JAX
example's ``main()`` returns, and prints one summary line when run as a
script.  Tiles are torch tensors.  ``jdf/stencil_1D.jdf`` is the port's
copy of the translated reference stencil (its prologue imports the
port's ``WireRegion`` and computes with torch); the JAX package's
``examples/jdf/Ex05``–``Ex07`` files import nothing and the port reads
them where they lie.

Most rungs run host chores only.  ``Ex08_Recursive`` runs its nested
GEMM pools on the card through K1, and ``Ex12_LLMServe`` decodes there
through K2 (``main(device="cpu")`` runs either on the host, as the tests
do).
"""

"""The examples ladder, ported: ``Ex00_StartStop`` through ``Ex07_RAW_CTL``,
then ``Ex10_WireHalo``, ``Ex11_Serve`` and ``Ex12_LLMServe``.

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

Most rungs run host chores only.  ``Ex12_LLMServe`` decodes on the card
through K2 (``main(device="cpu")`` runs it on the host, as the tests
do).

Left out: ``Ex08_Recursive`` (it needs ``runtime/recursive.py``) and
``Ex09_DTD_Tree`` (``models/irregular.py``), which wait for the nested
runtime.
"""

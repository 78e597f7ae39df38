"""parsec_tpu_torch: the PyTorch/CUDA port of the parsec-tpu runtime.

The same task runtime as :mod:`parsec_tpu` (PTG builder, dependency
tracking, the LFQ scheduler, the context and the device module), with
tiles held as ``torch.Tensor`` values and the accelerator being an NVIDIA
Hopper card driven through :mod:`parsec_tpu_torch.device.cuda`, and the
serving layer above it (:mod:`parsec_tpu_torch.serve`,
:mod:`parsec_tpu_torch.llm`: LLM decode streams by continuous batching),
and the compiled incarnation of taskpools
(:func:`parsec_tpu_torch.ptg.lower_taskpool`: one plan over tile stores
on the card).
Task bodies on the card run hand-written CUDA kernels built from
``csrc/`` at first use (:mod:`parsec_tpu_torch.ops._build`).

The package is self-contained: it imports neither ``jax`` nor anything of
``parsec_tpu``, and keeps its own trimmed copies of the framework-neutral
layers it needs.  Entry points run on the card unless the caller asks for
the CPU (``init_cuda_devices(device="cpu")``,
``lower_taskpool(tp, device="cpu")``).
"""

__version__ = "0.1.0"

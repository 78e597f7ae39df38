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
``lower_taskpool(tp, device="cpu")``,
``run_multiproc(..., transport="device", device="cpu")``).

Ranks run as threads of one process (:func:`run_multirank`) or as
processes over TCP (:func:`run_multiproc`, with the socket engines
:class:`SocketFabric`, :class:`SocketCommEngine` and
:class:`DeviceSocketCommEngine`); the package exports these five from
:mod:`parsec_tpu_torch.comm`.
"""

__version__ = "0.1.0"

# resolved at first use, so importing the package stays cheap
_API = ("DeviceSocketCommEngine", "SocketCommEngine", "SocketFabric",
        "run_multiproc", "run_multirank")

__all__ = ["__version__", *_API]


def __getattr__(name: str):
    if name in _API:
        from . import comm
        return getattr(comm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

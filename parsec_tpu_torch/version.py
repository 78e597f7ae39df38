"""Version of the PyTorch/CUDA port (``parsec_tpu/version.py``'s
numbering: the port tracks the same reference API generation)."""

__version__ = "0.1.0"
API_VERSION = (4, 0)  # the reference's runtime.h generation

"""Kernels and task bodies (importing :mod:`.gemm` registers ``"gemm"``)."""

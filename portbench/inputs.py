"""The benchmark's inputs, made on the device from ``--seed``.

Each is made in a few large calls of a ``torch.Generator`` on the run's
device, in the type it is served in; the same seed gives the same inputs
on the same device.  The program and the reference are both handed what
these return.
"""

from __future__ import annotations

import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number;
    taken modulo 2**64, the generator's range)."""
    return torch.Generator(device=device).manual_seed(seed % 2**64)


def gemm_operands(n: int, seed: int, device: torch.device,
                  dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A and B, each ``n x n`` with N(0, 1) entries, made in ``dtype``."""
    g = generator(seed, device)
    a = torch.randn(n, n, generator=g, device=device, dtype=dtype)
    b = torch.randn(n, n, generator=g, device=device, dtype=dtype)
    return a, b


def spd_matrix(n: int, seed: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """A symmetric positive definite ``n x n`` matrix, ``X·Xᵀ/n + I`` with
    ``X`` an ``n x n`` N(0, 1) matrix, its product taken in full fp32 and
    made exactly symmetric.  Its eigenvalues lie in about ``[1, 5]``, and
    the trailing updates of its factorization are as large as its
    entries, so an error in any task's product shows in the factor."""
    from .reference import strict_fp32

    g = generator(seed, device)
    x = torch.randn(n, n, generator=g, device=device, dtype=dtype)
    with strict_fp32():
        s = x @ x.T
    del x
    s.add_(s.T.contiguous()).mul_(0.5 / n)
    s.diagonal().add_(1.0)
    return s

"""K3's wrapper and plain version (``parsec_tpu_torch/ops/stencil.py``)
against the JAX package's two incarnations of the same function,
``stencil1d_xla`` and ``stencil1d_pallas`` (in interpret mode on the CPU),
and a per-row ``np.convolve`` oracle in float64, on the same seeded
inputs.

On the CPU, ``stencil1d`` takes the plain version (the kernel runs only
on the card: ``tests/test_torch_card.py``).  Tolerances: fp32 against
XLA, ``rtol=1e-6, atol=2e-6`` (at most 9 fp32 products of O(1) values,
summed in the same order; XLA may fuse a multiply-add); against the
float64 oracle, ``1e-5``; bf16 outputs, one bf16 ulp (``rtol=1e-2``).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.ops.stencil import (_MAX_VMEM_ROW, stencil1d_pallas,
                                    stencil1d_xla)
from parsec_tpu_torch.ops import stencil as ks

F32 = dict(rtol=1e-6, atol=2e-6)
ORACLE = dict(rtol=1e-5, atol=1e-5)


def _oracle(padded, w):
    """np.convolve on each row, in float64: sum_j w[j] * row[i + j]."""
    rows = np.asarray(padded, np.float64).reshape(-1, padded.shape[-1])
    out = np.stack([np.convolve(r, np.asarray(w)[::-1], mode="valid")
                    for r in rows])
    return out.reshape(padded.shape[:-1] + (out.shape[-1],))


def _port(fn, p, w):
    return fn(torch.from_numpy(p), w).numpy()


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("shape", [(48,), (4, 64), (9, 130), (2, 3, 40)])
def test_plain_and_wrapper_match_jax_and_oracle(R, shape):
    """1-D, 2-D (a ragged batch of 9 rows: not a multiple of the TPU
    kernel's 8-row block) and 3-D batches."""
    rng = np.random.default_rng(10 * R + len(shape))
    w = rng.standard_normal(2 * R + 1)
    p = rng.standard_normal(shape[:-1] + (shape[-1] + 2 * R,)).astype(
        np.float32)
    before = ks.stencil1d.launches
    plain = _port(ks.stencil1d_plain, p, w)
    got = _port(ks.stencil1d, p, w)
    assert ks.stencil1d.launches == before     # the CPU launches nothing
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, np.asarray(stencil1d_xla(p, w)), **F32)
    np.testing.assert_allclose(
        got, np.asarray(stencil1d_pallas(p, w, interpret=True)), **F32)
    np.testing.assert_allclose(got, _oracle(p, w), **ORACLE)


def test_row_longer_than_the_tpu_vmem_limit():
    """A row past 2^17 elements, which the JAX package sends to XLA; the
    port's wrapper (and K3 on the card) takes any length."""
    w = np.array([0.1, 0.2, 0.4, 0.2, 0.1])
    n = _MAX_VMEM_ROW + 8
    p = np.random.default_rng(1).standard_normal((2, n + 4)).astype(
        np.float32)
    got = _port(ks.stencil1d, p, w)
    assert got.shape == (2, n)
    np.testing.assert_allclose(
        got, np.asarray(stencil1d_pallas(p, w, interpret=True)), **F32)
    np.testing.assert_allclose(got, _oracle(p, w), **ORACLE)


def test_bf16_accumulates_in_fp32_and_stays_bf16():
    rng = np.random.default_rng(2)
    w = rng.standard_normal(5)
    p = rng.standard_normal((9, 70)).astype(ml_dtypes.bfloat16)
    got = ks.stencil1d(torch.from_numpy(p.view(np.int16)).view(
        torch.bfloat16), w)
    assert got.dtype == torch.bfloat16 and got.shape == (9, 66)
    want = np.asarray(stencil1d_pallas(p, w, interpret=True))
    assert want.dtype == ml_dtypes.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               _oracle(p.astype(np.float32), w),
                               rtol=1e-2, atol=2e-2)


def test_float64_stays_float64():
    w = np.array([0.2, 0.6, 0.2])
    p = np.linspace(0, 1, 66)
    got = ks.stencil1d(torch.from_numpy(p), w)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _oracle(p, w), rtol=1e-14,
                               atol=1e-15)
    p32 = p.astype(np.float32)
    assert ks.stencil1d(torch.from_numpy(p32), w).dtype == torch.float32
    np.testing.assert_allclose(
        _port(ks.stencil1d, p32, w),
        np.asarray(stencil1d_pallas(p32, w, interpret=True)), **F32)


def test_weights_are_rounded_to_the_accumulation_type_first():
    """Like the JAX tap loop (``ct.type(float(w[j]))``): a weight not
    representable in fp32 multiplies as its fp32 rounding."""
    w = np.array([0.1, 1.0 / 3.0, 0.7])
    p = np.random.default_rng(3).standard_normal(34).astype(np.float32)
    np.testing.assert_array_equal(
        _port(ks.stencil1d_plain, p, w),
        _port(ks.stencil1d_plain, p, w.astype(np.float32)))


@pytest.mark.parametrize("bad", ["short_row", "no_weights", "meta_device"])
def test_wrapper_refuses(bad):
    p = torch.zeros(3, 10)
    w = [0.25, 0.5, 0.25]
    if bad == "short_row":
        p = torch.zeros(3, 2)
    elif bad == "no_weights":
        w = []
    else:
        p = torch.empty(3, 10, device="meta")   # no kernel, no fallback
    before = ks.stencil1d.launches
    with pytest.raises(ValueError):
        ks.stencil1d(p, w)
    assert ks.stencil1d.launches == before

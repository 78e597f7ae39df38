"""The port's GEMM kernel module against the JAX package's GEMM.

``gemm_update_plain`` (what the CPU path runs, and what the card's kernel
is held against) is compared with ``parsec_tpu.ops.gemm._gemm_update`` and
with ``matmul_pallas`` in interpret mode, on the same numpy inputs.

Tolerances: fp32 ``rtol=1e-5, atol=1e-4`` at k <= 512 — both sides
compute fp32 products and fp32 sums, so only the summation order differs.
bf16 inputs are compared in fp32 at ``rtol=2e-2, atol=1e-2``: the
products are exact in fp32, but a bf16 *output* (``matmul``) rounds to 8
mantissa bits, about 0.4% of the value.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.ops.gemm import _gemm_update, matmul_pallas
from parsec_tpu_torch.data.datatype import to_numpy, to_tensor
from parsec_tpu_torch.ops import _build
from parsec_tpu_torch.ops import gemm as tg

FP32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=1e-2)

SHAPES = {
    "2d": (None, 64, 96, 128),
    "batched": (3, 32, 48, 64),
    "ragged": (None, 37, 53, 29),
}


def _inputs(seed, batch, m, n, k, in_dtype):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    a = rng.standard_normal(lead + (m, k), dtype=np.float32)
    b = rng.standard_normal(lead + (k, n), dtype=np.float32)
    c = rng.standard_normal(lead + (m, n), dtype=np.float32)
    if in_dtype == "bf16":
        a, b = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return a, b, c


def _f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("in_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_plain_matches_jax_gemm_update(kind, in_dtype):
    batch, m, n, k = SHAPES[kind]
    a, b, c = _inputs(1, batch, m, n, k, in_dtype)
    ref_fn = _gemm_update if batch is None else jax.vmap(_gemm_update)
    ref = ref_fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    got = tg.gemm_update_plain(to_tensor(a), to_tensor(b), to_tensor(c))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    tol = FP32_TOL if in_dtype == "fp32" else BF16_TOL
    np.testing.assert_allclose(to_numpy(got), _f32(ref), **tol)


@pytest.mark.parametrize("in_dtype", ["fp32", "bf16"])
def test_plain_and_matmul_match_matmul_pallas(in_dtype):
    m, n, k = 128, 192, 256
    a, b, _ = _inputs(2, None, m, n, k, in_dtype)
    ref = matmul_pallas(jnp.asarray(a), jnp.asarray(b), bm=64, bn=64, bk=64,
                        interpret=True)
    ta, tb = to_tensor(a), to_tensor(b)
    upd = tg.gemm_update_plain(ta, tb, torch.zeros(m, n))
    mm = tg.matmul(ta, tb)
    assert mm.dtype == ta.dtype            # matmul_pallas returns A's dtype
    tol = FP32_TOL if in_dtype == "fp32" else BF16_TOL
    np.testing.assert_allclose(to_numpy(upd), _f32(ref), **tol)
    np.testing.assert_allclose(_f32(to_numpy(mm)), _f32(ref), **tol)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    a, b, c = (torch.randn(3, 8, 8) for _ in range(3))
    before = (tg.gemm_update.launches, tg.matmul.launches)
    out = tg.gemm_update(a, b, c)
    tg.matmul(a, b)
    assert torch.equal(out, tg.gemm_update_plain(a, b, c))
    assert (tg.gemm_update.launches, tg.matmul.launches) == before
    assert out.data_ptr() != c.data_ptr()   # c is not modified in place


def test_tile_list_wrapper_on_cpu_tiles():
    rng = np.random.default_rng(3)
    a, b, c = (to_tensor(rng.standard_normal((4, 12, 12), dtype=np.float32))
               for _ in range(3))
    before = tg.gemm_update.launches
    got = tg.gemm_update_tiles(list(a), list(b), list(c))
    assert tg.gemm_update.launches == before
    assert torch.equal(torch.stack(got), tg.gemm_update_plain(a, b, c))
    # each result owns its storage: dropping one tile frees its bytes
    for t in got:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


@pytest.mark.parametrize("case", ["lengths", "empty", "shapes", "dtypes",
                                  "batched_tiles"])
def test_tile_list_wrapper_rejects_mixed_lists(case):
    a, b, c = torch.randn(8, 4), torch.randn(4, 6), torch.randn(8, 6)
    as_, bs, cs = [a, a], [b, b], [c, c]
    if case == "lengths":
        cs = [c]
    elif case == "empty":
        as_, bs, cs = [], [], []
    elif case == "shapes":
        as_ = [a, torch.randn(8, 5)]
    elif case == "dtypes":
        cs = [c, c.double()]
    elif case == "batched_tiles":
        as_, bs, cs = [a[None]], [b[None]], [c[None]]
    with pytest.raises((TypeError, ValueError)):
        tg.gemm_update_tiles(as_, bs, cs)


@pytest.mark.parametrize("case", [
    "dtype_mismatch", "unsupported_dtype", "shape_mismatch", "c_shape",
    "batch_mismatch", "mixed_rank", "non_contiguous", "rank_1"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    f = torch.float32
    a, b, c = torch.randn(8, 4), torch.randn(4, 6), torch.randn(8, 6)
    if case == "dtype_mismatch":
        b = b.to(torch.bfloat16)
    elif case == "unsupported_dtype":
        a, b = a.half(), b.half()
    elif case == "shape_mismatch":
        b = torch.randn(5, 6, dtype=f)
    elif case == "c_shape":
        c = torch.randn(6, 8, dtype=f)
    elif case == "batch_mismatch":
        a, b, c = torch.randn(2, 8, 4), torch.randn(3, 4, 6), torch.randn(2, 8, 6)
    elif case == "mixed_rank":
        a = a[None]
    elif case == "non_contiguous":
        a = torch.randn(4, 8).t()
    elif case == "rank_1":
        a, b, c = torch.randn(4), torch.randn(4), torch.randn(1)
    with pytest.raises((TypeError, ValueError)):
        tg.gemm_update(a, b, c)


def test_non_cuda_device_raises_instead_of_falling_back():
    a, b, c = (torch.empty(2, 2, device="meta") for _ in range(3))
    before = tg.gemm_update.launches
    with pytest.raises(ValueError, match="no kernel"):
        tg.gemm_update(a, b, c)
    assert tg.gemm_update.launches == before


def test_build_module_imports_without_nvcc_and_fails_only_on_build(
        monkeypatch, tmp_path):
    # importing it (above) needed no nvcc; a build request without one
    # raises a typed error naming the missing compiler
    assert "gemm" in _build.sources()
    assert _build.lib_path("gemm").parent == _build.BUILD_DIR
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.load("gemm")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build()

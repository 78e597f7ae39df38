"""Tests of the port that need an NVIDIA GPU: the CUDA kernel and the
device module on the card.  They skip without one.

This file imports no JAX, so it also runs where JAX is not installed;
there, skip ``tests/conftest.py`` (it sets JAX up)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py

Tolerances: the kernel and its plain version (cuBLAS with TF32 off) both
compute fp32 products and fp32 sums in different orders; with |C| of
order sqrt(k), ``rtol=1e-4, atol=1e-3`` is rounding, a wrong element is
off by O(1).
"""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.data_dist.matrix import TiledMatrix
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.ops import gemm as tg
from parsec_tpu_torch.runtime import Context

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    snapshot = list(registry.devices)
    yield init_cuda_devices()[0]
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


@pytest.mark.parametrize("shape,in_dtype,c_dtype", [
    ((4, 256, 256, 256), torch.float32, torch.float32),
    ((4, 256, 256, 256), torch.bfloat16, torch.float32),
    ((3, 65, 130, 47), torch.float32, torch.float32),
    ((1000, 700, 300), torch.float32, torch.float32),
    ((1000, 700, 300), torch.bfloat16, torch.bfloat16)])
def test_kernel_matches_plain(card, shape, in_dtype, c_dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    *lead, m, n, k = shape
    a = torch.randn(*lead, m, k, device="cuda", generator=g).to(in_dtype)
    b = torch.randn(*lead, k, n, device="cuda", generator=g).to(in_dtype)
    c = torch.randn(*lead, m, n, device="cuda", generator=g).to(c_dtype)
    before = tg.gemm_update.launches
    got = tg.gemm_update(a, b, c)
    torch.cuda.synchronize()
    assert tg.gemm_update.launches == before + 1
    assert got.dtype == c_dtype
    tol = dict(rtol=1e-4, atol=1e-3) if c_dtype == torch.float32 \
        else dict(rtol=1e-2, atol=5e-2)   # bf16 output: 8 mantissa bits
    torch.testing.assert_close(got.float(), tg.gemm_update_plain(a, b, c)
                               .float(), **tol)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_tile_list_kernel_matches_plain(card, in_dtype):
    g = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(5, 96, 80, device="cuda", generator=g).to(in_dtype)
    b = torch.randn(5, 80, 112, device="cuda", generator=g).to(in_dtype)
    c = torch.randn(5, 96, 112, device="cuda", generator=g)
    before = tg.gemm_update.launches
    got = tg.gemm_update_tiles(list(a), list(b), list(c))
    torch.cuda.synchronize()
    assert tg.gemm_update.launches == before + 1
    assert len({t.untyped_storage().data_ptr() for t in got}) == 5
    torch.testing.assert_close(torch.stack(got), tg.gemm_update_plain(a, b, c),
                               rtol=1e-4, atol=1e-3)


def test_wrapper_raises_on_a_mixed_device_call(card):
    a = torch.randn(8, 8, device="cuda")
    with pytest.raises(ValueError, match="different devices"):
        tg.gemm_update(a, a.cpu(), a)


def test_tiled_gemm_on_the_card(card):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 384), dtype=np.float32)
    b = rng.standard_normal((384, 320), dtype=np.float32)
    A = TiledMatrix.from_dense("A", a, 128, 128)
    B = TiledMatrix.from_dense("B", b, 128, 128)
    C = TiledMatrix("C", 512, 320, 128, 128)
    launches = tg.gemm_update.launches
    ctx = Context(nb_cores=2)
    try:
        ctx.add_taskpool(tiled_gemm_ptg(A, B, C))
        ctx.wait(timeout=120)
        card.sync()
    finally:
        ctx.fini(timeout=30)
    card.flush_cache()
    assert card.executed_tasks == 4 * 3 * 3
    assert tg.gemm_update.launches > launches
    np.testing.assert_allclose(C.to_dense(), a @ b, rtol=1e-4, atol=1e-3)

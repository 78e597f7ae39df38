"""The port's first slice as a whole: the PTG tiled GEMM through ``Context``
and the CUDA device module, against the JAX package on the same tiles.

The same host tiles (made with numpy from a seed) go through
``parsec_tpu`` (``Context`` + the ``accel_device`` fixture +
``tiled_gemm_ptg(..., devices="tpu")``) and through ``parsec_tpu_torch``
(``Context`` + ``init_cuda_devices(device="cpu")`` +
``tiled_gemm_ptg(..., devices="cuda")``), carried across with
``TiledMatrix.from_numpy_tiles``.  Results and the structural counters
are compared.

Tolerances: fp32 ``rtol=1e-5, atol=1e-4`` (k <= 512; both sides sum fp32
products, only the order differs); bf16 inputs in fp32 at ``rtol=2e-2``.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.data_dist.matrix import TiledMatrix as JTiledMatrix
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as jax_tiled_gemm
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch.core.params import params as port_params
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.data_dist.matrix import TiledMatrix
from parsec_tpu_torch.models.tiled_gemm import gemm_flops, tiled_gemm_ptg
from parsec_tpu_torch.ops import gemm as tg
from parsec_tpu_torch.ptg.lowering import find_traceable, register_traceable
from parsec_tpu_torch.runtime import Context

FP32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=1e-3)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cpu_cuda_device():
    """The port's CUDA device module wrapped around the host CPU,
    registered for the test and unregistered after."""
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


@pytest.fixture
def port_param():
    """Scoped override of a port MCA param, restored at test exit."""
    saved = {}

    def set_(name, value):
        saved.setdefault(name, port_params.get(name))
        port_params.set(name, value)

    yield set_
    for name, value in saved.items():
        port_params.set(name, value)


def _jax_matrix(name, lm, ln, mb, nb, seed, dtype=np.float32):
    def init(m, n, shape):
        rng = np.random.default_rng((seed, m, n))
        return rng.standard_normal(shape, dtype=np.float32).astype(dtype)
    M = JTiledMatrix(name, lm, ln, mb, nb, dtype=dtype, init_fn=init)
    tiles = {(i, j): M.data_of(i, j).newest_copy().value
             for i in range(M.mt) for j in range(M.nt)}
    return M, tiles


def _problem(M, N, K, mb, ab_dtype=np.float32):
    """JAX-side A, B, C plus their host tiles, and the port's copies of
    the same tiles."""
    jA, tA = _jax_matrix("A", M, K, mb, mb, 1, ab_dtype)
    jB, tB = _jax_matrix("B", K, N, mb, mb, 2, ab_dtype)
    jC, tC = _jax_matrix("C", M, N, mb, mb, 3)
    port = (TiledMatrix.from_numpy_tiles("A", tA, M, K, mb, mb),
            TiledMatrix.from_numpy_tiles("B", tB, K, N, mb, mb),
            TiledMatrix.from_numpy_tiles("C", tC, M, N, mb, mb))
    return (jA, jB, jC), port


def _run_jax(dev, A, B, C, nb_cores):
    ctx = JContext(nb_cores=nb_cores)
    try:
        ctx.add_taskpool(jax_tiled_gemm(A, B, C, devices="tpu"))
        ctx.wait(timeout=120)
        dev.sync()
        dev.flush_cache()
    finally:
        ctx.fini(timeout=30)
    return C.to_dense()


def _run_port(dev, A, B, C, nb_cores):
    ctx = Context(nb_cores=nb_cores)
    try:
        ctx.add_taskpool(tiled_gemm_ptg(A, B, C))
        ctx.wait(timeout=120)
        dev.sync()
    finally:
        ctx.fini(timeout=30)
    return C.to_dense()


@pytest.mark.parametrize("nb_cores", [0, 2])
def test_port_matches_jax_package(accel_device, cpu_cuda_device, nb_cores):
    jax_mats, port_mats = _problem(64, 48, 80, 16)
    want = _run_jax(accel_device, *jax_mats, nb_cores)
    got = _run_port(cpu_cuda_device, *port_mats, nb_cores)
    np.testing.assert_allclose(got, want, **FP32_TOL)
    ntasks = 4 * 3 * 5
    assert cpu_cuda_device.executed_tasks == accel_device.executed_tasks \
        == ntasks
    assert cpu_cuda_device.batched_dispatches > 0
    assert accel_device.batched_dispatches > 0
    assert cpu_cuda_device.bytes_in > 0
    assert cpu_cuda_device.kernel_launches < ntasks   # batches fused
    assert tg.gemm_update.launches == 0     # host tensors: no kernel ran


def test_ragged_edge_tiles_match(accel_device, cpu_cuda_device):
    jax_mats, port_mats = _problem(50, 37, 45, 16)
    want = _run_jax(accel_device, *jax_mats, 0)
    got = _run_port(cpu_cuda_device, *port_mats, 0)
    assert got.shape == (50, 37)
    np.testing.assert_allclose(got, want, **FP32_TOL)
    assert cpu_cuda_device.executed_tasks == accel_device.executed_tasks \
        == 4 * 3 * 3


def test_per_task_path_when_batching_is_off(accel_device, cpu_cuda_device,
                                            port_param):
    port_param("device_cuda_batch", "0")
    jax_mats, port_mats = _problem(32, 32, 48, 16)
    want = _run_jax(accel_device, *jax_mats, 0)
    got = _run_port(cpu_cuda_device, *port_mats, 0)
    np.testing.assert_allclose(got, want, **FP32_TOL)
    ntasks = 2 * 2 * 3
    assert cpu_cuda_device.batched_dispatches == 0
    assert cpu_cuda_device.kernel_launches == ntasks
    assert cpu_cuda_device.executed_tasks == ntasks


def test_bf16_host_tiles_cross_and_match(accel_device, cpu_cuda_device):
    jax_mats, port_mats = _problem(32, 32, 64, 16, ab_dtype=ml_dtypes.bfloat16)
    assert port_mats[0].dtype == torch.bfloat16
    want = _run_jax(accel_device, *jax_mats, 0)
    got = _run_port(cpu_cuda_device, *port_mats, 0)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_flush_cache_writes_back(cpu_cuda_device):
    _, (A, B, C) = _problem(32, 32, 32, 16)
    ctx = Context(nb_cores=0)
    ctx.add_taskpool(tiled_gemm_ptg(A, B, C))
    ctx.wait(timeout=60)
    ctx.fini(timeout=30)
    before = C.to_dense()
    idx = cpu_cuda_device.device_index
    assert C.data_of(0, 0).get_copy(idx) is not None   # resident, dirty
    cpu_cuda_device.flush_cache()
    assert cpu_cuda_device.bytes_out == 4 * 16 * 16 * 4   # the 4 C tiles
    for i in range(2):
        for j in range(2):
            d = C.data_of(i, j)
            assert d.get_copy(idx) is None
            host = d.get_copy(0)
            assert isinstance(host.value, torch.Tensor)
            assert host.value.device.type == "cpu"
            assert d.newest_copy() is host
    np.testing.assert_array_equal(C.to_dense(), before)


def test_deferred_eviction_under_a_small_budget(cpu_cuda_device):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 64), dtype=np.float32)
    b = rng.standard_normal((64, 64), dtype=np.float32)
    A = TiledMatrix.from_dense("A", a, 16, 16)
    B = TiledMatrix.from_dense("B", b, 16, 16)
    C = TiledMatrix("C", 64, 64, 16, 16)
    budget = 6 * 16 * 16 * 4     # six tiles
    cpu_cuda_device._mem_budget = budget
    ctx = Context(nb_cores=0)
    try:
        ctx.add_taskpool(tiled_gemm_ptg(A, B, C))
        ctx.wait(timeout=120)
    finally:
        ctx.fini(timeout=30)
    assert cpu_cuda_device.batched_dispatches > 0
    # what the LRU counts is what its tiles hold: each resident tile owns
    # its storage (no view into a batch's output), so evicting it frees it
    resident = list(cpu_cuda_device._mem_lru.values())
    storages = {c.value.untyped_storage().data_ptr(): c.value.untyped_storage()
                for c in resident}
    held = sum(st.nbytes() for st in storages.values())
    assert held == cpu_cuda_device._mem_bytes <= budget
    got = C.to_dense()
    cpu_cuda_device.flush_cache()
    assert cpu_cuda_device.deferred_evictions > 0
    np.testing.assert_allclose(got, a @ b, **FP32_TOL)
    np.testing.assert_allclose(C.to_dense(), a @ b, **FP32_TOL)


def test_cuda_build_has_no_cpu_chore_to_fall_through_to():
    _, (A, B, C) = _problem(16, 16, 16, 16)
    tp = tiled_gemm_ptg(A, B, C)
    assert [c.device_type for c in tp.task_classes[0].chores] == ["cuda"]
    # no "cuda" device registered: the task has no runnable chore and the
    # failure surfaces from wait() instead of running on the host
    assert not port_registry.by_type("cuda")
    ctx = Context(nb_cores=0)
    ctx.add_taskpool(tp)
    with pytest.raises(RuntimeError, match="no runnable chore"):
        ctx.wait(timeout=30)
    ctx.fini(timeout=5)


def test_kernel_failure_poisons_the_context(cpu_cuda_device):
    _, (A, B, C) = _problem(32, 32, 32, 16)
    good = find_traceable("gemm")

    def broken(*stacks):
        raise RuntimeError("injected kernel fault")

    register_traceable("gemm", broken, bilinear=True)
    try:
        ctx = Context(nb_cores=2)
        ctx.add_taskpool(tiled_gemm_ptg(A, B, C))
        with pytest.raises(RuntimeError) as ei:
            ctx.wait(timeout=30)
        ctx.fini(timeout=5)
    finally:
        register_traceable("gemm", good.apply, bilinear=good.bilinear)
    assert "injected kernel fault" in repr(ei.value.__cause__)


def test_init_cuda_devices_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU error cannot be observed")
    before = list(port_registry.devices)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cuda_devices()
    assert port_registry.devices == before     # nothing registered


def test_init_cuda_devices_is_idempotent(cpu_cuda_device):
    assert init_cuda_devices(device="cpu") == [cpu_cuda_device]
    with pytest.raises(ValueError):
        init_cuda_devices(device="meta")


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_numpy_tiles_round_trip_bytes(dtype):
    _, tiles = _jax_matrix("X", 40, 24, 16, 16, 7, dtype)
    X = TiledMatrix.from_numpy_tiles("X", tiles, 40, 24, 16, 16)
    back = X.to_numpy_tiles()
    assert sorted(back) == sorted(tiles)
    for k, v in tiles.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert back[k].tobytes() == np.asarray(v).tobytes()
    assert X.to_dense().dtype == np.dtype(dtype)


def test_from_numpy_tiles_needs_every_tile():
    _, tiles = _jax_matrix("X", 32, 32, 16, 16, 8)
    del tiles[(1, 1)]
    with pytest.raises(KeyError):
        TiledMatrix.from_numpy_tiles("X", tiles, 32, 32, 16, 16)


def test_gemm_flops():
    assert gemm_flops(8192, 8192, 8192) == 2.0 * 8192 ** 3


def test_quick_start_runs_in_a_subprocess():
    """The README's port quick start, on the CPU stand-in device."""
    code = textwrap.dedent("""
        import numpy as np
        from parsec_tpu_torch.data_dist.matrix import TiledMatrix
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
        from parsec_tpu_torch.runtime import Context
        dev = init_cuda_devices(device="cpu")[0]
        a = np.random.default_rng(0).standard_normal((96, 64), np.float32)
        A = TiledMatrix.from_dense("A", a, 32, 32)
        B = TiledMatrix.from_dense("B", a.T.copy(), 32, 32)
        C = TiledMatrix("C", 96, 96, 32, 32)
        ctx = Context(nb_cores=2)
        ctx.add_taskpool(tiled_gemm_ptg(A, B, C))
        ctx.wait(timeout=60)
        ctx.fini(timeout=30)
        dev.flush_cache()
        assert np.allclose(C.to_dense(), a @ a.T, rtol=1e-5, atol=1e-4)
        print("ok", dev.executed_tasks)
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok", "18"]

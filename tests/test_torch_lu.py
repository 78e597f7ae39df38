"""The port's tiled nopiv LU against the JAX package's, on the CPU.

The same diagonally dominant input (``make_dd`` from a seed, equal bit
for bit in both packages) is factored by ``parsec_tpu``'s
``tiled_lu_ptg(devices="cpu")`` and by the port, through its device
module around the host (``devices="cuda"`` chores on
``init_cuda_devices(device="cpu")``) and through its host chores; the
lowered pools of both packages are held against each other, the four
incarnations against the JAX traceables, and the plain GETRF loop (what
a CPU tensor takes: PyTorch's nopiv LU runs only on the card) against
the JAX package's ``_getrf_nopiv_np``.

Tolerances: packed factors of the two packages agree to
``rtol=1e-4, atol=1e-5`` (fp32 on both sides, sums in other orders; the
JAX host bodies solve the panels in float64 and round, the port
multiplies by an fp32 inverse: the L entries are of order 1/n, the U
entries of order n); ``L·U`` against the input to the JAX package's own
``2e-3`` (``tests/test_lu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JBC
from parsec_tpu.models import lu as jlu
from parsec_tpu.ptg.lowering import lower_taskpool as j_lower
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch.data_dist.matrix import TiledMatrix, TwoDimBlockCyclic
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models import lu
from parsec_tpu_torch.ops import factor
from parsec_tpu_torch.ops import gemm as tg
from parsec_tpu_torch.ptg.lowering import find_traceable, lower_taskpool
from parsec_tpu_torch.runtime import Context

PKG_TOL = dict(rtol=1e-4, atol=1e-5)
CLASSES = ("GETRF", "TRSM_L", "TRSM_U", "GEMM")


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


def _check_factors(packed, a, tol=2e-3):
    L, U = lu.unpack_lu(packed.astype(np.float64))
    np.testing.assert_allclose(L @ U, a, rtol=tol, atol=tol)


def _jax_run(a, nb):
    A = JBC.from_dense("A", a.copy(), nb, nb)
    tiles = {(m, n): np.array(A.data_of(m, n).newest_copy().value)
             for m in range(A.mt) for n in range(A.nt)}
    tp = jlu.tiled_lu_ptg(A, devices="cpu")
    counts = {name: len(list(tp._tc_builders[name]._enumerate_space()))
              for name in CLASSES}
    ctx = JContext(nb_cores=0)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
    finally:
        ctx.fini(timeout=30)
    return A.to_dense(), counts, tiles


def _port_run(tiles, n, nb, devices, nb_cores):
    A = TwoDimBlockCyclic.from_numpy_tiles("A", tiles, n, n, nb, nb)
    ctx = Context(nb_cores=nb_cores)
    try:
        ctx.add_taskpool(lu.tiled_lu_ptg(A, devices=devices))
        ctx.wait(timeout=120)
    finally:
        ctx.fini(timeout=30)
    return A.to_dense()


@pytest.mark.parametrize("nb_cores", [0, 2])
@pytest.mark.parametrize("n,nb", [(256, 64), (200, 64)])
def test_device_module_matches_jax_package(cpu_cuda_device, n, nb,
                                           nb_cores):
    a = lu.make_dd(n, seed=1)
    want, counts, tiles = _jax_run(a, nb)
    got = _port_run(tiles, n, nb, "cuda", nb_cores)
    np.testing.assert_allclose(got, want, **PKG_TOL)
    _check_factors(got, a)
    assert dict(cpu_cuda_device.tasks_by_class) == counts
    assert cpu_cuda_device.executed_tasks == sum(counts.values())
    if n % nb == 0:      # a ragged edge splits batches by tile shape
        assert cpu_cuda_device.batched_dispatches > 0
    assert tg.gemm_update.launches == 0


@pytest.mark.parametrize("n,nb", [(256, 64), (200, 64)])
def test_host_chores_match_jax_package(n, nb):
    a = lu.make_dd(n, seed=2)
    want, _, tiles = _jax_run(a, nb)
    got = _port_run(tiles, n, nb, "cpu", 2)
    np.testing.assert_allclose(got, want, **PKG_TOL)


def test_tile_algorithm_equals_straight_elimination():
    """The packed result equals ``_getrf_nopiv_np`` of the whole matrix
    (the JAX package's own check, ``tests/test_lu.py``)."""
    a = lu.make_dd(64, seed=3)
    A = TiledMatrix.from_dense("A", a.copy(), 16, 16)
    ctx = Context(nb_cores=0)
    try:
        ctx.add_taskpool(lu.tiled_lu_ptg(A, devices="cpu"))
        ctx.wait(timeout=60)
    finally:
        ctx.fini(timeout=30)
    np.testing.assert_allclose(A.to_dense(), jlu._getrf_nopiv_np(a),
                               rtol=2e-3, atol=2e-3)


def test_task_counts():
    tp = lu.tiled_lu_ptg(TiledMatrix.from_dense("A", lu.make_dd(80), 16, 16))
    counts = {name: len(list(tp._tc_builders[name]._enumerate_space()))
              for name in CLASSES}
    assert counts == {"GETRF": 5, "TRSM_L": 10, "TRSM_U": 10,
                      "GEMM": 1 + 4 + 9 + 16}


def test_lowered_matches_jax_lowering():
    """Both packages lower the LU pool to the wavefront pass and give
    the same packed factors."""
    n, nb = 256, 64
    a = lu.make_dd(n, seed=4)
    JA = JBC.from_dense("A", a.copy(), nb, nb)
    jlow = j_lower(jlu.tiled_lu_ptg(JA))
    jlow.execute()
    A = TwoDimBlockCyclic.from_dense("A", a.copy(), nb, nb)
    low = lower_taskpool(lu.tiled_lu_ptg(A), device="cpu")
    assert low.mode == jlow.mode == "wavefront"
    assert (low.levels, low.groups) == (10, 13)
    low.execute()
    np.testing.assert_allclose(A.to_dense(), JA.to_dense(), **PKG_TOL)
    _check_factors(A.to_dense(), a)


def test_lowered_plan_size_at_the_bench_tile_count():
    """At 16x16 tiles (the JAX bench's n=8192, nb=512, here on 2x2
    tiles) the plan has 46 levels in 61 batched calls."""
    A = TiledMatrix.from_dense("A", lu.make_dd(32, seed=5), 2, 2)
    low = lower_taskpool(lu.tiled_lu_ptg(A), device="cpu")
    assert (low.mode, low.levels, low.groups) == ("wavefront", 46, 61)


def test_no_incarnation_is_bilinear():
    for name in ("lu_getrf", "lu_trsm_l", "lu_trsm_u", "lu_gemm"):
        tr = find_traceable(name)
        assert tr is not None and tr.stacked is not None
        assert not tr.bilinear


# ---------------------------------------------------------------------------
# GETRF's plain loop and the incarnations against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [8, 64])
def test_plain_getrf_matches_getrf_nopiv_np(nb):
    """The fp32 rank-1 loop against the JAX package's float64 loop
    (rounded to fp32) and its fp32 traceable, one tile and a batch."""
    a = lu.make_dd(nb, seed=6)
    got = factor.getrf_nopiv_plain(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), jlu._getrf_nopiv_np(a),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jlu._getrf_traceable(
                                   jnp.asarray(a))), rtol=1e-6, atol=1e-6)
    batch = np.stack([a, lu.make_dd(nb, seed=7)])
    both = factor.getrf_nopiv_plain(torch.from_numpy(batch))
    torch.testing.assert_close(both[0], got)
    assert factor.getrf_nopiv(torch.from_numpy(a)).equal(got)   # CPU route
    # the input is not modified
    np.testing.assert_array_equal(a, lu.make_dd(nb, seed=6))


def _tiles(seed, count, nb=48):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((nb, nb)).astype(np.float32)
            for _ in range(count)]


def test_incarnations_match_jax_traceables():
    packed = [jlu._getrf_nopiv_np(lu.make_dd(48, seed=s)) for s in (8, 9)]
    ks = [packed[0], packed[1], packed[0]]
    cs, as_, bs = _tiles(10, 3), _tiles(11, 3), _tiles(12, 3)
    T = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    J = jnp.asarray
    cases = [
        (lu.getrf_tiles(T([lu.make_dd(48, seed=8)])),
         [jlu._getrf_traceable(J(lu.make_dd(48, seed=8)))]),
        (lu.trsm_l_tiles(T(ks), T(cs)),
         [jlu._trsm_l_traceable(J(k), J(c)) for k, c in zip(ks, cs)]),
        (lu.trsm_u_tiles(T(ks), T(cs)),
         [jlu._trsm_u_traceable(J(k), J(c)) for k, c in zip(ks, cs)]),
        (lu.gemm_tiles(T(as_), T(bs), T(cs)),
         [jlu._gemm_nn_traceable(J(x), J(y), J(c))
          for x, y, c in zip(as_, bs, cs)])]
    for got, want in cases:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.is_contiguous()
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max())
    stk = lambda xs: torch.from_numpy(np.stack(xs))  # noqa: E731
    for stacked, args, listed in (
            (lu.trsm_l_stacked, (stk(ks), stk(cs)), cases[1][0]),
            (lu.trsm_u_stacked, (stk(ks), stk(cs)), cases[2][0]),
            (lu.gemm_stacked, (stk(as_), stk(bs), stk(cs)), cases[3][0])):
        torch.testing.assert_close(stacked(*args), torch.stack(listed),
                                   rtol=1e-5, atol=1e-5)
    # a broadcast diagonal tile (a group sharing GETRF(k)'s output)
    bk = torch.from_numpy(ks[0])[None].expand(3, 48, 48)
    torch.testing.assert_close(
        lu.trsm_u_stacked(bk, stk(cs)),
        torch.stack(lu.trsm_u_tiles(T([ks[0]] * 3), T(cs))),
        rtol=1e-6, atol=1e-6)


def test_constructors_and_flops_match_jax():
    np.testing.assert_array_equal(lu.make_dd(40, seed=3),
                                  jlu.make_dd(40, seed=3))
    packed = jlu._getrf_nopiv_np(lu.make_dd(16, seed=3))
    for got, want in zip(lu.unpack_lu(packed), jlu.unpack_lu(packed)):
        np.testing.assert_array_equal(got, want)
    assert lu.lu_flops(1000) == jlu.lu_flops(1000)


@pytest.mark.parametrize("case", ["devices", "square"])
def test_builder_refuses_what_it_cannot_factor(case):
    a = lu.make_dd(32)
    A = TiledMatrix.from_dense("A", a if case == "devices" else a[:, :24],
                               8, 8)
    with pytest.raises(ValueError):
        lu.tiled_lu_ptg(A, **(dict(devices="tpu") if case == "devices"
                              else {}))

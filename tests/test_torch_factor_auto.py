"""``devices="auto"`` for the port's Cholesky and LU, and the upper
Cholesky, against the JAX package's factors and float64.

An ``"auto"`` class carries both chores, the CUDA one first: with the
device module registered (around the host here) every task takes it and
the host chore never runs (``ops.factor.host_runs`` stays 0); with no
CUDA device every task runs its host chore.  The upper distribution
factors ``A = Uᵀ·U`` with ``U = Lᵀ``, through typed edges of the
``"transposed"`` layout.  Tolerance: the factors of both packages within
1e-5 of each other and of the float64 factor (fp32 tiles, ``make_spd``
and ``make_dd`` inputs, the same operations in another order).
"""

import numpy as np
import pytest
import torch

from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.models import cholesky as jchol
from parsec_tpu.models import lu as jlu
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch.data.datatype import TileType, convert
from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                               TiledMatrix)
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models import cholesky as chol
from parsec_tpu_torch.models import lu
from parsec_tpu_torch.ops import factor
from parsec_tpu_torch.ptg.lowering import LoweringError, lower_taskpool
from parsec_tpu_torch.runtime import Context

TOL = 1e-5
N, NB = 48, 16


@pytest.fixture(params=["registered", "host"])
def device(request):
    """The device module around the host registered, or no CUDA device."""
    snapshot = list(registry.devices)
    if request.param == "registered":
        dev = init_cuda_devices(device="cpu")[0]
    else:
        registry.devices = [d for d in snapshot if d.type != "cuda"]
        dev = None
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def _run(tp, dev, nb_cores=2):
    ctx = Context(nb_cores=nb_cores)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        if dev is not None:
            dev.flush_cache()
    finally:
        ctx.fini()


def _jrun(tp):
    ctx = JContext(nb_cores=0)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
    finally:
        ctx.fini()


def _jax_cholesky(a):
    A = JSym.from_dense("A", a.copy(), NB, NB)
    _jrun(jchol.tiled_cholesky_ptg(A, devices="cpu"))
    return np.tril(A.to_dense())


@pytest.mark.parametrize("uplo", [0, 1])
def test_auto_cholesky_matches_the_jax_factor(device, uplo):
    a = chol.make_spd(N, seed=4)
    A = SymTwoDimBlockCyclic.from_dense("A", a.copy(), NB, NB, uplo=uplo)
    tp = chol.tiled_cholesky_ptg(A, devices="auto")
    assert all([c.device_type for c in tc.chores] == ["cuda", "cpu"]
               for tc in tp.task_classes)
    factor.host_runs.clear()
    before = device.executed_tasks if device is not None else 0
    _run(tp, device)
    ntasks = tp.nb_local_tasks()
    if device is not None:
        assert device.executed_tasks - before == ntasks
        assert sum(factor.host_runs.values()) == 0
    else:
        assert sum(factor.host_runs.values()) == ntasks
    got = A.to_dense()
    jl = _jax_cholesky(a)
    want = np.linalg.cholesky(a.astype(np.float64))
    if uplo == 0:
        got = np.tril(got)
        np.testing.assert_allclose(got, jl, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        got = np.triu(got)
        np.testing.assert_allclose(got, jl.T, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, want.T, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.T.astype(np.float64) @ got, a,
                                   rtol=1e-4, atol=1e-4)


def test_auto_lu_matches_the_jax_factor(device):
    a = lu.make_dd(N, seed=2)
    A = TiledMatrix.from_dense("A", a.copy(), NB, NB)
    tp = lu.tiled_lu_ptg(A, devices="auto")
    factor.host_runs.clear()
    _run(tp, device)
    ntasks = tp.nb_local_tasks()
    runs = sum(factor.host_runs.values())
    assert runs == (0 if device is not None else ntasks)
    jA = JTiled.from_dense("A", a.copy(), NB, NB)
    _jrun(jlu.tiled_lu_ptg(jA, devices="cpu"))
    np.testing.assert_allclose(A.to_dense(), jA.to_dense(), rtol=TOL,
                               atol=TOL)
    f = A.to_dense().astype(np.float64)
    unit = np.tril(f, -1) + np.eye(N)
    np.testing.assert_allclose(unit @ np.triu(f), a, rtol=1e-4, atol=1e-3)


def test_the_host_chore_counts_by_class():
    """With host chores alone every class's runs count in ``host_runs``:
    the Cholesky's enumerated execution spaces."""
    a = chol.make_spd(N, seed=1)
    A = SymTwoDimBlockCyclic.from_dense("A", a, NB, NB)
    factor.host_runs.clear()
    _run(chol.tiled_cholesky_ptg(A, devices="cpu"), None, nb_cores=0)
    nt = N // NB
    assert dict(factor.host_runs) == {
        "POTRF": nt, "TRSM": nt * (nt - 1) // 2, "SYRK": nt * (nt - 1) // 2,
        "GEMM": nt * (nt - 1) * (nt - 2) // 6}


def test_the_upper_cholesky_on_the_cuda_chores(device):
    """``devices="cuda"`` over the upper distribution, on the device
    module: the upper factor; with no CUDA device the pool fails."""
    a = chol.make_spd(N, seed=6)
    A = SymTwoDimBlockCyclic.from_dense("A", a.copy(), NB, NB, uplo=1)
    tp = chol.tiled_cholesky_ptg(A)
    if device is None:
        with pytest.raises(Exception):
            _run(tp, None, nb_cores=0)
        return
    _run(tp, device)
    want = np.linalg.cholesky(a.astype(np.float64)).T
    np.testing.assert_allclose(np.triu(A.to_dense()), want, rtol=TOL,
                               atol=TOL)


def test_the_upper_pool_is_the_lower_pool_with_typed_edges():
    """The same classes, task counts and edges; every collection read of
    the upper pool carries the ``transposed`` type, and the lowering
    refuses it (typed edges reshape on the dynamic path)."""
    a = chol.make_spd(N, seed=1)
    lower = chol.tiled_cholesky_ptg(
        SymTwoDimBlockCyclic.from_dense("A", a, NB, NB), devices="cpu")
    upper = chol.tiled_cholesky_ptg(
        SymTwoDimBlockCyclic.from_dense("A", a, NB, NB, uplo=1),
        devices="cpu")
    assert upper.nb_local_tasks() == lower.nb_local_tasks()
    for lt, ut in zip(lower.task_classes, upper.task_classes):
        assert lt.name == ut.name
        for lf, uf in zip(lt.flows, ut.flows):
            for ld, ud in zip(lf.deps_in, uf.deps_in):
                if ud.data_ref is not None:
                    assert ld.dtt is None
                    assert ud.dtt.layout == "transposed"
    with pytest.raises(LoweringError):
        lower_taskpool(upper, device="cpu")


def test_the_transposed_layout_converts_both_ways():
    t = torch.arange(6.0).reshape(2, 3)
    row = TileType((2, 3))
    tr = TileType((2, 3), layout="transposed")
    sq = torch.arange(9.0).reshape(3, 3)
    assert torch.equal(convert(sq, TileType((3, 3)),
                               TileType((3, 3), layout="transposed")), sq.T)
    assert torch.equal(convert(convert(sq, TileType((3, 3)),
                                       TileType((3, 3), layout="transposed")),
                               TileType((3, 3), layout="transposed"),
                               TileType((3, 3))), sq)
    assert row != tr and convert(t, row, row) is t

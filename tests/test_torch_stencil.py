"""The stencil slice as a whole: the 1-D and 2-D stencil taskpools of the
port (``parsec_tpu_torch/models/stencil.py``, ``stencil2d.py``) against
the JAX package's, on the same numpy tiles, through the dynamic runtime
(``Context``, host bodies) and through the lowering (``lower_taskpool``
with ``device="cpu"``: the wavefront pass, the traceable calling K3's
wrapper, which takes its plain version on CPU tensors).

Tolerances: the dynamic bodies compute in float64 on float64 tiles in
both packages, ``rtol=1e-10``; the lowered stencils compute in fp32
(JAX runs with x64 off), ``rtol=2e-5, atol=2e-5`` against the float64
oracle and ``rtol=1e-5`` between the packages (random weights grow the
values to O(1e3) over 7 iterations, and the two sum in another order);
the 2-D stencil in fp32 ``rtol=1e-4, atol=1e-5`` as in
``tests/test_stencil2d.py``; bf16 tiles, a bf16 ulp.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.data_dist.matrix import TiledMatrix as JTiledMatrix
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVector
from parsec_tpu.models.stencil import stencil_1d_ptg as j_stencil_1d
from parsec_tpu.models.stencil import stencil_reference as j_reference
from parsec_tpu.models.stencil2d import stencil_2d_ptg as j_stencil_2d
from parsec_tpu.models.stencil2d import stencil2d_reference as j_ref2d
from parsec_tpu.ptg.lowering import lower_taskpool as j_lower
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch.data_dist.matrix import TiledMatrix, VectorTwoDimCyclic
from parsec_tpu_torch.models.stencil import (run_stencil_bench,
                                             stencil_1d_ptg, stencil_flops,
                                             stencil_reference)
from parsec_tpu_torch.models.stencil2d import (stencil2d_flops,
                                               stencil2d_reference,
                                               stencil_2d_ptg)
from parsec_tpu_torch.ops import stencil as ks
from parsec_tpu_torch.ptg.lowering import lower_taskpool
from parsec_tpu_torch.runtime import Context

W2D = (0.5, 0.15, 0.15, 0.1, 0.1)


def _vectors(base, mb):
    """The JAX package's vector and the port's over the same segments."""
    init = lambda m, size: base[m * mb:m * mb + size]   # noqa: E731
    return (JVector("V", lm=len(base), mb=mb, dtype=base.dtype,
                    init_fn=init),
            VectorTwoDimCyclic("V", lm=len(base), mb=mb, dtype=base.dtype,
                               init_fn=init))


def _segments(V):
    return np.concatenate([np.asarray(V.data_of(i).newest_copy().value)
                           for i in range(V.mt)])


def _port_segments(V):
    v = torch.cat([V.data_of(i).newest_copy().value for i in range(V.mt)])
    return (v.float() if v.dtype == torch.bfloat16 else v).numpy()


@pytest.mark.parametrize("radius,iters", [(1, 1), (2, 4), (4, 7)])
@pytest.mark.parametrize("nb_cores", [0, 3])
def test_dynamic_1d_matches_jax_and_reference(nb_cores, radius, iters):
    rng = np.random.default_rng(0)
    base = rng.standard_normal(64)
    w = rng.standard_normal(2 * radius + 1)
    JV, V = _vectors(base, 16)
    with JContext(nb_cores=nb_cores) as ctx:
        ctx.add_taskpool(j_stencil_1d(JV, w, iters))
        ctx.wait(timeout=60)
    with Context(nb_cores=nb_cores) as ctx:
        ctx.add_taskpool(stencil_1d_ptg(V, w, iters))
        ctx.wait(timeout=60)
    got = _port_segments(V)
    np.testing.assert_allclose(got, _segments(JV), rtol=1e-10)
    np.testing.assert_allclose(got, stencil_reference(base, w, iters).numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(got, j_reference(base, w, iters), rtol=1e-10)


@pytest.mark.parametrize("shape,tile,iters", [
    ((24, 24), (8, 8), 1),
    ((24, 24), (8, 8), 5),
    ((16, 32), (8, 8), 4),
    ((24, 24), (24, 24), 3)])      # single tile: every ghost flow inactive
def test_dynamic_2d_matches_jax_and_reference(shape, tile, iters):
    dense = np.random.default_rng(1).standard_normal(shape).astype(
        np.float32)
    JM = JTiledMatrix.from_dense("M", dense.copy(), *tile)
    M = TiledMatrix.from_dense("M", dense.copy(), *tile)
    with JContext(nb_cores=0) as ctx:
        ctx.add_taskpool(j_stencil_2d(JM, W2D, iters))
        ctx.wait(timeout=60)
    with Context(nb_cores=2) as ctx:
        ctx.add_taskpool(stencil_2d_ptg(M, W2D, iters))
        ctx.wait(timeout=60)
    got = M.to_tensor().numpy()
    np.testing.assert_allclose(got, JM.to_dense(), rtol=1e-6, atol=1e-6)
    want = stencil2d_reference(dense, W2D, iters).numpy()
    np.testing.assert_allclose(want, j_ref2d(dense, W2D, iters), rtol=1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("radius", [1, 2, 4])
@pytest.mark.parametrize("iters", [1, 4, 7])
def test_lowered_1d_matches_jax_and_reference(radius, iters):
    rng = np.random.default_rng(radius * 10 + iters)
    base = rng.standard_normal(64).astype(np.float32)
    w = rng.standard_normal(2 * radius + 1)
    JV, V = _vectors(base, 16)
    jlow = j_lower(j_stencil_1d(JV, w, iters))
    low = lower_taskpool(stencil_1d_ptg(V, w, iters), device="cpu")
    assert low.mode == jlow.mode == "wavefront"
    assert low.written_collections == jlow.written_collections == {"V"}
    jlow.execute()
    low.execute()
    got = _port_segments(V)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _segments(JV), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, stencil_reference(base, w, iters).numpy(),
                               rtol=2e-5, atol=2e-5)


def test_lowered_1d_leaves_the_snapshot_and_launches_nothing_on_cpu():
    """The in-place versions parked on the snapshot's rows are restored at
    the end of the step (only V is written back), and the CPU path
    launches no kernel."""
    base = np.random.default_rng(3).standard_normal(48).astype(np.float32)
    _, V = _vectors(base, 8)
    tp = stencil_1d_ptg(V, np.array([0.25, 0.5, 0.25]), 5)
    low = lower_taskpool(tp, device="cpu")
    before = ks.stencil1d.launches
    out = low.execute()
    assert ks.stencil1d.launches == before
    np.testing.assert_array_equal(out["V_0"].reshape(-1).numpy(), base)
    assert low.written_collections == {"V"}


def test_lowered_1d_bf16_tiles_match_jax():
    base = np.random.default_rng(4).standard_normal(64).astype(
        ml_dtypes.bfloat16)
    w = np.array([0.1, 0.2, 0.4, 0.2, 0.1])
    JV, V = _vectors(base, 16)
    j_lower(j_stencil_1d(JV, w, 3)).execute()
    lower_taskpool(stencil_1d_ptg(V, w, 3), device="cpu").execute()
    assert V.data_of(0).newest_copy().value.dtype == torch.bfloat16
    np.testing.assert_allclose(_port_segments(V),
                               _segments(JV).astype(np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("shape,tile,iters", [
    ((24, 24), (8, 8), 4), ((16, 32), (8, 8), 1)])
def test_lowered_2d_matches_jax_and_reference(shape, tile, iters):
    dense = np.random.default_rng(5).standard_normal(shape).astype(
        np.float32)
    JM = JTiledMatrix.from_dense("M", dense.copy(), *tile)
    M = TiledMatrix.from_dense("M", dense.copy(), *tile)
    jlow = j_lower(j_stencil_2d(JM, W2D, iters))
    low = lower_taskpool(stencil_2d_ptg(M, W2D, iters), device="cpu")
    assert low.mode == jlow.mode == "wavefront"
    jlow.execute()
    low.execute()
    got = M.to_tensor().numpy()
    np.testing.assert_allclose(got, JM.to_dense(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, j_ref2d(dense, W2D, iters), rtol=1e-4,
                               atol=1e-5)


def test_halo_edges_carry_their_wire_views():
    """``output(wire=...)`` is stored on the dep (unused on one rank)."""
    M = TiledMatrix("M", 16, 16, 8, 8)
    tc = stencil_2d_ptg(M, W2D, 2).task_classes[0]
    wires = [d.wire for f in tc.flows if f.name == "C" for d in f.deps_out
             if d.target_flow in ("N", "S", "W", "E")]
    assert wires == [(slice(-1, None), slice(None)),
                     (slice(0, 1), slice(None)),
                     (slice(None), slice(-1, None)),
                     (slice(None), slice(0, 1))]


def test_flop_formulas_and_the_dynamic_bench():
    assert stencil_flops(100, 4, 10) == 2.0 * 9 * 100 * 10
    assert stencil2d_flops(8, 16, 3) == 2.0 * 5 * 8 * 16 * 3
    out = run_stencil_bench(n=1 << 12, mb=1 << 10, radius=2, iterations=3,
                            nb_cores=0)
    assert out["n"] == 1 << 12 and out["gflops"] > 0 and out["seconds"] > 0


def test_bad_stencil_arguments_raise():
    V = VectorTwoDimCyclic("V", lm=16, mb=4)
    with pytest.raises(ValueError, match="odd"):
        stencil_1d_ptg(V, [0.5, 0.5], 1)
    with pytest.raises(ValueError, match="radius"):
        stencil_1d_ptg(V, np.ones(11), 1)
    with pytest.raises(ValueError, match="ranks"):
        VectorTwoDimCyclic("V", lm=16, mb=4, P=0)
    # vectors over several ranks are ported: segment m on rank m % P
    assert [VectorTwoDimCyclic("V", lm=16, mb=4, P=2).rank_of(m)
            for m in range(4)] == [0, 1, 0, 1]

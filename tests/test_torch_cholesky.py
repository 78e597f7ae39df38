"""The port's tiled Cholesky against the JAX package's, on the CPU.

The same SPD input (``make_spd`` from a seed, equal bit for bit in both
packages) is factored by ``parsec_tpu``'s ``tiled_cholesky_ptg(devices=
"cpu")`` through its ``Context`` and by the port, both through its
device module wrapped around the host (``devices="cuda"`` chores on
``init_cuda_devices(device="cpu")``, so the batched bodies run their
plain forms in fused batches) and through its host chores
(``devices="cpu"``); the lowered pools of both packages are held against
each other too, and so are the four incarnations against the JAX
traceables, and the symmetric distribution's rules against the JAX
package's.

Tolerances: the factors of the two packages agree to
``rtol=1e-4, atol=1e-5`` (fp32 on both sides; the JAX host bodies solve
the TRSM directly where the port multiplies by the inverse, and the sums
run in other orders: a few fp32 ulps of entries of order 1, growing
slowly along the k chain); against the float64 factor, the JAX package's
own ``rtol=1e-3, atol=1e-4`` (``tests/test_cholesky.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.models import cholesky as jchol
from parsec_tpu.ptg.lowering import lower_taskpool as j_lower
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch.data_dist.collection import enumerate_keys
from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                               TiledMatrix,
                                               TwoDimBlockCyclic)
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models import cholesky as chol
from parsec_tpu_torch.ops import factor
from parsec_tpu_torch.ops import gemm as tg
from parsec_tpu_torch.ptg.lowering import find_traceable, lower_taskpool
from parsec_tpu_torch.runtime import Context

PKG_TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-3, atol=1e-4)
CLASSES = ("POTRF", "TRSM", "SYRK", "GEMM")


@pytest.fixture
def cpu_cuda_device():
    """The port's CUDA device module around the host CPU, registered for
    the test and unregistered after."""
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


def _jax_run(a, nb):
    """The JAX package's host-chore Cholesky: its lower factor, its task
    counts by class (the enumerated execution spaces) and its host tiles
    before the run."""
    A = JSym.from_dense("A", a, nb, nb)
    tiles = {(m, n): np.array(A.data_of(m, n).newest_copy().value)
             for m in range(A.mt) for n in range(m + 1)}
    tp = jchol.tiled_cholesky_ptg(A, devices="cpu")
    counts = {name: len(list(tp._tc_builders[name]._enumerate_space()))
              for name in CLASSES}
    ctx = JContext(nb_cores=0)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
    finally:
        ctx.fini(timeout=30)
    return np.tril(A.to_dense()), counts, tiles


def _port_run(tiles, n, nb, devices, nb_cores):
    A = SymTwoDimBlockCyclic.from_numpy_tiles("A", tiles, n, n, nb, nb)
    ctx = Context(nb_cores=nb_cores)
    try:
        ctx.add_taskpool(chol.tiled_cholesky_ptg(A, devices=devices))
        ctx.wait(timeout=120)
    finally:
        ctx.fini(timeout=30)
    return np.tril(A.to_dense())


@pytest.mark.parametrize("nb_cores", [0, 2])
@pytest.mark.parametrize("n,nb", [(256, 64), (200, 64)])
def test_device_module_matches_jax_package(cpu_cuda_device, n, nb,
                                           nb_cores):
    a = chol.make_spd(n, seed=1)
    want, counts, tiles = _jax_run(a, nb)
    got = _port_run(tiles, n, nb, "cuda", nb_cores)
    np.testing.assert_allclose(got, want, **PKG_TOL)
    np.testing.assert_allclose(got, np.linalg.cholesky(a.astype(np.float64)),
                               **F64_TOL)
    assert dict(cpu_cuda_device.tasks_by_class) == counts
    assert cpu_cuda_device.executed_tasks == sum(counts.values())
    if n % nb == 0:      # a ragged edge splits batches by tile shape
        assert cpu_cuda_device.batched_dispatches > 0   # fused batches
    assert tg.gemm_update.launches == 0             # host tensors: no kernel


@pytest.mark.parametrize("n,nb", [(256, 64), (200, 64)])
def test_host_chores_match_jax_package(n, nb):
    a = chol.make_spd(n, seed=2)
    want, _, tiles = _jax_run(a, nb)
    got = _port_run(tiles, n, nb, "cpu", 2)
    np.testing.assert_allclose(got, want, **PKG_TOL)


def test_task_counts_follow_the_triangle():
    a = chol.make_spd(96, seed=3)
    tp = chol.tiled_cholesky_ptg(SymTwoDimBlockCyclic.from_dense("A", a, 16,
                                                                 16))
    counts = {name: len(list(tp._tc_builders[name]._enumerate_space()))
              for name in CLASSES}
    assert counts == {"POTRF": 6, "TRSM": 15, "SYRK": 15, "GEMM": 20}


def test_lowered_matches_jax_lowering():
    """``lower_taskpool(..., device="cpu")`` against the JAX package's
    lowering on the CPU: both take the wavefront pass (chain collapse
    never claims the pool: no body is bilinear) and give the same
    factor, whether the pass is chosen or forced."""
    n, nb = 256, 64
    a = chol.make_spd(n, seed=4)
    JA = JSym.from_dense("A", a, nb, nb)
    jlow = j_lower(jchol.tiled_cholesky_ptg(JA))
    jlow.execute()
    assert jlow.mode == "wavefront"
    for passes in ("auto", "wavefront"):
        A = SymTwoDimBlockCyclic.from_dense("A", a, nb, nb)
        low = lower_taskpool(chol.tiled_cholesky_ptg(A), passes=passes,
                             device="cpu")
        assert low.mode == "wavefront"
        assert (low.levels, low.groups) == (10, 12)
        # the stores hold the lower tiles only
        assert low.initial_stores()["A"].shape == (10, nb, nb)
        low.execute()
        np.testing.assert_allclose(np.tril(A.to_dense()),
                                   np.tril(JA.to_dense()), **PKG_TOL)


def test_lowered_plan_size_at_the_bench_tile_count():
    """At 32x32 tiles (the JAX bench's n=16384, nb=512, here on 2x2
    tiles) the plan has 94 levels in 124 batched calls."""
    A = SymTwoDimBlockCyclic.from_dense("A", chol.make_spd(64, seed=5), 2, 2)
    low = lower_taskpool(chol.tiled_cholesky_ptg(A), device="cpu")
    assert (low.mode, low.levels, low.groups) == ("wavefront", 94, 124)


def test_no_incarnation_is_bilinear():
    for name in ("potrf", "trsm_rlt", "syrk_ln", "gemm_nt"):
        tr = find_traceable(name)
        assert tr is not None and tr.stacked is not None
        assert not tr.bilinear and tr.chain_combine is None


# ---------------------------------------------------------------------------
# the four incarnations against the JAX traceables
# ---------------------------------------------------------------------------

def _tiles(seed, count, nb=48):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((nb, nb)).astype(np.float32)
            for _ in range(count)]


def _lower_factors(count, nb=48, seed=6):
    return [np.linalg.cholesky(chol.make_spd(nb, seed + i)).astype(np.float32)
            for i in range(count)]


def test_incarnations_match_jax_traceables():
    """Each list form and stacked form against the JAX traceable on the
    same inputs (``vmap`` being a loop of its calls)."""
    spd = [chol.make_spd(48, seed=s) for s in (7, 8)]
    ls = _lower_factors(3)
    cs, as_, bs = _tiles(9, 3), _tiles(10, 3), _tiles(11, 3)
    cases = [
        (chol.potrf_tiles([torch.from_numpy(x) for x in spd]),
         [jchol._potrf_traceable(jnp.asarray(x)) for x in spd]),
        (chol.trsm_tiles([torch.from_numpy(x) for x in ls],
                         [torch.from_numpy(x) for x in cs]),
         [jchol._trsm_traceable(jnp.asarray(x), jnp.asarray(c))
          for x, c in zip(ls, cs)]),
        (chol.syrk_tiles([torch.from_numpy(x) for x in as_],
                         [torch.from_numpy(x) for x in cs]),
         [jchol._syrk_traceable(jnp.asarray(x), jnp.asarray(c))
          for x, c in zip(as_, cs)]),
        (chol.gemm_nt_tiles([torch.from_numpy(x) for x in as_],
                            [torch.from_numpy(x) for x in bs],
                            [torch.from_numpy(x) for x in cs]),
         [jchol._gemm_nt_traceable(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(c))
          for x, y, c in zip(as_, bs, cs)])]
    for got, want in cases:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.is_contiguous()
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)
    stk = lambda xs: torch.from_numpy(np.stack(xs))  # noqa: E731
    np.testing.assert_allclose(chol.potrf(stk(spd)).numpy(),
                               np.stack([x.numpy() for x in cases[0][0]]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        chol.trsm_stacked(stk(ls), stk(cs)).numpy(),
        np.stack([x.numpy() for x in cases[1][0]]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        chol.syrk_stacked(stk(as_), stk(cs)).numpy(),
        np.stack([x.numpy() for x in cases[2][0]]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        chol.gemm_nt_stacked(stk(as_), stk(bs), stk(cs)).numpy(),
        np.stack([x.numpy() for x in cases[3][0]]), rtol=1e-5, atol=1e-5)


def test_trsm_shares_one_inverse_per_diagonal_tile(monkeypatch):
    """A batch of TRSMs under one POTRF solves once; a broadcast diagonal
    tile in a stacked group solves once too."""
    solves = []
    real = torch.linalg.solve_triangular

    def counting(a, b, **kw):
        solves.append(tuple(a.shape))
        return real(a, b, **kw)

    monkeypatch.setattr(torch.linalg, "solve_triangular", counting)
    L = torch.from_numpy(_lower_factors(2)[0])
    L2 = torch.from_numpy(_lower_factors(2)[1])
    cs = [torch.from_numpy(c) for c in _tiles(12, 4)]
    got = chol.trsm_tiles([L, L, L2, L], cs)
    assert solves == [(2, 48, 48)]
    for g, c, x in zip(got, cs, [L, L, L2, L]):
        torch.testing.assert_close(g, c @ torch.linalg.inv(x).T,
                                   rtol=1e-4, atol=1e-4)
    solves.clear()
    stacked = chol.trsm_stacked(L[None].expand(4, 48, 48), torch.stack(cs))
    assert solves == [(1, 48, 48)]
    torch.testing.assert_close(stacked, torch.stack(chol.trsm_tiles(
        [L] * 4, cs)), rtol=1e-6, atol=1e-6)


def test_potrf_gives_nans_where_the_tile_is_not_spd():
    bad = -torch.eye(8)
    good = torch.from_numpy(chol.make_spd(8, seed=13))
    out = factor.potrf(torch.stack([good, bad]))
    assert bool(torch.isfinite(out[0]).all()) and bool(out[1].isnan().all())
    assert out.is_contiguous()


def test_factor_ops_refuse_other_devices():
    t = torch.empty(2, 4, 4, device="meta")
    for fn in (factor.potrf, factor.getrf_nopiv,
               lambda x: factor.tri_inverse(x, upper=False)):
        with pytest.raises(ValueError, match="no route"):
            fn(t)


def test_constructors_and_flops_match_jax():
    np.testing.assert_array_equal(chol.make_spd(40, seed=3),
                                  jchol.make_spd(40, seed=3))
    np.testing.assert_array_equal(chol.make_spd_fast(40, seed=3),
                                  jchol.make_spd_fast(40, seed=3))
    assert chol.cholesky_flops(1000) == jchol.cholesky_flops(1000)


@pytest.mark.parametrize("case", ["devices", "square", "upper"])
def test_builder_refuses_what_it_cannot_factor(case):
    a = chol.make_spd(32, seed=1)
    kw = {}
    A = SymTwoDimBlockCyclic.from_dense("A", a, 8, 8)
    if case == "devices":
        kw = dict(devices="auto")
    elif case == "square":
        A = TiledMatrix.from_dense("A", a[:, :24], 8, 8)
    else:
        A = SymTwoDimBlockCyclic.from_dense("A", a, 8, 8, uplo=1)
    with pytest.raises(ValueError):
        chol.tiled_cholesky_ptg(A, **kw)


# ---------------------------------------------------------------------------
# the symmetric and block-cyclic distributions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("uplo", [0, 1])
def test_symmetric_triangle_rules_match_jax(uplo):
    a = chol.make_spd(40, seed=14)
    J = JSym.from_dense("A", a, 16, 16, uplo=uplo)
    P = SymTwoDimBlockCyclic.from_dense("A", a, 16, 16, uplo=uplo)
    for m in range(-1, 4):
        for n in range(-1, 4):
            assert P.has_tile(m, n) == J.has_tile(m, n), (m, n)
            if 0 <= m < 3 and 0 <= n < 3 and not J.has_tile(m, n):
                for obj in (P, J):
                    with pytest.raises(KeyError):
                        obj.data_of(m, n)
                    with pytest.raises(KeyError):
                        obj.rank_of(m, n)
    assert enumerate_keys(P) == [(m, n) for m in range(3)
                                 for n in range(3) if J.has_tile(m, n)]
    dense = P.to_dense()
    for m, n in [(m, n) for m in range(3) for n in range(3)]:
        blk = dense[m * 16:(m + 1) * 16, n * 16:(n + 1) * 16]
        want = a[m * 16:(m + 1) * 16, n * 16:(n + 1) * 16] \
            if P.has_tile(m, n) else 0.0
        np.testing.assert_array_equal(blk, want)
    torch.testing.assert_close(P.to_tensor(), torch.from_numpy(dense))


def test_symmetric_tiles_round_trip_through_the_jax_package():
    a = chol.make_spd(40, seed=15)
    J = JSym.from_dense("A", a, 16, 16)
    tiles = {k: np.asarray(J.data_of(*k).newest_copy().value)
             for k in [(m, n) for m in range(3) for n in range(m + 1)]}
    P = SymTwoDimBlockCyclic.from_numpy_tiles("A", tiles, 40, 40, 16, 16)
    back = P.to_numpy_tiles()
    assert sorted(back) == sorted(tiles)
    for k, v in tiles.items():
        np.testing.assert_array_equal(back[k], v)
    del tiles[(2, 1)]
    with pytest.raises(KeyError, match="missing"):
        SymTwoDimBlockCyclic.from_numpy_tiles("A", tiles, 40, 40, 16, 16)


@pytest.mark.parametrize("kw", [dict(P=2), dict(Q=2), dict(kp=2),
                                dict(uplo=2)])
def test_distributions_refuse_more_than_one_rank(kw):
    # the P x Q grid is ported: a grid of 2 spreads the tiles over two
    # ranks, and a grid parameter below 1 is refused; uplo is checked
    if "uplo" in kw:
        with pytest.raises(ValueError):
            SymTwoDimBlockCyclic("A", 32, 32, 8, 8, **kw)
        return
    grid = dict(P=2, **kw) if "kp" in kw else kw      # kp groups P's rows
    A = TwoDimBlockCyclic("A", 32, 32, 8, 8, **grid)
    assert {A.rank_of(m, n) for m in range(4) for n in range(4)} == {0, 1}
    with pytest.raises(ValueError):
        TwoDimBlockCyclic("A", 32, 32, 8, 8, **{k: 0 for k in kw})


def test_block_cyclic_is_a_tiled_matrix_on_rank_0():
    a = np.arange(24 * 24, dtype=np.float32).reshape(24, 24)
    A = TwoDimBlockCyclic.from_dense("A", a, 8, 8)
    assert isinstance(A, TiledMatrix) and (A.mt, A.nt) == (3, 3)
    assert {A.rank_of(m, n) for m in range(3) for n in range(3)} == {0}
    np.testing.assert_array_equal(A.to_dense(), a)



def test_tile_error_reads_each_part_of_each_tile_apart():
    """``tile_error`` holds each tile's parts below, on and above the
    diagonal on their own scale: a 1% error in one off-diagonal tile of
    a diagonally dominant factor reads 1e-2, where the whole-matrix norm
    reads it 2e-4 (at n=256; less as n grows); a nonzero where the reference holds zeros reads
    infinite; identical factors read 0."""
    n, nb = 256, 64
    want = torch.linalg.cholesky(torch.from_numpy(
        chol.make_spd_fast(n, seed=3)).double())
    assert factor.tile_error(want, want, nb) == 0.0
    got = want.clone()
    got[128:192, 64:128] *= 1.01
    assert factor.tile_error(got, want, nb) == pytest.approx(1e-2, rel=1e-6)
    whole = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert whole < 1e-3
    got = want.clone()
    got[0, 1] = 1e-30
    assert factor.tile_error(got, want, nb) == float("inf")
    with pytest.raises(ValueError):
        factor.tile_error(want, want, 60)


@pytest.mark.parametrize("path", ["dynamic", "lowered"])
@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_tile_error_sees_one_dropped_update(cpu_cuda_device, kind, path):
    """The factor gate's control, on the host: each path once as it is
    (strict fp32 here, under 1e-5 against the float64 factor) and once
    with the first C tile of the trailing update's first call passed
    through, which reads what ``PERF.md`` predicts for one dropped
    update (``1.25 sqrt(nb)/n`` on ``make_spd_fast``, ``sqrt(nb)/n`` on
    ``make_dd``) within 25%."""
    from parsec_tpu_torch.models import lu
    n, nb = 256, 64
    mod, name = (chol, "gemm_nt") if kind == "cholesky" else (lu, "lu_gemm")
    if kind == "cholesky":
        a = chol.make_spd_fast(n, seed=8)
        want = torch.linalg.cholesky(torch.from_numpy(a).double())
        predicted = 1.25 * nb ** 0.5 / n
    else:
        a = lu.make_dd(n, seed=8)
        # the float64 rank-1 loop: PyTorch's nopiv LU is card-only
        w = torch.from_numpy(a).double()
        for j in range(n - 1):
            w[j + 1:, j] /= w[j, j]
            w[j + 1:, j + 1:] -= w[j + 1:, j, None] * w[j, None, j + 1:]
        want = w
        predicted = nb ** 0.5 / n

    def run():
        cls = SymTwoDimBlockCyclic if kind == "cholesky" else TiledMatrix
        A = cls.from_dense("A", a.copy(), nb, nb)
        tp = mod.tiled_cholesky_ptg(A) if kind == "cholesky" \
            else mod.tiled_lu_ptg(A)
        if path == "lowered":
            lower_taskpool(tp, device="cpu").execute()
        else:
            ctx = Context(nb_cores=0)
            try:
                ctx.add_taskpool(tp)
                ctx.wait(timeout=120)
            finally:
                ctx.fini(timeout=30)
            cpu_cuda_device.flush_cache()
        f = torch.from_numpy(A.to_dense()).double()
        return factor.tile_error(torch.tril(f) if kind == "cholesky" else f,
                                 want, nb)

    assert run() < 1e-5
    with factor.one_update_dropped(name, *mod._FORMS[name]) as dropped:
        assert run() == pytest.approx(predicted, rel=0.25)
    assert dropped == [1]
    assert run() < 1e-5           # the forms are back

"""The app tier of the port against the JAX package's: the binomial-forest
reduction, pingpong, the adaptive Haar tree, the DTD merge sort and the
all-to-all (``tests/test_apps_reduction.py``, ``tests/test_irregular.py``).

Each case builds one seeded numpy input and runs it through both
packages' builders: the forest arithmetic equal, the reduced tile equal
to the JAX run's and the float64 sum (``rtol=1e-5, atol=1e-5``: fp32
tiles, the same tree order on both sides), pingpong's chain state exact,
the Haar tree's nodes equal and its values within ``1e-12``, the sort
exact, the all-to-all within ``rtol=1e-5`` of its reference; across
ranks, each rank's task count equal to the JAX run's.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVector
from parsec_tpu.dtd import DTDTaskpool as JDTDTaskpool
from parsec_tpu.models import irregular as j_irr
from parsec_tpu.models import pingpong as j_pp
from parsec_tpu.models import reduction as j_red
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic
from parsec_tpu_torch.dtd import DTDTaskpool
from parsec_tpu_torch.models import irregular, pingpong, reduction
from parsec_tpu_torch.runtime import Context

PKG = {"port": (VectorTwoDimCyclic, reduction, pingpong, irregular, Context,
                DTDTaskpool, run_multirank),
       "jax": (JVector, j_red, j_pp, j_irr, JContext, JDTDTaskpool,
               j_run_multirank)}


def _value(copy):
    v = copy.value
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# the binomial forest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 12, 13, 21, 32, 37, 100])
def test_the_forest_arithmetic_equals_the_jax_forest(n):
    for fn in ("count_bits",):
        assert getattr(reduction, fn)(n) == getattr(j_red, fn)(n)
    T = reduction.count_bits(n)
    for t in range(1, T + 1):
        assert reduction.tree_bit(n, t) == j_red.tree_bit(n, t)
        assert reduction.tree_offset(n, t) == j_red.tree_offset(n, t)
    for i in range(n):
        assert reduction.index_to_tree(n, i) == j_red.index_to_tree(n, i)
        assert reduction.local_index(n, i) == j_red.local_index(n, i)


def _vec(pkg, nt, nranks=1, rank=0, mb=4, seed=0):
    base = np.random.default_rng(seed).standard_normal((nt, mb)).astype(
        np.float32)
    V = PKG[pkg][0]("A", lm=nt * mb, mb=mb, P=nranks, myrank=rank,
                    init_fn=lambda m, size: base[m, :size].copy())
    return base, V


def _reduce_one(pkg, nt, op=None, nb_cores=0):
    base, V = _vec(pkg, nt, seed=nt)
    tp = PKG[pkg][1].bt_reduction_ptg(V, op=op)
    with PKG[pkg][4](nb_cores=nb_cores) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
    return base, _value(V.data_of(0).newest_copy()), tp.nb_local_tasks()


@pytest.mark.parametrize("nt", [1, 2, 3, 5, 8, 13, 16, 21, 37])
def test_the_reduction_sums_as_the_jax_reduction(nt):
    base, got, ntasks = _reduce_one("port", nt)
    _, want, jtasks = _reduce_one("jax", nt)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, base.astype(np.float64).sum(axis=0),
                               rtol=1e-5, atol=1e-5)
    assert ntasks == jtasks


def test_a_custom_operator_reduces_as_in_the_jax_package():
    base, got, _ = _reduce_one("port", 8, op=torch.maximum, nb_cores=2)
    _, want, _ = _reduce_one("jax", 8, op=np.maximum, nb_cores=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.max(axis=0))


def _reduc_rank_body(pkg):
    def body(ctx, rank, nranks):
        base, V = _vec(pkg, 13, nranks=nranks, rank=rank, seed=9)
        tp = PKG[pkg][1].bt_reduction_ptg(V)
        ctx.add_taskpool(tp)
        ntasks = tp.nb_local_tasks()
        ctx.wait(timeout=180)
        ctx.comm_barrier()
        got = _value(V.data_of(0).newest_copy()) if V.rank_of(0) == rank \
            else None
        return got, ntasks, base
    return body


def test_the_reduction_across_four_ranks_equals_the_jax_run():
    port = run_multirank(4, _reduc_rank_body("port"), timeout=180)
    jax = j_run_multirank(4, _reduc_rank_body("jax"), timeout=180)
    np.testing.assert_allclose(port[0][0], jax[0][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port[0][0], port[0][2].sum(axis=0),
                               rtol=1e-5, atol=1e-5)
    assert [r[1] for r in port] == [r[1] for r in jax]


# ---------------------------------------------------------------------------
# pingpong
# ---------------------------------------------------------------------------

def _ping_body(pkg, nt, mb=2):
    def body(ctx, rank, nranks):
        V = PKG[pkg][0]("A", lm=nranks * mb, mb=mb, P=nranks, myrank=rank,
                        init_fn=lambda m, size: np.zeros(size, np.float32))
        res = PKG[pkg][2].run_pingpong(ctx, V, nt)
        ctx.comm_barrier()
        return (_value(V.data_of(rank).newest_copy()), res["hops"],
                res["us_per_hop"], res["payload_bytes"])
    return body


@pytest.mark.parametrize("nranks", [1, 2, 3, 4])
def test_pingpong_leaves_the_jax_chain_state_on_every_rank(nranks):
    nt = 24
    port = run_multirank(nranks, _ping_body("port", nt), timeout=120)
    jax = j_run_multirank(nranks, _ping_body("jax", nt), timeout=120)
    for rank, (p, j) in enumerate(zip(port, jax)):
        # rank r's home tile holds the chain after its last hop
        last = max(k for k in range(nt) if k % nranks == rank)
        np.testing.assert_array_equal(p[0], np.full(2, last + 1.0))
        np.testing.assert_array_equal(p[0], j[0])
        assert p[1] == j[1] == nt and p[2] > 0
        assert p[3] == j[3] == 8


# ---------------------------------------------------------------------------
# the adaptive Haar tree (bodies insert their children)
# ---------------------------------------------------------------------------

def _haar(pkg, alpha, thresh, nb_cores, min_depth=4, max_depth=20):
    _, _, _, irr, Ctx, DTD, _ = PKG[pkg]
    with Ctx(nb_cores=nb_cores) as ctx:
        tp = DTD("haar")
        ctx.add_taskpool(tp)
        tree = irr.haar_project_dtd(tp, alpha, thresh, min_depth=min_depth,
                                    max_depth=max_depth)
        tp.wait(timeout=120)
    return tree


@pytest.mark.parametrize("nb_cores", [0, 4])
def test_the_haar_tree_is_the_jax_tree(nb_cores):
    tree = _haar("port", 1.0, 1e-4, nb_cores)
    want = j_irr.haar_project_reference(1.0, 1e-4, min_depth=4,
                                        max_depth=20)
    assert irregular.haar_project_reference(1.0, 1e-4, min_depth=4,
                                            max_depth=20) == want
    assert len(want) > 50
    assert set(tree) == set(want) == set(_haar("jax", 1.0, 1e-4, nb_cores))
    for k in want:
        np.testing.assert_allclose(tree[k], want[k], rtol=0, atol=1e-12)


def test_a_finer_threshold_discovers_a_larger_tree():
    coarse = _haar("port", 1.0, 1e-2, 0, min_depth=2)
    fine = _haar("port", 1.0, 1e-5, 0, min_depth=2)
    assert set(coarse) < set(fine)
    assert set(fine) == set(_haar("jax", 1.0, 1e-5, 0, min_depth=2))


# ---------------------------------------------------------------------------
# merge sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,run,nb_cores,dtype", [
    (1000, 64, 0, np.float32),
    (4096, 128, 2, np.float32),
    (777, 50, 2, np.float32),        # ragged runs, odd level widths
    (2000, 37, 0, np.int64),
])
def test_the_merge_sort_sorts_as_the_jax_merge_sort(n, run, nb_cores, dtype):
    rng = np.random.default_rng(n)
    data = (rng.standard_normal(n) if dtype == np.float32
            else rng.integers(0, 10 ** 6, size=n)).astype(dtype)
    with Context(nb_cores=nb_cores) as ctx:
        tp = DTDTaskpool("msort")
        ctx.add_taskpool(tp)
        out = irregular.merge_sort_dtd(tp, torch.from_numpy(data), run=run)
        tp.wait(timeout=120)
    with JContext(nb_cores=nb_cores) as ctx:
        tp = JDTDTaskpool("msort")
        ctx.add_taskpool(tp)
        jout = j_irr.merge_sort_dtd(tp, data, run=run)
        tp.wait(timeout=120)
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(out.numpy(), np.sort(data))


# ---------------------------------------------------------------------------
# all-to-all
# ---------------------------------------------------------------------------

def _a2a_body(pkg, nt, mb, rounds, seed):
    def body(ctx, rank, nranks):
        rng = np.random.default_rng(seed)
        a0 = rng.standard_normal((nt, mb)).astype(np.float32)
        b0 = rng.standard_normal((nt, mb)).astype(np.float32)
        Vec = PKG[pkg][0]
        A = Vec("A", lm=nt * mb, mb=mb, P=nranks, myrank=rank,
                init_fn=lambda m, size: a0[m, :size].copy())
        B = Vec("B", lm=nt * mb, mb=mb, P=nranks, myrank=rank,
                init_fn=lambda m, size: b0[m, :size].copy())
        tp = PKG[pkg][3].all2all_ptg(A, B, rounds)
        ctx.add_taskpool(tp)
        ntasks = tp.nb_local_tasks()
        ctx.wait(timeout=180)
        ctx.comm_barrier()
        tiles = {s: _value(B.data_of(s).newest_copy()) for s in range(nt)
                 if B.rank_of(s) == rank}
        return tiles, ntasks, b0 + rounds * a0.sum(axis=0)
    return body


@pytest.mark.parametrize("nranks,nt,mb,rounds", [(1, 4, 8, 3),
                                                 (4, 8, 4, 2)])
def test_the_all_to_all_equals_the_jax_run(nranks, nt, mb, rounds):
    port = run_multirank(nranks, _a2a_body("port", nt, mb, rounds, 2),
                         timeout=180)
    jax = j_run_multirank(nranks, _a2a_body("jax", nt, mb, rounds, 2),
                          timeout=180)
    want = port[0][2]
    for (tiles, _, _), (jtiles, _, _) in zip(port, jax):
        assert tiles.keys() == jtiles.keys()
        for s, t in tiles.items():
            np.testing.assert_allclose(t, want[s], rtol=1e-5)
            np.testing.assert_allclose(t, jtiles[s], rtol=1e-6, atol=1e-6)
    assert [r[1] for r in port] == [r[1] for r in jax]

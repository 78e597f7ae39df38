"""K3's rows entry (``parsec_tpu_torch/ops/stencil.py:stencil1d_rows`` and
its plain version ``stencil1d_rows_plain``) against the JAX package's two
incarnations of the function it computes, ``stencil1d_pallas`` (in
interpret mode on the CPU) and ``stencil1d_xla``, run on the padded rows
built with numpy from the same seeded store rows; and the lowering's
``rows`` hook, called once a level for the 1-D stencil on one rank and on
a 4-rank CPU mesh, while other classes group as before.

On the CPU, ``stencil1d_rows`` takes the plain version (the kernel runs
only on the card: ``tests/test_torch_card.py``).  Rows stay under the TPU
kernel's 2^17-element VMEM limit, so the Pallas path really runs.
Tolerances: fp32, ``rtol=1e-6, atol=2e-6`` (at most 9 fp32 products of
O(1) values, summed in the same order; XLA may fuse a multiply-add);
bf16 outputs, one bf16 ulp (``rtol=atol=1e-2``).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.ops.stencil import stencil1d_pallas, stencil1d_xla
from parsec_tpu_torch.data_dist.matrix import (TiledMatrix,
                                               VectorTwoDimCyclic)
from parsec_tpu_torch.models import cholesky as chol
from parsec_tpu_torch.models.stencil import stencil_1d_ptg, stencil_reference
from parsec_tpu_torch.models.stencil2d import stencil_2d_ptg
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.ops import stencil as ks
from parsec_tpu_torch.ptg import lowering
from parsec_tpu_torch.ptg.lowering import DeviceMesh, lower_taskpool

F32 = dict(rtol=1e-6, atol=2e-6)
BF16 = dict(rtol=1e-2, atol=1e-2)
# (levels, groups) of a 4 x 4-tile GEMM, Cholesky and 2-D stencil (3
# iterations) under the wavefront pass, as the tree before the hook
# lowered them
GROUP_COUNTS = ((4, 4), (10, 12), (3, 27))


def _case(R, dtype, G, length, scattered, seed):
    """A store of G + 2 rows, a group of G tiles (store rows 1..G, in a
    seeded order where scattered) and their neighbours' rows, -1 at the
    two edges; returns the numpy store, the rows and the padded rows
    ``[G, length + 2R]`` they stand for."""
    rng = np.random.default_rng(seed)
    st = rng.standard_normal((G + 2, length)).astype(np.float32)
    if dtype == "bfloat16":
        st = st.astype(ml_dtypes.bfloat16)
    c = np.arange(1, G + 1)
    if scattered:
        c = rng.permutation(c)
    lt, rt = c - 1, c + 1
    lt[c == 1] = -1
    rt[c == G] = -1
    zeros = np.zeros((G, R), st.dtype)
    lg = np.where((lt >= 0)[:, None], st[np.maximum(lt, 0), length - R:],
                  zeros)
    rg = np.where((rt >= 0)[:, None], st[np.maximum(rt, 0), :R], zeros)
    padded = np.concatenate([lg, st[c], rg], axis=1)
    return st, c, lt, rt, padded


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _numpy(t):
    return t.float().numpy()


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,scattered", [(6, False), (6, True), (1, False)])
def test_rows_plain_matches_jax_on_the_padded_rows(R, dtype, G, scattered):
    st, c, lt, rt, padded = _case(R, dtype, G, 130, scattered,
                                  100 * R + 10 * G + scattered)
    w = np.random.default_rng(R).standard_normal(2 * R + 1)
    s = _torch(st)
    cr = (torch.from_numpy(c) if scattered
          else slice(int(c[0]), int(c[0]) + G))
    before = ks.stencil1d.launches
    got = ks.stencil1d_rows(s, cr, s, torch.from_numpy(lt), s,
                            torch.from_numpy(rt), w)
    plain = ks.stencil1d_rows_plain(s, cr, s, torch.from_numpy(lt), s,
                                    torch.from_numpy(rt), w)
    assert ks.stencil1d.launches == before       # the CPU launches nothing
    assert got.shape == (G, 130) and got.dtype == s.dtype
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    tol = F32 if dtype == "float32" else BF16
    jp = np.asarray(stencil1d_pallas(padded, w, interpret=True))
    jx = np.asarray(stencil1d_xla(padded, w))
    np.testing.assert_allclose(_numpy(got), jp.astype(np.float32), **tol)
    np.testing.assert_allclose(_numpy(got), jx.astype(np.float32), **tol)


def test_rows_from_three_stores_and_absent_flows():
    """Each flow from its own store, and a flow with no rows at all
    (None: zeros), against the JAX kernel on the same padded rows."""
    R, G, n = 2, 3, 40
    rng = np.random.default_rng(7)
    c, lft, rgt = (rng.standard_normal((5, n)).astype(np.float32)
                   for _ in range(3))
    w = rng.standard_normal(2 * R + 1)
    lt = np.array([4, -1, 0])
    padded = np.concatenate([
        np.where((lt >= 0)[:, None], lft[np.maximum(lt, 0), n - R:], 0),
        c[1:4], np.zeros((G, R), np.float32)], axis=1).astype(np.float32)
    got = ks.stencil1d_rows(torch.from_numpy(c), slice(1, 4),
                            torch.from_numpy(lft), torch.from_numpy(lt),
                            torch.from_numpy(rgt), None, w)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(stencil1d_pallas(padded, w, interpret=True)),
        **F32)


@pytest.mark.parametrize("bad", ["even_taps", "range_low", "range_high",
                                 "slice", "int32_rows", "dtypes",
                                 "kernel_dtype", "kernel_taps", "no_rows"])
def test_rows_wrapper_refuses(bad):
    """What neither entry takes raises on the CPU; what only the kernel
    does not take (a float64 store, taps past MAX_TAPS) raises on a
    device that has no kernel (``meta``), before any launch."""
    st = torch.zeros(6, 64)
    c, lt, rt = slice(1, 5), torch.tensor([-1, 1, 2, 3]), \
        torch.tensor([2, 3, 4, -1])
    lst, w = st, [0.1] * 9
    if bad == "even_taps":
        w = [0.1] * 8
    elif bad == "range_low":
        lt = torch.tensor([-2, 1, 2, 3])
    elif bad == "range_high":
        rt = torch.tensor([2, 3, 4, 6])
    elif bad == "slice":
        c = slice(3, 7)
    elif bad == "int32_rows":
        lt = lt.int()
    elif bad == "dtypes":
        lst = st.double()
    elif bad == "kernel_dtype":
        st = lst = torch.empty(6, 64, dtype=torch.float64, device="meta")
        lt = rt = None
    elif bad == "kernel_taps":
        st = lst = torch.empty(6, 64, device="meta")
        lt = rt = None
        w = [0.01] * (ks.MAX_TAPS + 1)
    else:
        c = None
    before = ks.stencil1d.launches
    with pytest.raises((TypeError, ValueError)):
        ks.stencil1d_rows(st, c, lst, lt, st, rt, w)
    assert ks.stencil1d.launches == before


def _count_hooks(tp):
    tr = tp.local_traceables["stencil1d"]
    calls = {"rows": 0, "apply": 0}

    def count(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    for kind in calls:
        setattr(tr, kind, count(kind, getattr(tr, kind)))
    return calls


@pytest.mark.parametrize("ranks", [1, 4])
def test_lowered_stencil_calls_rows_once_a_level(ranks):
    """The 1-D stencil lowered on one rank and over a 4-rank CPU mesh (4
    cyclic ranks): one ``rows`` call a level a rank, no gather, and V
    within 1e-5 of the float64 reference (fp32 stores, 6 levels)."""
    T, mb, nt = 6, 32, 16
    base = np.random.default_rng(5).standard_normal(nt * mb).astype(
        np.float32)
    V = VectorTwoDimCyclic("V", lm=len(base), mb=mb, P=ranks,
                           init_fn=lambda m, s: base[m * mb:m * mb + s])
    w = np.full(9, 1.0 / 9)
    tp = stencil_1d_ptg(V, w, T)
    calls = _count_hooks(tp)
    if ranks == 1:
        low = lower_taskpool(tp, device="cpu")
        assert low.step_fn.groups == T
    else:
        low = lower_taskpool(tp, mesh=DeviceMesh(["cpu"] * ranks))
        assert low.exchange["groups_by_rank"] == [T] * ranks
    low.execute()
    assert calls == {"rows": T * ranks, "apply": 0}
    got = torch.cat([V.data_of(i).newest_copy().value for i in range(nt)])
    np.testing.assert_allclose(got.numpy(),
                               stencil_reference(base, w, T).numpy(),
                               rtol=0, atol=1e-5)


def _groups(tp) -> tuple[int, int]:
    """(levels, groups) of a pool's single-rank wavefront lowering."""
    low = lower_taskpool(tp, device="cpu", passes="wavefront")
    assert low.mode == "wavefront"
    return low.step_fn.levels, low.step_fn.groups


def test_classes_without_the_hook_group_by_source_signature():
    """A GEMM and the 2-D stencil (no ``rows`` hook) group as before the
    hook existed, one group per (level, class, source signature), and so
    does the Cholesky, whose TRSM, SYRK and GEMM have had the hook since
    their tiles are read in place (none of its READ flows is ever
    absent): the counts below are the tree's before either hook."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    gemm = tiled_gemm_ptg(TiledMatrix.from_dense("A", a, 4, 4),
                          TiledMatrix.from_dense("B", a.copy(), 4, 4),
                          TiledMatrix.from_dense("C", a.copy(), 4, 4))
    spd = chol.make_spd(16, seed=1)
    cho = chol.tiled_cholesky_ptg(TiledMatrix.from_dense("S", spd, 4, 4))
    M = TiledMatrix.from_dense("M", rng.standard_normal((16, 16)).astype(
        np.float32), 4, 4)
    s2d = stencil_2d_ptg(M, [0.5, 0.125, 0.125, 0.125, 0.125], 3)
    assert lowering.find_traceable("gemm") is None \
        or lowering.find_traceable("gemm").rows is None
    assert (_groups(gemm), _groups(cho), _groups(s2d)) == GROUP_COUNTS


def test_in_place_groups_split_by_store_and_keep_minus_one_out_of_runs():
    """An in-place group's READ flows each name one store: a member whose
    left flow reads another store goes to another part, one with no left
    input fits any part; and rows holding -1 never make a slice."""
    out = [(("V", 0), (), True), (None, (), False), (None, (), False)]
    m_a = ([("row", "V", 1), ("row", "A", 0), ("none",)], out)
    m_none = ([("row", "V", 2), ("none",), ("row", "A", 3)], out)
    m_b = ([("row", "V", 3), ("row", "B", 2), ("none",)], out)
    parts = lowering._split_by_store([m_a, m_none, m_b], [1, 2])
    assert parts == [[m_a, m_none], [m_b]]
    assert lowering._Index(np.array([-1, 0, 1])).sel is None
    assert lowering._Index(np.array([2, 3, 4])).sel == slice(2, 5)

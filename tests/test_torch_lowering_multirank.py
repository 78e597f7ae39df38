"""The port's multi-rank (SPMD) lowering against the JAX package's.

``lower_taskpool(tp, mesh=...)`` over the same seeded numpy inputs: the
JAX package on ``Mesh(jax.devices()[:n], ("ranks",))`` (its 8-device CPU
mesh, ``tests/conftest.py``), the port on ``DeviceMesh(["cpu"] * n)``, at
the JAX tests' sizes (``tests/test_lowering_multirank.py``,
``test_apps_stencil.py``, ``test_lu.py``: n=64, nb=16).  Each case holds
the pass chosen, each store's rows and row count (rank-major, padded),
every tile on its owner's slab, and the output tiles, tile by tile: at
``rtol=1e-4, atol=1e-4`` for GEMM, LU and the stencil, at the JAX tests'
``rtol=1e-3, atol=1e-4`` for the Cholesky.

The port's half is also held to what only it has: its exchange plan
(every gather of a rank inside its own part or its receive rows; its
bytes against ``analysis/commcheck.py:check_comm``), its refusals, its
cache keys and the dynamic ``run_multirank`` run of the same GEMM.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from parsec_tpu.data_dist.matrix import SymTwoDimBlockCyclic as JSym
from parsec_tpu.data_dist.matrix import TiledMatrix as JTM
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JBC
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVec
from parsec_tpu.models.cholesky import tiled_cholesky_ptg as j_cholesky
from parsec_tpu.models.lu import tiled_lu_ptg as j_lu
from parsec_tpu.models.stencil import stencil_1d_ptg as j_stencil
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm
from parsec_tpu.ptg.lowering import LoweringError as JLoweringError
from parsec_tpu.ptg.lowering import lower_taskpool as j_lower
from parsec_tpu_torch.analysis.commcheck import check_comm
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                               TiledMatrix, TwoDimBlockCyclic,
                                               VectorTwoDimCyclic)
from parsec_tpu_torch.models.cholesky import make_spd, tiled_cholesky_ptg
from parsec_tpu_torch.models.lu import make_dd, tiled_lu_ptg
from parsec_tpu_torch.models.stencil import stencil_1d_ptg, stencil_reference
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.ptg import PTGBuilder, READ, RW, span
from parsec_tpu_torch.ptg.lowering import (DeviceMesh, LoweringError,
                                           Traceable, lower_regions,
                                           lower_taskpool, lowering_cache,
                                           structural_fingerprint)

N, NB = 64, 16
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
CHOL_TOL = dict(rtol=1e-3, atol=1e-4)


def j_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("ranks",))


def p_mesh(n):
    return DeviceMesh(["cpu"] * n)


def tiles(dc):
    """Every stored tile's newest value as float64 numpy, by key."""
    keys = ([(i,) for i in range(dc.mt)] if not hasattr(dc, "nt") else
            [(m, n) for m in range(dc.mt) for n in range(dc.nt)
             if dc.has_tile(m, n)])
    out = {}
    for k in keys:
        v = dc.data_of(*k).newest_copy().value
        v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[k] = v.astype(np.float64)
    return out


def assert_tiles(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **tol)


def grid(nranks):
    P = 2 if nranks % 2 == 0 else 1
    return P, nranks // P


def gemm_inputs(seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, N).astype(np.float32),
            rng.randn(N, N).astype(np.float32))


def gemm_pool(pkg, nranks, a, b, c_nodes=None):
    P, Q = grid(nranks)
    bc, gemm = (JBC, j_gemm) if pkg == "jax" else (TwoDimBlockCyclic,
                                                   tiled_gemm_ptg)
    A = bc.from_dense("A", a, NB, NB, P=P, Q=Q)
    B = bc.from_dense("B", b, NB, NB, P=P, Q=Q)
    if c_nodes == 1:
        tm = JTM if pkg == "jax" else TiledMatrix
        C = tm("C", N, N, NB, NB)
    else:
        C = bc("C", N, N, NB, NB, P=P, Q=Q)
    return gemm(A, B, C), C


def chol_pool(pkg, nranks, spd):
    sym, chol = (JSym, j_cholesky) if pkg == "jax" else (
        SymTwoDimBlockCyclic, tiled_cholesky_ptg)
    A = sym.from_dense("A", spd, NB, NB, P=nranks, Q=1)
    return chol(A), A


def lu_pool(pkg, nranks, a):
    bc, lu = (JBC, j_lu) if pkg == "jax" else (TwoDimBlockCyclic,
                                               tiled_lu_ptg)
    A = bc.from_dense("A", a, NB, NB, P=nranks, Q=1)
    return lu(A), A


def stencil_pool(pkg, nranks, base, w, iters, mb=8):
    def init(m, size):
        return base[m * mb:m * mb + size]
    if pkg == "jax":
        V = JVec("V", lm=len(base), mb=mb, P=nranks, dtype=np.float64,
                 init_fn=init)
        return j_stencil(V, w, iters), V
    V = VectorTwoDimCyclic("V", lm=len(base), mb=mb, P=nranks,
                           dtype=torch.float64, init_fn=init)
    return stencil_1d_ptg(V, w, iters), V


def both(build, nranks, passes="auto"):
    """Build ``build(pkg)`` with each package and lower it over the
    package's mesh: ((jax lowered, jax output), (port lowered, port
    output))."""
    jtp, jout = build("jax")
    ptp, pout = build("port")
    jl = j_lower(jtp, mesh=j_mesh(nranks), passes=passes)
    pl = lower_taskpool(ptp, mesh=p_mesh(nranks), passes=passes)
    return (jl, jout), (pl, pout)


def assert_same_stores(jl, pl, nranks):
    """Mode, rows and row counts equal; every distributed tile on its
    owner's slab; replicated stores the same."""
    assert pl.mode == jl.mode
    js, ps = jl._stores, pl._stores
    assert set(ps.dcs) == set(js.dcs)
    for name in js.dcs:
        assert ps.rows[name] == {tuple(k): r for k, r in
                                 js.rows[name].items()}, name
        assert ps.nrows[name] == js.nrows[name], name
    assert ps.replicated == js.replicated
    for name, rows in ps.rows.items():
        if name in ps.replicated:
            continue
        dc, cap = ps.dcs[name], ps.nrows[name] // nranks
        for key, row in rows.items():
            assert row // cap == dc.rank_of(*key), (name, key)


def run_and_compare(jl, jout, pl, pout, **tol):
    jl.execute()
    pl.execute()
    assert_tiles(tiles(pout), tiles(jout), **tol)


# ---------------------------------------------------------------------------
# the JAX package's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nranks", [2, 4, 8])
def test_gemm_chain_collapse_matches_jax(nranks):
    a, b = gemm_inputs()
    (jl, jC), (pl, pC) = both(lambda pkg: gemm_pool(pkg, nranks, a, b),
                              nranks)
    assert pl.mode == "chain-collapse"
    assert_same_stores(jl, pl, nranks)
    assert pl.layout == {"A": "stacked", "B": "stacked", "C": "stacked"}
    run_and_compare(jl, jC, pl, pC, **GEMM_TOL)
    for (m, n), t in tiles(pC).items():
        np.testing.assert_allclose(
            t, (a @ b)[m * NB:(m + 1) * NB, n * NB:(n + 1) * NB], **GEMM_TOL)
    # one contraction a rank: each owns a product set of C's tiles
    assert pl.exchange["groups_by_rank"] == [1] * nranks


def test_gemm_matches_dynamic_multirank():
    """The lowered GEMM against the port's dynamic runtime on 4 rank
    threads (remote deps through the comm engine)."""
    nranks = 4
    a, b = gemm_inputs()
    tp, C = gemm_pool("port", nranks, a, b)
    lower_taskpool(tp, mesh=p_mesh(nranks)).execute()
    lowered = np.zeros((N, N))
    for (m, n), t in tiles(C).items():
        lowered[m * NB:(m + 1) * NB, n * NB:(n + 1) * NB] = t
    P, Q = grid(nranks)

    def body(ctx, rank, nr):
        kw = dict(P=P, Q=Q, myrank=rank)
        A2 = TwoDimBlockCyclic.from_dense("A", a, NB, NB, **kw)
        B2 = TwoDimBlockCyclic.from_dense("B", b, NB, NB, **kw)
        C2 = TwoDimBlockCyclic("C", N, N, NB, NB, **kw)
        ctx.add_taskpool(tiled_gemm_ptg(A2, B2, C2, devices="cpu"))
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        return C2.to_dense()

    dynamic = sum(run_multirank(nranks, body))
    np.testing.assert_allclose(lowered, dynamic, **GEMM_TOL)
    np.testing.assert_allclose(lowered, a @ b, **GEMM_TOL)


@pytest.mark.parametrize("nranks", [2, 4])
def test_cholesky_wavefront_matches_jax(nranks):
    spd = make_spd(N)
    (jl, jA), (pl, pA) = both(lambda pkg: chol_pool(pkg, nranks, spd),
                              nranks)
    assert pl.mode == "wavefront"
    assert_same_stores(jl, pl, nranks)
    run_and_compare(jl, jA, pl, pA, **CHOL_TOL)
    want = np.linalg.cholesky(spd.astype(np.float64))
    for (m, n), t in tiles(pA).items():
        ref = want[m * NB:(m + 1) * NB, n * NB:(n + 1) * NB]
        np.testing.assert_allclose(t if m > n else np.tril(t), ref,
                                   **CHOL_TOL)


def test_lu_matches_jax():
    a = make_dd(N)
    (jl, jA), (pl, pA) = both(lambda pkg: lu_pool(pkg, 2, a), 2)
    assert pl.mode == "wavefront"
    assert_same_stores(jl, pl, 2)
    run_and_compare(jl, jA, pl, pA, **GEMM_TOL)


@pytest.mark.parametrize("nranks", [2, 4])
def test_stencil_wavefront_matches_jax(nranks):
    base = np.random.default_rng(2).standard_normal(64)
    w = np.array([0.25, 0.5, 0.25])
    (jl, jV), (pl, pV) = both(
        lambda pkg: stencil_pool(pkg, nranks, base, w, 5), nranks)
    assert pl.mode == "wavefront"
    assert_same_stores(jl, pl, nranks)
    # the snapshot V0 is distributed as V is: the chain's in-place
    # versions live on their owner's slab
    place = pl.placement()
    assert place["V"]["spec"] == place["V_0"]["spec"] == "sharded"
    run_and_compare(jl, jV, pl, pV, **GEMM_TOL)
    got = np.concatenate([tiles(pV)[(i,)] for i in range(pV.mt)])
    np.testing.assert_allclose(got, stencil_reference(base, w, 5).numpy(),
                               **GEMM_TOL)
    # the halos come through the exchange: a tile's neighbours lie on
    # other ranks (cyclic segments), level after level
    ex = pl.exchange
    assert ex["total_bytes"] > 0 and ex["levels_with_sends"] == 5


def test_unrolled_pass_over_a_mesh_matches_jax():
    """A forced unrolled pass: task by task, each on its rank, values
    crossing ranks as copies (the JAX package's ``passes="unrolled"``
    under the same mesh)."""
    spd = make_spd(N)
    (jl, jA), (pl, pA) = both(lambda pkg: chol_pool(pkg, 2, spd), 2,
                              passes="unrolled")
    assert pl.mode == jl.mode == "unrolled"
    assert_same_stores(jl, pl, 2)
    run_and_compare(jl, jA, pl, pA, **CHOL_TOL)
    # every cross-rank value of the step was copied to its reader
    assert pl.exchange["value_bytes"]
    assert set(pl.exchange["value_bytes"]) <= {(0, 1), (1, 0)}


def test_replicated_accumulator_matches_jax():
    """C over one rank (``nodes == 1``): replicated, its tiles computed
    by their affinity's rank (0) and left equal on every rank's copy."""
    a, b = gemm_inputs(3)
    (jl, jC), (pl, pC) = both(
        lambda pkg: gemm_pool(pkg, 4, a, b, c_nodes=1), 4)
    assert_same_stores(jl, pl, 4)
    assert pl.placement()["C"]["spec"] == "replicated"
    out = pl.step_fn(pl.initial_stores())
    for r in range(1, 4):
        assert torch.equal(out["C"][r], out["C"][0])
    ex = pl.exchange
    assert ex["groups_by_rank"] == [1, 0, 0, 0]
    assert ex["final_bytes"] == 3 * N * N * 4
    run_and_compare(jl, jC, pl, pC, **GEMM_TOL)


@pytest.mark.parametrize("kind", ["gemm", "cholesky"])
def test_one_rank_mesh_is_the_single_rank_lowering(kind):
    a, b = gemm_inputs()
    spd = make_spd(N)

    def build():
        if kind == "gemm":
            A = TiledMatrix.from_dense("A", a, NB, NB)
            B = TiledMatrix.from_dense("B", b, NB, NB)
            C = TiledMatrix("C", N, N, NB, NB)
            return tiled_gemm_ptg(A, B, C), C
        A = SymTwoDimBlockCyclic.from_dense("A", spd, NB, NB)
        return tiled_cholesky_ptg(A), A

    tp1, out1 = build()
    lower_taskpool(tp1, device="cpu").execute()
    tp2, out2 = build()
    low = lower_taskpool(tp2, mesh=p_mesh(1))
    assert low.exchange["total_bytes"] == 0
    low.execute()
    assert_tiles(tiles(out2), tiles(out1), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the exchange plan
# ---------------------------------------------------------------------------

def test_gemm_exchange_against_commcheck():
    """commcheck counts a remote input once per reading TASK; the
    lowering sends a tile once per reading RANK.  On the 2 x 2 grid of 4
    x 4 tiles each remote A(m,k) is read by the NT/Q = 2 tasks (m, n, k)
    of a rank, and each remote B(k,n) by its MT/P = 2 tasks: the
    lowering moves exactly half of commcheck's bytes on every pair."""
    a, b = gemm_inputs()
    tp, _ = gemm_pool("port", 4, a, b)
    low = lower_taskpool(tp, mesh=p_mesh(4))
    cc = check_comm(gemm_pool("port", 4, a, b)[0], 4)
    assert cc.rank_bytes and set(cc.rank_bytes) == set(low.exchange_bytes)
    for pair, nb in cc.rank_bytes.items():
        assert nb == 2 * low.exchange_bytes[pair], pair
    # each rank lacks a quarter of A and a quarter of B
    tile = NB * NB * 4
    per_rank = {}
    for (src, dst), nb in low.exchange_bytes.items():
        per_rank[dst] = per_rank.get(dst, 0) + nb
    assert per_rank == {r: 2 * (16 // 4) * tile for r in range(4)}


@pytest.mark.parametrize("nranks", [2, 4])
def test_cholesky_exchange_equals_commcheck(nranks):
    """Every version a rank reads from another rank crosses once per
    remote rank, as the dynamic protocol activates one payload per
    remote rank: the bytes equal commcheck's, pair by pair."""
    spd = make_spd(N)
    low = lower_taskpool(chol_pool("port", nranks, spd)[0],
                         mesh=p_mesh(nranks))
    cc = check_comm(chol_pool("port", nranks, spd)[0], nranks)
    assert low.exchange_bytes == dict(sorted(cc.rank_bytes.items()))


@pytest.mark.parametrize("kind", ["gemm", "cholesky", "lu", "stencil"])
def test_each_rank_reads_only_its_own_part_and_receive_rows(kind):
    """Every gather index of a rank's groups lies in its own part (its
    slab, or its copy) or its receive rows; every scatter in its own
    part; every send crosses ranks into consecutive receive rows."""
    a, b = gemm_inputs()
    spd, dd = make_spd(N), make_dd(N)
    base = np.random.default_rng(2).standard_normal(64)
    tp = {"gemm": lambda: gemm_pool("port", 4, a, b)[0],
          "cholesky": lambda: chol_pool("port", 4, spd)[0],
          "lu": lambda: lu_pool("port", 2, dd)[0],
          "stencil": lambda: stencil_pool("port", 4, base,
                                          [0.25, 0.5, 0.25], 5)[0]}[kind]()
    nranks = 2 if kind == "lu" else 4
    low = lower_taskpool(tp, mesh=p_mesh(nranks))
    step = low.step_fn
    own = step.own_len

    def bound(r, name):
        return own[name] + step.nrecv.get((r, name), 0)

    seen = 0
    if kind == "gemm":
        for r, (ja, jb, jc, _) in enumerate(step.per_rank):
            for idx, name in ((ja, step.an), (jb, step.bn)):
                assert idx.rows.max() < bound(r, name)
                seen += idx.rows.size
            assert jc.rows.max() < own[step.cn]
    else:
        for r in range(nranks):
            for specs in step.specs[r].values():
                for _k, _nw, gathers, scatters, _G, _c in specs:
                    for g in gathers:
                        if g is None or g[1] == "new":
                            continue
                        rows = (np.array([g[2]]) if g[1] == "const"
                                else g[2].rows)
                        assert rows.max() < bound(r, g[0])
                        seen += rows.size
                    for name, idx, _s, _i in scatters:
                        assert idx.rows.max() < own[name]
    assert seen
    for sends in step.sends.values():
        for src, dst, name, idx, slot0, count in sends:
            assert src != dst and len(idx.rows) == count
            assert idx.rows.max() < own[name]
            assert slot0 + count <= step.nrecv[(dst, name)]


def test_a_row_is_sent_once_until_its_owner_writes_it():
    """In the Cholesky, a panel tile is written by its TRSM once and then
    read by many tasks of a remote rank: it crosses to that rank once."""
    spd = make_spd(N)
    low = lower_taskpool(chol_pool("port", 2, spd)[0], mesh=p_mesh(2))
    sent = {}
    for sends in low.step_fn.sends.values():
        for src, dst, name, idx, _s, _c in sends:
            for row in idx.rows:
                sent[(dst, int(row))] = sent.get((dst, int(row)), 0) + 1
    # tiles are written once in this pool's order after their last remote
    # read, so no (rank, row) pair repeats
    assert sent and max(sent.values()) == 1


def test_warm_places_the_plan_and_launches_nothing(monkeypatch):
    a, b = gemm_inputs()
    low = lower_taskpool(gemm_pool("port", 4, a, b)[0], mesh=p_mesh(4))

    def boom(*args):
        raise AssertionError("warm() ran the contraction")

    monkeypatch.setattr(low.step_fn, "combine", boom)
    out = low.warm()
    assert set(out) == {"load_s", "upload_s"}
    placed = low.step_fn.placed
    assert placed and all(d == torch.device("cpu") for d, _ in placed)
    # the gathers over own and received rows are index tensors, each now
    # on its rank's device
    tensors = [idx for _, idx in placed if idx.sel is None]
    assert tensors and all(torch.device("cpu") in idx._dev
                           for idx in tensors)


def test_run_by_rank_and_exchange_share():
    a, b = gemm_inputs()
    low = lower_taskpool(gemm_pool("port", 4, a, b)[0], mesh=p_mesh(4))
    stores = low.initial_stores()
    calls = {"n": 0}

    def probe():
        calls["n"] += 1
        return {"probe": calls["n"]}

    out, by_rank = low.run_by_rank(stores, probe)
    assert [d["probe"] for d in by_rank] == [1, 1, 1, 1]
    assert set(out) == {"A", "B", "C"} and len(out["C"]) == 4
    share = low.exchange_share(stores, reps=1)
    assert share["step_ms"] > 0 and 0 <= share["exchange_share"]


@pytest.mark.parametrize("kind", ["gemm", "stencil"])
def test_stores_carry_receive_rows_and_a_step_copies_what_it_writes(kind):
    """Rank r's tensor of a store is its own part then the receive rows
    the plan gives it, laid out so when the stores are made; a step
    writes the sends into the tensors it was given and copies only the
    stores it writes, leaving their inputs' own parts as they were."""
    a, b = gemm_inputs()
    base = np.random.default_rng(2).standard_normal(64)
    tp = (gemm_pool("port", 4, a, b)[0] if kind == "gemm" else
          stencil_pool("port", 4, base, [0.25, 0.5, 0.25], 5)[0])
    low = lower_taskpool(tp, mesh=p_mesh(4))
    step = low.step_fn
    stores = low.initial_stores()
    for name, parts in stores.items():
        for r, t in enumerate(parts):
            assert t.shape[0] == step.own_len[name] + step.recv_rows(r, name)
    assert any(step.recv_rows(r, name) for r in range(4) for name in stores)
    before = {name: [t[:step.own_len[name]].clone() for t in parts]
              for name, parts in stores.items()}
    out = step(stores)
    for name, parts in stores.items():
        for r, t in enumerate(parts):
            assert out[name][r].shape == t.shape
            assert (out[name][r] is t) == (name not in step.targets)
            assert torch.equal(t[:step.own_len[name]], before[name][r])
    # the private stores are the step's, and placement reads them there
    place = low.placement()
    for name in step.private:
        assert place[name] == {"spec": "replicated", "devices": ["cpu"] * 4}


def test_fingerprint_equals_jax():
    from parsec_tpu.ptg.lowering import \
        structural_fingerprint as j_fingerprint
    spd = make_spd(N)
    (jl, _), (pl, _) = both(lambda pkg: chol_pool(pkg, 4, spd), 4)
    assert structural_fingerprint(pl) == j_fingerprint(jl)


# ---------------------------------------------------------------------------
# refusals and the cache
# ---------------------------------------------------------------------------

def test_refusals_raise_lowering_error_like_jax():
    a, b = gemm_inputs()
    # a mesh axis other than "ranks"
    with pytest.raises(JLoweringError):
        j_lower(gemm_pool("jax", 2, a, b)[0],
                mesh=Mesh(np.array(jax.devices()[:2]), ("x",)))
    with pytest.raises(LoweringError):
        lower_taskpool(gemm_pool("port", 2, a, b)[0],
                       mesh=DeviceMesh(["cpu"] * 2, ("x",)))
    # a multi-rank context with no mesh: the caller runs the dynamic path
    ctx = SimpleNamespace(nb_ranks=2)
    with pytest.raises(JLoweringError, match="mesh"):
        j_lower(gemm_pool("jax", 2, a, b)[0], context=ctx)
    with pytest.raises(LoweringError, match="mesh"):
        lower_taskpool(gemm_pool("port", 2, a, b)[0], context=ctx,
                       device="cpu")
    # a distributed collection over another number of ranks
    with pytest.raises(JLoweringError, match="distributed over"):
        j_lower(gemm_pool("jax", 2, a, b)[0], mesh=j_mesh(4))
    with pytest.raises(LoweringError, match="distributed over"):
        lower_taskpool(gemm_pool("port", 2, a, b)[0], mesh=p_mesh(4))


def test_open_key_space_is_refused_under_a_mesh():
    """An empty undeclared dict collection has no enumerable ownership."""
    def pool():
        D = DictCollection("D", init_fn=lambda i: torch.ones(4))
        p = PTGBuilder("open", D=D, NT=2)
        t = p.task("T", i=span(0, lambda g, l: g.NT - 1))
        t.flow("X", RW).input(data=("D", lambda g, l: (l.i,))).output(
            data=("D", lambda g, l: (l.i,)))
        t.body(device="cuda", dyld="torch_port_scale2_mr")
        tp = p.build()
        tp.local_traceables = {"torch_port_scale2_mr": Traceable(
            lambda xs: [x * 2.0 for x in xs])}
        return tp

    lower_taskpool(pool(), device="cpu").execute()   # one rank: open store
    with pytest.raises(LoweringError, match="open key spaces"):
        lower_taskpool(pool(), mesh=p_mesh(2))


def test_lower_regions_refuses_a_multi_rank_context():
    spd = make_spd(N)
    with pytest.raises(LoweringError, match="single-rank"):
        lower_regions(chol_pool("port", 2, spd)[0],
                      context=SimpleNamespace(nb_ranks=2), device="cpu")


def test_a_task_writing_two_ranks_rows_is_refused():
    """A task whose RW flow reads A(i) and writes B(i+1), on other ranks
    of the same mesh: two owners."""
    A = VectorTwoDimCyclic("A", lm=16, mb=4, P=2)
    B = VectorTwoDimCyclic("B", lm=16, mb=4, P=2)
    p = PTGBuilder("two", A=A, B=B, NT=3)
    t = p.task("T", i=span(0, lambda g, l: g.NT - 1))
    f = t.flow("X", RW)
    f.input(data=("A", lambda g, l: (l.i,)))
    f.output(data=("A", lambda g, l: (l.i,)))
    f.output(data=("B", lambda g, l: (l.i + 1,)))
    t.flow("Y", READ).input(data=("B", lambda g, l: (l.i,)))
    t.body(device="cuda", dyld="torch_port_two_mr")
    tp = p.build()
    tp.local_traceables = {"torch_port_two_mr": Traceable(
        lambda xs, ys: [x + 1.0 for x in xs])}
    with pytest.raises(LoweringError, match="writes rows of ranks"):
        lower_taskpool(tp, mesh=p_mesh(2), passes="wavefront")


def test_cache_keys_the_mesh():
    """Two meshes of another size or other devices never share a step;
    the same mesh does."""
    a, b = gemm_inputs()
    lowering_cache.clear()
    with params.overrides({"lowering_cache": True}):
        def low(mesh):
            P, Q = 2, 1
            A = TwoDimBlockCyclic.from_dense("A", a, NB, NB, P=P, Q=Q)
            B = TwoDimBlockCyclic.from_dense("B", b, NB, NB, P=P, Q=Q)
            C = TwoDimBlockCyclic("C", N, N, NB, NB, P=P, Q=Q)
            return lower_taskpool(tiled_gemm_ptg(A, B, C), mesh=mesh)

        first = low(DeviceMesh(["cpu", "cpu"]))
        again = low(DeviceMesh(["cpu", "cpu"]))
        other = low(DeviceMesh(["cpu:0", "cpu"]))
        assert again.step_fn is first.step_fn
        assert other.step_fn is not first.step_fn
        A = TiledMatrix.from_dense("A", a, NB, NB)
        B = TiledMatrix.from_dense("B", b, NB, NB)
        C = TiledMatrix("C", N, N, NB, NB)
        one = lower_taskpool(tiled_gemm_ptg(A, B, C), mesh=p_mesh(1))
        single = lower_taskpool(
            tiled_gemm_ptg(*(TiledMatrix.from_dense(nm, x, NB, NB)
                             for nm, x in (("A", a), ("B", b))),
                           TiledMatrix("C", N, N, NB, NB)), device="cpu")
        assert one.step_fn is not single.step_fn
    lowering_cache.clear()

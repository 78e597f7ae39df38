"""Rows the lowered step reads and writes in place (``ptg/lowering.py``'s
``rows`` hooks and ``rows_into``; ``models/cholesky.py``'s TRSM, SYRK and
GEMM over ``ops/gemm.py:gemm_update_rows``).

- The lowered Cholesky at nt = 4..8 is bit for bit the same plan run
  on gathered (stacked) rows through the list forms (the K1 traceables
  registered again without their ``rows`` hooks for the test's
  duration), and matches a float64 reference within the Cholesky tests'
  tolerance.
- The ``in_place`` counter: every SYRK and GEMM row written in place,
  nt(nt-1)(nt+1)/6, and no row gathered; POTRF's and TRSM's results,
  nt(nt+1)/2 rows, scattered.
- A hazard: a task of a level reads a row that another task of the level
  writes.  That row is scattered, not written in place; the other rows of
  the same class are written in place; the result is the unrolled pass's
  and the dynamic runtime's.  The lowered 1-D stencil, whose neighbours
  read every row in the level that writes it, writes no row in place.
- K1's rows entry on the host: each tile is the plain expression, written
  into its row, and what the entry refuses.
- The hooks on the plan's indices: TRSM inverts a group's one diagonal
  tile once (or each of several), bit for bit the list form; the
  dropped-update fault wraps the GEMM's rows hook, so that the faulty run
  moves what the program moves; a traceable takes a ``rows`` hook or a
  stacked form, not both.
"""

import contextlib

import numpy as np
import pytest
import torch

from parsec_tpu_torch import ptg
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data.data import data_create
from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                               TiledMatrix,
                                               VectorTwoDimCyclic)
from parsec_tpu_torch.models import cholesky as chol
from parsec_tpu_torch.models.stencil import stencil_1d_ptg
from parsec_tpu_torch.ops import gemm as gemm_ops
from parsec_tpu_torch.ptg.lowering import (Traceable, _Index,
                                           find_traceable, lower_taskpool,
                                           register_traceable)
from parsec_tpu_torch.runtime import Context

F64_TOL = dict(rtol=1e-3, atol=1e-4)
K1_CLASSES = ("trsm_rlt", "syrk_ln", "gemm_nt")


@contextlib.contextmanager
def _hooks_off():
    """The Cholesky's K1 traceables registered again without their rows
    hooks (their list forms as they are) while the block runs; the
    registered ones back after it."""
    kept = {name: find_traceable(name) for name in K1_CLASSES}
    for name, t in kept.items():
        register_traceable(name, t.apply, libs=t.libs)
    try:
        yield
    finally:
        for name, t in kept.items():
            register_traceable(name, t.apply, rows=t.rows,
                               rows_into=t.rows_into, libs=t.libs)


def _cholesky(nt: int, nb: int = 8, seed: int = 3):
    a = chol.make_spd(nt * nb, seed=seed)
    A = SymTwoDimBlockCyclic.from_dense("A", a, nb, nb)
    low = lower_taskpool(chol.tiled_cholesky_ptg(A), device="cpu")
    return a, low, low.step_fn(low.initial_stores())


@pytest.mark.parametrize("nt", [4, 5, 6, 7, 8])
def test_lowered_cholesky_is_the_stacked_path_bit_for_bit(nt):
    """The plan on its rows hooks against the same plan with the hooks
    off: each group gathered into stacked rows and run through the list
    forms."""
    _, low, got = _cholesky(nt)
    with _hooks_off():
        _, low_st, want = _cholesky(nt)
    assert low.mode == low_st.mode == "wavefront"
    assert (low.levels, low.groups) == (low_st.levels, low_st.groups)
    assert low.step_fn is not low_st.step_fn
    assert low_st.rows_moved["in_place"]["written"] == {}
    assert torch.equal(got["A"], want["A"])


@pytest.mark.parametrize("nt", [4, 6, 8])
def test_lowered_cholesky_matches_the_float64_reference(nt):
    nb = 16
    a = chol.make_spd(nt * nb, seed=nt)
    A = SymTwoDimBlockCyclic.from_dense("A", a, nb, nb)
    lower_taskpool(chol.tiled_cholesky_ptg(A), device="cpu").execute()
    np.testing.assert_allclose(np.tril(A.to_dense()),
                               np.linalg.cholesky(a.astype(np.float64)),
                               **F64_TOL)


@pytest.mark.parametrize("nt", [4, 5, 8])
def test_the_in_place_counter_reads_the_plan(nt):
    _, low, _ = _cholesky(nt, nb=4)
    moved = low.rows_moved
    written = nt * (nt - 1) * (nt + 1) // 6          # SYRK + GEMM tasks
    assert moved["in_place"]["written"] == {"A": written}
    assert moved["gather"] == {}
    assert moved["scatter"] == {"A": nt * (nt + 1) // 2}   # POTRF + TRSM
    # TRSM reads 2 rows, SYRK 2, GEMM 3, one row a flow
    trsm, syrk = nt * (nt - 1) // 2, nt * (nt - 1) // 2
    gemm = written - syrk
    assert moved["in_place"]["read"] == {"A": 2 * trsm + 2 * syrk + 3 * gemm}
    row = 4 * 4 * 4
    assert low.bytes_moved == {"gather": 0,
                               "scatter": nt * (nt + 1) // 2 * row,
                               "clone": nt * (nt + 1) // 2 * row}


# ---------------------------------------------------------------------------
# the hazard: a row read in the level that writes it
# ---------------------------------------------------------------------------

NT, NB = 6, 4
READ_BY_R = 2          # R(i) reads the rows W(i) writes, for i < 2


def _detach(task, flow, value):
    task.set_flow_data(flow, data_create(value, key=None).get_copy(0))


def _hazard_pool(v: np.ndarray, u: np.ndarray):
    """P(i) adds 1 to tile V[i] (a version left in row V[i]); at the next
    level W(i) doubles it into V[i] and, for i < 2, R(i) adds three times
    P(i)'s version to U[i].  W's traceable can write its result into the
    rows it read; R reads W's row in W's level."""
    V = TiledMatrix.from_dense("V", v, NB, NB)
    U = TiledMatrix.from_dense("U", u, NB, NB)
    p = ptg.PTGBuilder("hazard", V=V, U=U, NT=NT)
    tp_ = p.task("P", i=ptg.span(0, lambda g, l: g.NT - 1))
    fx = tp_.flow("X", ptg.RW)
    fx.input(data=("V", lambda g, l: (0, l.i)))
    fx.output(succ=("W", "X", lambda g, l: {"i": l.i}))
    fx.output(succ=("R", "Y", lambda g, l: {"i": l.i}),
              guard=lambda g, l: l.i < READ_BY_R)
    tw = p.task("W", i=ptg.span(0, lambda g, l: g.NT - 1))
    fw = tw.flow("X", ptg.RW)
    fw.input(pred=("P", "X", lambda g, l: {"i": l.i}))
    fw.output(data=("V", lambda g, l: (0, l.i)))
    tr = p.task("R", i=ptg.span(0, lambda g, l: READ_BY_R - 1))
    tr.flow("Y", ptg.READ).input(pred=("P", "X", lambda g, l: {"i": l.i}))
    fz = tr.flow("Z", ptg.RW)
    fz.input(data=("U", lambda g, l: (0, l.i)))
    fz.output(data=("U", lambda g, l: (0, l.i)))

    def p_body(es, task, g, l):
        _detach(task, "X", task.flow_data("X").value + 1.0)

    def w_body(es, task, g, l):
        _detach(task, "X", task.flow_data("X").value * 2.0)

    def r_body(es, task, g, l):
        _detach(task, "Z", task.flow_data("Z").value
                + 3.0 * task.flow_data("Y").value)

    tp_.body(p_body, dyld="hz_p")
    tw.body(w_body, dyld="hz_w")
    tr.body(r_body, dyld="hz_r")
    tp = p.build()

    def w_rows(x, out=(None,)):
        store, index = x
        index = index.on(store.device)
        new = store[index] * 2.0
        if out[0] is None:
            return new
        store[index] = new
        return None

    tp.local_traceables = {
        "hz_p": Traceable(lambda xs: [x + 1.0 for x in xs]),
        "hz_w": Traceable(lambda xs: [x * 2.0 for x in xs], rows=w_rows,
                          rows_into=(0,)),
        "hz_r": Traceable(lambda ys, zs: [z + 3.0 * y
                                          for y, z in zip(ys, zs)])}
    return tp, V, U


def _hazard_inputs():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((NB, NT * NB)).astype(np.float32),
            rng.standard_normal((NB, NT * NB)).astype(np.float32))


def _lowered(passes: str):
    v, u = _hazard_inputs()
    tp, V, U = _hazard_pool(v, u)
    low = lower_taskpool(tp, device="cpu", passes=passes)
    low.execute()
    return low, V.to_dense(), U.to_dense()


def test_a_row_read_in_its_writers_level_is_scattered():
    low, v_low, u_low = _lowered("wavefront")
    assert low.mode == "wavefront" and low.levels == 2
    in_place = low.rows_moved["in_place"]
    # W's rows that R reads in W's level are scattered, the others not
    assert in_place["written"] == {"V": NT - READ_BY_R}
    assert in_place["read"] == {"V": NT}
    # P's versions (its class has no hook) and the two W rows R reads
    assert low.rows_moved["scatter"]["V"] == NT + READ_BY_R
    _, v_unr, u_unr = _lowered("unrolled")
    v, u = _hazard_inputs()
    tp, V, U = _hazard_pool(v, u)
    with params.overrides({"runtime_dag_compile": False}):
        ctx = Context(nb_cores=2)
        try:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
        finally:
            ctx.fini(timeout=30)
    want_v = (v + 1.0) * 2.0
    want_u = u.copy()
    want_u[:, :READ_BY_R * NB] += 3.0 * (v[:, :READ_BY_R * NB] + 1.0)
    for got_v, got_u in ((v_low, u_low), (v_unr, u_unr),
                         (V.to_dense(), U.to_dense())):
        np.testing.assert_array_equal(got_v, want_v)
        np.testing.assert_array_equal(got_u, want_u)


def test_the_lowered_stencil_writes_no_row_in_place():
    """Its neighbours read row i in the level that writes it, so every
    level scatters its slab; its K3 hook still reads every row in place."""
    base = np.random.default_rng(2).standard_normal(1 << 10).astype(
        np.float32)
    V = VectorTwoDimCyclic("V", lm=len(base), mb=1 << 7,
                           init_fn=lambda m, s: base[m * 128:m * 128 + s])
    low = lower_taskpool(stencil_1d_ptg(V, [1 / 3] * 3, 4), device="cpu")
    assert low.mode == "wavefront"
    moved = low.rows_moved
    assert moved["in_place"]["written"] == {}
    # the chain runs over the snapshot store V_0: 8 tiles, 3 rows each a
    # task (its own and its neighbours', none past the edges)
    assert moved["in_place"]["read"] == {"V_0": 4 * (3 * 8 - 2)}
    assert moved["scatter"] == {"V_0": 3 * 8, "V": 8}


# ---------------------------------------------------------------------------
# K1's rows entry on the host
# ---------------------------------------------------------------------------

def _store(rows, seed, m=8, n=8):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (rows, m, n)).astype(np.float32))


def _ix(rows):
    return _Index(np.array(rows, np.int64))


@pytest.mark.parametrize("index", ["slice", "index"])
def test_the_rows_entry_writes_each_tile_into_its_row(index):
    st = _store(10, 1)
    a_rows, b_rows, c_rows = [0, 1, 2], [3, 3, 4], [7, 5, 9]

    def ix(r):
        if index == "slice" and (np.diff(r) == 1).all():
            return slice(r[0], r[0] + len(r))
        return _ix(r)

    want = [gemm_ops.gemm_update_plain(st[a], st[b], st[c], trans_b=True,
                                       subtract=True)
            for a, b, c in zip(a_rows, b_rows, c_rows)]
    before = st.clone()
    c = (st, ix(c_rows))
    assert gemm_ops.gemm_update_rows((st, ix(a_rows)), (st, ix(b_rows)), c,
                                     c, trans_b=True, subtract=True) is None
    for r, w in zip(c_rows, want):
        assert torch.equal(st[r], w)
    untouched = [r for r in range(10) if r not in c_rows]
    assert torch.equal(st[untouched], before[untouched])
    fresh = gemm_ops.gemm_update_rows((before, ix(a_rows)),
                                      (before, ix(b_rows)), trans_b=True)
    assert fresh.shape == (3, 8, 8)
    for g, (a, b) in enumerate(zip(a_rows, b_rows)):
        assert torch.equal(fresh[g], before[a] @ before[b].T)


@pytest.mark.parametrize("out_rows,why", [
    ([0, 5, 6], "shares rows with A"),
    ([5, 3, 6], "shares rows with B"),
    ([7, 9, 5], "aliases C other than row for row"),
    ([5, 5, 6], "two results share one row"),
    ([5, 6, 10], "outside its store"),
    ("int64 tensor", "rows must be a lowered step's index")])
def test_the_rows_entry_refuses_unsafe_outputs(out_rows, why):
    """Unsafe output rows, and rows of a kind no lowered step makes (an
    int64 tensor)."""
    st = _store(10, 2)
    before = st.clone()
    ix = _ix if out_rows != "int64 tensor" else torch.tensor
    with pytest.raises(ValueError, match=why):
        gemm_ops.gemm_update_rows(
            (st, ix([0, 1, 2])), (st, ix([3, 3, 4])), (st, ix([7, 5, 9])),
            (st, ix([5, 6, 8] if out_rows == "int64 tensor" else out_rows)),
            trans_b=True, subtract=True)
    assert torch.equal(st, before)


# ---------------------------------------------------------------------------
# the hooks on the plan's indices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l_rows", [[6, 6, 6], [6, 8, 6]])
def test_the_trsm_hook_inverts_the_groups_l_rows(l_rows):
    """One diagonal tile for the group (the plan's ``one`` row, as every
    level of the Cholesky has it) or several: the list form's result on
    the same tiles, bit for bit."""
    st = _store(10, 5)
    st[6:10] = torch.tril(st[6:10]) + 8.0 * torch.eye(8)
    l_ix, c_ix = _ix(l_rows), _ix([0, 1, 2])
    assert (l_ix.one is not None) == (len(set(l_rows)) == 1)
    got = chol.trsm_rows((st, l_ix), (st, c_ix))
    want = chol.trsm_tiles(list(st[l_rows]), list(st[[0, 1, 2]]))
    assert torch.equal(got, torch.stack(want))


@pytest.mark.parametrize("into", [True, False])
def test_the_dropped_update_keeps_the_first_c_row_in_the_rows_hook(into):
    """``one_update_dropped`` wraps the GEMM's rows hook: the group's
    first C row keeps its value, written in place or returned, and every
    other tile is the plain update; the hook is the program's again
    after the block."""
    from parsec_tpu_torch.ops.factor import one_update_dropped
    st = _store(10, 6)
    before = st.clone()
    a_rows, b_rows, c_rows = [0, 1, 2], [3, 3, 4], [7, 5, 9]
    a, b, c = ((st, _ix(r)) for r in (a_rows, b_rows, c_rows))
    want = [gemm_ops.gemm_update_plain(st[x], st[y], st[z], trans_b=True,
                                       subtract=True)
            for x, y, z in zip(a_rows, b_rows, c_rows)]
    with one_update_dropped("gemm_nt") as dropped:
        hook = find_traceable("gemm_nt").rows
        assert hook is not chol.gemm_nt_rows
        res = hook(a, b, c, out=(c,)) if into else hook(a, b, c)
    assert dropped == [1]
    assert find_traceable("gemm_nt").rows is chol.gemm_nt_rows
    got = st[c_rows] if into else res
    assert res is None if into else torch.equal(st, before)
    assert torch.equal(got[0], before[7])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_the_dropped_update_runs_the_programs_in_place_path():
    """The faulty lowered Cholesky moves what the program moves (nothing
    gathered, SYRK and GEMM written in place) and differs from its
    factor."""
    from parsec_tpu_torch.ops.factor import one_update_dropped
    _, low, want = _cholesky(5)
    with one_update_dropped("gemm_nt") as dropped:
        _, low_f, got = _cholesky(5)
    assert dropped == [1]
    assert low_f.rows_moved == low.rows_moved
    assert low_f.rows_moved["gather"] == {}
    assert not torch.equal(got["A"], want["A"])


def test_a_traceable_takes_rows_or_stacked_not_both():
    """One batched form a class on the lowered step: ``register_traceable``
    refuses a ``rows`` hook beside a stacked form, and registers
    nothing."""
    def form(*a, **kw):
        return None

    with pytest.raises(ValueError, match="rows or stacked, not both"):
        register_traceable("rows_and_stacked", form, stacked=form,
                           rows=form)
    assert find_traceable("rows_and_stacked") is None
    with pytest.raises(ValueError, match="rows or stacked, not both"):
        Traceable(form, stacked=form, rows=form)

"""The port's taskpool lowering (``parsec_tpu_torch/ptg/lowering.py``)
against the JAX package's (``parsec_tpu/ptg/lowering.py``).

Every pool is built twice from the same numpy tiles, once with each
package's PTG builder, and lowered by each package's ``lower_taskpool``
(the port with ``device="cpu"``): the passes chosen must be the same, and
the results must match each other and a numpy oracle.  The pools mirror
``tests/test_lowering.py``: the GEMM k-chain (dense and stacked-gather
chain collapse, fp32 and bf16 -> fp32), value chains through the
wavefront and unrolled passes, the WAR and scratch-shadow hazards that
send ``"auto"`` to the unrolled pass, missing inputs arriving as None,
level-atomic forwarding, and the 1-D and 2-D stencils.

Tolerances: fp32 ``rtol=1e-5, atol=1e-5`` between the packages and
against the oracle (fp32 sums of at most 12 products; both sides sum in
order, XLA may fuse a multiply-add); bf16 inputs with fp32 accumulation
``rtol=1e-4, atol=1e-4`` against float64 (the products are exact in
fp32).
"""

from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu import ptg as jptg
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiledMatrix
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVector
from parsec_tpu.models.stencil import stencil_1d_ptg as j_stencil_1d
from parsec_tpu.models.stencil2d import stencil_2d_ptg as j_stencil_2d
from parsec_tpu.models.tiled_gemm import tiled_gemm_fused as j_fused
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm
from parsec_tpu.ptg.lowering import LoweringError as JLoweringError
from parsec_tpu.ptg.lowering import lower_taskpool as j_lower
from parsec_tpu.ptg.lowering import register_traceable as j_register
from parsec_tpu_torch import ptg as tptg
from parsec_tpu_torch.data_dist.matrix import TiledMatrix
from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic
from parsec_tpu_torch.models.stencil import stencil_1d_ptg
from parsec_tpu_torch.models.stencil2d import stencil_2d_ptg
from parsec_tpu_torch.models.tiled_gemm import (tiled_gemm_fused,
                                                tiled_gemm_ptg)
from parsec_tpu_torch.ptg.lowering import (LoweringError, lower_taskpool,
                                           register_traceable)

TOL = dict(rtol=1e-5, atol=1e-5)


def _dense_np(M):
    v = M.to_dense()
    return np.asarray(v, np.float32) if v.dtype == ml_dtypes.bfloat16 else v


JAX = SimpleNamespace(
    name="jax", ptg=jptg, TM=JTiledMatrix, Vec=JVector, dev="tpu",
    gemm=j_gemm, stencil1d=j_stencil_1d, stencil2d=j_stencil_2d,
    lower=lambda tp, **kw: j_lower(tp, **kw), dense=_dense_np)
PORT = SimpleNamespace(
    name="port", ptg=tptg, TM=TiledMatrix, Vec=VectorTwoDimCyclic,
    dev="cuda", gemm=tiled_gemm_ptg, stencil1d=stencil_1d_ptg,
    stencil2d=stencil_2d_ptg,
    lower=lambda tp, **kw: lower_taskpool(tp, device="cpu", **kw),
    dense=lambda M: M.to_tensor().float().numpy())

# the same toy bodies in both packages: JAX's take one task's values, the
# port's take lists over a batch (None for a flow with no value)
j_register("torch_port_scale2", lambda x: x * 2.0)
register_traceable("torch_port_scale2", lambda xs: [x * 2.0 for x in xs])
j_register("torch_port_halo_sum",
           lambda c, l, r: c + (0.0 if l is None else l.sum())
           + (0.0 if r is None else r.sum()))
register_traceable(
    "torch_port_halo_sum",
    lambda cs, ls, rs: [c + (0.0 if ls is None else ls[i].sum())
                        + (0.0 if rs is None else rs[i].sum())
                        for i, c in enumerate(cs)])


# ---------------------------------------------------------------------------
# pools: each builder returns (taskpool, {collection name: collection},
# {collection name: oracle})
# ---------------------------------------------------------------------------

def _gemm(pkg, seed=0, n=12, nb=4, ab_dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32).astype(ab_dtype)
    b = rng.standard_normal((n, n)).astype(np.float32).astype(ab_dtype)
    A = pkg.TM.from_dense("A", a, nb, nb)
    B = pkg.TM.from_dense("B", b, nb, nb)
    C = pkg.TM.from_dense("C", np.zeros((n, n), np.float32), nb, nb)
    want = a.astype(np.float64) @ b.astype(np.float64)
    return pkg.gemm(A, B, C), {"C": C}, {"C": want}


def _gemm_bt(pkg, n=8, nb=4):
    """B stored key-transposed: a non-identity tile grid."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    A = pkg.TM.from_dense("A", a, nb, nb)
    # tile (i, j) of collection Bt holds logical B block (j, i)
    Bt = pkg.TM("Bt", n, n, nb, nb, dtype=np.float32,
                init_fn=lambda i, j, s: b[j * nb:(j + 1) * nb,
                                          i * nb:(i + 1) * nb])
    C = pkg.TM.from_dense("C", np.zeros((n, n), np.float32), nb, nb)
    P = pkg.ptg
    p = P.PTGBuilder("gemm_bt", A=A, Bt=Bt, C=C, MT=C.mt, NT=C.nt, KT=A.nt)
    t = p.task("GEMM", m=P.span(0, lambda g, l: g.MT - 1),
               n=P.span(0, lambda g, l: g.NT - 1),
               k=P.span(0, lambda g, l: g.KT - 1))
    t.flow("A", P.READ).input(data=("A", lambda g, l: (l.m, l.k)))
    t.flow("B", P.READ).input(data=("Bt", lambda g, l: (l.n, l.k)))
    fc = t.flow("C", P.RW)
    fc.input(data=("C", lambda g, l: (l.m, l.n)), guard=lambda g, l: l.k == 0)
    fc.input(pred=("GEMM", "C",
                   lambda g, l: {"m": l.m, "n": l.n, "k": l.k - 1}),
             guard=lambda g, l: l.k > 0)
    fc.output(succ=("GEMM", "C",
                    lambda g, l: {"m": l.m, "n": l.n, "k": l.k + 1}),
              guard=lambda g, l: l.k < g.KT - 1)
    fc.output(data=("C", lambda g, l: (l.m, l.n)),
              guard=lambda g, l: l.k == g.KT - 1)
    t.body(device=pkg.dev, dyld="gemm")
    return p.build(), {"C": C}, {"C": a.astype(np.float64) @ b}


def _scale_chain(pkg, nb=4, K=3):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    X = pkg.TM.from_dense("X", x.copy(), nb, nb)
    P = pkg.ptg
    p = P.PTGBuilder("chain", X=X, K=K, MT=X.mt, NT=X.nt)
    t = p.task("SCALE", m=P.span(0, lambda g, l: g.MT - 1),
               n=P.span(0, lambda g, l: g.NT - 1),
               k=P.span(0, lambda g, l: g.K - 1))
    f = t.flow("V", P.RW)
    f.input(data=("X", lambda g, l: (l.m, l.n)), guard=lambda g, l: l.k == 0)
    f.input(pred=("SCALE", "V",
                  lambda g, l: {"m": l.m, "n": l.n, "k": l.k - 1}),
            guard=lambda g, l: l.k > 0)
    f.output(succ=("SCALE", "V",
                   lambda g, l: {"m": l.m, "n": l.n, "k": l.k + 1}),
             guard=lambda g, l: l.k < g.K - 1)
    f.output(data=("X", lambda g, l: (l.m, l.n)),
             guard=lambda g, l: l.k == g.K - 1)
    t.body(device=pkg.dev, dyld="torch_port_scale2")
    return p.build(), {"X": X}, {"X": x * 2.0 ** K}


def _forward(pkg):
    """A READ flow forwards its input to a second class."""
    x = np.full((4, 4), 3.0, np.float32)
    X = pkg.TM.from_dense("X", x, 4, 4)
    Y = pkg.TM.from_dense("Y", np.zeros((4, 4), np.float32), 4, 4)
    P = pkg.ptg
    p = P.PTGBuilder("fwd", X=X, Y=Y)
    t1 = p.task("SRC", z=P.span(0, 0))
    f1 = t1.flow("A", P.READ)
    f1.input(data=("X", lambda g, l: (0, 0)))
    f1.output(succ=("DST", "B", lambda g, l: {"z": 0}))
    t1.body(device=pkg.dev, dyld="torch_port_scale2")
    t2 = p.task("DST", z=P.span(0, 0))
    f2 = t2.flow("B", P.RW)
    f2.input(pred=("SRC", "A", lambda g, l: {"z": 0}))
    f2.output(data=("Y", lambda g, l: (0, 0)))
    t2.body(device=pkg.dev, dyld="torch_port_scale2")
    return p.build(), {"Y": Y}, {"Y": x * 2.0}


def _war(pkg):
    """A version that must survive past a later in-place write: the
    wavefront pass refuses, and the forwarded value is the ORIGINAL."""
    x = np.full((4, 4), 3.0, np.float32)
    X = pkg.TM.from_dense("X", x, 4, 4)
    Y = pkg.TM.from_dense("Y", np.zeros((4, 8), np.float32), 4, 4)
    P = pkg.ptg
    p = P.PTGBuilder("war", X=X, Y=Y)
    t1 = p.task("SRC", z=P.span(0, 0))
    f1 = t1.flow("A", P.READ)
    f1.input(data=("X", lambda g, l: (0, 0)))
    f1.output(succ=("MID", "B", lambda g, l: {"z": 0}))
    t1.body(device=pkg.dev, dyld="torch_port_scale2")
    t2 = p.task("MID", z=P.span(0, 0))
    f2 = t2.flow("B", P.READ)
    f2.input(pred=("SRC", "A", lambda g, l: {"z": 0}))
    f2.output(succ=("DST", "C", lambda g, l: {"z": 0}))
    t2.body(device=pkg.dev, dyld="torch_port_scale2")
    t3 = p.task("DST", z=P.span(0, 0))
    f3 = t3.flow("C", P.RW)
    f3.input(pred=("MID", "B", lambda g, l: {"z": 0}))
    f3.output(data=("Y", lambda g, l: (0, 0)))
    t3.body(device=pkg.dev, dyld="torch_port_scale2")
    # WRITER updates X(0,0) in place (no collection out-arrow: a scratch
    # write in wavefront terms), racing the forwarded original
    t4 = p.task("WRITER", z=P.span(0, 0))
    f4 = t4.flow("V", P.RW)
    f4.input(data=("X", lambda g, l: (0, 0)))
    f4.output(succ=("SINK", "W", lambda g, l: {"z": 0}))
    t4.body(device=pkg.dev, dyld="torch_port_scale2")
    t5 = p.task("SINK", z=P.span(0, 0))
    f5 = t5.flow("W", P.RW)
    f5.input(pred=("WRITER", "V", lambda g, l: {"z": 0}))
    f5.output(data=("Y", lambda g, l: (0, 1)))
    t5.body(device=pkg.dev, dyld="torch_port_scale2")
    return p.build(), {"Y": Y}, {"Y": np.hstack([x * 2.0, x * 4.0])}


def _shadow(pkg):
    """An in-place (scratch) version parked on a store row must not be
    visible to a LATER direct read of that row."""
    x = np.full((4, 8), 3.0, np.float32)
    X = pkg.TM.from_dense("X", x, 4, 4)
    Y = pkg.TM.from_dense("Y", np.zeros((4, 4), np.float32), 4, 4)
    P = pkg.ptg
    p = P.PTGBuilder("shadow", X=X, Y=Y)
    t1 = p.task("WRITER", z=P.span(0, 0))
    f1 = t1.flow("V", P.RW)
    f1.input(data=("X", lambda g, l: (0, 0)))
    f1.output(succ=("SINK", "W", lambda g, l: {"z": 0}))
    t1.body(device=pkg.dev, dyld="torch_port_scale2")
    t2 = p.task("SINK", z=P.span(0, 0))
    f2 = t2.flow("W", P.READ)
    f2.input(pred=("WRITER", "V", lambda g, l: {"z": 0}))
    t2.body(device=pkg.dev, dyld="torch_port_scale2")
    t3 = p.task("PRE", z=P.span(0, 0))
    f3 = t3.flow("P", P.READ)
    f3.input(data=("X", lambda g, l: (0, 1)))
    c3 = t3.flow("GO", P.CTL)
    c3.output(succ=("READER", "D", lambda g, l: {"z": 0}))
    t3.body(device=pkg.dev, dyld="torch_port_scale2")
    t4 = p.task("READER", z=P.span(0, 0))
    f4 = t4.flow("D", P.CTL)
    f4.input(pred=("PRE", "GO", lambda g, l: {"z": 0}))
    f5 = t4.flow("E", P.READ)
    f5.input(data=("X", lambda g, l: (0, 0)))
    f5.output(data=("Y", lambda g, l: (0, 0)))
    t4.body(device=pkg.dev, dyld="torch_port_scale2")
    return p.build(), {"Y": Y}, {"Y": x[:, :4]}


def _halo(pkg):
    """Flows with no active input arrow reach the body as None; boundary
    tasks group apart from interior ones."""
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    X = pkg.TM.from_dense("X", x.copy(), 2, 2)
    NT = X.nt
    P = pkg.ptg
    p = P.PTGBuilder("halo", X=X, NT=NT)
    t = p.task("H", i=P.span(0, lambda g, l: g.NT - 1))
    fc = t.flow("C", P.RW)
    fc.input(data=("X", lambda g, l: (0, l.i)))
    fc.output(data=("X", lambda g, l: (0, l.i)))
    t.flow("L", P.READ).input(data=("X", lambda g, l: (0, l.i - 1)),
                              guard=lambda g, l: l.i > 0)
    t.flow("R", P.READ).input(data=("X", lambda g, l: (0, l.i + 1)),
                              guard=lambda g, l: l.i < g.NT - 1)
    t.body(device=pkg.dev, dyld="torch_port_halo_sum")
    tiles = [x[:, 2 * i:2 * i + 2] for i in range(NT)]
    want = np.hstack([tiles[i]
                      + (tiles[i - 1].sum() if i > 0 else 0.0)
                      + (tiles[i + 1].sum() if i < NT - 1 else 0.0)
                      for i in range(NT)])
    return p.build(), {"X": X}, {"X": want}


def _level_atomic(pkg):
    """One level both overwrites X's rows (BUMP) and forwards the same
    rows' snapshot into Y (COPY): the snapshot must be the original."""
    x = np.arange(48, dtype=np.float32).reshape(4, 12)
    X = pkg.TM.from_dense("X", x.copy(), 4, 4)
    Y = pkg.TM.from_dense("Y", np.zeros((4, 12), np.float32), 4, 4)
    P = pkg.ptg
    p = P.PTGBuilder("atomic", X=X, Y=Y, NT=X.nt)
    t1 = p.task("BUMP", i=P.span(0, lambda g, l: g.NT - 1))
    f1 = t1.flow("V", P.RW)
    f1.input(data=("X", lambda g, l: (0, l.i)))
    f1.output(data=("X", lambda g, l: (0, l.i)))
    t1.body(device=pkg.dev, dyld="torch_port_scale2")
    t2 = p.task("COPY", i=P.span(0, lambda g, l: g.NT - 1))
    f2 = t2.flow("A", P.READ)
    f2.input(data=("X", lambda g, l: (0, l.i)))
    f2.output(data=("Y", lambda g, l: (0, l.i)))
    t2.body(device=pkg.dev, dyld="torch_port_scale2")
    return p.build(), {"X": X, "Y": Y}, {"X": 2.0 * x, "Y": x}


def _stencil1d(pkg, R=2, T=4):
    rng = np.random.default_rng(11)
    base = rng.standard_normal(64).astype(np.float32)
    w = rng.standard_normal(2 * R + 1)
    V = pkg.Vec("V", lm=64, mb=16,
                init_fn=lambda m, size: base[m * 16:m * 16 + size])
    want = np.asarray(base, np.float64)
    for _ in range(T):
        want = np.convolve(np.concatenate([np.zeros(R), want, np.zeros(R)]),
                           w[::-1], mode="valid")
    return pkg.stencil1d(V, w, T), {"V": V}, {"V": want}


def _stencil2d(pkg, T=3):
    w = (0.5, 0.15, 0.15, 0.1, 0.1)
    dense = np.random.default_rng(12).standard_normal((16, 24)).astype(
        np.float32)
    M = pkg.TM.from_dense("M", dense.copy(), 8, 8)
    x = dense.astype(np.float64)
    for _ in range(T):
        pad = np.zeros((x.shape[0] + 2, x.shape[1] + 2))
        pad[1:-1, 1:-1] = x
        x = (w[0] * pad[1:-1, 1:-1] + w[1] * pad[:-2, 1:-1]
             + w[2] * pad[2:, 1:-1] + w[4] * pad[1:-1, :-2]
             + w[3] * pad[1:-1, 2:])
    return pkg.stencil2d(M, w, T), {"M": M}, {"M": x}


def _collect(pkg, coll):
    if hasattr(coll, "to_dense") or hasattr(coll, "to_tensor"):
        return pkg.dense(coll)
    return np.concatenate([np.asarray(coll.data_of(i).newest_copy().value,
                                      np.float32) for i in range(coll.mt)])


POOLS = {
    "gemm": (_gemm, "chain-collapse"),
    "gemm_bt": (_gemm_bt, "chain-collapse"),
    "scale_chain": (_scale_chain, "wavefront"),
    "forward": (_forward, "wavefront"),
    "war": (_war, "unrolled"),
    "shadow": (_shadow, "unrolled"),
    "halo": (_halo, "wavefront"),
    "level_atomic": (_level_atomic, "wavefront"),
    "stencil1d": (_stencil1d, "wavefront"),
    "stencil2d": (_stencil2d, "wavefront"),
}


def _run(pkg, builder, passes):
    tp, colls, want = builder(pkg)
    low = pkg.lower(tp, passes=passes)
    low.execute()
    return low.mode, {k: _collect(pkg, c) for k, c in colls.items()}, want


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_auto_mode_and_results_match_jax(pool):
    builder, mode = POOLS[pool]
    j_mode, j_out, want = _run(JAX, builder, "auto")
    p_mode, p_out, _ = _run(PORT, builder, "auto")
    assert p_mode == j_mode == mode
    for name in want:
        np.testing.assert_allclose(p_out[name], j_out[name], **TOL)
        np.testing.assert_allclose(p_out[name], want[name], **TOL)


@pytest.mark.parametrize("pool,passes", [
    ("gemm", "wavefront"), ("gemm", "unrolled"),
    ("scale_chain", "unrolled"), ("stencil1d", "unrolled"),
    ("stencil2d", "unrolled")])
def test_forced_passes_match_jax(pool, passes):
    """The GEMM k-chain through the wavefront pass runs the traceable's
    stacked form over each level's group; the unrolled pass runs the
    list form task by task."""
    builder, _ = POOLS[pool]
    j_mode, j_out, want = _run(JAX, builder, passes)
    p_mode, p_out, _ = _run(PORT, builder, passes)
    assert p_mode == j_mode == passes
    for name in want:
        np.testing.assert_allclose(p_out[name], j_out[name], **TOL)
        np.testing.assert_allclose(p_out[name], want[name], **TOL)


@pytest.mark.parametrize("ab_dtype", [np.float32, ml_dtypes.bfloat16])
def test_gemm_dense_chain_collapse(ab_dtype):
    """Identity tile grids select the dense layout: the stores are the
    whole matrices, A and B keep their dtype (bf16 never widens on its
    way to the device), and one call of the body is the whole step."""
    tp, colls, want = _gemm(PORT, seed=3, n=16, nb=4, ab_dtype=ab_dtype)
    low = lower_taskpool(tp, device="cpu")
    assert low.mode == "chain-collapse"
    assert low.layout == {"A": "dense", "B": "dense", "C": "dense"}
    st = low.initial_stores()
    dt = torch.bfloat16 if ab_dtype == ml_dtypes.bfloat16 else torch.float32
    assert st["A"].shape == (16, 16) and st["A"].dtype == dt
    assert st["C"].dtype == torch.float32
    low.execute()
    jtp, jcolls, _ = _gemm(JAX, seed=3, n=16, nb=4, ab_dtype=ab_dtype)
    j_lower(jtp).execute()
    got = colls["C"].to_tensor().numpy()
    np.testing.assert_allclose(got, jcolls["C"].to_dense(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, want["C"], rtol=1e-4, atol=1e-4)


def test_gemm_permuted_operand_uses_stacked_gather():
    tp, colls, want = _gemm_bt(PORT)
    low = lower_taskpool(tp, device="cpu")
    assert low.mode == "chain-collapse"
    assert low.layout["Bt"] == "stacked"
    assert low.initial_stores()["Bt"].shape == (4, 4, 4)
    low.execute()
    np.testing.assert_allclose(colls["C"].to_tensor().numpy(), want["C"],
                               **TOL)


@pytest.mark.parametrize("pool", ["gemm", "gemm_bt", "stencil1d",
                                  "level_atomic", "war"])
def test_step_is_pure_and_rerunnable(pool):
    """``step_fn`` leaves its input stores as they were, and two steps
    from the same stores give the same result."""
    builder, _ = POOLS[pool]
    tp, _, _ = builder(PORT)
    low = lower_taskpool(tp, device="cpu")
    st = low.initial_stores()
    before = {k: v.clone() for k, v in st.items()}
    one = low.step_fn(st)
    two = low.step_fn(st)
    for k in st:
        torch.testing.assert_close(st[k], before[k], rtol=0, atol=0)
        torch.testing.assert_close(one[k], two[k], rtol=0, atol=0)


def test_gemm_steps_chain_like_jax():
    """Feeding a step its own output accumulates: C + 2AB, as the JAX
    step composed with itself."""
    tp, _, want = _gemm(PORT, seed=2, n=8, nb=4)
    low = lower_taskpool(tp, device="cpu")
    st = low.step_fn(low.step_fn(low.initial_stores()))
    np.testing.assert_allclose(st["C"].numpy(), 2 * want["C"], **TOL)


def test_stencil_groups_one_call_per_group_a_level():
    """Per level: one group, the boundary tiles folded into the interior
    ones, and one call of the traceable's ``rows`` hook for it (one K3
    launch a level on the card), which reads the tiles in place: no
    list call, no gather."""
    tp, _, _ = _stencil1d(PORT, R=1, T=5)
    tr = tp.local_traceables["stencil1d"]
    calls = {"rows": 0, "apply": 0}

    def count(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    tr.rows = count("rows", tr.rows)
    tr.apply = count("apply", tr.apply)
    low = lower_taskpool(tp, device="cpu")
    assert low.step_fn.groups == low.step_fn.levels == 5
    low.execute()
    assert calls == {"rows": 5, "apply": 0}


def test_python_body_is_not_lowerable():
    X = TiledMatrix.from_dense("X", np.zeros((4, 4), np.float32), 4, 4)
    p = tptg.PTGBuilder("nope", X=X)
    t = p.task("T", z=tptg.span(0, 0))
    f = t.flow("V", tptg.RW)
    f.input(data=("X", lambda g, l: (0, 0)))
    f.output(data=("X", lambda g, l: (0, 0)))
    t.body(lambda es, task, g, l: None)       # python-only body
    with pytest.raises(LoweringError):
        lower_taskpool(p.build(), device="cpu")


def test_ragged_tiles_are_not_lowerable():
    a = np.zeros((6, 6), np.float32)          # 6/4 -> ragged edge tiles
    A = TiledMatrix.from_dense("A", a, 4, 4)
    B = TiledMatrix.from_dense("B", a.copy(), 4, 4)
    C = TiledMatrix.from_dense("C", a.copy(), 4, 4)
    with pytest.raises(LoweringError):
        lower_taskpool(tiled_gemm_ptg(A, B, C), device="cpu")


def test_forced_pass_that_does_not_apply():
    tp, _, _ = _scale_chain(PORT)
    with pytest.raises(LoweringError):
        lower_taskpool(tp, device="cpu", passes="chain-collapse")
    tp, _, _ = _war(PORT)
    with pytest.raises(LoweringError):
        lower_taskpool(tp, device="cpu", passes="wavefront")
    with pytest.raises(ValueError):
        lower_taskpool(tp, device="cpu", passes="regions")


def test_writeback_bumps_versions_and_gives_tiles_of_their_own():
    tp, colls, _ = _gemm(PORT, seed=3, n=8, nb=4)
    C = colls["C"]
    v0 = C.data_of(0, 0).newest_copy().version
    lower_taskpool(tp, device="cpu").execute()
    assert C.data_of(0, 0).newest_copy().version == v0 + 1
    tiles = [C.data_of(i, j).newest_copy().value
             for i in range(2) for j in range(2)]
    assert all(t.is_contiguous() and t.device.type == "cpu" for t in tiles)
    assert len({t.untyped_storage().data_ptr() for t in tiles}) == 4


def test_multi_rank_context_without_a_mesh_is_refused():
    """A context over more than one rank with no mesh, or a mesh with no
    ``"ranks"`` axis, raises LoweringError as in the JAX package, so a
    caller that catches it runs the dynamic scheduler on the pool."""
    for pkg in (JAX, PORT):
        tp, _, _ = _gemm(pkg)
        err = LoweringError if pkg is PORT else JLoweringError
        with pytest.raises(err, match="mesh"):
            pkg.lower(tp, context=SimpleNamespace(nb_ranks=2))
        with pytest.raises(err, match="ranks"):
            pkg.lower(tp, mesh=object())


def test_lowering_onto_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU error cannot be observed")
    tp, _, _ = _gemm(PORT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lower_taskpool(tp)                    # device="cuda" by default


def test_tiled_gemm_fused_matches_jax():
    rng = np.random.default_rng(9)
    a, b, c = (rng.standard_normal((24, 24)).astype(np.float32)
               for _ in range(3))
    got = tiled_gemm_fused(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_fused(a, b, c)),
                               **TOL)

"""Reference-shaped JDF ingestion in the port, against the JAX package.

The cases of ``tests/test_jdf_reference.py`` run through both packages
on the same seeded numpy inputs:

- the translated reference stencil on 1, 2 and 4 ranks: the port's copy
  (``parsec_tpu_torch/examples/jdf/stencil_1D.jdf``, torch prologue)
  against the JAX package's ``load_jdf`` of the original and against
  ``stencil_reference``; the multi-rank runs also hold each rank's
  staged payload bytes equal to the JAX run's, which only the ``LR`` wire
  regions (``mb * R * itemsize`` a halo) make small;
- the translated ``Ex05``–``Ex07`` JDF files, read where they lie, on one
  rank and on four;
- the user-defined override family (``nb_local_tasks_fn``,
  ``make_key_fn``, ``find_deps_fn``, ``hash_struct``, ``startup_fn``,
  body ``evaluate``, ``SIMCOST``), ``%option termdet = user_trigger``,
  the empty ranged fan-in, and the rejections (``JDFError`` with the JAX
  message);
- counted classes never reach the native dep table.

Tolerance: the stencil bodies compute in float64 on fp32 tiles in both
packages, ``rtol=1e-4, atol=1e-5`` against the oracle as in the JAX
test, and ``rtol=atol=1e-5`` between the packages.
"""

import pathlib

import numpy as np
import pytest
import torch

from parsec_tpu import ptg as jptg
from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JTwoDim
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVector
from parsec_tpu.models.stencil import stencil_reference as j_reference
from parsec_tpu.runtime import Context as JContext
from parsec_tpu.runtime.task import KeyHashStruct as JKeyHashStruct
from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.core.params import params as port_params
from parsec_tpu_torch.data_dist.matrix import (TwoDimBlockCyclic,
                                               VectorTwoDimCyclic)
from parsec_tpu_torch.models.stencil import stencil_reference
from parsec_tpu_torch.runtime import Context, UserTriggerTermDet
from parsec_tpu_torch.runtime.task import KeyHashStruct

ROOT = pathlib.Path(__file__).resolve().parent.parent
JDF_DIR = ROOT / "examples" / "jdf"
PORT_STENCIL = ROOT / "parsec_tpu_torch" / "examples" / "jdf" / "stencil_1D.jdf"


# ---------------------------------------------------------------------------
# the translated stencil
# ---------------------------------------------------------------------------

def _interior(MB, NB, LNT, R, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((MB, LNT * (NB - 2 * R))).astype(np.float32)


def _stencil_desc(cls, interior, nranks, rank, MB, NB, LMT, LNT, R):
    """LMT x LNT buffer tiles of (MB, NB); generation 0 in buffer row 0,
    ghosts zero."""
    def init(m, n, shape):
        tile = np.zeros(shape, np.float32)
        if m == 0:
            w = NB - 2 * R
            tile[:, R:NB - R] = interior[:, n * w:(n + 1) * w]
        return tile

    return cls("descA", lm=LMT * MB, ln=LNT * NB, mb=MB, nb=NB,
               P=1, Q=nranks, myrank=rank, init_fn=init)


def _oracle(interior, W, iters):
    return np.stack([stencil_reference(torch.from_numpy(row.astype(
        np.float64)), torch.as_tensor(W), iters).numpy()
        for row in interior])


_ST = dict(MB=2, NB=8, LMT=2, LNT=8, R=2, iters=4)
_W = np.array([0.1, 0.2, 0.4, 0.2, 0.1])


def _stencil_rank(port):
    def body(ctx, rank, nranks):
        MB, NB, LMT, LNT, R, iters = (_ST[k] for k in
                                      ("MB", "NB", "LMT", "LNT", "R",
                                       "iters"))
        interior = _interior(MB, NB, LNT, R, seed=1)
        desc = _stencil_desc(TwoDimBlockCyclic if port else JTwoDim,
                             interior, nranks, rank, MB, NB, LMT, LNT, R)
        jdf = (ptg.load_jdf(PORT_STENCIL) if port
               else jptg.load_jdf(JDF_DIR / "stencil_1D.jdf"))
        tp = jdf.build(descA=desc, iter=iters, R=R, W=_W, LMT=LMT, LNT=LNT)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        m = iters % LMT
        tiles = {n: np.asarray(desc.data_of(m, n).newest_copy().value).copy()
                 for n in range(LNT) if desc.rank_of(m, n) == rank}
        staged = (ctx.comm_engine.payload_bytes_staged
                  if ctx.comm_engine is not None else 0)
        return tiles, staged
    return body


def _gather(results, NB, R):
    tiles = {}
    for rank_tiles, _ in results:
        tiles.update(rank_tiles)
    return np.concatenate([tiles[n][:, R:NB - R] for n in sorted(tiles)],
                          axis=1)


@pytest.mark.parametrize("nranks", [1, 2, 4])
def test_translated_stencil_on_ranks(nranks):
    NB, R = _ST["NB"], _ST["R"]
    port = run_multirank(nranks, _stencil_rank(True), timeout=180)
    jax = j_run_multirank(nranks, _stencil_rank(False), timeout=180)
    got, jgot = _gather(port, NB, R), _gather(jax, NB, R)
    want = _oracle(_interior(_ST["MB"], NB, _ST["LNT"], R, seed=1), _W,
                   _ST["iters"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)
    staged = [s for _, s in port]
    assert staged == [s for _, s in jax]
    # a halo to a rank ships its (MB, R) region; when both neighbours of
    # a tile live on ONE other rank (two ranks), the two views of one
    # activation merge into the whole tile, in both packages
    region, tile = _ST["MB"] * R * 4, _ST["MB"] * NB * 4
    LNT = _ST["LNT"]
    per_gen = 0
    for n in range(LNT):
        dests = [m % nranks for m in (n - 1, n + 1)
                 if 0 <= m < LNT and m % nranks != n % nranks]
        per_gen += (tile if len(dests) == 2 and dests[0] == dests[1]
                    else region * len(dests))
    assert sum(staged) == per_gen * _ST["iters"]
    if nranks > 2:
        assert per_gen == 2 * (LNT - 1) * region


def test_port_stencil_copy_imports_no_jax_package():
    text = PORT_STENCIL.read_text()
    assert "parsec_tpu_torch.data.datatype import WireRegion" in text
    assert "from parsec_tpu." not in text and "import parsec_tpu\n" not in text
    assert "jax" not in text


def test_translated_stencil_matches_the_programmatic_stencil():
    """1-row tiles make the JDF stencil the 1-D problem of
    ``stencil_1d_ptg``: the same trajectory."""
    from parsec_tpu_torch.models.stencil import stencil_1d_ptg
    MB, R, iters, NB, LMT, LNT = 1, 1, 4, 6, 2, 3
    interior = _interior(MB, NB, LNT, R, seed=3)
    desc = _stencil_desc(TwoDimBlockCyclic, interior, 1, 0, MB, NB, LMT,
                         LNT, R)
    W = np.array([0.25, 0.5, 0.25])
    tp = ptg.load_jdf(PORT_STENCIL).build(descA=desc, iter=iters, R=R, W=W,
                                          LMT=LMT, LNT=LNT)
    with Context(nb_cores=0) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
    m = iters % LMT
    got = np.concatenate([desc.data_of(m, n).newest_copy().value[:, R:NB - R]
                          .numpy() for n in range(LNT)], axis=1)[0]
    w = NB - 2 * R
    V = VectorTwoDimCyclic("V", lm=interior.shape[1], mb=w,
                           init_fn=lambda i, size:
                           interior[0, i * w:i * w + size])
    with Context(nb_cores=0) as ctx:
        ctx.add_taskpool(stencil_1d_ptg(V, W, iters))
        ctx.wait(timeout=60)
    prog = torch.cat([V.data_of(i).newest_copy().value
                      for i in range(V.mt)]).numpy()
    np.testing.assert_allclose(got, prog, rtol=1e-5, atol=1e-5)
    jwant = j_reference(interior[0].astype(np.float64), W, iters)
    np.testing.assert_allclose(got, jwant, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the translated Ex05-07
# ---------------------------------------------------------------------------

def _ex_body(port, fname):
    def body(ctx, rank, nranks):
        nodes = nranks
        cls = VectorTwoDimCyclic if port else JVector
        md = cls("mydata", lm=nodes + 7, mb=1, P=nranks, myrank=rank,
                 dtype=np.int32,
                 init_fn=lambda m, size: np.zeros(size, np.int32))
        jdf = (ptg if port else jptg).load_jdf(JDF_DIR / fname)
        tp = jdf.build(mydata=md, nodes=nodes)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        return {k: int(np.asarray(md.data_of(k).newest_copy().value)[0])
                for k in range(md.mt) if md.rank_of(k) == rank}
    return body


@pytest.mark.parametrize("nranks", [1, 4])
@pytest.mark.parametrize("fname", ["Ex05_Broadcast.jdf", "Ex06_RAW.jdf",
                                   "Ex07_RAW_CTL.jdf"])
def test_translated_examples(fname, nranks):
    got = run_multirank(nranks, _ex_body(True, fname))
    want = j_run_multirank(nranks, _ex_body(False, fname))
    assert got == want
    if fname != "Ex05_Broadcast.jdf":
        values = {k: v for r in got for k, v in r.items()}
        assert all(values[k] == -k - 1 for k in range(nranks))


def test_ex07_counted_join_with_workers():
    """The counted CTL fan-in on one rank with two workers: every Recv
    sees the value before the update."""
    md = VectorTwoDimCyclic("mydata", lm=11, mb=1, dtype=np.int32,
                            init_fn=lambda m, size: np.zeros(size, np.int32))
    tp = ptg.load_jdf(JDF_DIR / "Ex07_RAW_CTL.jdf").build(mydata=md,
                                                          nodes=4)
    assert tp.task_class("TaskUpdate").counted
    with Context(nb_cores=2) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
    assert [int(md.data_of(k).newest_copy().value[0]) for k in range(4)] \
        == [-1, -2, -3, -4]


def test_counted_classes_never_reach_the_native_table():
    """With the index tier off, a counted class still decrements its goal
    in the Python tier: the native table sees only the mask classes."""
    from parsec_tpu_torch.runtime import deps as port_deps
    old = port_params.get("deps_storage")
    port_params.set("deps_storage", "hash")
    try:
        md = VectorTwoDimCyclic("mydata", lm=11, mb=1, dtype=np.int32,
                                init_fn=lambda m, size:
                                np.zeros(size, np.int32))
        tp = ptg.load_jdf(JDF_DIR / "Ex07_RAW_CTL.jdf").build(mydata=md,
                                                              nodes=4)
        ctx = Context(nb_cores=0)
        seen = []
        if ctx.deps._native is not None:
            inner = ctx.deps._native

            class _Watch:
                def release(self, k64, bit, mask):
                    seen.append(k64 >> port_deps._PARAM_BITS
                                & ((1 << port_deps._TC_BITS) - 1))
                    return inner.release(k64, bit, mask)

                def __len__(self):
                    return len(inner)
            ctx.deps._native = _Watch()
        counted = []
        try:
            orig = ctx.deps._release_counted

            def spy(tp_, tc, *a, **kw):
                counted.append(tc.name)
                return orig(tp_, tc, *a, **kw)
            ctx.deps._release_counted = spy
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
        finally:
            ctx.fini()
        upd = tp.task_class("TaskUpdate").task_class_id
        assert upd not in seen
        assert counted.count("TaskUpdate") == 4 * (1 + 4)   # A + 4 ctl
        assert [int(md.data_of(k).newest_copy().value[0])
                for k in range(4)] == [-1, -2, -3, -4]
    finally:
        port_params.set("deps_storage", old)


# ---------------------------------------------------------------------------
# user-defined overrides (udf.jdf mirror)
# ---------------------------------------------------------------------------

_UD_JDF = """
%{
calls = {"nb": 0, "key": 0, "deps": 0, "hash": 0, "startup": 0, "eval": 0}

def ud_nb_local_tasks(tp):
    calls["nb"] += 1
    return 2 * tp.globals.N    # N tasks in each of the two classes

def ud_make_key(g, l):
    calls["key"] += 1
    return l.i * 1000 + 7

def ud_find_deps(tp, g, l):
    calls["deps"] += 1
    return ("CHAIN", l.i)

def never_here(es, task):
    calls["eval"] += 1
    from PKG.runtime import HOOK_RETURN_NEXT
    return HOOK_RETURN_NEXT

def ud_startup(tp, context, g):
    calls["startup"] += 1
    return [{"i": i} for i in range(g.N)]
%}

%option nb_local_tasks_fn = ud_nb_local_tasks

V [type = data]
N [type = int]
out [type = object]
ud_hs [type = object]

CHAIN(i) [make_key_fn = ud_make_key  find_deps_fn = ud_find_deps  hash_struct = ud_hs]
  i = 0 .. N - 1
  SIMCOST i + 1
  : V(0)
  RW A <- (i == 0) ? V(0) : A CHAIN(i-1)
       -> (i < N - 1) ? A CHAIN(i+1) : V(0)
BODY [evaluate = never_here]
  out.append(("never", i))
END
BODY
  A[...] += 1
  out.append(("chain", i))
END

FREE(i) [startup_fn = ud_startup]
  i = 0 .. N - 1
  : V(0)
  READ X <- V(0)
BODY
  out.append(("free", i))
END
"""


def _ud_run(port, N=5):
    out, hs_calls = [], []
    mod_ptg = ptg if port else jptg
    kh = KeyHashStruct if port else JKeyHashStruct
    V = (VectorTwoDimCyclic if port else JVector)(
        "V", lm=4, mb=4, init_fn=lambda m, size: np.zeros(size))
    text = _UD_JDF.replace("PKG", "parsec_tpu_torch" if port
                           else "parsec_tpu")
    jdf = mod_ptg.parse_jdf(text, "udf")
    hs = kh(key_hash=lambda k: hs_calls.append(k) or hash(k),
            key_print=lambda k: f"<udkey {k}>")
    tp = jdf.build(V=V, N=N, out=out, ud_hs=hs)
    ctx = (Context if port else JContext)(nb_cores=0)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
    finally:
        ctx.fini()
    calls = jdf._last_ns["calls"]
    return dict(out=sorted(out), chain=[i for t, i in out if t == "chain"],
                calls={k: calls[k] for k in ("nb", "startup", "eval")},
                used_keys=calls["key"] > 0 and calls["deps"] > 0,
                hashed=bool(hs_calls),
                sim=tp.largest_simulation_date,
                v=float(np.asarray(V.data_of(0).newest_copy().value)[0]))


def test_ud_overrides_full_family():
    got, want = _ud_run(True), _ud_run(False)
    assert got == want
    N = 5
    assert got["chain"] == list(range(N)) and got["calls"]["nb"] == 1
    assert got["calls"]["eval"] == N and got["calls"]["startup"] == 1
    assert got["sim"] == pytest.approx(N * (N + 1) / 2) and got["v"] == N
    assert got["used_keys"] and got["hashed"]


def test_ud_classes_run_dynamically():
    """The compiled-DAG executor refuses UD overrides and SIMCOST, as the
    JAX package's does."""
    from parsec_tpu.runtime.dagrun import compile_taskpool_dag as jcompile
    from parsec_tpu_torch.runtime.dagrun import compile_taskpool_dag
    src = _UD_JDF.replace("PKG", "parsec_tpu_torch")
    V = VectorTwoDimCyclic("V", lm=4, mb=4)
    tp = ptg.parse_jdf(src, "u").build(V=V, N=3, out=[],
                                       ud_hs=KeyHashStruct())
    jsrc = _UD_JDF.replace("PKG", "parsec_tpu")
    jtp = jptg.parse_jdf(jsrc, "u").build(
        V=JVector("V", lm=4, mb=4), N=3, out=[], ud_hs=JKeyHashStruct())
    ctx, jctx = Context(nb_cores=0), JContext(nb_cores=0)
    try:
        assert compile_taskpool_dag(tp, ctx) is None
        assert jcompile(jtp, jctx) is None
    finally:
        ctx.fini()
        jctx.fini()


_TD = """
%option termdet = user_trigger
V [type = data]
T(i)
  i = 0 .. 0
  : V(0)
  READ X <- V(0)
BODY
  pass
END
"""


def test_per_pool_termdet_option():
    V = VectorTwoDimCyclic("V", lm=1, mb=1)
    tp = ptg.parse_jdf(_TD, "td").build(V=V)
    assert tp.termdet_name == "user_trigger"
    with Context(nb_cores=0) as ctx:
        ctx.add_taskpool(tp)
        assert isinstance(tp.tdm, UserTriggerTermDet)
        assert not tp.test()      # tasks done, but only trigger() ends it
        snap = tp.tdm.snapshot()
        tp.tdm.trigger()
        ctx.wait(timeout=60)
    assert tp.test()
    jtp = jptg.parse_jdf(_TD, "td").build(V=JVector("V", lm=1, mb=1))
    with JContext(nb_cores=0) as jctx:
        jctx.add_taskpool(jtp)
        assert not jtp.test()
        assert (jtp.tdm.nb_tasks, jtp.tdm.nb_pending_actions) == \
            (snap["nb_tasks"], snap["nb_pending_actions"])
        jtp.tdm.trigger()
        jctx.wait(timeout=60)


_EMPTY = """K [type = int]
V [type = data]
out [type = object]
P(i)
  i = 0 .. K - 1
  : V(0)
  CTL c -> c J(0)
BODY
  pass
END
J(z)
  z = 0 .. 0
  : V(0)
  CTL c <- c P(0 .. K - 1)
BODY
  out.append("ran")
END
"""


@pytest.mark.parametrize("K", [0, 3])
def test_ranged_fanin_empty_and_full(K):
    """An active ranged CTL input over an EMPTY range expects no arrival
    (the task starts at once); over K producers it waits for all K."""
    ran, jran = [], []
    tp = ptg.parse_jdf(_EMPTY, "empty").build(
        V=VectorTwoDimCyclic("V", lm=1, mb=1), out=ran, K=K)
    tc = tp.task_class("J")
    assert tc.counted and tc.input_dep_goal({"z": 0}) == K
    with Context(nb_cores=0) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)
    jtp = jptg.parse_jdf(_EMPTY, "empty").build(
        V=JVector("V", lm=1, mb=1), out=jran, K=K)
    with JContext(nb_cores=0) as jctx:
        jctx.add_taskpool(jtp)
        jctx.wait(timeout=30)
    assert ran == jran == ["ran"]


def test_dsl_rejects_ranged_data_flow():
    msgs = []
    for mod in (ptg, jptg):
        p = mod.PTGBuilder("bad", N=2)
        f = p.task("T", i=mod.span(0, 1)).flow("X", mod.READ)
        with pytest.raises(ValueError, match="CTL-only") as ei:
            f.input(pred=("T", "X", lambda g, l: ({"i": 0}, {"i": 1})),
                    ranged=True)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


_BAD = [
    ("%option bogus_fn = x\nV [type = data]\n", "unknown %option"),
    ("""
V [type = data]
T(i) [make_key_fn = missing_fn]
  i = 0 .. 0
  : V(0)
  READ X <- V(0)
BODY
  pass
END
""", "does not name"),
    ("""
V [type = data]
A(i)
  i = 0 .. 3
  : V(0)
  RW X <- V(0)
BODY
  pass
END
B(i)
  i = 0 .. 0
  : V(0)
  READ X <- X A(0 .. 3)
BODY
  pass
END
""", "CTL-only"),
    ("V [type = data]\nT(i)\n  i = 0 .. 0\n  SIMCOST\n", "SIMCOST needs"),
]


@pytest.mark.parametrize("src,match", _BAD, ids=[m for _, m in _BAD])
def test_ud_jdf_errors_match_the_jax_messages(src, match):
    msgs = []
    for mod in (ptg, jptg):
        with pytest.raises(mod.JDFError, match=match) as ei:
            mod.parse_jdf(src, "e").build(V=1)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_commcheck_predicts_the_wire_regions_landed_bytes():
    """On 4 ranks every halo of the translated stencil lands its (MB, R)
    region, and commcheck, reading the ``LR`` wire views, predicts the
    landed total exactly."""
    from parsec_tpu_torch.analysis.commcheck import check_comm
    MB, NB, LMT, LNT, R, iters = (_ST[k] for k in
                                  ("MB", "NB", "LMT", "LNT", "R", "iters"))
    interior = _interior(MB, NB, LNT, R, seed=1)

    def body(ctx, rank, nranks):
        desc = _stencil_desc(TwoDimBlockCyclic, interior, nranks, rank, MB,
                             NB, LMT, LNT, R)
        tp = ptg.load_jdf(PORT_STENCIL).build(descA=desc, iter=iters, R=R,
                                              W=_W, LMT=LMT, LNT=LNT)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        return ctx.comm_engine.payload_bytes_received

    landed = run_multirank(4, body, timeout=180)
    desc = _stencil_desc(TwoDimBlockCyclic, interior, 4, 0, MB, NB, LMT,
                         LNT, R)
    cr = check_comm(ptg.load_jdf(PORT_STENCIL).build(
        descA=desc, iter=iters, R=R, W=_W, LMT=LMT, LNT=LNT), nb_ranks=4)
    assert cr.ok and cr.pattern == "halo"
    assert cr.activation_bytes == sum(landed) \
        == 2 * (LNT - 1) * iters * MB * R * 4


def test_wire_region_slices():
    from parsec_tpu.data.datatype import WireRegion as JWireRegion
    from parsec_tpu_torch.data.datatype import WireRegion
    lr, jlr = WireRegion(2, 3, 4), JWireRegion(2, 3, 4)
    tile = np.arange(2 * 10, dtype=np.float32).reshape(2, 10)
    for displ in (0, 4 * 2 * 3, 4 * 2 * 7):
        np.testing.assert_array_equal(
            torch.from_numpy(tile)[lr.slices(displ)].numpy(),
            tile[jlr.slices(displ)])
    assert lr.nbytes == jlr.nbytes == 24
    for region in (lr, jlr):
        with pytest.raises(ValueError, match="not column-aligned"):
            region.slices(4)


_RING = """
%{
def st(tp, context, g):
    return [{"i": 0}]
%}
V [type = data]
T(i) [startup_fn = st]
  i = 0 .. 2
  : V(0)
  CTL c <- c T((i + 2) % 3)
        -> c T((i + 1) % 3)
BODY
  pass
END
"""


def test_graphcheck_counts_a_startup_fn_as_a_start():
    """Every instance of the ring has a task predecessor, so only its
    ``startup_fn`` starts it: graphcheck's findings (the ring's cycle, no
    ``no-startup-task``) equal the JAX package's."""
    from parsec_tpu.analysis import check_ptg as j_check_ptg
    from parsec_tpu_torch.analysis import check_ptg
    rep = check_ptg(ptg.parse_jdf(_RING, "ring").build(
        V=VectorTwoDimCyclic("V", lm=1, mb=1)))
    jrep = j_check_ptg(jptg.parse_jdf(_RING, "ring").build(
        V=JVector("V", lm=1, mb=1)))
    codes = sorted(f.code for f in rep.findings)
    assert codes == sorted(f.code for f in jrep.findings)
    assert codes == ["dependency-cycle"]     # no "no-startup-task"


def test_stage_hooks_replace_the_device_staging():
    """A class's ``stage_hooks`` run once a task around its device
    dispatch in place of the default staging, task by task (no batched
    launch), and the lowering refuses the class."""
    import parsec_tpu_torch.ops.gemm  # noqa: F401 (registers "gemm")
    from parsec_tpu_torch.data.datatype import TileType
    from parsec_tpu_torch.data_dist.collection import DictCollection
    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.ptg.lowering import LoweringError, lower_taskpool
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    try:
        tt = TileType((4, 4), torch.float32)
        rng = np.random.default_rng(2)
        a = rng.standard_normal((4, 4)).astype(np.float32)
        A = DictCollection("A", dtt=tt, init_fn=lambda *k: a.copy())
        C = DictCollection("C", dtt=tt)
        calls = []

        def stage_in(device, task):
            calls.append(("in", task.locals["i"]))
            for c in task.data:
                if c is not None:
                    c.value = c.value.clone()

        def stage_out(device, task):
            calls.append(("out", task.locals["i"]))

        def build():
            p = ptg.PTGBuilder("hooked", A=A, C=C)
            t = p.task("GEMM", i=ptg.span(0, 3))
            t.flow("A", ptg.READ).input(data=("A", lambda g, l: (0,)))
            t.flow("B", ptg.READ).input(data=("A", lambda g, l: (0,)))
            fc = t.flow("C", ptg.RW)
            fc.input(data=("C", lambda g, l: (l.i,)))
            fc.output(data=("C", lambda g, l: (l.i,)))
            t.stage_hooks(stage_in=stage_in)
            t.stage_hooks(stage_out=stage_out)
            t.body(device="cuda", dyld="gemm")
            return p.build()

        batched = dev.batched_dispatches
        with Context(nb_cores=0) as ctx:
            ctx.add_taskpool(build())
            ctx.wait(timeout=60)
        assert sorted(calls) == sorted([("in", i) for i in range(4)]
                                       + [("out", i) for i in range(4)])
        assert dev.batched_dispatches == batched
        for i in range(4):
            np.testing.assert_allclose(
                C.data_of(i).newest_copy().value.numpy(), a @ a,
                rtol=1e-5, atol=1e-5)
        with pytest.raises(LoweringError, match="stage hooks"):
            lower_taskpool(build(), device="cpu")
    finally:
        registry.devices = snapshot
        for i, d in enumerate(registry.devices):
            d.device_index = i

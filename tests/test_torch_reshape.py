"""Typed-edge reshape in the port against the JAX package.

The cases of ``tests/test_reshape_deps.py`` without layout tags (the port
converts shape and dtype only): an output dep's type, an input dep's
type winning over it, a dtype conversion, the producer's copy left
untouched, one conversion shared by two typed consumers, a typed
collection read, a typed write-back, an untyped write-back restoring the
home tile's type, the cache following the source's version, and the
remote read reshape on two ranks, where the wire carries the producer's
type and the consumer's rank repacks.  Each runs through both packages
on the same numpy values and must give the JAX package's outputs
exactly (a reshape and a cast change no value).  The compiled-DAG
executor and the lowering refuse typed edges in both.
"""

import numpy as np
import pytest
import torch

from parsec_tpu import ptg as jptg
from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.data.data import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JTwoDim
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.data import reshape
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.runtime import Context

F32 = np.float32
_TYPES = {"VEC8": ((8,), "float32"), "MAT24": ((2, 4), "float32"),
          "MAT42": ((4, 2), "float32"), "F64_8": ((8,), "float64")}


class _Pkg:
    """One package's names, so each case is written once."""

    def __init__(self, port):
        self.port = port
        self.ptg = ptg if port else jptg
        self.Context = Context if port else JContext
        self.Dict = DictCollection if port else JDict
        self.TwoDim = TwoDimBlockCyclic if port else JTwoDim
        self.run_multirank = run_multirank if port else j_run_multirank

    def tt(self, name):
        if name is None:
            return None
        shape, dt = _TYPES[name]
        return (TileType(shape, getattr(torch, dt)) if self.port
                else JTileType(shape, np.dtype(dt)))

    def coll(self, name, value):
        v = np.asarray(value, F32)
        dtt = (TileType(v.shape, torch.float32) if self.port
               else JTileType(v.shape, v.dtype))
        return self.Dict(name, dtt=dtt, init_fn=lambda *k: v.copy())

    def run(self, tp):
        ctx = self.Context(nb_cores=0)
        try:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
        finally:
            ctx.fini()


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


BOTH = [_Pkg(True), _Pkg(False)]


def _local_edge(pk, in_dtt=None, out_dtt=None):
    """P -> C over one tile, typed on either end; returns what C saw and
    the home tile after the run."""
    A = pk.coll("A", np.arange(8))
    seen = []
    p = pk.ptg.PTGBuilder("ty", A=A)
    t = p.task("P", i=pk.ptg.span(0, 0))
    f = t.flow("V", pk.ptg.RW)
    f.input(data=("A", lambda g, l: (0,)))
    f.output(succ=("C", "V", lambda g, l: {"i": 0}), dtt=pk.tt(out_dtt))
    t.body(lambda es, task, g, l: None)
    c = p.task("C", i=pk.ptg.span(0, 0))
    c.flow("V", pk.ptg.READ).input(pred=("P", "V", lambda g, l: {"i": 0}),
                                   dtt=pk.tt(in_dtt))
    c.body(lambda es, task, g, l:
           seen.append(_np(task.flow_data("V").value).copy()))
    pk.run(p.build())
    return seen[0], _np(A.data_of(0).newest_copy().value).copy()


@pytest.mark.parametrize("in_dtt,out_dtt", [
    (None, "MAT24"), ("MAT42", "MAT24"), ("F64_8", None), (None, "VEC8")],
    ids=["out-type", "in-wins", "dtype", "same-type"])
def test_local_edge_reshape(in_dtt, out_dtt):
    (seen, home), (jseen, jhome) = (_local_edge(pk, in_dtt, out_dtt)
                                    for pk in BOTH)
    assert seen.shape == jseen.shape and seen.dtype == jseen.dtype
    np.testing.assert_array_equal(seen, jseen)
    # read-side reshape: the producer's copy keeps its type
    assert home.shape == jhome.shape == (8,)
    np.testing.assert_array_equal(home, jhome)


def test_one_conversion_shared_by_two_typed_consumers(monkeypatch):
    calls = []
    inner = reshape._convert_copy
    monkeypatch.setattr(reshape, "_convert_copy",
                        lambda c, w: (calls.append(w), inner(c, w))[1])
    pk = BOTH[0]
    A = pk.coll("A", np.arange(8))
    seen = []
    p = ptg.PTGBuilder("sh", A=A)
    t = p.task("P", i=ptg.span(0, 0))
    f = t.flow("V", ptg.RW)
    f.input(data=("A", lambda g, l: (0,)))
    for name in ("C", "D"):
        f.output(succ=(name, "V", lambda g, l: {"i": 0}),
                 dtt=pk.tt("MAT24"))
    t.body(lambda es, task, g, l: None)
    for name in ("C", "D"):
        c = p.task(name, i=ptg.span(0, 0))
        c.flow("V", ptg.READ).input(pred=("P", "V", lambda g, l: {"i": 0}))
        c.body(lambda es, task, g, l: seen.append(task.flow_data("V")))
    pk.run(p.build())
    assert len(calls) == 1 and seen[0] is seen[1]
    assert tuple(seen[0].value.shape) == (2, 4)


def _collection_read(pk):
    A = pk.coll("A", np.arange(8))
    seen = []
    p = pk.ptg.PTGBuilder("cr", A=A)
    t = p.task("T", i=pk.ptg.span(0, 0))
    t.flow("V", pk.ptg.READ).input(data=("A", lambda g, l: (0,)),
                                   dtt=pk.tt("MAT24"))
    t.body(lambda es, task, g, l:
           seen.append(_np(task.flow_data("V").value).copy()))
    pk.run(p.build())
    return seen[0]


def test_collection_read_with_type():
    got, want = (_collection_read(pk) for pk in BOTH)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got, want)


def _writeback(pk, typed):
    A = pk.coll("A", np.arange(8))
    B = pk.coll("B", np.zeros((2, 4)))
    p = pk.ptg.PTGBuilder("wb", A=A, B=B)
    t = p.task("T", i=pk.ptg.span(0, 0))
    f = t.flow("V", pk.ptg.RW)
    if typed:
        f.input(data=("A", lambda g, l: (0,)))
        f.output(data=("B", lambda g, l: (0,)), dtt=pk.tt("MAT24"))
        t.body(lambda es, task, g, l: None)
    else:
        # the input was reshaped; the untyped write-back restores A's type
        f.input(data=("A", lambda g, l: (0,)), dtt=pk.tt("MAT24"))
        f.output(data=("A", lambda g, l: (0,)))

        def body(es, task, g, l):
            v = task.flow_data("V")
            assert tuple(v.value.shape) == (2, 4)
            v.value = v.value + 100
            v.version += 1
        t.body(body)
    pk.run(p.build())
    return _np((B if typed else A).data_of(0).newest_copy().value).copy()


@pytest.mark.parametrize("typed", [True, False],
                         ids=["typed", "untyped-restores-home"])
def test_writeback(typed):
    got, want = (_writeback(pk, typed) for pk in BOTH)
    assert got.shape == want.shape == ((2, 4) if typed else (8,))
    np.testing.assert_array_equal(got, want)


def test_cache_follows_the_source_version():
    pk = BOTH[0]
    A = pk.coll("A", np.arange(8))
    copy = A.data_of(0).newest_copy()
    mat = pk.tt("MAT24")
    assert not reshape.needs_reshape(copy, None)
    assert not reshape.needs_reshape(copy, pk.tt("VEC8"))
    assert reshape.needs_reshape(copy, mat)
    f1 = reshape.reshaped_future(copy, mat)
    assert reshape.reshaped_future(copy, mat) is f1
    first = f1.get()
    assert first.value.data_ptr() != copy.value.data_ptr()
    np.testing.assert_array_equal(first.value.reshape(-1).numpy(),
                                  np.arange(8, dtype=F32))
    copy.value = torch.arange(100, 108, dtype=torch.float32)
    copy.version += 1
    second = reshape.reshaped_future(copy, mat).get()
    np.testing.assert_array_equal(second.value.reshape(-1).numpy(),
                                  np.arange(100, 108, dtype=F32))


def _remote_body(pk):
    def body(ctx, rank, nranks):
        A = pk.TwoDim("A8", lm=2 * 8, ln=1, mb=8, nb=1, P=2, Q=1,
                      myrank=rank,
                      init_fn=lambda m, n, sh:
                      np.arange(8, dtype=F32).reshape(sh)
                      if tuple(sh) == (8, 1) else np.zeros(sh, F32))
        seen = []
        p = pk.ptg.PTGBuilder("rr", A=A)
        t = p.task("P", i=pk.ptg.span(0, 0))
        t.affinity("A", lambda g, l: (0, 0))
        f = t.flow("V", pk.ptg.RW)
        f.input(data=("A", lambda g, l: (0, 0)))
        f.output(succ=("C", "V", lambda g, l: {"i": 0}))
        t.body(lambda es, task, g, l: None)
        c = p.task("C", i=pk.ptg.span(0, 0))
        c.affinity("A", lambda g, l: (1, 0))   # lives on rank 1
        c.flow("V", pk.ptg.READ).input(
            pred=("P", "V", lambda g, l: {"i": 0}), dtt=pk.tt("MAT24"))
        c.body(lambda es, task, g, l:
               seen.append(_np(task.flow_data("V").value).copy()))
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=60)
        ctx.comm_barrier()
        return seen[0] if seen else None
    return body


def test_remote_read_reshape_on_2_ranks():
    got, want = (pk.run_multirank(2, _remote_body(pk)) for pk in BOTH)
    assert got[0] is None and want[0] is None
    assert got[1].shape == (2, 4)
    np.testing.assert_array_equal(got[1], want[1])


def _remote_writeback_body(pk):
    """Rank 1 computes on a typed read of a rank-0 tile and writes it
    back, untyped, to its rank-0 home: the home keeps its (8, 1) type."""
    def body(ctx, rank, nranks):
        A = pk.TwoDim("A8", lm=2 * 8, ln=1, mb=8, nb=1, P=2, Q=1,
                      myrank=rank,
                      init_fn=lambda m, n, sh:
                      np.arange(8, dtype=F32).reshape(sh) + 10 * m)
        p = pk.ptg.PTGBuilder("rw", A=A)
        t = p.task("T", i=pk.ptg.span(0, 0))
        t.affinity("A", lambda g, l: (1, 0))
        f = t.flow("V", pk.ptg.RW)
        f.input(data=("A", lambda g, l: (1, 0)), dtt=pk.tt("MAT24"))
        f.output(data=("A", lambda g, l: (0, 0)))

        def tbody(es, task, g, l):
            v = task.flow_data("V")
            v.value = v.value * 2
            v.version += 1
        t.body(tbody)
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=60)
        ctx.comm_barrier()
        if rank == 0:
            return _np(A.data_of(0, 0).newest_copy().value).copy()
        return None
    return body


def test_remote_untyped_writeback_restores_the_home_type():
    from parsec_tpu_torch.core.params import params
    old = params.get("termdet")
    params.set("termdet", "fourcounter")
    try:
        got = run_multirank(2, _remote_writeback_body(BOTH[0]))
    finally:
        params.set("termdet", old)
    from parsec_tpu.core.params import params as jparams
    jold = jparams.get("termdet")
    jparams.set("termdet", "fourcounter")
    try:
        want = j_run_multirank(2, _remote_writeback_body(BOTH[1]))
    finally:
        jparams.set("termdet", jold)
    assert got[0].shape == want[0].shape == (8, 1)
    np.testing.assert_array_equal(got[0], want[0])


_JDF = """
A   [type = data]
B   [type = data]
M24 [type = int]

T(i)
  i = 0 .. 0
  : A(0)
  RW V <- A(0)
       -> B(0) [type = M24]
BODY
  pass
END
"""


def test_jdf_type_property():
    outs = []
    for pk in BOTH:
        A = pk.coll("A", np.arange(8))
        B = pk.coll("B", np.zeros((2, 4)))
        pk.run(pk.ptg.parse_jdf(_JDF, "ty").build(A=A, B=B,
                                                  M24=pk.tt("MAT24")))
        outs.append(_np(B.data_of(0).newest_copy().value).copy())
    np.testing.assert_array_equal(outs[0], outs[1])
    msgs = []
    for pk in BOTH:
        with pytest.raises(pk.ptg.JDFError) as ei:
            pk.ptg.parse_jdf(_JDF.replace("-> B(0)", "-> A(0)"), "bad") \
                .build(A=pk.coll("A", np.arange(8)),
                       B=pk.coll("B", np.zeros((2, 4))), M24=7)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _typed_pool(pk):
    A = pk.coll("A", np.arange(8))
    p = pk.ptg.PTGBuilder("oo", A=A)
    t = p.task("P", i=pk.ptg.span(0, 0))
    f = t.flow("V", pk.ptg.RW)
    f.input(data=("A", lambda g, l: (0,)))
    f.output(succ=("C", "V", lambda g, l: {"i": 0}), dtt=pk.tt("MAT24"))
    t.body(lambda es, task, g, l: None)
    c = p.task("C", i=pk.ptg.span(0, 0))
    c.flow("V", pk.ptg.READ).input(pred=("P", "V", lambda g, l: {"i": 0}))
    c.body(lambda es, task, g, l: None)
    return p.build()


def test_typed_edges_opt_out_of_the_compiled_dag_and_the_lowering():
    from parsec_tpu_torch.ptg.lowering import LoweringError, lower_taskpool
    from parsec_tpu_torch.runtime.dagrun import compile_taskpool_dag
    ctx = Context(nb_cores=0)
    try:
        assert compile_taskpool_dag(_typed_pool(BOTH[0]), ctx) is None
    finally:
        ctx.fini()
    with pytest.raises(LoweringError):
        lower_taskpool(_typed_pool(BOTH[0]), device="cpu")

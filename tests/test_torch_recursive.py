"""Recursive task bodies in the port against the JAX package's
(``tests/test_recursive.py``): an outer task's body spawns a nested pool
over ``SubtileCollection`` views of its tiles, detaches, and completes
when the nested pool drains.

Each GEMM case builds one seeded numpy input and runs it through
``parsec_tpu.models.tiled_gemm.tiled_gemm_recursive_ptg`` and the port's
counterpart: on the host (``devices="cpu"``), and with the nested pools
on the device module around the host (``init_cuda_devices(device="cpu")``,
``devices="cuda"``: stage-in of strided sub-tiles, the batched GEMM body,
``sync_parent`` and the release of the sub-tiles' device copies).  C
within ``rtol=1e-3, atol=1e-4`` of the float64 product (the JAX test's)
and within ``1e-5`` of the JAX run.
"""

import numpy as np
import pytest
import torch

from parsec_tpu import ptg as j_ptg
from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.data_dist.matrix import SubtileCollection as JSub
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JTwoDim
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm
from parsec_tpu.models.tiled_gemm import tiled_gemm_recursive_ptg as j_rec
from parsec_tpu.runtime import Context as JContext
from parsec_tpu.runtime import recursive_call as j_recursive_call
from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.data_dist.matrix import (SubtileCollection,
                                               TiledMatrix, TwoDimBlockCyclic)
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models.tiled_gemm import (tiled_gemm_ptg,
                                                tiled_gemm_recursive_ptg)
from parsec_tpu_torch.runtime import Context, recursive_call

PKG = {"port": (ptg, SubtileCollection, TiledMatrix, TwoDimBlockCyclic,
                tiled_gemm_ptg, tiled_gemm_recursive_ptg, Context,
                recursive_call),
       "jax": (j_ptg, JSub, JTiled, JTwoDim, j_gemm, j_rec, JContext,
               j_recursive_call)}


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def _dense(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((n, n)).astype(np.float32)
                 for _ in range(3))


def _mats(pkg, n, nb, seed, nranks=1, rank=0):
    a, b, c = _dense(n, seed)
    Tiled, TwoDim = PKG[pkg][2], PKG[pkg][3]
    if nranks == 1:
        mk = lambda nm, x: Tiled.from_dense(nm, x.copy(), nb, nb)  # noqa: E731
    else:
        mk = lambda nm, x: TwoDim.from_dense(  # noqa: E731
            nm, x.copy(), nb, nb, P=nranks, Q=1, myrank=rank)
    return (a, b, c), mk("A", a), mk("B", b), mk("C", c)


def _rec_run(pkg, n, nb, sub, seed, nb_cores=0, min_tile=0,
             devices="cpu", inputs=None):
    (a, b, c), A, B, C = _mats(pkg, n, nb, seed)
    if inputs is not None:
        inputs.extend((A, B))
    if pkg == "port":
        tp = tiled_gemm_recursive_ptg(A, B, C, sub, sub, min_tile=min_tile,
                                      devices=devices)
    else:
        tp = j_rec(A, B, C, sub_mb=sub, sub_nb=sub, min_tile=min_tile)
    with PKG[pkg][6](nb_cores=nb_cores) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
    return C, c.astype(np.float64) + a.astype(np.float64) @ b


# ---------------------------------------------------------------------------
# the sub-tile views
# ---------------------------------------------------------------------------

def test_sub_tiles_are_views_and_sync_parent_publishes_a_rebound_value():
    parent = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    M = TiledMatrix.from_dense("P", parent.clone(), 8, 8)
    copy = M.data_of(0, 0).newest_copy()
    v0 = copy.version
    sub = SubtileCollection.of_copy(copy, 4, 4, name="S")
    jsub = JSub.of_copy(JTiled.from_dense("P", parent.numpy().copy(), 8, 8)
                        .data_of(0, 0).newest_copy(), 4, 4, name="S")
    assert (sub.mt, sub.nt, sub.mb, sub.nb) == (jsub.mt, jsub.nt, 4, 4)
    # an in-place write lands in the parent: the sub-tile is a view
    t01 = sub.data_of(0, 1).newest_copy()
    t01.value += 1.0
    assert copy.value[0, 4].item() == parent[0, 4].item() + 1.0
    assert t01.value.stride() == (8, 1)
    # a rebound value is written back by sync_parent, in place
    t10 = sub.data_of(1, 0).newest_copy()
    t10.value = torch.full((4, 4), -1.0)
    t10.version += 1
    ptr = copy.value.data_ptr()
    sub.sync_parent()
    assert copy.value.data_ptr() == ptr
    assert copy.version == v0 + 1
    assert torch.equal(copy.value[4:, :4], torch.full((4, 4), -1.0))
    jt = jsub.data_of(1, 0).newest_copy()
    jt.value = np.full((4, 4), -1.0, np.float32)
    jt.version += 1
    jsub.data_of(0, 1).newest_copy().value[...] += 1.0
    jsub.sync_parent()
    np.testing.assert_array_equal(copy.value.numpy(),
                                  np.asarray(jsub.parent_copy.value))


def test_a_parent_collection_view_and_its_ragged_edge():
    x = np.random.default_rng(1).standard_normal((10, 10)).astype(np.float32)
    M = TiledMatrix.from_dense("M", x.copy(), 10, 10)
    sub = SubtileCollection(M, 0, 0, 4, 4)
    jsub = JSub(JTiled.from_dense("M", x.copy(), 10, 10), 0, 0, 4, 4)
    assert (sub.mt, sub.nt) == (jsub.mt, jsub.nt) == (3, 3)
    for m in range(3):
        for n in range(3):
            np.testing.assert_array_equal(
                sub.data_of(m, n).newest_copy().value.numpy(),
                np.asarray(jsub.data_of(m, n).newest_copy().value))
    assert sub.name == jsub.name


# ---------------------------------------------------------------------------
# the recursive GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,nb,sub,nb_cores,seed", [(32, 16, 4, 0, 0),
                                                    (32, 16, 8, 2, 2)])
def test_the_recursive_gemm_equals_the_jax_one_on_the_host(n, nb, sub,
                                                           nb_cores, seed):
    C, want = _rec_run("port", n, nb, sub, seed, nb_cores)
    JC, _ = _rec_run("jax", n, nb, sub, seed, nb_cores)
    got = C.to_dense()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, JC.to_dense(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nb_cores", [0, 2])
def test_the_recursive_gemm_through_the_device_module(cpu_cuda_device,
                                                      nb_cores):
    dev = cpu_cuda_device
    inputs = []
    C, want = _rec_run("port", 32, 16, 4, 5, nb_cores, devices="cuda",
                       inputs=inputs)
    JC, _ = _rec_run("jax", 32, 16, 4, 5, nb_cores)
    dev.sync()
    got = C.to_dense()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, JC.to_dense(), rtol=1e-5, atol=1e-5)
    # 8 outer tasks of 4x4x4 sub-GEMMs, all on the device module; every
    # sub-tile's device copy released when its pool drained
    assert dev.tasks_by_class["GEMM"] == 8 * 64
    assert dev.released == 8 * 3 * 16
    assert not dev._mem_lru
    # the read-only inputs keep their versions: only C's sub-tiles are
    # published into their parent
    for M in inputs:
        assert {M.data_of(m, k).newest_copy().version
                for m in range(2) for k in range(2)} == {1}, M.name


@pytest.mark.parametrize("devices", ["cpu", "cuda"])
def test_min_tile_falls_through_to_the_pool_chore(cpu_cuda_device, devices):
    dev = cpu_cuda_device
    C, want = _rec_run("port", 16, 8, 4, 1, min_tile=8, devices=devices)
    JC, _ = _rec_run("jax", 16, 8, 4, 1, min_tile=8)
    dev.sync()
    dev.flush_cache()
    np.testing.assert_allclose(C.to_dense(), want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(C.to_dense(), JC.to_dense(), rtol=1e-5,
                               atol=1e-5)
    # no recursion: 8 whole-tile GEMMs, on the device module for "cuda"
    assert dev.tasks_by_class["GEMM"] == (8 if devices == "cuda" else 0)
    assert dev.released == 0


def _depth_two_pool(pkg, A, B, C):
    p_, Sub, _, _, _, rec, _, rcall = PKG[pkg]
    p = p_.PTGBuilder("rec2", A=A, B=B, C=C, MT=C.mt, NT=C.nt, KT=A.nt)
    t = p.task("GEMM", m=p_.span(0, lambda g, l: g.MT - 1),
               n=p_.span(0, lambda g, l: g.NT - 1),
               k=p_.span(0, lambda g, l: g.KT - 1))
    t.affinity("C", lambda g, l: (l.m, l.n))
    t.flow("A", p_.READ).input(data=("A", lambda g, l: (l.m, l.k)))
    t.flow("B", p_.READ).input(data=("B", lambda g, l: (l.k, l.n)))
    fc = t.flow("C", p_.RW)
    fc.input(data=("C", lambda g, l: (l.m, l.n)), guard=lambda g, l: l.k == 0)
    fc.input(pred=("GEMM", "C", lambda g, l: {"m": l.m, "n": l.n,
                                              "k": l.k - 1}),
             guard=lambda g, l: l.k > 0)
    fc.output(succ=("GEMM", "C", lambda g, l: {"m": l.m, "n": l.n,
                                               "k": l.k + 1}),
              guard=lambda g, l: l.k < g.KT - 1)
    fc.output(data=("C", lambda g, l: (l.m, l.n)),
              guard=lambda g, l: l.k == g.KT - 1)

    def body(es, task, g, l):
        subs = [Sub.of_copy(task.data[i], 8, 8, name=f"S{i}{task.key}")
                for i in range(3)]
        inner = (rec(*subs, 4, 4, devices="cpu") if pkg == "port"
                 else rec(*subs, sub_mb=4, sub_nb=4))
        return rcall(es, task, inner, collections=(subs[2],))

    t.body(body, device="recursive")
    return p.build()


def test_a_nested_pool_that_recurses_again():
    out = {}
    for pkg in ("port", "jax"):
        (a, b, c), A, B, C = _mats(pkg, 32, 16, 3)
        with PKG[pkg][6](nb_cores=0) as ctx:
            ctx.add_taskpool(_depth_two_pool(pkg, A, B, C))
            ctx.wait(timeout=60)
        out[pkg] = C.to_dense()
    np.testing.assert_allclose(out["port"], c + a @ b, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5,
                               atol=1e-5)


def _drain_order(pkg):
    order = []
    p_, Sub, Tiled, _, gemm, _, Ctx, rcall = PKG[pkg]
    (a, b, c), A, B, C = _mats(pkg, 16, 16, 4)
    p = p_.PTGBuilder("rcb", A=A, B=B, C=C)
    t = p.task("G", z=p_.span(0, 0))
    t.affinity("C", lambda g, l: (0, 0))
    fc = t.flow("C", p_.RW)
    fc.input(data=("C", lambda g, l: (0, 0)))
    fc.output(succ=("S", "X", lambda g, l: {"z": 0}))

    class Spy:
        def __init__(self, inner):
            self.inner = inner

        def sync_parent(self):
            order.append("sync_parent")
            self.inner.sync_parent()

    def gbody(es, task, g, l):
        sub = Sub.of_copy(task.data[0], 8, 8)
        asub = Sub.of_copy(A.data_of(0, 0).newest_copy(), 8, 8)
        bsub = Sub.of_copy(B.data_of(0, 0).newest_copy(), 8, 8)
        inner = gemm(asub, bsub, sub, devices="cpu")
        inner.on_complete = lambda tp_: order.append("on_complete")
        return rcall(es, task, inner,
                     callback=lambda tp_, outer: order.append("callback"),
                     collections=(Spy(sub),))

    t.body(gbody, device="recursive")
    s = p.task("S", z=p_.span(0, 0))
    s.affinity("C", lambda g, l: (0, 0))
    s.flow("X", p_.READ).input(pred=("G", "C", lambda g, l: {"z": 0}))

    def sbody(es, task, g, l):
        order.append("successor")
        seen = task.flow_data("X").value
        order.append(np.allclose(np.asarray(seen), c + a @ b, rtol=1e-3,
                                 atol=1e-4))

    s.body(sbody)
    with Ctx(nb_cores=0) as ctx:
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=60)
    return order


def test_the_drain_chain_runs_in_the_jax_order():
    order = _drain_order("port")
    assert order == _drain_order("jax")
    assert order == ["on_complete", "callback", "sync_parent", "successor",
                     True]


def test_a_failure_in_a_nested_pool_reaches_the_outer_wait():
    (a, b, c), A, B, C = _mats("port", 16, 16, 6)
    reached = []

    def inner_pool():
        p = ptg.PTGBuilder("faulty")
        t = p.task("BAD", i=ptg.span(0, 3))

        def body(es, task, g, l):
            raise RuntimeError(f"nested body {l.i} failed")

        t.body(body)
        return p.build()

    p = ptg.PTGBuilder("outer", C=C)
    t = p.task("G", z=ptg.span(0, 0))
    t.affinity("C", lambda g, l: (0, 0))
    fc = t.flow("C", ptg.RW)
    fc.input(data=("C", lambda g, l: (0, 0)))
    fc.output(succ=("S", "X", lambda g, l: {"z": 0}))
    t.body(lambda es, task, g, l: recursive_call(es, task, inner_pool()),
           device="recursive")
    s = p.task("S", z=ptg.span(0, 0))
    s.affinity("C", lambda g, l: (0, 0))
    s.flow("X", ptg.READ).input(pred=("G", "C", lambda g, l: {"z": 0}))
    s.body(lambda es, task, g, l: reached.append(True))
    with pytest.raises(Exception) as ei:
        with Context(nb_cores=2) as ctx:
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=30)
    text = repr(ei.value) + repr(ei.value.__cause__)
    assert "nested body" in text and "failed" in text, text
    assert not reached     # the outer successor never ran


# ---------------------------------------------------------------------------
# across ranks: rank-private nested pools
# ---------------------------------------------------------------------------

def _rank_body(pkg):
    def body(ctx, rank, nranks):
        (a, b, c), A, B, C = _mats(pkg, 32, 4, 7, nranks=nranks, rank=rank)
        tp = (tiled_gemm_recursive_ptg(A, B, C, 2, 2, devices="cpu")
              if pkg == "port" else j_rec(A, B, C, sub_mb=2, sub_nb=2))
        ctx.add_taskpool(tp)
        ntasks = tp.nb_local_tasks()
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        tiles = {}
        for m in range(C.mt):
            for nn in range(C.nt):
                if C.rank_of(m, nn) == rank:
                    v = C.data_of(m, nn).newest_copy().value
                    tiles[(m, nn)] = (v.numpy() if isinstance(v, torch.Tensor)
                                      else np.asarray(v)).copy()
        return tiles, ntasks, c + a @ b
    return body


def test_rank_private_nested_pools_across_four_ranks():
    port = run_multirank(4, _rank_body("port"), timeout=120)
    jax = j_run_multirank(4, _rank_body("jax"), timeout=120)
    want = port[0][2]
    for (tiles, _, _), (jtiles, _, _) in zip(port, jax):
        assert tiles.keys() == jtiles.keys() and tiles
        for (m, n), t in tiles.items():
            np.testing.assert_allclose(
                t, want[m * 4:(m + 1) * 4, n * 4:(n + 1) * 4], rtol=1e-3,
                atol=1e-4)
            np.testing.assert_allclose(t, jtiles[(m, n)], rtol=1e-5,
                                       atol=1e-5)
    assert [r[1] for r in port] == [r[1] for r in jax]

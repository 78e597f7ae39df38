"""The stencils across ranks, and two ranks' copies of one tile in one LRU.

The 1-D stencil on 2, 3 and 4 rank threads and the 2-D stencil on a 2 x 2
grid, as ``tests/test_apps_stencil.py`` and ``tests/test_stencil2d.py``
run them in the JAX package: the port's result equals the JAX run's and
the float64 oracle (the dynamic bodies compute in float64: ``rtol=1e-10``
for the 1-D float64 tiles; the 2-D fp32 tiles ``rtol=1e-4, atol=1e-5`` as
in the JAX test, ``rtol=atol=1e-6`` between the packages), and each
rank's staged payload bytes equal the JAX run's.  On the 2-D grid the
halo edges carry ``wire=`` views, so what crosses is a ghost row or
column, or, where two views of one activation go to one rank, the tile.

The last case records a known property of ranks that share one device
module (``ROADMAP.md`` §1 item 8): its LRU is keyed by datum key, so two
ranks' copies of one read-only tile hold ONE entry, and the other copy
sits on the device outside the LRU, where eviction cannot reach it.
Under a byte budget that forces eviction the pool still completes, with
the right values.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.core.params import params as j_params
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JTwoDim
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVector
from parsec_tpu.models.stencil import stencil_1d_ptg as j_stencil_1d
from parsec_tpu.models.stencil import stencil_reference as j_reference
from parsec_tpu.models.stencil2d import stencil_2d_ptg as j_stencil_2d
from parsec_tpu.models.stencil2d import stencil2d_reference as j_ref2d
from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.core.params import params as p_params
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.matrix import (TwoDimBlockCyclic,
                                               VectorTwoDimCyclic)
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models.stencil import stencil_1d_ptg, stencil_reference
from parsec_tpu_torch.models.stencil2d import (stencil2d_reference,
                                               stencil_2d_ptg)

W1 = np.array([0.25, 0.5, 0.25])
W2D = (0.5, 0.15, 0.15, 0.1, 0.1)


def _base():
    return np.random.default_rng(0).standard_normal(48).astype(np.float64)


def _body_1d(port):
    def body(ctx, rank, nranks):
        base = _base()
        V = (VectorTwoDimCyclic if port else JVector)(
            "V", lm=48, mb=8, P=nranks, myrank=rank, dtype=np.float64,
            init_fn=lambda m, size: base[m * 8:m * 8 + size])
        tp = (stencil_1d_ptg if port else j_stencil_1d)(V, W1, 5)
        ctx.add_taskpool(tp)
        ntasks = tp.nb_local_tasks()
        ctx.wait(timeout=90)
        ctx.comm_barrier()
        tiles = {i: np.asarray(V.data_of(i).newest_copy().value).copy()
                 for i in range(V.mt) if V.rank_of(i) == rank}
        eng = ctx.comm_engine
        return tiles, ntasks, eng.payload_bytes_staged
    return body


def _assemble_1d(res):
    got = np.zeros(48)
    for tiles, _, _ in res:
        for i, t in tiles.items():
            got[i * 8:(i + 1) * 8] = t
    return got


@pytest.mark.parametrize("nranks", [2, 3, 4])
def test_stencil_1d_across_ranks(nranks):
    port = run_multirank(nranks, _body_1d(True), timeout=180)
    jax = _j_run(nranks, _body_1d(False))
    got = _assemble_1d(port)
    want = stencil_reference(torch.from_numpy(_base()), torch.from_numpy(W1),
                             5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(got, _assemble_1d(jax), rtol=1e-10)
    np.testing.assert_allclose(want, j_reference(_base(), W1, 5),
                               rtol=1e-12)
    # per-rank task counts and staged bytes: the JAX run's
    assert [r[1] for r in port] == [r[1] for r in jax]
    assert [r[2] for r in port] == [r[2] for r in jax]
    assert all(r[2] > 0 for r in port)     # every rank shipped halos


def _dense2d():
    return np.random.default_rng(7).standard_normal((16, 16)).astype(
        np.float32)


def _body_2d(port):
    def body(ctx, rank, nranks):
        dense = _dense2d()
        M = (TwoDimBlockCyclic if port else JTwoDim).from_dense(
            "M", dense.copy(), 4, 4, P=2, Q=nranks // 2, myrank=rank)
        tp = (stencil_2d_ptg if port else j_stencil_2d)(M, W2D, 4)
        ctx.add_taskpool(tp)
        ntasks = tp.nb_local_tasks()
        ctx.wait(timeout=180)
        ctx.comm_barrier()
        tiles = {(i, j): np.asarray(M.data_of(i, j).newest_copy().value)
                 .copy() for i in range(M.mt) for j in range(M.nt)
                 if M.rank_of(i, j) == rank}
        return tiles, ntasks, ctx.comm_engine.payload_bytes_staged
    return body


def _assemble_2d(res):
    got = np.zeros((16, 16), np.float32)
    for tiles, _, _ in res:
        for (i, j), t in tiles.items():
            got[i * 4:(i + 1) * 4, j * 4:(j + 1) * 4] = t
    return got


def _report_2d(port, jax, got, want):
    """What a failure prints: per-rank task counts and staged bytes of
    both runs, and the largest difference from each reference."""
    return (f"port tasks {[r[1] for r in port]} staged "
            f"{[r[2] for r in port]}; jax tasks {[r[1] for r in jax]} "
            f"staged {[r[2] for r in jax]}; max|port - oracle| "
            f"{float(np.abs(got - want).max()):.3g}, max|port - jax| "
            f"{float(np.abs(got - _assemble_2d(jax)).max()):.3g}")


def _j_run(nranks, body):
    """``j_run_multirank`` with the JAX package's ``comm_wire_datatypes``
    at its default (on), as the port always ships wire views; the value
    before is restored.  The JAX package's own
    ``tests/test_stencil2d.py::_band_body`` sets and restores that global
    param from each of its four rank threads at once, so a run of it can
    leave it off on the worker, and the JAX half would then ship whole
    tiles."""
    saved = j_params.get("comm_wire_datatypes")
    j_params.set("comm_wire_datatypes", True)
    try:
        return j_run_multirank(nranks, body, timeout=180)
    finally:
        j_params.set("comm_wire_datatypes", saved)


def _p_run(nranks, body):
    """``run_multirank`` with the port's ``comm_wire_datatypes`` pinned
    on (its default), its value and source restored after, as
    :func:`_j_run` pins the JAX package's."""
    with p_params.overrides({"comm_wire_datatypes": True}):
        return run_multirank(nranks, body, timeout=180)


def _check_2d():
    port = _p_run(4, _body_2d(True))
    jax = _j_run(4, _body_2d(False))
    got = _assemble_2d(port)
    want = np.asarray(stencil2d_reference(torch.from_numpy(_dense2d()),
                                          W2D, 4))
    msg = _report_2d(port, jax, got, want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                               err_msg=msg)
    np.testing.assert_allclose(got, j_ref2d(_dense2d(), W2D, 4), rtol=1e-4,
                               atol=1e-5, err_msg=msg)
    np.testing.assert_allclose(got, _assemble_2d(jax), rtol=1e-6,
                               atol=1e-6, err_msg=msg)
    assert [r[1] for r in port] == [r[1] for r in jax], msg
    staged = [r[2] for r in port]
    assert staged == [r[2] for r in jax], msg
    # wire views cut the traffic below whole tiles: 16 tiles, 4 steps,
    # at most 4 halos a tile a step, a tile 64 B
    assert 0 < sum(staged) < 16 * 3 * 4 * 64, msg


def test_stencil_2d_on_a_2x2_grid():
    _check_2d()


def test_the_2x2_grid_holds_when_an_earlier_test_left_wire_views_off():
    """The state ``tests/test_stencil2d.py`` can leave on a worker: the
    JAX package's ``comm_wire_datatypes`` off.  The comparison still
    runs both packages with wire views, and the value is left as found."""
    saved = j_params.get("comm_wire_datatypes")
    j_params.set("comm_wire_datatypes", False)
    try:
        _check_2d()
        assert j_params.get("comm_wire_datatypes") is False
    finally:
        j_params.set("comm_wire_datatypes", saved)


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


NB_TILE, NC = 32, 6


def _shared_tile_body(dev, seen):
    """Each rank owns a copy of A(0) and B(0) under the same keys, and
    runs NC device GEMMs C(r, c) += A(0) @ B(0) of its own."""
    import parsec_tpu_torch.ops.gemm  # noqa: F401 (registers "gemm")

    def body(ctx, rank, nranks):
        rng = np.random.default_rng(3)
        a = rng.standard_normal((NB_TILE, NB_TILE)).astype(np.float32)
        b = rng.standard_normal((NB_TILE, NB_TILE)).astype(np.float32)
        tt = TileType((NB_TILE, NB_TILE), torch.float32)
        mine = lambda *k: rank       # noqa: E731
        A = DictCollection("A", dtt=tt, init_fn=lambda *k: a.copy(),
                           rank_of_fn=mine)
        B = DictCollection("B", dtt=tt, init_fn=lambda *k: b.copy(),
                           rank_of_fn=mine)
        C = DictCollection("C", dtt=tt, rank_of_fn=lambda r, c: r)
        p = ptg.PTGBuilder("shared", A=A, B=B, C=C, R=rank, NC=NC)
        t = p.task("GEMM", c=ptg.span(0, lambda g, l: g.NC - 1))
        t.affinity("C", lambda g, l: (g.R, l.c))
        t.flow("A", ptg.READ).input(data=("A", lambda g, l: (0,)))
        t.flow("B", ptg.READ).input(data=("B", lambda g, l: (0,)))
        fc = t.flow("C", ptg.RW)
        fc.input(data=("C", lambda g, l: (g.R, l.c)))
        fc.output(data=("C", lambda g, l: (g.R, l.c)))
        t.body(device="cuda", dyld="gemm")
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=60)
        ctx.comm_barrier()
        seen.append((rank, A.data_of(0)))
        dev.sync()
        dev.flush_cache()
        return [C.data_of(rank, c).newest_copy().value.clone()
                for c in range(NC)], a @ b
    return body


def test_two_ranks_copies_of_one_tile_share_one_lru_entry(cpu_cuda_device):
    dev = cpu_cuda_device
    tile = NB_TILE * NB_TILE * 4
    saved = dev._mem_budget
    dev._mem_budget = 3 * tile       # forces evictions at every batch
    seen, inserts = [], []
    inner = dev._cache_insert

    def spy(key, copy, nbytes):
        inserts.append((key, id(copy.original)))
        return inner(key, copy, nbytes)
    dev._cache_insert = spy
    try:
        res = run_multirank(2, _shared_tile_body(dev, seen), timeout=60)
    finally:
        dev._mem_budget = saved
        del dev._cache_insert
    for cs, want in res:
        for c in cs:
            np.testing.assert_allclose(c.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
    # the two ranks' A(0) are two data with ONE key: both were staged to
    # the device, and the LRU never holds more than one entry for the key
    datas = [d for _, d in sorted(seen, key=lambda s: s[0])]
    assert datas[0] is not datas[1] and datas[0].key == datas[1].key
    assert dev.executed_tasks >= 2 * NC
    owners = {o for k, o in inserts if k == datas[0].key}
    assert owners == {id(d) for d in datas}   # two copies, one key
    assert sum(1 for k in dev._mem_lru if k == datas[0].key) <= 1

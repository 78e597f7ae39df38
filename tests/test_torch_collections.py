"""The port's collection tier against the JAX package's: the band and hash
distributions, the map/reduce/broadcast operator pools and the
redistribution pool (``parsec_tpu_torch/data_dist/{matrix,operators,
redistribute}.py``).

The cases are those of ``tests/test_collections.py``, each run through
both packages on the same seeded numpy inputs.  The port's pools run two
ways: with host chores (``devices="cpu"``) and with their CUDA chores on
the device module around the host (``init_cuda_devices(device="cpu")``,
the stand-in the card's runs take).  Tolerance: the copies, maps by
powers of two and float64 sums are exact (``assert_array_equal``); the
float32 reductions agree within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.data_dist import matrix as jm
from parsec_tpu.data_dist.operators import (
    broadcast_taskpool as j_broadcast, map_taskpool as j_map,
    reduce_taskpool as j_reduce)
from parsec_tpu.data_dist.redistribute import redistribute_taskpool as j_redist
from parsec_tpu.runtime import Context as JContext
from parsec_tpu.runtime.taskpool import compose as j_compose
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.data_dist import matrix as pm
from parsec_tpu_torch.data_dist import redistribute as predist
from parsec_tpu_torch.data_dist.operators import (broadcast_taskpool,
                                                  map_taskpool,
                                                  reduce_taskpool)
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.runtime import Context, compose

DEVICES = ["cpu", "cuda"]


@pytest.fixture
def devices(request):
    """``"cpu"``: host chores; ``"cuda"``: the CUDA chores on the device
    module around the host, flushed home before the test reads."""
    snapshot = list(port_registry.devices)
    devs = init_cuda_devices(device="cpu") if request.param == "cuda" else []
    yield request.param, devs
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


def _jrun(*tps):
    ctx = JContext(nb_cores=0)
    try:
        for tp in tps:
            ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
    finally:
        ctx.fini()


def _prun(devs, *tps, nb_cores=0):
    ctx = Context(nb_cores=nb_cores)
    try:
        for tp in tps:
            ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        for d in devs:
            d.flush_cache()
    finally:
        ctx.fini()


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# the band and hash distributions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nodes", [1, 2, 3])
@pytest.mark.parametrize("band", [1, 2, 3])
def test_band_distribution_matches_the_jax_one(nodes, band):
    kw = dict(P=nodes, Q=1, band_size=band, nodes=nodes)
    jb = jm.TwoDimBlockCyclicBand("B", 10, 10, 2, 2, **kw)
    pb = pm.TwoDimBlockCyclicBand("B", 10, 10, 2, 2, **kw)
    for m in range(5):
        for n in range(5):
            assert pb.has_tile(m, n) == jb.has_tile(m, n), (m, n)
            if jb.has_tile(m, n):
                assert pb.rank_of(m, n) == jb.rank_of(m, n), (m, n)
                assert tuple(pb.data_of(m, n).newest_copy().value.shape) \
                    == jb.data_of(m, n).newest_copy().value.shape
            else:
                for dc in (jb, pb):
                    with pytest.raises(KeyError):
                        dc.data_of(m, n)
                    with pytest.raises(KeyError):
                        dc.rank_of(m, n)


@pytest.mark.parametrize("uplo", [0, 1])
def test_symmetric_band_matches_the_jax_one(uplo):
    jb = jm.SymTwoDimBlockCyclicBand("S", 8, 8, 2, 2, uplo=uplo, band_size=2)
    pb = pm.SymTwoDimBlockCyclicBand("S", 8, 8, 2, 2, uplo=uplo, band_size=2)
    for m in range(4):
        for n in range(4):
            assert pb.has_tile(m, n) == jb.has_tile(m, n), (m, n)
            ok = jb.has_tile(m, n)
            for dc in (jb, pb):
                if ok:
                    assert dc.data_of(m, n) is not None
                else:
                    with pytest.raises(KeyError):
                        dc.data_of(m, n)


def test_the_band_storage_case():
    """``tests/test_collections.py::test_band_storage`` on the port."""
    dB = pm.TwoDimBlockCyclicBand("B", 8, 8, 2, 2, P=2, Q=1, band_size=2,
                                  nodes=2)
    assert dB.rank_of(0, 0) == 0
    assert dB.rank_of(2, 1) == 1
    with pytest.raises(KeyError):
        dB.data_of(0, 3)
    assert tuple(dB.data_of(1, 0).newest_copy().value.shape) == (2, 2)


def test_hash_distribution_matches_the_jax_one():
    rng = np.random.default_rng(3)
    vals = {(i, "x"): rng.standard_normal((2, 3)).astype(np.float32)
            for i in range(5)}

    def fn(i, tag):
        return (i * 7) % 3

    jh = jm.HashDataDist("H", nodes=3, rank_fn=fn)
    ph = pm.HashDataDist("H", nodes=3, rank_fn=fn)
    for k, v in vals.items():
        jh.register(k, v)
        ph.register(k, v)
    for k, v in vals.items():
        assert ph.rank_of(*k) == jh.rank_of(*k)
        np.testing.assert_array_equal(
            ph.data_of(*k).newest_copy().value.numpy(),
            np.asarray(jh.data_of(*k).newest_copy().value))
        assert ph.data_of(*k).key == jh.data_of(*k).key
    assert sorted(ph.known_keys()) == sorted(vals)
    with pytest.raises(KeyError):
        ph.data_of(9, "x")
    assert pm.HashDataDist("d").rank_of(1, 2) == 0
    assert ph.key_to_string(1, "x") == jh.key_to_string(1, "x")


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", DEVICES, indirect=True)
def test_map_matches_the_jax_pool(devices):
    dev, devs = devices
    a = np.random.default_rng(1).standard_normal((6, 6)).astype(np.float32)
    jA = jm.TiledMatrix.from_dense("A", a, 2, 3)
    pA = pm.TiledMatrix.from_dense("A", a, 2, 3)
    jtp = j_map(jA, lambda key, t: t * 2.0)
    ptp = map_taskpool(pA, lambda key, t: t * 2.0, devices=dev)
    assert ptp.nb_local_tasks() == jtp.nb_local_tasks() == 6
    _jrun(jtp)
    _prun(devs, ptp)
    np.testing.assert_array_equal(pA.to_dense(), jA.to_dense())
    np.testing.assert_array_equal(pA.to_dense(), a * 2.0)


@pytest.mark.parametrize("devices", DEVICES, indirect=True)
def test_map_in_place_matches_the_jax_pool(devices):
    dev, devs = devices
    a = np.ones((4, 4), dtype=np.float32)
    # each matrix over its own copy: tiles are views of the dense input
    jA = jm.TiledMatrix.from_dense("A", a.copy(), 2, 2)
    pA = pm.TiledMatrix.from_dense("A", a.copy(), 2, 2)

    def bump(key, t):
        t += key[0] + key[1]

    _jrun(j_map(jA, bump))
    _prun(devs, map_taskpool(pA, bump, devices=dev))
    np.testing.assert_array_equal(pA.to_dense(), jA.to_dense())
    assert pA.to_dense()[3, 3] == 3.0


@pytest.mark.parametrize("devices", DEVICES, indirect=True)
@pytest.mark.parametrize("mt", [1, 2, 3, 5, 8])
def test_reduce_matches_the_jax_pool(devices, mt):
    dev, devs = devices
    n = mt * 2
    a = np.arange(n * n, dtype=np.float64).reshape(n, n)
    jA = jm.TiledMatrix.from_dense("A", a, 2, 2)
    pA = pm.TiledMatrix.from_dense("A", a, 2, 2)
    jout, pout = {}, {}
    jtp = j_reduce(jA, lambda x, y: x + y, out=jout)
    ptp = reduce_taskpool(pA, lambda x, y: x + y, out=pout, devices=dev)
    assert ptp.nb_local_tasks() == jtp.nb_local_tasks()
    _jrun(jtp)
    _prun(devs, ptp)
    np.testing.assert_array_equal(_host(pout["value"]), jout["value"])
    np.testing.assert_array_equal(pA.to_dense(), a)   # sources untouched


@pytest.mark.parametrize("devices", DEVICES, indirect=True)
def test_ragged_reduce_with_a_transform_matches_the_jax_pool(devices):
    dev, devs = devices
    a = np.random.default_rng(2).standard_normal((7, 10)).astype(np.float32)
    jA = jm.TiledMatrix.from_dense("A", a, 3, 4)
    pA = pm.TiledMatrix.from_dense("A", a, 3, 4)
    jout, pout = {}, {}
    _jrun(j_reduce(jA, lambda x, y: x + y, out=jout, transform=np.sum))
    _prun(devs, reduce_taskpool(pA, lambda x, y: x + y, out=pout,
                                transform=torch.sum, devices=dev))
    got, want = float(_host(pout["value"])), float(jout["value"])
    assert abs(got - want) <= 1e-6 * np.abs(a).sum()
    assert abs(got - float(a.astype(np.float64).sum())) \
        <= 1e-6 * np.abs(a).sum()


def _vec(mod, name, lm, mb, P, fill, **kw):
    return mod.VectorTwoDimCyclic(name, lm=lm, mb=mb, P=P,
                                  init_fn=lambda m, size: fill(size), **kw)


@pytest.mark.parametrize("devices", DEVICES, indirect=True)
@pytest.mark.parametrize("case", ["one", "segments", "matrix"])
def test_broadcast_matches_the_jax_pool(devices, case):
    """One segment, a destination of three segments (the fan-out is sized
    by the destination), and a 2-D tiled destination."""
    dev, devs = devices
    out = []
    for mod, bc, run in ((jm, j_broadcast, _jrun),
                         (pm, broadcast_taskpool, None)):
        if case == "one":
            src = _vec(mod, "S", 4, 4, 1, lambda s: np.arange(4.0))
            dst = _vec(mod, "D", 4, 4, 1, np.zeros)
        elif case == "segments":
            src = _vec(mod, "S", 4, 4, 1, lambda s: np.arange(4.0))
            dst = _vec(mod, "D", 12, 4, 3, np.zeros, nodes=1)
        else:
            src = _vec(mod, "S", 4, 2, 1, lambda s: np.full(s, 7.0))
            dst = mod.TiledMatrix.from_dense("D", np.zeros((4, 4)), 2, 2)
        if run is None:
            _prun(devs, bc(src, (0,), dst, devices=dev))
        else:
            run(bc(src, (0,), dst))
        from parsec_tpu_torch.data_dist.collection import enumerate_keys
        out.append([_host(dst.data_of(*k).newest_copy().value)
                    for k in enumerate_keys(dst)])
    assert len(out[0]) == len(out[1]) > 0
    for w, g in zip(*out):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("devices", DEVICES, indirect=True)
def test_map_over_band_and_symmetric_storage(devices):
    dev, devs = devices
    for mod, run in ((jm, None), (pm, dev)):
        dB = mod.TwoDimBlockCyclicBand("B", 8, 8, 2, 2, band_size=2)
        dS = mod.SymTwoDimBlockCyclic("S", 8, 8, 2, 2, uplo=0)
        if run is None:
            _jrun(j_map(dB, lambda key, t: t + 1.0),
                  j_map(dS, lambda key, t: t + 1.0, name="map2"))
        else:
            tps = (map_taskpool(dB, lambda key, t: t + 1.0, devices=dev),
                   map_taskpool(dS, lambda key, t: t + 1.0, name="map2",
                                devices=dev))
            assert [tp.nb_local_tasks() for tp in tps] == [10, 10]
            _prun(devs, *tps)
        assert float(dB.data_of(1, 0).newest_copy().value[0, 0]) == 1.0
        assert float(dS.data_of(3, 0).newest_copy().value[0, 0]) == 1.0


def _reduce_body(mod, reduce_fn, devices_kw):
    def body(ctx, rank, nranks):
        n = 8
        a = np.arange(n * n, dtype=np.float64).reshape(n, n)
        dA = mod.TwoDimBlockCyclic(
            "A", n, n, 2, 2, P=nranks, Q=1, myrank=rank,
            init_fn=lambda m, nn, shape:
            a[m * 2:m * 2 + shape[0], nn * 2:nn * 2 + shape[1]])
        out = {}
        ctx.add_taskpool(reduce_fn(dA, lambda x, y: x + y, out=out,
                                   **devices_kw))
        ctx.wait(timeout=60)
        ctx.comm_barrier()
        v = out.get("value")
        return None if v is None else _host(v)
    return body


@pytest.mark.parametrize("nranks", [2, 4])
def test_reduce_across_ranks_matches_the_jax_pool(nranks):
    """The reduce's cross-rank hops ride the remote-dep activations: the
    same result on the same rank as the JAX package's."""
    got = run_multirank(nranks, _reduce_body(pm, reduce_taskpool,
                                             {"devices": "cpu"}))
    want = j_run_multirank(nranks, _reduce_body(jm, j_reduce, {}))
    assert [r is None for r in got] == [r is None for r in want]
    g = [r for r in got if r is not None]
    w = [r for r in want if r is not None]
    assert len(g) == len(w) == 1
    np.testing.assert_array_equal(g[0], w[0])
    a = np.arange(64, dtype=np.float64).reshape(8, 8)
    np.testing.assert_array_equal(
        g[0], sum(a[m * 2:(m + 1) * 2, k * 2:(k + 1) * 2]
                  for m in range(4) for k in range(4)))


# ---------------------------------------------------------------------------
# redistribute
# ---------------------------------------------------------------------------

def _redist_pair(src_nb, dst_nb, a, n=None, **kw):
    out = []
    for mod in (jm, pm):
        S = mod.TiledMatrix.from_dense("S", a, src_nb, src_nb)
        T = mod.TiledMatrix.from_dense(
            "T", np.zeros(a.shape if n is None else (n, n), np.float32),
            dst_nb, dst_nb)
        out.append((S, T))
    return out


@pytest.mark.parametrize("devices", DEVICES, indirect=True)
@pytest.mark.parametrize("src_nb,dst_nb", [(4, 4), (4, 6), (6, 4), (5, 3)])
def test_redistribute_full_matches_the_jax_pool(devices, src_nb, dst_nb):
    dev, devs = devices
    a = np.arange(144, dtype=np.float32).reshape(12, 12)
    (jS, jT), (pS, pT) = _redist_pair(src_nb, dst_nb, a)
    jctx = JContext(nb_cores=0)
    jtp = j_redist(jS, jT)
    jctx.add_taskpool(jtp)
    jtp.wait(timeout=30)
    jctx.fini()
    before = dict(predist.copies)
    ptp = predist.redistribute_taskpool(pS, pT, devices=dev)
    _prun(devs, ptp)
    np.testing.assert_array_equal(pT.to_dense(), jT.to_dense())
    np.testing.assert_array_equal(pT.to_dense(), a)
    # the same fragment DAG: one copy task an overlap
    assert ptp.nb_frags == ptp.local_tasks == jtp._insert_seq
    chore = "host" if dev == "cpu" else "cuda"
    assert predist.copies[chore] - before.get(chore, 0) == ptp.nb_frags
    other = "cuda" if dev == "cpu" else "host"
    assert predist.copies[other] == before.get(other, 0)


@pytest.mark.parametrize("devices", DEVICES, indirect=True)
def test_redistribute_submatrix_matches_the_jax_pool(devices):
    dev, devs = devices
    a = np.arange(100, dtype=np.float32).reshape(10, 10)
    (jS, jT), (pS, pT) = _redist_pair(4, 3, a)
    kw = dict(size_row=5, size_col=6, disi_src=2, disj_src=1, disi_dst=3,
              disj_dst=4)
    jctx = JContext(nb_cores=0)
    jtp = j_redist(jS, jT, **kw)
    jctx.add_taskpool(jtp)
    jtp.wait(timeout=30)
    jctx.fini()
    ptp = predist.redistribute_taskpool(pS, pT, devices=dev, **kw)
    _prun(devs, ptp)
    expect = np.zeros((10, 10), np.float32)
    expect[3:8, 4:10] = a[2:7, 1:7]
    np.testing.assert_array_equal(pT.to_dense(), jT.to_dense())
    np.testing.assert_array_equal(pT.to_dense(), expect)
    assert ptp.nb_frags == jtp._insert_seq


@pytest.mark.parametrize("devices", DEVICES, indirect=True)
def test_composed_redistributes_match_the_jax_pools(devices):
    """Two redistributes sequenced by ``compose`` round-trip the data."""
    dev, devs = devices
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    res = []
    for mod, redist, comp in ((jm, j_redist, j_compose),
                              (pm, predist.redistribute_taskpool, compose)):
        S = mod.TiledMatrix.from_dense("S", a, 4, 4)
        T = mod.TiledMatrix.from_dense("T", np.zeros((8, 8), np.float32),
                                       3, 3)
        U = mod.TiledMatrix.from_dense("U", np.zeros((8, 8), np.float32),
                                       5, 5)
        kw = {} if mod is jm else {"devices": dev}
        c = comp(redist(S, T, name="r1", **kw), redist(T, U, name="r2",
                                                       **kw))
        if mod is jm:
            _jrun(c)
        else:
            _prun(devs, c, nb_cores=2)
        res.append((T.to_dense(), U.to_dense(),
                    [m._insert_seq for m in c.members]))
    np.testing.assert_array_equal(res[1][1], a)
    np.testing.assert_array_equal(res[1][0], res[0][0])
    np.testing.assert_array_equal(res[1][1], res[0][1])
    assert res[1][2] == res[0][2]


def test_the_card_geometry_has_the_jax_fragment_count():
    """``chip_smoke.py``'s ``data_layer`` redistributes an n=8192 matrix
    from 1024-tiles to 512-tiles and gates 256 fragments.  The JAX pool
    counts 256 on the same geometry cut by 128 (n=64, 8 -> 4: every
    target tile inside one source tile), and the port's fragment list
    counts 256 at the card's size, with no tile made."""
    a = np.zeros((64, 64), np.float32)
    jS = jm.TiledMatrix.from_dense("S", a, 8, 8)
    jT = jm.TiledMatrix.from_dense("T", a, 4, 4)
    jctx = JContext(nb_cores=0)
    jtp = j_redist(jS, jT)
    jctx.add_taskpool(jtp)
    jtp.wait(timeout=30)
    jctx.fini()
    big_s = pm.TiledMatrix("S", 8192, 8192, 1024, 1024)
    big_t = pm.TwoDimBlockCyclic("T", 8192, 8192, 512, 512)
    frags = predist.fragments(big_s, big_t, 8192, 8192, 0, 0, 0, 0)
    assert len(frags) == jtp._insert_seq == 256
    assert not big_s._store and not big_t._store


def test_a_hash_source_redistributes_like_a_tiled_one():
    """The card's phase reads its source from a :class:`HashDataDist`
    carrying the tiled geometry: the same result and fragments as a
    :class:`TiledMatrix` source."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((16, 16)).astype(np.float32)

    class HashTiles(pm.HashDataDist):
        lm = ln = 16
        mb = nb = 8
        dtype = torch.float32

        def tile_shape(self, m, n):
            return (8, 8)

    H = HashTiles("H")
    for m in range(2):
        for n in range(2):
            H.register((m, n), a[m * 8:m * 8 + 8, n * 8:n * 8 + 8])
    T = pm.TwoDimBlockCyclic("T", 16, 16, 4, 4)
    tp = predist.redistribute_taskpool(H, T, devices="cpu")
    _prun([], tp)
    np.testing.assert_array_equal(T.to_dense(), a)
    assert tp.nb_frags == 16


def test_a_cuda_redistribute_without_a_device_fails():
    """The CUDA chore alone: with no CUDA device registered the pool
    fails, it never runs its copies on the host."""
    snapshot = list(port_registry.devices)
    port_registry.devices = [d for d in snapshot if d.type != "cuda"]
    try:
        a = np.ones((4, 4), np.float32)
        S = pm.TiledMatrix.from_dense("S", a, 2, 2)
        T = pm.TiledMatrix.from_dense("T", np.zeros((4, 4), np.float32),
                                      2, 2)
        before = dict(predist.copies)
        ctx = Context(nb_cores=0)
        with pytest.raises(Exception):
            ctx.add_taskpool(predist.redistribute_taskpool(S, T))
            ctx.wait(timeout=30)
        try:
            ctx.fini()
        except Exception:   # noqa: BLE001 — the recorded failure again
            pass
        assert dict(predist.copies) == before
        np.testing.assert_array_equal(T.to_dense(), 0.0)
    finally:
        port_registry.devices = snapshot
        for i, d in enumerate(port_registry.devices):
            d.device_index = i

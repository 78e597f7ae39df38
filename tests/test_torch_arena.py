"""The port's arenas (``parsec_tpu_torch/data/arena.py``) against the JAX
package's, and its socket fabric's pooled wire buffers.

``Arena``, ``BufferPool`` and ``ArenaDatatypeRegistry`` run the same
sequence of calls in both packages and report the same stats (exact
counts).  Then a two-rank Cholesky over the socket fabric (two rank
processes) runs twice in each rank: once with a wire pool that keeps
nothing (every scratch buffer fresh, the fabric before the pool) and once
with the process's pool; the remote-dep payload bytes, the activations,
the GETs and the factor's tiles are the same both times (exact), and the
pooled run hits its pool.
"""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.comm import run_multiproc
from parsec_tpu_torch.data import arena as parena
from parsec_tpu_torch.data.data import Data
from parsec_tpu_torch.data.datatype import TileType


def _script(a_mod, dtt):
    """One sequence of arena calls; the stats after each step."""
    out = []
    ar = a_mod.Arena(dtt, max_used=3, max_released=2)
    c1 = ar.get_copy()
    c2 = ar.get_copy(device_index=0)
    out.append(ar.stats())
    assert c1.arena_chunk is ar and c1.value.shape == (4, 4)
    ar.release_copy(c1)
    out.append(ar.stats())
    c3 = ar.get_copy()            # from the freelist
    c4 = ar.get_copy()
    out.append(ar.stats())
    with pytest.raises(MemoryError):
        ar.get_copy()
    for c in (c2, c3, c4):
        ar.release_copy(c)
    out.append(ar.stats())        # max_released caps the freelist at 2
    return out


def test_arena_stats_equal_the_jax_arenas():
    from parsec_tpu.data import arena as jarena
    from parsec_tpu.data.datatype import TileType as JTileType
    got = _script(parena, TileType((4, 4), torch.float32))
    want = _script(jarena, JTileType((4, 4), np.float32))
    assert got == want
    assert got[-1] == {"used": 0, "cached": 2}


def test_an_arena_copy_attaches_to_a_given_datum():
    ar = parena.Arena(TileType((2, 3), torch.float16))
    d = Data(key="x")
    c = ar.get_copy(device_index=0, original=d)
    assert d.get_copy(0) is c and c.value.dtype == torch.float16
    ar.release_copy(c)
    assert c.value is None and c.arena_chunk is None


def _pool_script(pool):
    out = []
    views = [pool.acquire(n) for n in (0, 1, 200, 256, 257, 1000, 70000)]
    assert [v.nbytes for v in views] == [0, 1, 200, 256, 257, 1000, 70000]
    out.append(pool.stats())
    for v in views:
        pool.release(v)
    out.append(pool.stats())
    again = [pool.acquire(n) for n in (100, 300, 300, 64 << 20)]
    out.append(pool.stats())
    for v in again:
        pool.release(v)
    out.append(pool.stats())
    return out


def test_buffer_pool_stats_equal_the_jax_pool():
    from parsec_tpu.data import arena as jarena
    got = _pool_script(parena.BufferPool(max_per_class=1))
    want = _pool_script(jarena.BufferPool(max_per_class=1))
    assert got == want
    assert got[2]["hits"] >= 2
    assert parena.BufferPool._cls(257) == 512 == parena.BufferPool._cls(512)


def test_the_registry_equals_the_jax_registry():
    from parsec_tpu.data import arena as jarena
    from parsec_tpu.data.datatype import TileType as JTileType
    reg, jreg = parena.ArenaDatatypeRegistry(), jarena.ArenaDatatypeRegistry()
    a = reg.register("t", TileType((2,)), max_used=4)
    ja = jreg.register("t", JTileType((2,)), max_used=4)
    assert reg.register("t", TileType((9,))) is a and reg.get("t") is a
    assert jreg.register("t", JTileType((9,))) is ja
    assert (a.max_used, a.max_released) == (ja.max_used, ja.max_released)
    with pytest.raises(KeyError):
        reg.get("missing")


def pooled_cholesky_body(ctx, rank, nranks):
    """In a rank process: a block-cyclic Cholesky of 4 x 4 tiles of 64
    (16 KiB, past the short limit: the panels move by fragmented GETs)
    twice, first with a wire pool that keeps nothing, then with the
    process's pool; each run's remote-dep counters, tiles and pool
    stats."""
    from parsec_tpu_torch.comm import socket_fabric as sf
    from parsec_tpu_torch.comm.mp_bodies import _run_kind
    from parsec_tpu_torch.data.arena import BufferPool

    runs = []
    pooled = sf.wire_pool
    for pool in (BufferPool(max_per_class=0), pooled):
        sf.wire_pool = pool
        eng = ctx.comm_engine
        before = (eng.payload_bytes_staged, eng.payload_bytes_received,
                  eng.activations_sent, eng.ce.gets)
        rec = _run_kind(ctx, rank, nranks, "cholesky", 256, 64, 0, "cpu",
                        None)
        after = (eng.payload_bytes_staged, eng.payload_bytes_received,
                 eng.activations_sent, eng.ce.gets)
        runs.append({"delta": [x - y for x, y in zip(after, before)],
                     "tiles": rec["tiles"], "pool": pool.stats()})
    sf.wire_pool = pooled
    return runs


def test_a_two_rank_factor_over_the_pooled_fabric_moves_the_same_bytes():
    res = run_multiproc(2, f"{__file__}:pooled_cholesky_body", timeout=120)
    for r, (plain, pooled) in enumerate(res):
        assert plain["delta"] == pooled["delta"], r
        assert plain["delta"][0] + plain["delta"][1] > 0, r
        assert plain["delta"][3] > 0 or plain["delta"][0] > 0, r
        assert plain["tiles"].keys() == pooled["tiles"].keys()
        for k, v in plain["tiles"].items():
            np.testing.assert_array_equal(v, pooled["tiles"][k])
        assert plain["pool"]["hits"] == plain["pool"]["cached"] == 0, r
        assert pooled["pool"]["hits"] > 0, (r, pooled["pool"])

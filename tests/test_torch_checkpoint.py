"""The port's checkpoint and restore (``parsec_tpu_torch/data/
checkpoint.py``) against the JAX package's.

The cases of ``tests/test_checkpoint.py`` on the port, each held against
the JAX package's run on the same seeded inputs; a checkpoint written by
either package restored by the other; and a restore on the device module
around the host after a pool staged the tiles, which must drop the
device copies so that the next pool reads the restored bytes.
Tolerance: a host GEMM of the two packages agrees within 1e-5 (the same
float32 products, summed in another order); everything a checkpoint
carries comes back bit for bit.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.data import checkpoint as jck
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JBC
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch.comm import run_multirank
from parsec_tpu_torch.data import checkpoint as pck
from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic as PBC
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.runtime import Context

TOL = 1e-5


def mk(cls, n=32, nb=8, seed=5, **kw):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n, n).astype(np.float32)
    A = cls.from_dense("A", a.copy(), nb, nb, **kw)
    B = cls.from_dense("B", b.copy(), nb, nb, **kw)
    C = cls("C", n, n, nb, nb, **kw)
    return a, b, A, B, C


def run_gemm(A, B, C, devices="cpu", devs=()):
    if isinstance(C, JBC):
        ctx = JContext(nb_cores=0)
        ctx.add_taskpool(j_gemm(A, B, C, devices="cpu"))
    else:
        ctx = Context(nb_cores=0)
        ctx.add_taskpool(tiled_gemm_ptg(A, B, C, devices=devices))
    try:
        ctx.wait(timeout=60)
        for d in devs:
            d.sync()
    finally:
        ctx.fini()


def _clobber(C, rank=None):
    for m in range(C.mt):
        for n in range(C.nt):
            if rank is None or C.rank_of(m, n) == rank:
                C.data_of(m, n).newest_copy().value[:] = -1.0


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


# ---------------------------------------------------------------------------
# the cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_round_trip_matches_the_jax_package(tmp_path):
    a, b, A, B, C = mk(PBC)
    ja, jb, jA, jB, jC = mk(JBC)
    run_gemm(A, B, C)
    run_gemm(jA, jB, jC)
    p, jp = str(tmp_path / "ck.npz"), str(tmp_path / "jck.npz")
    assert pck.save_collections(p, C, meta={"phase": 1}) == p
    jck.save_collections(jp, jC, meta={"phase": 1})
    _clobber(C)
    _clobber(jC)
    assert pck.restore_collections(p, C) == {"phase": 1}
    assert jck.restore_collections(jp, jC) == {"phase": 1}
    np.testing.assert_allclose(C.to_dense(), jC.to_dense(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(C.to_dense(), a @ b, rtol=1e-4, atol=1e-4)


def test_crash_resume_equals_uninterrupted(tmp_path):
    """C = A·B, checkpoint, D = C·B; then fresh collections, restore C,
    D2 = C2·B2: D2 is D bit for bit, and within TOL of the JAX run."""
    p = str(tmp_path / "phase1.npz")
    _, _, A, B, C = mk(PBC)
    run_gemm(A, B, C)
    pck.save_collections(p, C)
    D = PBC("D", 32, 32, 8, 8)
    run_gemm(C, B, D)
    _, _, A2, B2, C2 = mk(PBC)
    pck.restore_collections(p, C2)
    D2 = PBC("D2", 32, 32, 8, 8)
    run_gemm(C2, B2, D2)
    np.testing.assert_array_equal(D2.to_dense(), D.to_dense())
    _, _, jA, jB, jC = mk(JBC)
    run_gemm(jA, jB, jC)
    jD = JBC("D", 32, 32, 8, 8)
    run_gemm(jC, jB, jD)
    np.testing.assert_allclose(D2.to_dense(), jD.to_dense(), rtol=1e-4,
                               atol=1e-3)


def test_versions_round_trip_like_the_jax_package(tmp_path):
    out = []
    for cls, ck in ((PBC, pck), (JBC, jck)):
        _, _, A, B, C = mk(cls)
        run_gemm(A, B, C)
        ver = C.data_of(0, 0).newest_copy().version
        p = str(tmp_path / f"v{cls.__module__.split('.')[0]}.npz")
        ck.save_collections(p, C)
        C.data_of(0, 0).newest_copy().version = 999
        ck.restore_collections(p, C)
        assert C.data_of(0, 0).newest_copy().version == ver
        out.append(ver)
    assert out[0] == out[1]


@pytest.mark.parametrize("case", ["geometry", "collection", "shape",
                                  "dtype", "names", "empty"])
def test_what_the_jax_package_refuses_the_port_refuses(tmp_path, case):
    for cls, ck in ((PBC, pck), (JBC, jck)):
        _, _, A, B, _ = mk(cls)
        p = str(tmp_path / f"{case}-{cls.__module__.split('.')[0]}.npz")
        if case == "empty":
            with pytest.raises(ck.CheckpointError):
                ck.save_collections(p)
            continue
        if case == "names":
            with pytest.raises(ck.CheckpointError, match="duplicate"):
                ck.save_collections(p, A, cls("A", 8, 8, 4, 4))
            continue
        ck.save_collections(p, A)
        if case == "geometry":
            other, match = cls("A", 16, 16, 8, 8), "geometry"
        elif case == "collection":
            other, match = B, "no collection"
        elif case == "shape":
            # the same key grid, home tiles of another shape
            other, match = cls("A", 32, 32, 8, 8), "shape"
            for m in range(4):
                for n in range(4):
                    c = other.data_of(m, n).newest_copy()
                    c.value = (torch.zeros((8, 9)) if cls is PBC
                               else np.zeros((8, 9), np.float32))
        else:
            other = cls("A", 32, 32, 8, 8,
                        dtype=torch.float64 if cls is PBC else np.float64)
            match = "dtype"
        with pytest.raises(ck.CheckpointError, match=match):
            ck.restore_collections(p, other)


def _shard_body(cls, ck, gemm, p):
    def body(ctx, rank, nranks):
        a, b, A, B, C = mk(cls, P=2, Q=2, myrank=rank)
        ctx.add_taskpool(gemm(A, B, C, devices="cpu"))
        ctx.wait(timeout=60)
        ctx.comm_barrier()
        out = ck.save_collections(p, C)
        _clobber(C, rank)
        ck.restore_collections(p, C)
        return out, C.to_dense()
    return body


def test_per_rank_shards_match_the_jax_package(tmp_path):
    """Each rank saves and restores the tiles it owns, in its own
    ``.rankN`` file; every rank's shard restores in the other package."""
    p, jp = str(tmp_path / "dist.npz"), str(tmp_path / "jdist.npz")
    res = run_multirank(4, _shard_body(PBC, pck, tiled_gemm_ptg, p))
    jres = j_run_multirank(4, _shard_body(JBC, jck, j_gemm, jp))
    assert sorted(r[0] for r in res) == [f"{p}.rank{r}" for r in range(4)]
    assert sorted(r[0] for r in jres) == [f"{jp}.rank{r}" for r in range(4)]
    got = sum(r[1] for r in res)
    want = sum(r[1] for r in jres)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    a, b, *_ = mk(PBC)
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)
    # rank 1's shard, written by each package, restores in the other
    for ck, cls, src in ((pck, PBC, jp), (jck, JBC, p)):
        C = cls("C", 32, 32, 8, 8, P=2, Q=2, myrank=1)
        ck.restore_collections(src, C)
        np.testing.assert_allclose(C.to_dense(), [r[1] for r in res][1],
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_a_port_checkpoint_restores_in_the_jax_package(tmp_path):
    _, _, A, B, C = mk(PBC)
    run_gemm(A, B, C)
    p = str(tmp_path / "port.npz")
    pck.save_collections(p, C, A, meta={"by": "port"})
    jC, jA = JBC("C", 32, 32, 8, 8), JBC("A", 32, 32, 8, 8)
    assert jck.restore_collections(p, jC, jA) == {"by": "port"}
    np.testing.assert_array_equal(jC.to_dense(), C.to_dense())
    np.testing.assert_array_equal(jA.to_dense(), A.to_dense())
    for m in range(4):
        for n in range(4):
            assert jC.data_of(m, n).newest_copy().version \
                == C.data_of(m, n).newest_copy().version


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    _, _, jA, jB, jC = mk(JBC)
    run_gemm(jA, jB, jC)
    p = str(tmp_path / "jax.npz")
    jck.save_collections(p, jC, meta={"by": "jax"})
    C = PBC("C", 32, 32, 8, 8)
    assert pck.restore_collections(p, C) == {"by": "jax"}
    np.testing.assert_array_equal(C.to_dense(), jC.to_dense())
    assert C.data_of(2, 3).newest_copy().version \
        == jC.data_of(2, 3).newest_copy().version


def test_bf16_tiles_cross_as_their_bit_pattern(tmp_path):
    """A bf16 checkpoint of the JAX package (numpy writes its
    ``ml_dtypes`` tiles as two-byte voids) restores in the port bit for
    bit, and the port's own bf16 checkpoint round-trips."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((16, 16)).astype(ml_dtypes.bfloat16)
    jA = JBC.from_dense("A", a, 8, 8)
    p = str(tmp_path / "bf16.npz")
    jck.save_collections(p, jA)
    A = PBC("A", 16, 16, 8, 8, dtype=torch.bfloat16)
    pck.restore_collections(p, A)
    got = A.to_tensor().view(torch.int16).numpy()
    np.testing.assert_array_equal(got, a.view(np.int16))
    q = str(tmp_path / "bf16-port.npz")
    pck.save_collections(q, A)
    B = PBC("A", 16, 16, 8, 8, dtype=torch.bfloat16)
    pck.restore_collections(q, B)
    assert torch.equal(B.to_tensor().view(torch.int16),
                       A.to_tensor().view(torch.int16))
    with pytest.raises(pck.CheckpointError, match="dtype"):
        pck.restore_collections(p, PBC("A", 16, 16, 8, 8))


# ---------------------------------------------------------------------------
# on the device module
# ---------------------------------------------------------------------------

def test_save_reads_the_newest_copy_on_the_device(tmp_path, cpu_cuda_device):
    """After a pool on the device module the newest version of each C
    tile is the device's tensor (the write-back leaves it in the home
    copy until a flush moves it home): the save writes that version."""
    dev = cpu_cuda_device
    a, b, A, B, C = mk(PBC)
    run_gemm(A, B, C, devices="cuda", devs=[dev])
    d = C.data_of(0, 0)
    assert d.newest_copy().value is d.get_copy(dev.device_index).value
    p = str(tmp_path / "dev.npz")
    pck.save_collections(p, C)
    D = PBC("C", 32, 32, 8, 8)
    pck.restore_collections(p, D)
    np.testing.assert_allclose(D.to_dense(), a @ b, rtol=1e-4, atol=1e-4)
    dev.flush_cache()
    np.testing.assert_array_equal(D.to_dense(), C.to_dense())


def test_a_restore_drops_the_device_copies(tmp_path, cpu_cuda_device):
    """C = A·B on the device module, checkpoint, then a second pass on
    the card (C = 2·A·B there), restore, and a third pass: the third
    pass must start from the restored bytes (C = 2·A·B at the end), not
    from the device copies the second pass left newer.  Without the
    restore's invalidation it reads 3·A·B."""
    dev = cpu_cuda_device
    a, b, A, B, C = mk(PBC)
    run_gemm(A, B, C, devices="cuda", devs=[dev])
    p = str(tmp_path / "restage.npz")
    pck.save_collections(p, C)
    run_gemm(A, B, C, devices="cuda", devs=[dev])      # the device copies
    assert len(dev._mem_lru) > 0
    pck.restore_collections(p, C)
    left = [k for k in dev._mem_lru if k[0] == "C"]
    copies = {(m, n): sorted(C.data_of(m, n).device_copies)
              for m in range(4) for n in range(4)}
    run_gemm(A, B, C, devices="cuda", devs=[dev])
    dev.flush_cache()
    want = (a.astype(np.float64) @ b) * 2
    np.testing.assert_allclose(C.to_dense(), want, rtol=1e-4, atol=1e-3)
    assert left == [] and set(map(tuple, copies.values())) == {(0,)}


def test_the_saved_file_is_an_npz_with_the_jax_header(tmp_path):
    _, _, A, _, _ = mk(PBC)
    p = str(tmp_path / "h.npz")
    pck.save_collections(p, A, meta={"k": 1})
    with np.load(p) as z:
        import json
        header = json.loads(bytes(z["__header__"]).decode())
        assert sorted(z.files) == sorted(
            ["__header__"] + [f"A:{i}" for i in range(16)])
    assert header == {"rank": 0, "nranks": 1, "meta": {"k": 1},
                      "collections": {"A": {
                          "keys": [[m, n] for m in range(4)
                                   for n in range(4)],
                          "versions": [1] * 16}}}
    assert not os.path.exists(p + ".tmp.npz")

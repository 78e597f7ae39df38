"""The port's GEMM kernel module against the JAX package's GEMM.

``gemm_update_plain`` (what the CPU path runs, and what the card's kernel
is held against) is compared with ``parsec_tpu.ops.gemm._gemm_update`` and
with ``matmul_pallas`` in interpret mode, on the same numpy inputs.

The ``gemm_precision`` knob is held against the JAX package's on the
same inputs: on the CPU both packages compute full fp32 under
``default`` and ``highest`` alike (XLA's CPU default is fp32), so the
port's plain version matches ``_gemm_update``, ``tiled_gemm_fused`` and
the lowered GEMM under either.  What the knob picks on the card is
pinned through :func:`k1_variant`, and ``round_tf32`` (the reference of
the ``mma_tf32`` variant) against a numpy emulation of
``cvt.rna.tf32.f32`` bit by bit.

Tolerances: fp32 ``rtol=1e-5, atol=1e-4`` at k <= 512 — both sides
compute fp32 products and fp32 sums, so only the summation order differs.
bf16 inputs are compared in fp32 at ``rtol=2e-2, atol=1e-2``: the
products are exact in fp32, but a bf16 *output* (``matmul``) rounds to 8
mantissa bits, about 0.4% of the value.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.core.params import params as j_params
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiledMatrix
from parsec_tpu.models.tiled_gemm import tiled_gemm_fused as j_fused
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm_ptg
from parsec_tpu.ops.gemm import _gemm_update, matmul_pallas
from parsec_tpu.ptg.lowering import lower_taskpool as j_lower
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data.datatype import to_numpy, to_tensor
from parsec_tpu_torch.data_dist.matrix import TiledMatrix
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_fused, tiled_gemm_ptg
from parsec_tpu_torch.ops import _build
from parsec_tpu_torch.ops import gemm as tg
from parsec_tpu_torch.ptg.lowering import lower_taskpool

REPO = Path(__file__).resolve().parents[1]

FP32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=1e-2)

SHAPES = {
    "2d": (None, 64, 96, 128),
    "batched": (3, 32, 48, 64),
    "ragged": (None, 37, 53, 29),
}


def _inputs(seed, batch, m, n, k, in_dtype):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    a = rng.standard_normal(lead + (m, k), dtype=np.float32)
    b = rng.standard_normal(lead + (k, n), dtype=np.float32)
    c = rng.standard_normal(lead + (m, n), dtype=np.float32)
    if in_dtype == "bf16":
        a, b = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return a, b, c


def _f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("in_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_plain_matches_jax_gemm_update(kind, in_dtype):
    batch, m, n, k = SHAPES[kind]
    a, b, c = _inputs(1, batch, m, n, k, in_dtype)
    ref_fn = _gemm_update if batch is None else jax.vmap(_gemm_update)
    ref = ref_fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    got = tg.gemm_update_plain(to_tensor(a), to_tensor(b), to_tensor(c))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    tol = FP32_TOL if in_dtype == "fp32" else BF16_TOL
    np.testing.assert_allclose(to_numpy(got), _f32(ref), **tol)


@pytest.mark.parametrize("in_dtype", ["fp32", "bf16"])
def test_plain_and_matmul_match_matmul_pallas(in_dtype):
    m, n, k = 128, 192, 256
    a, b, _ = _inputs(2, None, m, n, k, in_dtype)
    ref = matmul_pallas(jnp.asarray(a), jnp.asarray(b), bm=64, bn=64, bk=64,
                        interpret=True)
    ta, tb = to_tensor(a), to_tensor(b)
    upd = tg.gemm_update_plain(ta, tb, torch.zeros(m, n))
    mm = tg.matmul(ta, tb)
    assert mm.dtype == ta.dtype            # matmul_pallas returns A's dtype
    tol = FP32_TOL if in_dtype == "fp32" else BF16_TOL
    np.testing.assert_allclose(to_numpy(upd), _f32(ref), **tol)
    np.testing.assert_allclose(_f32(to_numpy(mm)), _f32(ref), **tol)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    a, b, c = (torch.randn(3, 8, 8) for _ in range(3))
    before = (tg.gemm_update.launches, tg.matmul.launches)
    out = tg.gemm_update(a, b, c)
    tg.matmul(a, b)
    assert torch.equal(out, tg.gemm_update_plain(a, b, c))
    assert (tg.gemm_update.launches, tg.matmul.launches) == before
    assert out.data_ptr() != c.data_ptr()   # c is not modified in place


def test_tile_list_wrapper_on_cpu_tiles():
    rng = np.random.default_rng(3)
    a, b, c = (to_tensor(rng.standard_normal((4, 12, 12), dtype=np.float32))
               for _ in range(3))
    before = tg.gemm_update.launches
    got = tg.gemm_update_tiles(list(a), list(b), list(c))
    assert tg.gemm_update.launches == before
    assert torch.equal(torch.stack(got), tg.gemm_update_plain(a, b, c))
    # each result owns its storage: dropping one tile frees its bytes
    for t in got:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


@pytest.mark.parametrize("case", ["lengths", "empty", "shapes", "dtypes",
                                  "batched_tiles"])
def test_tile_list_wrapper_rejects_mixed_lists(case):
    a, b, c = torch.randn(8, 4), torch.randn(4, 6), torch.randn(8, 6)
    as_, bs, cs = [a, a], [b, b], [c, c]
    if case == "lengths":
        cs = [c]
    elif case == "empty":
        as_, bs, cs = [], [], []
    elif case == "shapes":
        as_ = [a, torch.randn(8, 5)]
    elif case == "dtypes":
        cs = [c, c.double()]
    elif case == "batched_tiles":
        as_, bs, cs = [a[None]], [b[None]], [c[None]]
    with pytest.raises((TypeError, ValueError)):
        tg.gemm_update_tiles(as_, bs, cs)


@pytest.mark.parametrize("case", [
    "dtype_mismatch", "unsupported_dtype", "shape_mismatch", "c_shape",
    "batch_mismatch", "mixed_rank", "non_contiguous", "rank_1"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    f = torch.float32
    a, b, c = torch.randn(8, 4), torch.randn(4, 6), torch.randn(8, 6)
    if case == "dtype_mismatch":
        b = b.to(torch.bfloat16)
    elif case == "unsupported_dtype":
        a, b = a.half(), b.half()
    elif case == "shape_mismatch":
        b = torch.randn(5, 6, dtype=f)
    elif case == "c_shape":
        c = torch.randn(6, 8, dtype=f)
    elif case == "batch_mismatch":
        a, b, c = torch.randn(2, 8, 4), torch.randn(3, 4, 6), torch.randn(2, 8, 6)
    elif case == "mixed_rank":
        a = a[None]
    elif case == "non_contiguous":
        a = torch.randn(4, 8).t()
    elif case == "rank_1":
        a, b, c = torch.randn(4), torch.randn(4), torch.randn(1)
    with pytest.raises((TypeError, ValueError)):
        tg.gemm_update(a, b, c)


def test_non_cuda_device_raises_instead_of_falling_back():
    a, b, c = (torch.empty(2, 2, device="meta") for _ in range(3))
    before = tg.gemm_update.launches
    with pytest.raises(ValueError, match="no kernel"):
        tg.gemm_update(a, b, c)
    assert tg.gemm_update.launches == before


def test_build_module_imports_without_nvcc_and_fails_only_on_build(
        monkeypatch, tmp_path):
    # importing it (above) needed no nvcc; a build request without one
    # raises a typed error naming the missing compiler
    assert "gemm" in _build.sources()
    assert _build.lib_path("gemm").parent == _build.BUILD_DIR
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.load("gemm")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build()


# ---------------------------------------------------------------------------
# the gemm_precision knob and the rule that picks K1's variant
# ---------------------------------------------------------------------------

@pytest.fixture
def knobs():
    """Restores both packages' ``gemm_precision`` after the test."""
    port, jax_ = params.get("gemm_precision"), j_params.get("gemm_precision")
    yield
    params.set("gemm_precision", port)
    j_params.set("gemm_precision", jax_)


J_PRECISION = {"default": None, "highest": jax.lax.Precision.HIGHEST}
F32, BF16 = torch.float32, torch.bfloat16


# (A/B dtype, out dtype, m, n, k, aligned, precision, variant); every
# shape that chip_smoke.py and tests/test_torch_card.py run, and the
# edges of the rule
@pytest.mark.parametrize("a_dtype,out_dtype,m,n,k,aligned,prec,variant", [
    # the dynamic GEMM path's tiles (chip_smoke.py, kernel and path)
    (F32, F32, 1024, 1024, 1024, True, "default", "mma_tf32"),
    (F32, F32, 1024, 1024, 1024, True, "highest", "simt_fp32"),
    # the lowered GEMM headline, 16384^3 bf16 -> fp32
    (BF16, F32, 16384, 16384, 16384, True, "default", "wgmma_bf16"),
    (BF16, F32, 16384, 16384, 16384, True, "highest", "wgmma_bf16"),
    (BF16, F32, 512, 512, 512, True, "default", "wgmma_bf16"),
    (F32, F32, 1000, 700, 300, True, "default", "mma_tf32"),
    (F32, F32, 1000, 700, 300, True, "highest", "simt_fp32"),
    (F32, BF16, 1000, 700, 300, True, "default", "mma_tf32"),
    # the recursive GEMM's sub-tiles and Ex08's
    (F32, F32, 512, 512, 512, True, "default", "mma_tf32"),
    (F32, F32, 8, 8, 8, True, "default", "mma_tf32"),
    # a 600-byte pitch TMA cannot take (chip_smoke.py's matmul too)
    (BF16, F32, 1000, 700, 300, True, "default", "simt_fp32"),
    (BF16, BF16, 1000, 700, 300, True, "highest", "simt_fp32"),
    # tests/test_torch_card.py
    (F32, F32, 256, 256, 256, True, "default", "mma_tf32"),
    (BF16, F32, 256, 256, 256, True, "highest", "wgmma_bf16"),
    (F32, F32, 65, 130, 47, True, "default", "simt_fp32"),      # k % 4
    (BF16, F32, 1000, 712, 304, True, "default", "wgmma_bf16"),
    (BF16, BF16, 130, 264, 72, True, "default", "wgmma_bf16"),
    (BF16, F32, 64, 64, 0, True, "default", "wgmma_bf16"),      # K = 0
    (F32, F32, 64, 64, 0, True, "default", "mma_tf32"),
    (BF16, F32, 128, 256, 64, True, "default", "wgmma_bf16"),
    (BF16, F32, 256, 512, 4160, True, "default", "wgmma_bf16"),
    (F32, F32, 256, 256, 2052, True, "default", "mma_tf32"),
    (F32, F32, 96, 112, 80, True, "default", "mma_tf32"),       # tile lists
    (BF16, F32, 96, 112, 80, True, "default", "wgmma_bf16"),
    (BF16, F32, 200, 264, 136, True, "default", "wgmma_bf16"),
    (BF16, F32, 64, 96, 128, False, "default", "simt_fp32"),    # unaligned
    (F32, F32, 64, 96, 128, False, "default", "simt_fp32"),
    # the rule's edges: pitches of 8 bytes short of 16, n % 4
    (BF16, F32, 64, 64, 68, True, "default", "simt_fp32"),
    (BF16, F32, 64, 68, 64, True, "default", "simt_fp32"),
    (F32, F32, 64, 66, 64, True, "default", "simt_fp32"),
    (F32, F32, 64, 64, 64, True, "highest", "simt_fp32")])
def test_k1_variant_rule(a_dtype, out_dtype, m, n, k, aligned, prec,
                         variant):
    assert tg.k1_variant(a_dtype, out_dtype, m, n, k, aligned, prec) \
        == variant


@pytest.mark.parametrize("bad", ["precision", "dtype"])
def test_k1_variant_refuses_what_it_does_not_know(bad):
    args = [F32, F32, 8, 8, 8, True, "default"]
    if bad == "precision":
        args[-1] = "fast"
    else:
        args[0] = torch.float16
    with pytest.raises((TypeError, ValueError)):
        tg.k1_variant(*args)


def _tf32_numpy(x):
    """``cvt.rna.tf32.f32`` emulated on the bits: keep the sign, round the
    magnitude's 13 low mantissa bits to nearest with ties (0x1000) away
    from zero, pass infinities and NaNs through."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    sign, mag = u & 0x80000000, u & 0x7FFFFFFF
    low = mag & 0x1FFF
    rounded = mag - low + np.where(low >= 0x1000, np.uint64(0x2000),
                                   np.uint64(0))
    special = (mag & 0x7F800000) == 0x7F800000
    out = np.where(special, u, sign | rounded).astype(np.uint32)
    return out.view(np.float32)


def test_round_tf32_matches_cvt_rna_bit_for_bit():
    rng = np.random.default_rng(11)
    exact = 0x3F800000 + (rng.integers(0, 1 << 10, 64) << 13)   # on grid
    ties = exact + 0x1000                      # exactly half way
    ties_up = (0x3FFFF000, 0x3F801000)         # carry into the exponent
    below, above = exact + 0x0FFF, exact + 0x1001
    special = (0x7F800000, 0xFF800000, 0x7FC00001, 0x00000000, 0x80000000,
               0x00001000, 0x00000FFF, 0x807FF000, 0x7F7FFFFF)
    bits = np.concatenate([exact, ties, below, above, ties_up, special])
    bits = np.concatenate([bits, bits | 0x80000000]).astype(np.uint32)
    vals = np.concatenate([bits.view(np.float32),
                           rng.standard_normal(4096).astype(np.float32)
                           * np.float32(1e3)])
    got = tg.round_tf32(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _tf32_numpy(vals).view(np.uint32))
    # the ties went away from zero: up in magnitude, whatever the sign
    t = torch.from_numpy(ties.astype(np.uint32).view(np.float32))
    assert bool((tg.round_tf32(t).abs() > t.abs()).all())
    assert bool((tg.round_tf32(-t) == -tg.round_tf32(t)).all())


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_plain_tf32_is_the_product_of_rounded_inputs(kind):
    batch, m, n, k = SHAPES[kind]
    a, b, c = (to_tensor(x) for x in _inputs(4, batch, m, n, k, "fp32"))
    got = tg.gemm_update_plain(a, b, c, tf32=True)
    ra, rb = tg.round_tf32(a), tg.round_tf32(b)
    # TF32 products are exact in fp32: only the summation order differs
    want = c.double() + torch.matmul(ra.double(), rb.double())
    torch.testing.assert_close(got.double(), want, **FP32_TOL)
    assert not torch.equal(got, tg.gemm_update_plain(a, b, c))
    # bf16 values are TF32 values already
    a16, b16 = a.bfloat16(), b.bfloat16()
    assert torch.equal(tg.gemm_update_plain(a16, b16, c, tf32=True),
                       tg.gemm_update_plain(a16, b16, c))


def _knob_in_subprocess(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "PARSEC_MCA_gemm_precision"}
    if env_value is not None:
        env["PARSEC_MCA_gemm_precision"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "from parsec_tpu_torch.ops import gemm; print(gemm.gemm_precision())"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("env_value,want", [(None, "default"),
                                            ("highest", "highest"),
                                            ("default", "default")])
def test_gemm_precision_default_and_environment(env_value, want):
    assert _knob_in_subprocess(env_value) == want


class _Recorder:
    """Stands in for the card: records the variant of each launch."""

    def __init__(self, monkeypatch):
        self.variants = []
        monkeypatch.setattr(tg, "_require_cuda", lambda t: None)
        monkeypatch.setattr(tg, "_launch", self._launch)

    def _launch(self, a, b, c, out, batch, m, n, k, variant, **kw):
        self.variants.append(variant)


def test_wrappers_read_the_knob_at_call_time(knobs, monkeypatch):
    """Each wrapper reads ``gemm_precision`` when it is called: fp32 on
    ``meta`` tensors (a device with no plain version, standing in for the
    card) picks ``mma_tf32`` under ``default`` and ``simt_fp32`` under
    ``highest``, set between two calls."""
    rec = _Recorder(monkeypatch)
    a, b, c = (torch.empty(2, 8, 8, device="meta") for _ in range(3))
    lhs = torch.empty(2, 3, 8, 8, device="meta")
    rhs = torch.empty(3, 2, 8, 8, device="meta")
    acc = torch.empty(2, 2, 8, 8, device="meta")
    calls = [lambda: tg.gemm_update(a, b, c),
             lambda: tg.gemm_update_stacked(a, b, c),
             lambda: tg.gemm_chain(lhs, rhs, acc),
             lambda: tg.matmul(a, b),
             lambda: tiled_gemm_fused(a, b, c)]
    # count on fresh counters: the fake launches leave the real ones as
    # they were
    monkeypatch.setattr(tg.gemm_update, "launches", 0)
    monkeypatch.setattr(tg.gemm_update, "launches_by_variant",
                        dict.fromkeys(tg.K1_VARIANTS, 0))
    for prec, variant in (("default", "mma_tf32"), ("highest", "simt_fp32"),
                          ("default", "mma_tf32")):
        params.set("gemm_precision", prec)
        rec.variants.clear()
        for call in calls:
            call()
        assert rec.variants == [variant] * len(calls)
    # an explicit precision wins over the knob
    rec.variants.clear()
    tiled_gemm_fused(a, b, c, precision="highest")
    assert rec.variants == ["simt_fp32"]
    # every launch but matmul's counts on gemm_update, by variant too
    assert tg.gemm_update.launches == 13
    assert tg.gemm_update.launches_by_variant == {
        "simt_fp32": 5, "mma_tf32": 8, "wgmma_bf16": 0}


def test_a_bad_knob_value_raises_at_the_next_call(knobs):
    a, b, c = (torch.randn(8, 8) for _ in range(3))
    params.set("gemm_precision", "fast")
    for call in (lambda: tg.gemm_update(a, b, c),
                 lambda: tg.gemm_update_tiles([a], [b], [c]),
                 lambda: tg.matmul(a, b)):
        with pytest.raises(ValueError, match="gemm_precision"):
            call()
    params.set("gemm_precision", "highest")
    assert torch.equal(tg.gemm_update(a, b, c), tg.gemm_update_plain(a, b, c))


@pytest.mark.parametrize("prec", ["default", "highest"])
@pytest.mark.parametrize("in_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_knob_matches_jax_gemm_update(knobs, kind, in_dtype, prec):
    """The port's CPU path under either setting against ``_gemm_update``
    at the matching precision, on the same numpy inputs."""
    batch, m, n, k = SHAPES[kind]
    a, b, c = _inputs(5, batch, m, n, k, in_dtype)
    ref_fn = (lambda x, y, z: _gemm_update(x, y, z,
                                           precision=J_PRECISION[prec]))
    ref = (ref_fn if batch is None else jax.vmap(ref_fn))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    params.set("gemm_precision", prec)
    got = tg.gemm_update(to_tensor(a), to_tensor(b), to_tensor(c))
    tol = FP32_TOL if in_dtype == "fp32" else BF16_TOL
    np.testing.assert_allclose(to_numpy(got), _f32(ref), **tol)
    tiles = tg.gemm_update_tiles(*(list(to_tensor(x).reshape(-1, *x.shape[-2:]))
                                   for x in (a, b, c)))
    np.testing.assert_allclose(to_numpy(torch.stack(tiles)).reshape(ref.shape),
                               _f32(ref), **tol)


@pytest.mark.parametrize("prec", [None, "default", "highest"])
def test_tiled_gemm_fused_precision_matches_jax(knobs, prec):
    rng = np.random.default_rng(12)
    a, b, c = (rng.standard_normal((48, 40)).astype(np.float32),
               rng.standard_normal((40, 56)).astype(np.float32),
               rng.standard_normal((48, 56)).astype(np.float32))
    params.set("gemm_precision", "highest")       # what None reads
    got = tiled_gemm_fused(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c), precision=prec)
    want = j_fused(a, b, c, precision=J_PRECISION[prec or "highest"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("ab_dtype", [np.float32, ml_dtypes.bfloat16])
def test_lowered_gemm_under_both_settings_matches_jax(knobs, ab_dtype):
    """``lower_taskpool(..., device="cpu")`` of the tiled GEMM gives the
    same C under ``default`` and ``highest``, equal to the JAX package's
    lowering under the same setting of its own knob."""
    rng = np.random.default_rng(13)
    a = rng.standard_normal((16, 12)).astype(np.float32).astype(ab_dtype)
    b = rng.standard_normal((12, 20)).astype(np.float32).astype(ab_dtype)
    outs = {}
    for prec in ("default", "highest"):
        params.set("gemm_precision", prec)
        j_params.set("gemm_precision", prec)
        C = TiledMatrix.from_dense("C", np.zeros((16, 20), np.float32), 4, 4)
        low = lower_taskpool(tiled_gemm_ptg(TiledMatrix.from_dense(
            "A", a, 4, 4), TiledMatrix.from_dense("B", b, 4, 4), C),
            device="cpu")
        assert low.mode == "chain-collapse"
        low.execute()
        JC = JTiledMatrix.from_dense("C", np.zeros((16, 20), np.float32),
                                     4, 4)
        j_lower(j_gemm_ptg(JTiledMatrix.from_dense("A", a, 4, 4),
                           JTiledMatrix.from_dense("B", b, 4, 4),
                           JC)).execute()
        outs[prec] = C.to_tensor().numpy()
        np.testing.assert_allclose(outs[prec], JC.to_dense(), **FP32_TOL)
        np.testing.assert_allclose(
            outs[prec], a.astype(np.float64) @ b.astype(np.float64),
            **FP32_TOL)
    np.testing.assert_array_equal(outs["default"], outs["highest"])


# ---------------------------------------------------------------------------
# the transposed and subtracting forms (the Cholesky and LU updates)
# ---------------------------------------------------------------------------

# form -> (trans_b, subtract, with C); each against the JAX body it serves
FORMS = {"nt-sub": (True, True, True),      # gemm_nt, syrk_ln
         "nt-noc": (True, False, False),    # trsm_rlt's product
         "nn-sub": (False, True, True),     # lu_gemm
         "nn-noc": (False, False, False),   # lu_trsm_l/u's products
         "nt": (True, False, True),
         "nn-sub-noc": (False, True, False)}


def _form_inputs(seed, batch, m, n, k, form):
    trans_b, subtract, with_c = FORMS[form]
    a, b, c = _inputs(seed, batch, m, n, k, "fp32")
    if trans_b:
        b = np.ascontiguousarray(np.swapaxes(b, -1, -2))
    return a, b, (c if with_c else None), dict(trans_b=trans_b,
                                               subtract=subtract)


def _jax_form(a, b, c, trans_b, subtract):
    """The JAX package's arithmetic for a form: ``c ± a @ op(b)`` with
    fp32 products (``parsec_tpu/models/cholesky.py:_gemm_nt_traceable``,
    ``models/lu.py:_gemm_nn_traceable``)."""
    bb = jnp.swapaxes(jnp.asarray(b), -1, -2) if trans_b else jnp.asarray(b)
    p = jnp.matmul(jnp.asarray(a), bb,
                   precision=jax.lax.Precision.HIGHEST)
    if c is None:
        return -p if subtract else p
    return jnp.asarray(c) - p if subtract else jnp.asarray(c) + p


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_forms_plain_and_wrappers_match_jax(form, kind):
    """Each form's plain version, and the three CPU wrappers that take
    it (strided, tile list, stacked), against the JAX arithmetic."""
    batch, m, n, k = SHAPES[kind]
    a, b, c, kw = _form_inputs(6, batch, m, n, k, form)
    if FORMS[form] == (True, True, True):
        ref = (jax.vmap(jchol_gemm_nt) if batch else jchol_gemm_nt)(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    else:
        ref = _jax_form(a, b, c, **kw)
    ta, tb = to_tensor(a), to_tensor(b)
    tc = None if c is None else to_tensor(c)
    got = tg.gemm_update_plain(ta, tb, tc, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(to_numpy(got), _f32(ref), **FP32_TOL)
    assert torch.equal(tg.gemm_update(ta, tb, tc, **kw), got)
    assert torch.equal(tg.gemm_update_stacked(ta, tb, tc, **kw), got)
    lead = ta.reshape(-1, m, k), tb.reshape(-1, *tb.shape[-2:])
    tiles = tg.gemm_update_tiles(
        list(lead[0]), list(lead[1]),
        None if tc is None else list(tc.reshape(-1, m, n)), **kw)
    assert torch.equal(torch.stack(tiles).reshape(got.shape), got)


def jchol_gemm_nt(a, b, c):
    from parsec_tpu.models.cholesky import _gemm_nt_traceable
    return _gemm_nt_traceable(a, b, c)


def test_plain_tf32_rounds_both_operands_of_a_transposed_form():
    a, b, c, kw = _form_inputs(7, None, 32, 48, 64, "nt-sub")
    ta, tb, tc = to_tensor(a), to_tensor(b), to_tensor(c)
    got = tg.gemm_update_plain(ta, tb, tc, tf32=True, **kw)
    want = tc.double() - tg.round_tf32(ta).double() \
        @ tg.round_tf32(tb).double().T
    torch.testing.assert_close(got.double(), want, **FP32_TOL)


def test_transposed_form_checks_the_transposed_shape():
    a, b, c = torch.randn(8, 4), torch.randn(6, 4), torch.randn(8, 6)
    tg.gemm_update(a, b, c, trans_b=True)
    for bad in (dict(b=torch.randn(4, 6)), dict(c=torch.randn(6, 8))):
        args = dict(a=a, b=b, c=c) | bad
        with pytest.raises(ValueError):
            tg.gemm_update(args["a"], args["b"], args["c"], trans_b=True)


@pytest.mark.parametrize("a_dtype,m,n,k,aligned,prec,trans_b,sub,variant", [
    # the factorizations' tiles: the dynamic paths' 1024, the lowered 512
    (F32, 1024, 1024, 1024, True, "default", True, True, "mma_tf32"),
    (F32, 1024, 1024, 1024, True, "default", True, False, "mma_tf32"),
    (F32, 1024, 1024, 1024, True, "default", False, True, "mma_tf32"),
    (F32, 512, 512, 512, True, "default", True, True, "mma_tf32"),
    (F32, 1024, 1024, 1024, True, "highest", True, True, "simt_fp32"),
    (F32, 512, 512, 512, True, "highest", False, True, "simt_fp32"),
    # tests/test_torch_card.py
    (F32, 130, 264, 72, True, "default", True, True, "mma_tf32"),
    (F32, 256, 192, 2052, True, "default", True, False, "mma_tf32"),
    (F32, 130, 264, 72, True, "highest", False, True, "simt_fp32"),
    # the ragged edge tiles of n=200/nb=64: 8-wide panels
    (F32, 8, 64, 64, True, "default", True, True, "mma_tf32"),
    (F32, 64, 8, 64, True, "default", True, True, "mma_tf32"),
    (F32, 64, 64, 8, True, "default", True, True, "mma_tf32"),
    (F32, 64, 66, 64, True, "default", True, True, "simt_fp32"),
    (F32, 64, 64, 66, True, "default", True, True, "simt_fp32"),
    (F32, 64, 64, 64, False, "default", True, True, "simt_fp32"),
    # wgmma_bf16 takes neither new form
    (BF16, 128, 256, 64, True, "default", True, True, "simt_fp32"),
    (BF16, 128, 256, 64, True, "default", True, False, "simt_fp32"),
    (BF16, 128, 256, 64, True, "default", False, True, "simt_fp32"),
    (BF16, 128, 256, 64, True, "default", False, False, "wgmma_bf16")])
def test_k1_variant_rule_for_the_new_forms(a_dtype, m, n, k, aligned, prec,
                                           trans_b, sub, variant):
    assert tg.k1_variant(a_dtype, F32, m, n, k, aligned, prec, trans_b,
                         sub) == variant


def test_wrappers_pass_the_form_and_count_it(knobs, monkeypatch):
    """The forms reach the launch (meta tensors standing in for the
    card; the tile-list entry needs pinned memory, which only a card
    gives, and goes through the same ``_launch``), pick their variant by
    the rule, and count by form."""
    seen = []
    monkeypatch.setattr(tg, "_require_cuda", lambda t: None)
    monkeypatch.setattr(tg, "_launch", lambda *a, **kw: seen.append(
        (a[8], kw.get("trans_b"), kw.get("subtract"), a[2] is None)))
    monkeypatch.setattr(tg.gemm_update, "launches", 0)
    monkeypatch.setattr(tg.gemm_update, "launches_by_variant",
                        dict.fromkeys(tg.K1_VARIANTS, 0))
    monkeypatch.setattr(tg.gemm_update, "launches_by_form", {})
    params.set("gemm_precision", "default")
    a = torch.empty(2, 8, 8, device="meta")
    tg.gemm_update(a, a, a, trans_b=True, subtract=True)
    tg.gemm_update(a, a, None, trans_b=True)
    tg.gemm_update_stacked(a, a, a, subtract=True)
    tg.gemm_update(a.bfloat16(), a.bfloat16(), a, trans_b=True)
    tg.gemm_update(a, a, a)
    assert seen == [("mma_tf32", True, True, False),
                    ("mma_tf32", True, False, True),
                    ("mma_tf32", False, True, False),
                    ("simt_fp32", True, False, False),
                    ("mma_tf32", False, False, False)]
    assert tg.gemm_update.launches_by_form == {
        "nt-sub": 1, "nt-noc": 1, "nn-sub": 1, "nt": 1, "nn": 1}
    assert tg.gemm_update.launches == 5


@pytest.mark.parametrize("case", ["trsm_rlt", "lu_trsm_l"])
def test_stacked_form_lists_a_shared_tile_without_copying(case, monkeypatch):
    """A group's shared tile (a broadcast view, as the wavefront pass
    hands a TRSM group its inverse) goes to the tile-list launch as one
    pointer repeated, and the result matches the copied operand's."""
    g = torch.Generator().manual_seed(12)
    inv = torch.randn(1, 12, 12, generator=g)
    cs = torch.randn(5, 12, 12, generator=g)
    shared = inv.expand(5, 12, 12)
    args = (cs, shared) if case == "trsm_rlt" else (shared, cs)
    kw = dict(trans_b=case == "trsm_rlt")
    seen = []
    real = tg.gemm_update_tiles

    def spy(as_, bs, cs=None, **kw):
        seen.append([{t.data_ptr() for t in col} for col in (as_, bs)])
        return real(as_, bs, cs, **kw)

    monkeypatch.setattr(tg, "gemm_update_tiles", spy)
    got = tg.gemm_update_stacked(*args, **kw)
    want = tg.gemm_update_plain(*(t.contiguous() for t in args), **kw)
    assert got.shape == (5, 12, 12) and got.is_contiguous()
    # fp32 products of 12 terms, summed in per-tile order: a few ulps
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    shared_col = 1 if case == "trsm_rlt" else 0
    assert len(seen) == 1 and seen[0][shared_col] == {inv.data_ptr()}
    assert len(seen[0][1 - shared_col]) == 5
    with pytest.raises(ValueError, match="out"):
        real(list(cs), [inv[0]] * 5, out=torch.empty(4, 12, 12))

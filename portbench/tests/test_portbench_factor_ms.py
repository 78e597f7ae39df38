"""The ``factor_ms`` reader: which device operations of a traced solve it
counts as the diagonal tiles' factors and inverses."""

from types import SimpleNamespace

from portbench import spec
from portbench.trace import Trace


def test_factor_ms_reads_both_routes_and_no_movement():
    """``factor_ms`` sums, a solve, the hand kernels' and the library's
    factor and inverse operations, and none of the copies that
    ``movement_ms`` reads, nor the fills, compares, ``tril`` and fp32
    GEMMs that other operations of a solve launch too; a trace with none
    of them gives no value."""
    reader, movement = spec.metric("factor_ms"), spec.metric("movement_ms")
    assert not set(reader.PATTERNS) & set(movement.PATTERNS)
    ns = {"(anonymous namespace)::potrf_kernel(float const*, long long, "
          "long long, float*, int)": 3_000_000,
          "(anonymous namespace)::trinv_kernel(float const*, long long, "
          "long long, float*, int)": 1_000_000,
          "void kernel<getrf_wo_pivot_params_<float, 0, 256> >(int)":
          2_000_000,
          "void kernel_trsm_l_mul32<float, 8, true>(int)": 1_000_000,
          "void at::native::elementwise_kernel<128, 2, at::native::"
          "direct_copy_kernel_cuda>": 5_000_000,
          "void tf32::gemm_update_kernel<float, true, true>": 9_000_000,
          "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8": 4_000_000,
          "void at::native::triu_tril_kernel<float, int, false, 2, true>":
          4_000_000,
          "void at::native::vectorized_elementwise_kernel<4, at::native::"
          "FillFunctor<float>>": 4_000_000,
          "void at::native::masked_fill_kernel<bool>": 4_000_000}
    t = Trace(solves=2)
    t.device_ns.update(ns)
    assert reader.read(SimpleNamespace(trace=t)) == 3.5
    empty = Trace(solves=2)
    empty.device_ns.update({"void tf32::gemm_update_kernel": 1})
    assert reader.read(SimpleNamespace(trace=empty)) is None
    assert reader.read(SimpleNamespace(trace=None)) is None


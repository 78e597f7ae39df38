// Batched tile GEMM with a C + A@B epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel parsec_tpu/ops/gemm.py:matmul_pallas (body
// _pallas_matmul_kernel): A@B over a (m/bm, n/bn, k/bk) grid with an fp32
// accumulator zeroed at k-step 0 and cast to A's dtype at the last one.
// This port extends it to what the port's main path calls: the GEMM task
// body C + A@B cast to C's dtype (parsec_tpu/ops/gemm.py:_gemm_update),
// and a batch dimension for the device module's fused same-class dispatch
// (parsec_tpu/device/tpu.py:_run_vmapped).  Edges are masked, so ragged
// edge tiles and dims that no block size divides work.
//
//   out[b] = (ADD_C ? C[b] : 0) + A[b] @ B[b]
//   A[b] (M, K), B[b] (K, N), C[b] and out[b] (M, N), each row-major and
//   contiguous; inputs fp32 or bf16, C/out fp32 or bf16; products and
//   sums in fp32.  The batch is either strided (one (batch, M, K) tensor
//   per operand) or given as a device array of 4*batch tile pointers
//   (A tiles, then B, C, out): the device module's fused dispatch passes
//   its tiles that way, so each output tile has storage of its own and
//   no operand is stacked.
//
// What bounds it: at the path's tile (nb = 1024, fp32) one task is
// 2*1024^3 = 2.15 GFLOP against 16 MiB moved (A, B and C read, out
// written), about 128 FLOP per byte, so it is compute-bound on an H100
// SXM: 67 TFLOP/s fp32 outside the tensor cores (32 us per tile) against
// 3.35 TB/s (5 us per tile).  The tensor cores would give 495 TFLOP/s in
// TF32 and 989 TFLOP/s in bf16 (NVIDIA data sheet).
//
// What this first design does about it: nothing beyond shared-memory
// reuse.  Each 256-thread block owns a 64x64 output tile; the k-loop runs
// inside the block in steps of 16 (it replaces Pallas' sequential k grid
// axis, since Hopper blocks run in no order); each step stages a 64x16
// slice of A (stored k-major) and a 16x64 slice of B in shared memory as
// fp32, and each thread accumulates a 4x4 register micro-tile with fp32
// FMAs.  The batch index is blockIdx.z.  No tensor cores (wgmma), no TMA
// and no multi-stage pipeline yet: every product is strict fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TI, typename TO, bool ADD_C>
__global__ void __launch_bounds__(THREADS)
    gemm_update_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
                       const TO* __restrict__ C, TO* __restrict__ Out,
                       const void* const* __restrict__ ptrs, int M, int N,
                       int K) {
  __shared__ float As[BK][BM + 4];  // k-major: a column of A is a row here
  __shared__ float Bs[BK][BN + 4];

  const size_t bz = blockIdx.z;
  if (ptrs) {
    const size_t nb = gridDim.z;
    A = static_cast<const TI*>(ptrs[bz]);
    B = static_cast<const TI*>(ptrs[nb + bz]);
    C = static_cast<const TO*>(ptrs[2 * nb + bz]);
    Out = static_cast<TO*>(const_cast<void*>(ptrs[3 * nb + bz]));
  } else {
    A += bz * M * K;
    B += bz * K * N;
    Out += bz * M * N;
    if (ADD_C) C += bz * M * N;
  }

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slice BM x BK: consecutive threads walk k along one row of A
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? to_f32(A[(size_t)gr * K + gk]) : 0.f;
    }
    // B slice BK x BN: consecutive threads walk n along one row of B
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N) ? to_f32(B[(size_t)gk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= N) continue;
      const size_t o = (size_t)r * N + c;
      float v = acc[i][j];
      if (ADD_C) v += to_f32(C[o]);
      Out[o] = from_f32<TO>(v);
    }
  }
}

template <typename TI, typename TO>
void launch(const void* a, const void* b, const void* c, void* out,
            const void* const* ptrs, int batch, int m, int n, int k,
            int add_c, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  const TI* A = static_cast<const TI*>(a);
  const TI* B = static_cast<const TI*>(b);
  const TO* C = static_cast<const TO*>(c);
  TO* O = static_cast<TO*>(out);
  if (add_c)
    gemm_update_kernel<TI, TO, true>
        <<<grid, THREADS, 0, stream>>>(A, B, C, O, ptrs, m, n, k);
  else
    gemm_update_kernel<TI, TO, false>
        <<<grid, THREADS, 0, stream>>>(A, B, C, O, ptrs, m, n, k);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  ptrs is null for a strided
// batch, else a device array of 4*batch tile pointers (a, b, c and out
// are then ignored).  Returns cudaGetLastError() after the launch
// (0 = launched); the caller raises on anything else.
extern "C" int parsec_gemm_update(const void* a, const void* b, const void* c,
                                  void* out, const void* const* ptrs,
                                  int batch, int m, int n, int k,
                                  int in_dtype, int out_dtype, int add_c,
                                  void* stream) {
  if (batch <= 0 || batch > 65535 || m <= 0 || n <= 0 || k < 0 ||
      in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(a, b, c, out, ptrs, batch, m, n, k, add_c, s);
  else if (in_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(a, b, c, out, ptrs, batch, m, n, k, add_c,
                                 s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(a, b, c, out, ptrs, batch, m, n, k, add_c,
                                 s);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, out, ptrs, batch, m, n, k,
                                         add_c, s);
  return static_cast<int>(cudaGetLastError());
}

// 1-D weighted stencil over batched padded rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel parsec_tpu/ops/stencil.py:_stencil1d_pallas_rows
// (kernel _stencil_row_kernel, wrapper stencil1d_pallas): each row of
// `padded` carries taps-1 halo elements, and
//
//   out[r, i] = sum_{j=0}^{taps-1} w[j] * padded[r, i + j],  0 <= i < n,
//
// with n = npad - taps + 1, accumulated in fp32 over j = 0..taps-1 in that
// order and written in the input dtype (fp32 or bf16).  The Pallas kernel
// kept whole 8-row blocks in VMEM and sent rows longer than 2^17 elements
// to XLA; here every length runs on this kernel, tiled along the row.
//
// What bounds it: each input element is read once and each output written
// once, about 8 bytes an fp32 element (4 in, 4 out) against 2*taps flops,
// 18 flops at 9 taps: about 2 flops a byte, far below the H100's 20 fp32
// flops a byte, so the memory rate (3.35 TB/s) bounds it.
//
// What this first design does about it: one pass over memory.  A block of
// 256 threads owns CHUNK = 2048 consecutive outputs of one row; it loads
// those CHUNK + taps - 1 inputs into shared memory in one coalesced pass
// (widening bf16 to fp32), then each thread accumulates the taps of its 8
// outputs from shared memory and writes them, neighbouring threads on
// neighbouring addresses.  The halo is read twice (once by each of the two
// blocks that share it), taps-1 elements in CHUNK.  Grid: (row chunks,
// rows), rows strided past 65535.  Weights travel by value in the launch
// parameters (at most MAX_TAPS), so concurrent launches with different
// weights cannot race on a __constant__ symbol.  No vector loads, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MAX_TAPS = 64;
constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int CHUNK = THREADS * PER_THREAD;  // 2048 outputs per block

struct Taps {
  float w[MAX_TAPS];
};

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    stencil1d_kernel(const T* __restrict__ in, T* __restrict__ out,
                     long long rows, long long npad, long long n, int taps,
                     Taps tw) {
  __shared__ float s[CHUNK + MAX_TAPS - 1];
  const long long c0 = (long long)blockIdx.x * CHUNK;
  const int span = (int)min((long long)CHUNK, n - c0);  // outputs here
  const int width = span + taps - 1;                     // inputs here
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* src = in + (size_t)r * (size_t)npad + c0;
    for (int i = threadIdx.x; i < width; i += THREADS) s[i] = to_f32(src[i]);
    __syncthreads();
    T* dst = out + (size_t)r * (size_t)n + c0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (i < span) {
        float acc = 0.f;
        for (int j = 0; j < taps; ++j) acc = fmaf(tw.w[j], s[i + j], acc);
        dst[i] = from_f32<T>(acc);
      }
    }
    __syncthreads();  // s is refilled for the next row
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `in` is (rows, npad) and `out`
// (rows, npad - taps + 1), both row-major and contiguous on the device;
// `weights` is a host array of `taps` floats.  Returns cudaGetLastError()
// after the launch (0 = launched); the caller raises on anything else.
extern "C" int parsec_stencil1d(const void* in, void* out, long long rows,
                                long long npad, int taps,
                                const float* weights, int dtype,
                                void* stream) {
  const long long n = npad - taps + 1;
  if (rows <= 0 || taps <= 0 || taps > MAX_TAPS || n <= 0 || dtype < 0 ||
      dtype > 1 || weights == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Taps tw;
  for (int j = 0; j < MAX_TAPS; ++j) tw.w[j] = j < taps ? weights[j] : 0.f;
  const dim3 grid((unsigned)chunks, (unsigned)(rows < 65535 ? rows : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    stencil1d_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), rows, npad,
        n, taps, tw);
  else
    stencil1d_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(in),
        static_cast<__nv_bfloat16*>(out), rows, npad, n, taps, tw);
  return static_cast<int>(cudaGetLastError());
}

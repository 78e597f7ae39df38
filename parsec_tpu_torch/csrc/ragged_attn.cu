// Ragged paged-attention decode update, one KV page per task, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel parsec_tpu/ops/ragged_attention.py:
// build_pallas_page_update (kernel at :457-478): one query against one
// KV page with the online-softmax (flash) state carried in an
// accumulator tile.  Per task:
//
//   q3   (3, H, D)     fp32; channel 0 is the query
//   page (3, P, H, D)  fp32 or bf16 (widened on load); K is channel 0,
//                      V channel 1, the fill count is page[2, 0, 0, 0]
//   acc  (H, D+2)      fp32, [o | m | l]; l == 0 is the empty accumulator
//   out  (H, D+2)      fp32, a new tile (never aliases acc)
//
//   s[p, h]  = sum_d K[p, h, d] * q[h, d] / sqrt(D)      for p < fill
//   m_prev   = l > 0 ? acc[h, D] : NEG_INF
//   m_new    = max(m_prev, max_p s[p, h])
//   w[p, h]  = exp(s[p, h] - m_new)                       (0 past fill)
//   alpha    = exp(m_prev - m_new)
//   out[h]   = [acc[h, :D] * alpha + sum_p w V[p, h, :], m_new,
//               l * alpha + sum_p w]
//
// One launch serves a whole fused batch of tasks.  The batch is either
// strided (one (B, ...) tensor per operand) or given as a device array of
// 4*B tile pointers (q3 tiles, then pages, accs, outs): the device
// module's fused dispatch passes its tiles that way, reading each where
// it lies, and every output tile has storage of its own.
//
// What bounds it: bytes.  Per task it reads the query row, K and V of the
// filled slots only, and acc, and writes out: at the ToyLM page (P=16,
// H=4, D=8) a full page is 16*4*8*2*4 = 4 KiB of K/V against about 8
// flops a byte, far under the H100's 67 TFLOP/s fp32 / 3.35 TB/s = 20
// flops a byte.  So the least time is those bytes over 3.35 TB/s.
//
// What this first design does about it: slots at or past the fill are
// never read, and each block reads the fill itself on the device (clamped
// to [0, P]), so the host never syncs to learn it.  The grid is (H, B);
// one block per (head, task), threads laid over D.  Each warp takes
// slots in turn, its lanes walk D (coalesced), and a shuffle sum gives
// the slot's score, kept in shared memory with the query row.  Then each
// thread owns one d of the output and sums w*V over the filled slots.
// exp is expf (no fast math), so the kernel tracks the plain PyTorch
// version to rounding.  No TMA, no cp.async pipeline, no head packing
// yet: at D=8 three quarters of each warp idle in the score phase.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float NEG_INF = -1e30f;  // finite: exp(NEG_INF - m) underflows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TP>
__global__ void ragged_attn_page_kernel(const float* __restrict__ q3,
                                        const TP* __restrict__ page,
                                        const float* __restrict__ acc,
                                        float* __restrict__ out,
                                        const void* const* __restrict__ ptrs,
                                        int P, int H, int D) {
  extern __shared__ float smem[];
  float* qs = smem;      // the query row q[h, :], D floats
  float* sc = smem + D;  // the scores of the filled slots, P floats

  const int h = blockIdx.x;
  const size_t b = blockIdx.y;
  const size_t HD = static_cast<size_t>(H) * D;
  const size_t PHD = static_cast<size_t>(P) * HD;
  if (ptrs) {
    const size_t nb = gridDim.y;
    q3 = static_cast<const float*>(ptrs[b]);
    page = static_cast<const TP*>(ptrs[nb + b]);
    acc = static_cast<const float*>(ptrs[2 * nb + b]);
    out = static_cast<float*>(const_cast<void*>(ptrs[3 * nb + b]));
  } else {
    q3 += b * 3 * HD;
    page += b * 3 * PHD;
    acc += b * static_cast<size_t>(H) * (D + 2);
    out += b * static_cast<size_t>(H) * (D + 2);
  }

  // valid slots are p < fill (the fill is a float in the page), so
  // n = ceil(fill) clamped to [0, P]; a NaN fill reads as 0
  const float fill = to_f32(page[2 * PHD]);
  int n = 0;
  if (fill >= static_cast<float>(P))
    n = P;
  else if (fill > 0.f)
    n = static_cast<int>(ceilf(fill));

  const int tid = threadIdx.x;
  for (int d = tid; d < D; d += blockDim.x) qs[d] = q3[h * D + d];
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float scale = sqrtf(static_cast<float>(D));
  const TP* K = page + static_cast<size_t>(h) * D;
  const TP* V = page + PHD + static_cast<size_t>(h) * D;
  for (int s = warp; s < n; s += nwarps) {
    float part = 0.f;
    for (int d = lane; d < D; d += 32)
      part = fmaf(to_f32(K[s * HD + d]), qs[d], part);
    part = warp_sum(part);
    if (lane == 0) sc[s] = part / scale;
  }
  __syncthreads();

  const float* a = acc + static_cast<size_t>(h) * (D + 2);
  const float l_prev = a[D + 1];
  const float m_prev = l_prev > 0.f ? a[D] : NEG_INF;
  float smax = NEG_INF;
  for (int s = 0; s < n; ++s) smax = fmaxf(smax, sc[s]);
  const float m_new = fmaxf(m_prev, smax);
  const float alpha = expf(m_prev - m_new);

  float* o = out + static_cast<size_t>(h) * (D + 2);
  for (int d = tid; d < D; d += blockDim.x) {
    float pv = 0.f;
    for (int s = 0; s < n; ++s)
      pv = fmaf(expf(sc[s] - m_new), to_f32(V[s * HD + d]), pv);
    o[d] = a[d] * alpha + pv;
  }
  if (tid == 0) {
    float lsum = 0.f;
    for (int s = 0; s < n; ++s) lsum += expf(sc[s] - m_new);
    o[D] = m_new;
    o[D + 1] = l_prev * alpha + lsum;
  }
}

template <typename TP>
void launch(const void* q3, const void* page, const void* acc, void* out,
            const void* const* ptrs, int batch, int P, int H, int D,
            cudaStream_t stream) {
  int threads = ((D + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid(H, batch);
  const size_t smem = static_cast<size_t>(D + P) * sizeof(float);
  ragged_attn_page_kernel<TP><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(q3), static_cast<const TP*>(page),
      static_cast<const float*>(acc), static_cast<float*>(out), ptrs, P, H,
      D);
}

}  // namespace

// page_dtype: 0 = float32, 1 = bfloat16 (q3, acc and out are float32).
// ptrs is null for a strided batch, else a device array of 4*batch tile
// pointers (q3, page, acc and out are then ignored).  Returns
// cudaGetLastError() after the launch (0 = launched); the caller raises
// on anything else.
extern "C" int parsec_ragged_attn_page(const void* q3, const void* page,
                                       const void* acc, void* out,
                                       const void* const* ptrs, int batch,
                                       int P, int H, int D, int page_dtype,
                                       void* stream) {
  if (batch <= 0 || batch > 65535 || P <= 0 || H <= 0 || D <= 0 ||
      D > 1024 || static_cast<size_t>(D + P) * sizeof(float) > 48 * 1024 ||
      page_dtype < 0 || page_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_dtype == 0)
    launch<float>(q3, page, acc, out, ptrs, batch, P, H, D, s);
  else
    launch<__nv_bfloat16>(q3, page, acc, out, ptrs, batch, P, H, D, s);
  return static_cast<int>(cudaGetLastError());
}

// Ragged paged-attention decode update, one KV page per task, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel parsec_tpu/ops/ragged_attention.py:
// build_pallas_page_update (kernel at :457-478): one query against one
// KV page with the online-softmax (flash) state carried in an
// accumulator tile.  Per task:
//
//   q3   (3, H, D)     fp32; channel 0 is the query
//   page (3, P, H, D)  fp32 or bf16 (widened on load from shared memory);
//                      K is channel 0, V channel 1, the fill count is
//                      page[2, 0, 0, 0]
//   acc  (H, D+2)      fp32, [o | m | l]; l == 0 is the empty accumulator
//   out  (H, D+2)      fp32; may be acc itself (the update in place)
//
//   s[p, h]  = sum_d K[p, h, d] * q[h, d] / sqrt(D)      for p < fill
//   m_prev   = l > 0 ? acc[h, D] : NEG_INF
//   m_new    = max(m_prev, max_p s[p, h])
//   w[p, h]  = exp(s[p, h] - m_new)                       (0 past fill)
//   alpha    = exp(m_prev - m_new)
//   out[h]   = [acc[h, :D] * alpha + sum_p w V[p, h, :], m_new,
//               l * alpha + sum_p w]
//
// What bounds it.  A task has one query row per head, so q.K^T is a
// matrix-vector product at about half a flop per byte: the tensor cores
// have nothing to do, and the floor is the bytes of the filled slots' K
// and V over 3.35 TB/s.  At the serving path's ToyLM pages (P=16, H=4,
// D=8, fp32: 4 KiB of K/V a page, batches of about five tasks) that floor
// is nanoseconds, and the kernel is bound by latency: the fill read, one
// round trip for the staged K/V, the launch.  At a Llama-2-7B head
// geometry (P=16, H=32, D=128: 512 KiB of K/V a full page, 1024 pages a
// launch) it is bound by bytes.
//
// What the design does about it.
// - Grid (head groups, tasks): one block serves one task and hg heads,
//   chosen by the wrapper (ops/ragged_attention.py:plan) so that the
//   block's staged K/V fits a budget of 16 KiB of shared memory: all 4
//   heads at ToyLM's shape, 1 (fp32) or 2 (bf16) of Llama's 32. Small
//   blocks keep many resident on an SM, so some are always loading while
//   others compute, and spread a serving batch of a few tasks over the SMs
//   (1024 Llama pages in fp32 on an H100 SXM at 700 W: 0.124 ms at 16 KiB,
//   0.127 at 64 KiB; scripts/k2_compare.py --kv-bytes). Where one head's
//   page does not fit, the block walks the filled slots in chunks of cs
//   slots with the online-softmax update, so any P, H and D run.
// - Loading: the block issues its query and accumulator rows as cp.async
//   copies, reads the fill (clamped to [0, P] on the device; the host never
//   syncs on it), then stages only the filled slots' K and V: for one slot
//   the block's heads are one contiguous run of hg*D elements, copied in
//   16-byte cp.async units, in two commit groups, K's and then V's, so that
//   V lands while the scores are computed (with one group and a warp a
//   score this design took 0.173 ms there at 64 KiB, against 0.127 with
//   both changes). A run or base off a 16-byte boundary falls back to 4-byte
//   cp.async units, and a bf16 run off a 4-byte boundary to 2-byte plain
//   loads. TMA buys nothing here: a box of fixed extent would read the
//   unfilled slots, and a tensor map per page would bring back host work.
// - Computing: a group of lanes takes each (slot, head), lanes over D in
//   4-wide vectors (8 lanes at D=128, four vectors each), and reduces by
//   shuffles; one warp a head takes the max and the sum; exp(s - m_new) is
//   computed once a score (expf, no fast math) and kept in shared memory; a
//   thread per (head, 4 d's) runs P.V over the staged V.
// - In place: every read of the block's acc rows is a copy into shared
//   memory that completes before the first barrier; the rows are written
//   after the last one.  Blocks own disjoint rows, so out may be acc.
// - Pointers: a batch of up to MAX_BYVAL (64, the device module's
//   device_cuda_batch_max) tasks passes its 4*B tile pointers by value in
//   the kernel's parameters (2 KiB, inside the 4 KiB every driver takes);
//   a larger batch passes a device array of them, which the wrapper
//   fills from a pinned buffer it keeps per device and reuses behind an
//   event.  A strided batch passes base pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr float NEG_INF = -1e30f;  // finite: exp(NEG_INF - m) underflows
constexpr int MAX_BYVAL = 64;      // tasks whose pointers ride by value
constexpr int MAX_THREADS = 256;

enum Mode { STRIDED = 0, BYVAL = 1, ARRAY = 2 };

struct Params {
  const void* tiles[4][MAX_BYVAL];  // BYVAL: q3, page, acc, out of task b
  const void* const* dev_ptrs;      // ARRAY: 4*batch pointers, same columns
  const float* q3;                  // STRIDED: batch-strided bases
  const void* page;
  const float* acc;
  float* out;
  int mode;
  int batch, P, H, D;
  int hg;     // heads per block
  int cs;     // slots staged per chunk
  int pitch;  // elements between staged slot rows (a 16-byte multiple)
};

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Byte offsets of the shared-memory regions, each 16-byte aligned: K and
// V (cs slot rows of pitch elements), the query rows (hg*D fp32), the
// running state in acc's layout (hg*(D+2) fp32), the scores and then
// weights of one chunk (hg*cs fp32), and each head's alpha (hg fp32).
struct Layout {
  size_t v, q, a, w, al, total;
};

__host__ __device__ inline Layout layout(int hg, int cs, int pitch, int D,
                                         size_t esize) {
  Layout L;
  const size_t kv = static_cast<size_t>(cs) * pitch * esize;
  L.v = kv;
  L.q = 2 * kv;
  L.a = L.q + round16(static_cast<size_t>(hg) * D * 4);
  L.w = L.a + round16(static_cast<size_t>(hg) * (D + 2) * 4);
  L.al = L.w + round16(static_cast<size_t>(hg) * cs * 4);
  L.total = L.al + round16(static_cast<size_t>(hg) * 4);
  return L;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four elements d..d+3 of a staged row, widened to fp32.  VEC: D is a
// multiple of 4, so the four lie in one aligned 16-byte (fp32) or
// 8-byte (bf16) word of shared memory; else scalar, zero past D.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* r, int d, int D) {
  if (VEC) return *reinterpret_cast<const float4*>(r + d);
  float4 x;
  x.x = r[d];
  x.y = d + 1 < D ? r[d + 1] : 0.f;
  x.z = d + 2 < D ? r[d + 2] : 0.f;
  x.w = d + 3 < D ? r[d + 3] : 0.f;
  return x;
}

template <bool VEC>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* r, int d,
                                        int D) {
  if (VEC) {
    const uint2 u = *reinterpret_cast<const uint2*>(r + d);
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &u.x, 4);
    memcpy(&hi, &u.y, 4);
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float4 x;
  x.x = __bfloat162float(r[d]);
  x.y = d + 1 < D ? __bfloat162float(r[d + 1]) : 0.f;
  x.z = d + 2 < D ? __bfloat162float(r[d + 2]) : 0.f;
  x.w = d + 3 < D ? __bfloat162float(r[d + 3]) : 0.f;
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy units of u bytes (16 and 4: cp.async; 2: a plain load and store).
__device__ __forceinline__ void copy_unit(char* dst, const char* src,
                                          int u) {
  if (u == 16)
    cp_async16(dst, src);
  else if (u == 4)
    cp_async4(dst, src);
  else
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
}

// The widest unit every address and length in `bits` is a multiple of.
__device__ __forceinline__ int unit_of(uintptr_t bits) {
  return (bits & 15) == 0 ? 16 : (bits & 3) == 0 ? 4 : 2;
}

// One contiguous run of nbytes into a 16-byte aligned smem region.
__device__ __forceinline__ void stage_run(void* dst, const void* src,
                                          int nbytes, int tid, int nthr) {
  const int u = unit_of(reinterpret_cast<uintptr_t>(src) |
                        static_cast<uintptr_t>(nbytes));
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int o = tid * u; o < nbytes; o += nthr * u) copy_unit(d + o, s + o, u);
}

// K's or V's rows of slots c0..c0+cn-1 for the block's heads: cn runs of
// run_bytes.  Slot rows lie HD elements apart in the page and pitch
// elements apart in shared memory (a 16-byte multiple).
template <typename TP>
__device__ __forceinline__ void stage_slots(TP* dst_rows, const TP* src_rows,
                                            int c0, int cn, size_t HD,
                                            int pitch, int run_bytes, int tid,
                                            int nthr) {
  const int u = unit_of(reinterpret_cast<uintptr_t>(src_rows) |
                        static_cast<uintptr_t>(HD * sizeof(TP)) |
                        static_cast<uintptr_t>(run_bytes));
  const int upr = run_bytes / u;  // units a run
  const int total = cn * upr;
  int r = tid / upr;              // this thread's run and unit in it,
  int o = tid - r * upr;          // stepped by nthr units a turn
  const int dr = nthr / upr;
  const int dof = nthr - dr * upr;
  for (int i = tid; i < total; i += nthr) {
    const char* src = reinterpret_cast<const char*>(
                          src_rows + static_cast<size_t>(c0 + r) * HD) +
                      o * u;
    char* dst = reinterpret_cast<char*>(dst_rows +
                                        static_cast<size_t>(r) * pitch) +
                o * u;
    copy_unit(dst, src, u);
    r += dr;
    o += dof;
    if (o >= upr) {
      o -= upr;
      ++r;
    }
  }
}

template <typename TP, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
    ragged_attn_page_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int h0 = blockIdx.x * p.hg;
  const int hgc = min(p.hg, p.H - h0);  // heads of this block
  const int P = p.P, D = p.D, A = D + 2;
  const size_t HD = static_cast<size_t>(p.H) * D;
  const size_t PHD = static_cast<size_t>(P) * HD;

  const float* q3;
  const TP* page;
  const float* acc;
  float* out;
  if (p.mode == BYVAL) {
    q3 = static_cast<const float*>(p.tiles[0][b]);
    page = static_cast<const TP*>(p.tiles[1][b]);
    acc = static_cast<const float*>(p.tiles[2][b]);
    out = static_cast<float*>(const_cast<void*>(p.tiles[3][b]));
  } else if (p.mode == ARRAY) {
    const size_t nb = p.batch;
    q3 = static_cast<const float*>(p.dev_ptrs[b]);
    page = static_cast<const TP*>(p.dev_ptrs[nb + b]);
    acc = static_cast<const float*>(p.dev_ptrs[2 * nb + b]);
    out = static_cast<float*>(const_cast<void*>(p.dev_ptrs[3 * nb + b]));
  } else {
    q3 = p.q3 + b * 3 * HD;
    page = static_cast<const TP*>(p.page) + b * 3 * PHD;
    acc = p.acc + static_cast<size_t>(b) * p.H * A;
    out = p.out + static_cast<size_t>(b) * p.H * A;
  }

  const Layout L = layout(p.hg, p.cs, p.pitch, D, sizeof(TP));
  TP* Ks = reinterpret_cast<TP*>(smem);
  TP* Vs = reinterpret_cast<TP*>(smem + L.v);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* as = reinterpret_cast<float*>(smem + L.a);
  float* ws = reinterpret_cast<float*>(smem + L.w);
  float* al = reinterpret_cast<float*>(smem + L.al);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;

  // the query rows and the accumulator rows: the only reads of acc, done
  // before the first barrier (out may alias acc)
  stage_run(qs, q3 + static_cast<size_t>(h0) * D, hgc * D * 4, tid, nthr);
  stage_run(as, acc + static_cast<size_t>(h0) * A, hgc * A * 4, tid, nthr);

  // valid slots are p < fill (the fill is a float in the page), so
  // n = ceil(fill) clamped to [0, P]; a NaN fill reads as 0
  const float fill = to_f32(page[2 * PHD]);
  int n = 0;
  if (fill >= static_cast<float>(P))
    n = P;
  else if (fill > 0.f)
    n = static_cast<int>(ceilf(fill));

  const TP* Kg = page + static_cast<size_t>(h0) * D;
  const TP* Vg = Kg + PHD;
  const int run_bytes = static_cast<int>(hgc * D * sizeof(TP));
  // two groups: the query, accumulator and K rows, then the V rows, which
  // land while the scores are computed
  int cn = min(p.cs, n);
  stage_slots(Ks, Kg, 0, cn, HD, p.pitch, run_bytes, tid, nthr);
  cp_async_commit();
  stage_slots(Vs, Vg, 0, cn, HD, p.pitch, run_bytes, tid, nthr);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int D4 = (D + 3) / 4;
  // lanes a (slot, head): a power of two, at most 32, giving each lane
  // about four 4-wide vectors of the row (D=128: 8 lanes, 3 shuffles);
  // at least 8, or the row, so that a quarter-warp reads 128 contiguous
  // bytes of shared memory
  int G = 1;
  while (G < 32 && ((G < 8 && G < D4) || 4 * G < D4)) G <<= 1;
  const int gpw = 32 / G;
  const int grp = lane / G;
  const int lig = lane - grp * G;
  const float scale = sqrtf(static_cast<float>(D));
  const int cs = p.cs;
  const int pitch = p.pitch;

  for (int c0 = 0; c0 < n;) {
    // scores of the chunk's (slot, head) pairs; the loop bound is
    // warp-uniform, so every lane reaches the shuffles
    const int npairs = cn * hgc;
    for (int base = warp * gpw; base < npairs; base += nwarps * gpw) {
      const int i = base + grp;
      const int s = i / hgc;
      const int hl = i - s * hgc;
      float part = 0.f;
      if (i < npairs) {
        const TP* kr = Ks + static_cast<size_t>(s) * pitch + hl * D;
        const float* qr = qs + hl * D;
        for (int j = lig; j < D4; j += G) {
          const float4 k4 = load4<VEC>(kr, 4 * j, D);
          const float4 q4 = load4<VEC>(qr, 4 * j, D);
          part += k4.x * q4.x + k4.y * q4.y + k4.z * q4.z + k4.w * q4.w;
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (i < npairs && lig == 0) ws[hl * cs + s] = part / scale;
    }
    __syncthreads();

    // per head: the new max, each weight once, the sum, alpha
    for (int hl = warp; hl < hgc; hl += nwarps) {
      float* w = ws + hl * cs;
      float mx = NEG_INF;
      for (int s = lane; s < cn; s += 32) mx = fmaxf(mx, w[s]);
      mx = warp_max(mx);
      const float l_prev = as[hl * A + D + 1];
      const float m_prev = l_prev > 0.f ? as[hl * A + D] : NEG_INF;
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < cn; s += 32) {
        const float e = expf(w[s] - m_new);
        w[s] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al[hl] = alpha;
        as[hl * A + D] = m_new;
        as[hl * A + D + 1] = l_prev * alpha + sum;
      }
    }
    cp_async_wait<0>();  // the V rows
    __syncthreads();

    // o = o * alpha + sum_s w[s] V[s]: a thread per (head, 4 d's)
    for (int it = tid; it < hgc * D4; it += nthr) {
      const int hl = it / D4;
      const int d = 4 * (it - hl * D4);
      const float* w = ws + hl * cs;
      const TP* vr = Vs + hl * D;
      float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < cn; ++s) {
        const float4 v = load4<VEC>(vr + static_cast<size_t>(s) * pitch, d, D);
        const float ww = w[s];
        pv.x = fmaf(ww, v.x, pv.x);
        pv.y = fmaf(ww, v.y, pv.y);
        pv.z = fmaf(ww, v.z, pv.z);
        pv.w = fmaf(ww, v.w, pv.w);
      }
      const float alpha = al[hl];
      float* o = as + hl * A + d;
      o[0] = o[0] * alpha + pv.x;
      if (d + 1 < D) o[1] = o[1] * alpha + pv.y;
      if (d + 2 < D) o[2] = o[2] * alpha + pv.z;
      if (d + 3 < D) o[3] = o[3] * alpha + pv.w;
    }
    __syncthreads();

    c0 += cn;
    if (c0 >= n) break;
    cn = min(cs, n - c0);
    stage_slots(Ks, Kg, c0, cn, HD, pitch, run_bytes, tid, nthr);
    cp_async_commit();
    stage_slots(Vs, Vg, c0, cn, HD, pitch, run_bytes, tid, nthr);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
  }

  // an empty state (l == 0) carries m = NEG_INF, as the plain version's
  // max over masked scores gives
  for (int hl = tid; hl < hgc; hl += nthr)
    if (!(as[hl * A + D + 1] > 0.f)) as[hl * A + D] = NEG_INF;
  __syncthreads();
  float* og = out + static_cast<size_t>(h0) * A;
  for (int i = tid; i < hgc * A; i += nthr) og[i] = as[i];
}

int smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return v;
}

template <typename TP, bool VEC>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  // once per instantiation: allow dynamic shared memory up to the
  // card's opt-in limit (each launch asks only for what its plan needs)
  static const int optin = smem_optin();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ragged_attn_page_kernel<TP, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (attr != cudaSuccess) return attr;
  const Layout L = layout(prm.hg, prm.cs, prm.pitch, prm.D, sizeof(TP));
  if (L.total > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  const int D4 = (prm.D + 3) / 4;
  int threads = (prm.hg * D4 + 31) / 32 * 32;
  threads = threads < 64 ? 64 : threads > MAX_THREADS ? MAX_THREADS : threads;
  const dim3 grid((prm.H + prm.hg - 1) / prm.hg, prm.batch);
  ragged_attn_page_kernel<TP, VEC><<<grid, threads, L.total, stream>>>(prm);
  return cudaGetLastError();
}

template <typename TP>
cudaError_t launch_dtype(const Params& prm, cudaStream_t stream) {
  return prm.D % 4 == 0 ? launch<TP, true>(prm, stream)
                        : launch<TP, false>(prm, stream);
}

}  // namespace

// One launch over a batch of tasks, on `stream`.
//   host_ptrs non-null: a host array of 4*batch tile pointers (q3 tiles,
//     then pages, accs, outs), batch <= 64; copied into the launch's
//     parameters.
//   dev_ptrs non-null: a device array laid out the same, any batch.
//   both null: a strided batch at q3, page, acc and out.
// out may equal acc (the update in place).  page_dtype: 0 = float32,
// 1 = bfloat16 (q3, acc and out are float32).  hg heads a block and cs
// slots a chunk, from ops/ragged_attention.py:plan.  Returns
// cudaGetLastError() after the launch (0 = launched); the caller raises on
// anything else.
extern "C" int parsec_ragged_attn_page(const void* q3, const void* page,
                                       const void* acc, void* out,
                                       const void* host_ptrs,
                                       const void* dev_ptrs, int batch, int P,
                                       int H, int D, int page_dtype, int hg,
                                       int cs, void* stream) {
  if (batch <= 0 || batch > 65535 || P <= 0 || H <= 0 || D <= 0 ||
      hg <= 0 || hg > H || cs <= 0 || cs > P || page_dtype < 0 ||
      page_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  std::memset(&prm, 0, sizeof(prm));
  if (host_ptrs) {
    if (batch > MAX_BYVAL) return static_cast<int>(cudaErrorInvalidValue);
    const void* const* hp = static_cast<const void* const*>(host_ptrs);
    for (int c = 0; c < 4; ++c)
      std::memcpy(prm.tiles[c], hp + static_cast<size_t>(c) * batch,
                  sizeof(void*) * batch);
    prm.mode = BYVAL;
  } else if (dev_ptrs) {
    prm.dev_ptrs = static_cast<const void* const*>(dev_ptrs);
    prm.mode = ARRAY;
  } else {
    if (!q3 || !page || !acc || !out)
      return static_cast<int>(cudaErrorInvalidValue);
    prm.q3 = static_cast<const float*>(q3);
    prm.page = page;
    prm.acc = static_cast<const float*>(acc);
    prm.out = static_cast<float*>(out);
    prm.mode = STRIDED;
  }
  const size_t esize = page_dtype == 0 ? 4 : 2;
  prm.batch = batch;
  prm.P = P;
  prm.H = H;
  prm.D = D;
  prm.hg = hg;
  prm.cs = cs;
  prm.pitch = static_cast<int>(round16(static_cast<size_t>(hg) * D * esize) /
                               esize);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = page_dtype == 0
                             ? launch_dtype<float>(prm, s)
                             : launch_dtype<__nv_bfloat16>(prm, s);
  return static_cast<int>(rc);
}

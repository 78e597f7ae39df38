// 1-D weighted stencil over a group of rows read where they lie, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel parsec_tpu/ops/stencil.py:_stencil1d_pallas_rows
// (kernel _stencil_row_kernel, wrapper stencil1d_pallas), which runs over
// padded rows.  Here each of the G output rows reads a virtual padded row
//
//   v_g = [last hl cells of row l_g | row c_g | first hr cells of row r_g]
//
// and computes
//
//   out[g, i] = sum_{j=0}^{taps-1} w[j] * v_g[i + j],  0 <= i < n,
//
// with n = hl + len(c) + hr - taps + 1, accumulated in fp32 over
// j = 0..taps-1 in that order with fmaf (each weight rounded to fp32
// first) and rounded once to the rows' dtype (fp32 or bf16).  Each of the
// three flows names its own store (base, row pitch, row length) and its
// rows: an index array on the device, or consecutive rows from r0; a row
// of -1 (or a flow with no rows) reads zeros.  Two entries run on it: the
// stencil's rows entry (hl = hr = R, taps = 2R + 1: the ghosts are read in
// place from the neighbour rows, where the first design read rows that a
// concatenation had padded), and the padded entry (hl = hr = 0, no l or
// r: a padded row is the rows entry with its ghosts inline).  The output
// is a fresh [G, n] tensor: the kernel never writes the rows it reads.
//
// What bounds it: each input element is read once and each output written
// once, about 8 bytes an fp32 element (4 in, 4 out) against 2 * taps
// flops, 18 at 9 taps: about 2 flops a byte, against the H100's 20 fp32
// flops a byte at 3.35 TB/s, so the memory rate bounds it.
//
// What the design does about it:
// - 16-byte traffic.  A tile is CHUNK = 4096 consecutive outputs of one
//   row; its inputs (plus the taps - 1 halo and at most VEC - 1 cells of
//   alignment) land in shared memory through 16-byte cp.async copies
//   (float4, or 8 bf16), and each thread writes its outputs VEC at a time
//   with one 16-byte store.  The cells that are not 16-byte aligned (the
//   ghost cells at offsets len - hl of a neighbour row, the head and tail
//   of an unaligned span, rows whose base or pitch is unaligned) take a
//   scalar path.
// - Bytes in flight.  The grid is one block a tile: each SM holds several
//   blocks' 16 KB tiles in flight at once, and each block loads its tile,
//   waits for it, computes and returns.  On an H100 this beat a persistent
//   grid of as many blocks as fit, each walking its tiles through a
//   two-stage cp.async ring, at the lowered stencil's level (0.048 against
//   0.053 ms), so the ring was taken out.
// - Compute from registers.  A thread keeps a window of 2 * VEC inputs,
//   read from shared memory 16 bytes at a time (a warp reads 512
//   consecutive bytes: no bank conflict), and updates its VEC sums from
//   it; weights are broadcast from shared memory.  The halo of a tile is
//   read twice (by the two tiles that share it): taps - 1 cells in 4096.
// Weights travel by value in the launch parameters (at most MAX_TAPS), so
// concurrent launches with different weights cannot race on a
// __constant__ symbol.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int MAX_TAPS = 64;
constexpr int THREADS = 256;
constexpr int CHUNK = 4096;  // outputs a tile

struct Taps {
  float w[MAX_TAPS];
};

// One flow's rows: row g of the group is idx[g] when idx is set, else
// r0 + g, or none when r0 < 0; a row of -1 reads zeros.
struct Rows {
  const void* base;
  const long long* idx;
  long long r0;
  long long pitch;  // elements from one row to the next
  long long len;    // elements a row
};

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  // elements of a shared tile: its inputs, its alignment and the last
  // window's overrun
  static constexpr int TILE = CHUNK + MAX_TAPS + 4 * N;
};

__device__ __forceinline__ long long row_of(const Rows& r, long long g) {
  if (r.idx != nullptr) return r.idx[g];
  return r.r0 < 0 ? -1 : r.r0 + g;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// VEC inputs from 16 aligned bytes of shared memory, widened to fp32
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned*>(&h) = u[k];
    const float2 f = __bfloat1622float2(h);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

// VEC sums rounded once to T and written with one 16-byte store
__device__ __forceinline__ void store_vec(float* p, const float* a) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* a) {
  uint4 v;
  unsigned* u = reinterpret_cast<unsigned*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * k], a[2 * k + 1]);
    u[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float from_f32(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}

struct Geometry {
  long long g, c0;  // the tile's row in the group and first output
  int span;         // its outputs
};

__device__ __forceinline__ Geometry tile_at(long long t, long long chunks,
                                            long long n) {
  Geometry q;
  q.g = t / chunks;
  q.c0 = (t - q.g * chunks) * CHUNK;
  q.span = (int)min((long long)CHUNK, n - q.c0);
  return q;
}

// Scalar copies of v[a, b) into s[a - lo, b - lo): cells of `row` from
// `off` + (v - a), or zeros where the row is -1.
template <typename T>
__device__ __forceinline__ void load_cells(T* s, long long lo, long long a,
                                           long long b, const T* row,
                                           long long off) {
  for (long long v = a + threadIdx.x; v < b; v += THREADS)
    s[v - lo] = row != nullptr ? row[off + (v - a)] : zero<T>();
}

// Start the copies of tile q's inputs into shared tile s: s[k] holds
// v[c0 - sh + k] for k < sh + span + taps - 1.  The 16-byte part is in
// flight when this returns; the scalar part has landed.
template <typename T>
__device__ void load_tile(T* s, const Geometry& q, const Rows& c,
                          const Rows& l, const Rows& r, int hl, int hr,
                          int taps, int sh, bool vec_in) {
  constexpr int VEC = Vec<T>::N;
  const long long lo = q.c0 - sh;
  const long long hi = q.c0 + q.span + taps - 1;
  const long long cend = hl + c.len;
  const long long rc = row_of(c, q.g);
  const long long rl = row_of(l, q.g);
  const long long rr = row_of(r, q.g);
  // left ghosts: the last hl cells of row l
  {
    const long long a = max(lo, 0LL), b = min(hi, (long long)hl);
    if (a < b) {
      const T* lrow =
          rl < 0 ? nullptr
                 : static_cast<const T*>(l.base) + rl * l.pitch;
      load_cells(s, lo, a, b, lrow, l.len - hl + a);
    }
  }
  // the row itself: 16-byte copies, scalar head and tail
  {
    const long long a = max(lo, (long long)hl), b = min(hi, cend);
    if (a < b) {
      if (rc < 0) {
        load_cells<T>(s, lo, a, b, nullptr, 0);
      } else {
        const T* crow = static_cast<const T*>(c.base) + rc * c.pitch;
        const long long qa = a - hl, qb = b - hl;
        long long v0 = qb, v1 = qb;
        if (vec_in) {
          v0 = min((qa + VEC - 1) / VEC * VEC, qb);
          v1 = max(qb / VEC * VEC, v0);
        }
        const int nv = (int)((v1 - v0) / VEC);
        for (int k = threadIdx.x; k < nv; k += THREADS) {
          const long long qq = v0 + (long long)k * VEC;
          cp_async16(s + (qq + hl - lo), crow + qq);
        }
        load_cells(s, lo, a, v0 + hl, crow, qa);
        load_cells(s, lo, v1 + hl, b, crow, v1);
      }
    }
  }
  // right ghosts: the first hr cells of row r
  {
    const long long a = max(lo, cend), b = min(hi, cend + hr);
    if (a < b) {
      const T* rrow =
          rr < 0 ? nullptr
                 : static_cast<const T*>(r.base) + rr * r.pitch;
      load_cells(s, lo, a, b, rrow, a - cend);
    }
  }
}

// Tile q's outputs from shared tile s: thread t owns VEC consecutive
// outputs in each of CHUNK / (THREADS * VEC) groups.  Output i reads
// s[sh + i + j]; the window starts VEC-aligned at s[i0], so tap j is
// window position m = j + sh and positions m < sh or m >= sh + taps are
// skipped (no fmaf with them: the sums are the tap loop's exactly).
template <typename T>
__device__ void compute_tile(const T* s, const float* ws, const Geometry& q,
                             T* __restrict__ out, long long n, int taps,
                             int sh, bool vec_out) {
  constexpr int VEC = Vec<T>::N;
  constexpr int GROUPS = CHUNK / (THREADS * VEC);
  const int mend = sh + taps;
  T* orow = out + q.g * n + q.c0;
#pragma unroll
  for (int u = 0; u < GROUPS; ++u) {
    const int i0 = (u * THREADS + (int)threadIdx.x) * VEC;
    if (i0 >= q.span) break;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    float x[2 * VEC];
    load_vec(s + i0, x);
    for (int m0 = 0; m0 < mend; m0 += VEC) {
      load_vec(s + i0 + m0 + VEC, x + VEC);
#pragma unroll
      for (int jj = 0; jj < VEC; ++jj) {
        const int m = m0 + jj;
        if (m >= sh && m < mend) {
          const float wm = ws[m];
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wm, x[k + jj], acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) x[k] = x[k + VEC];
    }
    if (vec_out && i0 + VEC <= q.span) {
      store_vec(orow + i0, acc);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (i0 + k < q.span) orow[i0 + k] = from_f32(acc[k], (T*)nullptr);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    stencil1d_kernel(Rows c, Rows l, Rows r, T* __restrict__ out,
                     long long n, int hl, int hr, int taps,
                     int vec_in, int vec_out, Taps tw) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  __shared__ float ws[MAX_TAPS + VEC];
  // s[k] holds v[c0 - sh + k]: sh aligns row c's cells to 16 bytes
  const int sh = (VEC - hl % VEC) % VEC;
  for (int j = threadIdx.x; j < MAX_TAPS + VEC; j += THREADS)
    ws[j] = (j >= sh && j < sh + taps) ? tw.w[j - sh] : 0.f;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const Geometry q = tile_at(blockIdx.x, chunks, n);
  load_tile(tile, q, c, l, r, hl, hr, taps, sh, vec_in != 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  compute_tile(tile, ws, q, out, n, taps, sh, vec_out != 0);
}

template <typename T>
int launch(const Rows& c, const Rows& l, const Rows& r, void* out,
           long long G, long long n, int hl, int hr, int taps,
           const Taps& tw, cudaStream_t stream) {
  const long long tiles = G * ((n + CHUNK - 1) / CHUNK);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Vec<T>::TILE * sizeof(T);
  const uintptr_t vec_mask = 15;
  const int vec_in = ((uintptr_t)c.base & vec_mask) == 0 &&
                     (c.pitch * (long long)sizeof(T)) % 16 == 0;
  const int vec_out =
      ((uintptr_t)out & vec_mask) == 0 && (n * (long long)sizeof(T)) % 16 == 0;
  stencil1d_kernel<T><<<(unsigned)tiles, THREADS, smem, stream>>>(
      c, l, r, static_cast<T*>(out), n, hl, hr, taps, vec_in, vec_out, tw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Each flow (c, l, r) is a store
// base on the device, its rows (`idx`, G device int64s, or r0 + g where
// idx is null; r0 < 0 with no idx: no rows), its row pitch and its row
// length, in elements.  `out` is a fresh (G, n) row-major tensor with
// n = hl + c_len + hr - taps + 1; `weights` a host array of `taps` floats.
// Returns cudaGetLastError() after the launch (0 = launched); the caller
// raises on anything else.
extern "C" int parsec_stencil1d(
    const void* c_base, const long long* c_idx, long long c_r0,
    long long c_pitch, long long c_len, const void* l_base,
    const long long* l_idx, long long l_r0, long long l_pitch,
    long long l_len, const void* r_base, const long long* r_idx,
    long long r_r0, long long r_pitch, long long r_len, void* out,
    long long G, int hl, int hr, int taps, const float* weights, int dtype,
    void* stream) {
  const long long n = hl + c_len + hr - taps + 1;
  const bool has_l = l_idx != nullptr || l_r0 >= 0;
  const bool has_r = r_idx != nullptr || r_r0 >= 0;
  if (G <= 0 || taps <= 0 || taps > MAX_TAPS || n <= 0 || hl < 0 ||
      hr < 0 || dtype < 0 || dtype > 1 || weights == nullptr ||
      c_base == nullptr || out == nullptr || (has_l && l_len < hl) ||
      (has_r && r_len < hr) || (has_l && l_base == nullptr) ||
      (has_r && r_base == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Taps tw;
  for (int j = 0; j < MAX_TAPS; ++j) tw.w[j] = j < taps ? weights[j] : 0.f;
  const Rows c{c_base, c_idx, c_r0, c_pitch, c_len};
  const Rows l{l_base, l_idx, has_l ? l_r0 : -1, l_pitch, l_len};
  const Rows r{r_base, r_idx, has_r ? r_r0 : -1, r_pitch, r_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(c, l, r, out, G, n, hl, hr, taps, tw, s);
  return launch<__nv_bfloat16>(c, l, r, out, G, n, hl, hr, taps, tw, s);
}

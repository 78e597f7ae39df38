// K1: batched tile GEMM with a C + A@B epilogue, for Hopper (sm_90a).
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
//   out[b] = (ADD_C ? C[b] : 0) + s * A[b] @ op(B[b]),  s = -1 if SUB else 1
//   A[b] (M, K), op(B[b]) (K, N): B[b] itself (K, N), or with TRANS_B
//   B[b] given as (N, K) and op(B) its transpose; C[b] and out[b] (M, N);
//   each row-major and contiguous; inputs fp32 or bf16, C/out fp32 or
//   bf16; sums in fp32.  The subtracting form negates the finished sum in
//   the epilogue, so C - A@B rounds once, as the JAX bodies' ``c - a@b``
//   does.  The transposed and subtracting forms are what the Cholesky and
//   LU trailing updates call (parsec_tpu/models/cholesky.py:
//   gemm_nt/syrk_ln, models/lu.py: lu_gemm); simt_fp32 and mma_tf32 take
//   them, wgmma_bf16 refuses them.
//   The batch is either strided (one (batch, M, K) tensor per operand) or
//   given as a device array of 4*batch tile pointers (A tiles, then B, C,
//   out): the device module's fused dispatch passes its tiles that way,
//   so each output tile has storage of its own and no operand is stacked.
//
// What bounds it: at the lowered GEMM's shape (16384^3, bf16 in, fp32 C)
// one launch is 8.8 TFLOP against 2.1 GB moved, so it is bound by the
// tensor cores' 989 TFLOP/s in bf16 (8.9 ms) on an H100 SXM; at the
// dynamic path's batch-64 1024^3 fp32 tiles, 137 GFLOP against 1.07 GB,
// TF32's 495 TFLOP/s (0.28 ms) sits under the bytes (0.32 ms at 3.35
// TB/s); strict fp32 off the tensor cores has 67 TFLOP/s (2.05 ms).
//
// Three variants share the entry point; the caller (ops/gemm.py:
// k1_variant) picks one before the launch by a stated rule:
//
// - wgmma_bf16: bf16 A/B.  A block owns a 128x256 output tile.  One
//   producer warp streams 128x64 tiles of A and 64x256 tiles of B into a
//   4-stage shared-memory ring with TMA (cp.async.bulk.tensor, 128-byte
//   swizzle; out-of-bounds boxes are zero-filled, so the K tail and the
//   M/N edges need no masked loads), and signals each stage through an
//   mbarrier.  Two consumer warpgroups (64 rows each) run
//   wgmma.mma_async m64n256k16 on the stages that have arrived, keeping
//   one group of products in flight while they release the stage before
//   it.  A is K-major; B is row-major (K, N), which is MN-major for
//   wgmma, so B's descriptor takes trans-b = 1 and its tile arrives as
//   four 64-column boxes (the 128-byte swizzle's width).  The strided
//   form reads 3-D tensor maps over (batch, rows, cols) passed by value;
//   the tile-pointer form reads one pair of maps per tile, encoded on the
//   host (parsec_gemm_encode_tiles) and copied up with the pointer array
//   in the wrapper's one H2D: every tile may live anywhere, and a TMA map
//   is the one way to give the hardware a base address.  The encoder is
//   fetched through cudaGetDriverEntryPointByVersion, so nothing links
//   -lcuda.  bf16 products are exact in fp32, so this variant is also
//   what strict precision runs for bf16 inputs.
// - mma_tf32: fp32 A/B at default precision.  wgmma takes TF32 operands
//   only K-major and B is MN-major here, so this variant stays on
//   mma.sync.m16n8k8 TF32, fed by a 3-stage cp.async ring of 128x32 A
//   and 32x128 B tiles (padded rows: the fragment reads are free of bank
//   conflicts), each input rounded with cvt.rna.tf32.f32 as its fragment
//   is read.  128 threads in 4 warps of 64x64; two blocks fit an SM.  A
//   transposed B is K-major, as A is: its 128x32 tile is staged like A's
//   (rows padded to 36 floats) and read straight into the .col B
//   fragment, so nothing is transposed in shared memory.
// - simt_fp32: strict fp32 FMAs off the tensor cores, 64x64 tiles and a
//   single shared-memory stage: fp32 at strict precision, and every shape
//   the other two refuse (pitches TMA or 16-byte cp.async cannot take).
//
// The two tensor-core variants raster their output tiles in groups of 8
// tile rows, so the blocks resident together share A's rows and B's
// columns in L2, and end in one epilogue: the accumulators go through
// shared memory, and C is read, added and stored in 16-byte (8-byte for
// bf16 out of mma_tf32) vectors with 64-bit offsets, masked at the M/N
// edge.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// simt_fp32
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <typename TI, typename TO, bool ADD_C, bool TRANS_B>
__global__ void __launch_bounds__(THREADS)
    gemm_update_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
                       const TO* __restrict__ C, TO* __restrict__ Out,
                       const void* const* __restrict__ ptrs, int M, int N,
                       int K, bool sub) {
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
    // B slice BK x BN: consecutive threads walk n along one row of B, or
    // k along one row of a transposed B
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = TRANS_B ? idx % BK : idx / BN;
      const int c = TRANS_B ? idx / BK : idx % BN;
      const int gk = k0 + kk, gc = col0 + c;
      const size_t o = TRANS_B ? (size_t)gc * K + gk : (size_t)gk * N + gc;
      Bs[kk][c] = (gk < K && gc < N) ? to_f32(B[o]) : 0.f;
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
      float v = sub ? -acc[i][j] : acc[i][j];
      if (ADD_C) v += to_f32(C[o]);
      Out[o] = from_f32<TO>(v);
    }
  }
}

template <typename TI, typename TO>
void launch(const void* a, const void* b, const void* c, void* out,
            const void* const* ptrs, int batch, int m, int n, int k,
            int add_c, int trans_b, int sub, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  const TI* A = static_cast<const TI*>(a);
  const TI* B = static_cast<const TI*>(b);
  const TO* C = static_cast<const TO*>(c);
  TO* O = static_cast<TO*>(out);
  auto kernel = add_c ? (trans_b ? gemm_update_kernel<TI, TO, true, true>
                                 : gemm_update_kernel<TI, TO, true, false>)
                      : (trans_b ? gemm_update_kernel<TI, TO, false, true>
                                 : gemm_update_kernel<TI, TO, false, false>);
  kernel<<<grid, THREADS, 0, stream>>>(A, B, C, O, ptrs, m, n, k, sub != 0);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// shared by the tensor-core variants: the raster and the epilogue
// ---------------------------------------------------------------------------

constexpr int GROUP_M = 8;  // tile rows a raster group spans

// blockIdx.x -> (tile row, tile column), walking GROUP_M tile rows down
// one column before the next column
__device__ __forceinline__ void tile_coords(int tiles_m, int tiles_n,
                                            int& tm, int& tn) {
  const int pid = blockIdx.x;
  const int per_group = GROUP_M * tiles_n;
  const int first = (pid / per_group) * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in_group = pid % per_group;
  tm = first + in_group % rows;
  tn = in_group / rows;
}

// VEC elements of TO moved as one 8- or 16-byte word group
template <typename TO, int VEC>
struct Chunk {
  static constexpr int PER_WORD = 4 / sizeof(TO);
  static constexpr int WORDS = VEC / PER_WORD;
  static_assert(WORDS == 2 || WORDS == 4, "8- or 16-byte chunks");
  uint32_t w[WORDS] = {};

  __device__ __forceinline__ void load(const TO* p) {
    if constexpr (WORDS == 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x, w[1] = q.y;
    }
  }
  __device__ __forceinline__ void store(TO* p) const {
    if constexpr (WORDS == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
  __device__ __forceinline__ float get(int i) const {
    if constexpr (PER_WORD == 1) return __uint_as_float(w[i]);
    const uint32_t x = w[i / 2];
    return __uint_as_float(i % 2 ? (x & 0xffff0000u) : (x << 16));
  }
  __device__ __forceinline__ void set(int i, float v) {
    if constexpr (PER_WORD == 1) {
      w[i] = __float_as_uint(v);
    } else {
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(v));
      w[i / 2] = i % 2 ? (w[i / 2] & 0xffffu) | (h << 16)
                       : (w[i / 2] & 0xffff0000u) | h;
    }
  }
};

// out[m0 + r, n0 + c] = C[...] +/- stage[r * LD + c] over a BM x BN tile
// staged in shared memory as fp32, in chunks of VEC elements; N is a
// multiple of VEC, so a chunk is wholly inside the matrix or wholly out
template <typename TO, bool ADD_C, int BM, int BN, int LD, int VEC,
          int NTHREADS>
__device__ __forceinline__ void store_tile(const float* stage,
                                           const TO* __restrict__ C,
                                           TO* __restrict__ Out, int m0,
                                           int n0, int M, int N, int tid,
                                           bool sub) {
  constexpr int CHUNKS = BN / VEC;
#pragma unroll 4
  for (int idx = tid; idx < BM * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * VEC;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const size_t o = (size_t)gr * N + gc;
    Chunk<TO, VEC> in, res;
    if constexpr (ADD_C) in.load(C + o);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = stage[r * LD + c + j];
      if (sub) v = -v;
      if constexpr (ADD_C) v += in.get(j);
      res.set(j, v);
    }
    res.store(Out + o);
  }
}

// ---------------------------------------------------------------------------
// mma_tf32
// ---------------------------------------------------------------------------

namespace tf32 {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int WM = 64;        // a warp's tile: 4 x 8 mma tiles of 16x8
constexpr int WN = 64;
constexpr int THREADS = 32 * (BM / WM) * (BN / WN);  // 4 warps, 2 x 2
constexpr int LDA = BK + 4;   // floats a row of the A tile: row r starts
                              // at bank 4r, so a fragment's 32 reads hit
                              // 32 banks
constexpr int LDB = BN + 8;   // likewise for B: bank 8k + n
constexpr int LDO = BN + 8;   // the epilogue's staging rows
constexpr int A_FLOATS = BM * LDA;
// a transposed B tile is BN rows of BK, padded like A's
template <bool TRANS_B>
constexpr int STAGE_FLOATS = A_FLOATS + (TRANS_B ? BN * LDA : BK * LDB);
// 107,520 B (110,592 B with a transposed B): two blocks an SM
template <bool TRANS_B>
constexpr int SMEM = STAGES * STAGE_FLOATS<TRANS_B> * 4;
static_assert(BM * LDO <= STAGES * STAGE_FLOATS<false>,
              "staging fits the ring");
static_assert(2 * (SMEM<true> + 1024) <= 233472, "two blocks fit an SM");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes: the M/N edge and the K tail
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TO, bool ADD_C, bool TRANS_B>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_update_kernel(const float* __restrict__ A,
                       const float* __restrict__ B, const TO* C, TO* Out,
                       const void* const* __restrict__ ptrs, int M, int N,
                       int K, int tiles_m, int tiles_n, bool sub) {
  constexpr int STAGE = STAGE_FLOATS<TRANS_B>;
  extern __shared__ __align__(16) float smem[];
  const size_t bz = blockIdx.z;
  if (ptrs) {
    const size_t nb = gridDim.z;
    A = static_cast<const float*>(ptrs[bz]);
    B = static_cast<const float*>(ptrs[nb + bz]);
    C = static_cast<const TO*>(ptrs[2 * nb + bz]);
    Out = static_cast<TO*>(const_cast<void*>(ptrs[3 * nb + bz]));
  } else {
    A += bz * M * K;
    B += bz * K * N;
    Out += bz * M * N;
    if (ADD_C) C += bz * M * N;
  }
  int tm, tn;
  tile_coords(tiles_m, tiles_n, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles a warp
  const int g = lane / 4, t = lane % 4;
  const int KT = (K + BK - 1) / BK;

  // each thread moves A_CHUNKS 16-byte chunks of A and B_CHUNKS of B a
  // stage: chunk i of A is row a_r + i * A_STEP, columns a_c..a_c+3; a
  // transposed B's tile (BN rows of BK) is cut as A's is
  constexpr int A_CHUNKS = BM * BK / 4 / THREADS, A_STEP = THREADS * 4 / BK;
  constexpr int B_CHUNKS = BK * BN / 4 / THREADS;
  constexpr int B_STEP = TRANS_B ? A_STEP : THREADS * 4 / BN;
  const int a_r = tid / (BK / 4), a_c = (tid % (BK / 4)) * 4;
  const int b_r = TRANS_B ? a_r : tid / (BN / 4);
  const int b_c = TRANS_B ? a_c : (tid % (BN / 4)) * 4;
  auto load_stage = [&](int stage, int kt) {
    float* As = smem + stage * STAGE;
    float* Bs = As + A_FLOATS;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int r = a_r + i * A_STEP;
      const bool ok = m0 + r < M && k0 + a_c < K;
      cp_async16(smem_u32(As + r * LDA + a_c),
                 ok ? A + (size_t)(m0 + r) * K + k0 + a_c : A, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int r = b_r + i * B_STEP;
      if constexpr (TRANS_B) {   // row n0 + r of B, columns k0 + b_c..
        const bool ok = n0 + r < N && k0 + b_c < K;
        cp_async16(smem_u32(Bs + r * LDA + b_c),
                   ok ? B + (size_t)(n0 + r) * K + k0 + b_c : B, ok);
      } else {
        const bool ok = k0 + r < K && n0 + b_c < N;
        cp_async16(smem_u32(Bs + r * LDB + b_c),
                   ok ? B + (size_t)(k0 + r) * N + n0 + b_c : B, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    // this thread's chunks of k-tile kt have landed: round them; after
    // the barrier all of k-tile kt is rounded, and every thread is done
    // with k-tile kt-1, whose stage the prefetch below refills
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load_stage(next % STAGES, next);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const float* As = smem + (kt % STAGES) * STAGE;
    const float* Bs = As + A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = As + (wm + i * 16 + g) * LDA + kk + t;
        af[i][0] = to_tf32(p[0]);
        af[i][1] = to_tf32(p[8 * LDA]);
        af[i][2] = to_tf32(p[4]);
        af[i][3] = to_tf32(p[8 * LDA + 4]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if constexpr (TRANS_B) {   // B[k][n] sits at Bs[n * LDA + k]
          const float* p = Bs + (wn + j * 8 + g) * LDA + kk + t;
          bf[j][0] = to_tf32(p[0]);
          bf[j][1] = to_tf32(p[4]);
        } else {
          const float* p = Bs + (kk + t) * LDB + wn + j * 8 + g;
          bf[j][0] = to_tf32(p[0]);
          bf[j][1] = to_tf32(p[4 * LDB]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(acc[i][j], af[i], bf[j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  float* stage = smem;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = wm + i * 16 + g, c = wn + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(stage + r * LDO + c) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(stage + (r + 8) * LDO + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  store_tile<TO, ADD_C, BM, BN, LDO, 4, THREADS>(stage, C, Out, m0, n0, M, N,
                                                 tid, sub);
}

template <typename TO, bool TRANS_B>
int launch(const void* a, const void* b, const void* c, void* out,
           const void* const* ptrs, int batch, int m, int n, int k,
           int add_c, int sub, cudaStream_t stream) {
  const long long tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  if (tiles_m * tiles_n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = add_c ? gemm_update_kernel<TO, true, TRANS_B>
                      : gemm_update_kernel<TO, false, TRANS_B>;
  constexpr int smem = SMEM<TRANS_B>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>(tiles_m * tiles_n), 1, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const TO*>(c), static_cast<TO*>(out), ptrs, m, n, k,
      static_cast<int>(tiles_m), static_cast<int>(tiles_n), sub != 0);
  return 0;
}

template <typename TO>
int launch(const void* a, const void* b, const void* c, void* out,
           const void* const* ptrs, int batch, int m, int n, int k,
           int add_c, int trans_b, int sub, cudaStream_t stream) {
  return trans_b ? launch<TO, true>(a, b, c, out, ptrs, batch, m, n, k,
                                    add_c, sub, stream)
                 : launch<TO, false>(a, b, c, out, ptrs, batch, m, n, k,
                                     add_c, sub, stream);
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// wgmma_bf16
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;                           // 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                     // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer's
constexpr int A_BYTES = BM * BK * 2;             // 16 KB
constexpr int B_BOX = 64;                        // columns a box of B holds
constexpr int B_BOX_BYTES = BK * B_BOX * 2;      // 8 KB
constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;  // 48 KB
constexpr int RING_BYTES = STAGES * STAGE_BYTES;    // 192 KB
constexpr int LDO = BN + 8;  // staging row: row g, column 2t at bank 8g+2t
// the ring, a full and an empty barrier a stage, and room to put the
// ring on a 1024-byte boundary (the 128-byte swizzle's period)
constexpr int SMEM = RING_BYTES + 2 * STAGES * 8 + 1024;
static_assert(BM * LDO * 4 <= RING_BYTES, "staging fits the ring");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const void* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// d[64x256] += A[64x16] (K-major) @ B[16x256] (MN-major: trans-b = 1).
// Thread l of warp w in the warpgroup holds d[4j + 2i + e] at row
// 16w + l/4 + 8i, column 8j + 2(l%4) + e.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
#define D8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(da), "l"(db), "r"(1));
#undef D8
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}

template <typename TO, bool ADD_C>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_update_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const CUtensorMap* __restrict__ tile_maps,
                       const void* const* __restrict__ ptrs, const TO* C,
                       TO* Out, int M, int N, int K, int tiles_m,
                       int tiles_n) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full0 = ring + RING_BYTES;  // full[s] at full0 + 8s
  const uint32_t empty0 = full0 + STAGES * 8;

  const size_t bz = blockIdx.z;
  const void* ma = &map_a;
  const void* mb = &map_b;
  int bc = static_cast<int>(bz);  // batch coordinate in the maps
  if (tile_maps) {
    const size_t nb = gridDim.z;
    ma = tile_maps + 2 * bz;
    mb = tile_maps + 2 * bz + 1;
    bc = 0;
    C = static_cast<const TO*>(ptrs[2 * nb + bz]);
    Out = static_cast<TO*>(const_cast<void*>(ptrs[3 * nb + bz]));
  } else {
    Out += bz * M * N;
    if (ADD_C) C += bz * M * N;
  }
  int tm, tn;
  tile_coords(tiles_m, tiles_n, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int KT = (K + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrival
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);    // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        // wait until the consumers released this stage's previous round
        // (the first round passes: the preceding phase counts as done)
        mbar_wait(empty0 + 8 * s, ((kt / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t a_dst = ring + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load(a_dst, ma, full, kt * BK, m0, bc);
#pragma unroll
        for (int j = 0; j < BN / B_BOX; ++j)
          tma_load(a_dst + A_BYTES + j * B_BOX_BYTES, mb, full,
                   n0 + j * B_BOX, kt * BK, bc);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = tid / 128;  // this warpgroup's rows: [64w, 64w + 64)
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    fence_acc(d);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full0 + 8 * s, (kt / STAGES) & 1);
      const uint32_t a = ring + s * STAGE_BYTES + w * 64 * BK * 2;
      const uint32_t b = ring + s * STAGE_BYTES + A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // A: K-major, 8-row groups 1024 B apart, k advances 32 B in the
        // swizzled row; B: MN-major, 64-column boxes B_BOX_BYTES apart
        // (leading), 8-row groups of k 1024 B apart (stride), k
        // advances 16 rows of 128 B
        wgmma_m64n256k16(d, smem_desc(a + kk * 32, 16, 1024),
                         smem_desc(b + kk * 16 * 128, B_BOX_BYTES, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the products of k-tile kt-1 are done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && tid % 32 == 0)
        mbar_arrive(empty0 + 8 * ((kt - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);

    // both warpgroups are done with the ring: stage the tile through it
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
    float* stage = reinterpret_cast<float*>(smem_raw + (ring - raw));
    const int lane = tid % 32;
    const int r0 = w * 64 + (tid % 128) / 32 * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(stage + (r0 + 8 * i) * LDO + 8 * j + c0) =
            make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
    store_tile<TO, ADD_C, BM, BN, LDO, 16 / sizeof(TO), CONSUMERS * 128>(
        stage, C, Out, m0, n0, M, N, tid, false);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (batch, rows, cols) bf16 tensor map read in boxes of box_rows x
// box_cols, 128-byte swizzle, zeros outside the tensor.  An empty operand
// (K = 0) gets a blank map: the kernel issues no load then.
int encode(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
           uint64_t batch, uint32_t box_rows, uint32_t box_cols) {
  if (rows == 0 || cols == 0) {
    memset(map, 0, sizeof(*map));
    return 0;
  }
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cols, rows, batch};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int encode_pair(CUtensorMap* maps, const void* a, const void* b, int batch,
                int m, int n, int k) {
  const int rc = encode(&maps[0], a, m, k, batch, BM, BK);
  return rc ? rc : encode(&maps[1], b, k, n, batch, BK, B_BOX);
}

template <typename TO>
int launch(const void* a, const void* b, const void* c, void* out,
           const void* const* ptrs, const void* tile_maps, int batch, int m,
           int n, int k, int add_c, cudaStream_t stream) {
  const long long tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  if (tiles_m * tiles_n > 0x7fffffffLL || (ptrs && !tile_maps))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  if (ptrs) {
    memset(maps, 0, sizeof(maps));
  } else {
    const int rc = encode_pair(maps, a, b, batch, m, n, k);
    if (rc) return rc;
  }
  auto kernel = add_c ? gemm_update_kernel<TO, true>
                      : gemm_update_kernel<TO, false>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>(tiles_m * tiles_n), 1, batch);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      maps[0], maps[1], static_cast<const CUtensorMap*>(tile_maps), ptrs,
      static_cast<const TO*>(c), static_cast<TO*>(out), m, n, k,
      static_cast<int>(tiles_m), static_cast<int>(tiles_n));
  return 0;
}

}  // namespace wg

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Variant codes: 0 = simt_fp32, 1 = mma_tf32, 2 = wgmma_bf16.
// dtype codes: 0 = float32, 1 = bfloat16.  ptrs is null for a strided
// batch, else a device array of 4*batch tile pointers (a, b, c and out
// are then ignored; the C pointers too when add_c is 0); wgmma_bf16 then
// also needs tile_maps, the device copy of 2*batch tensor maps from
// parsec_gemm_encode_tiles.  trans_b: B is given as (n, k); subtract:
// out = C - A@op(B) (-A@op(B) with no C); wgmma_bf16 takes neither.  A
// variant that cannot take the call is refused, never replaced.  Returns
// 0 when the kernel was launched, else a cudaError_t; the caller raises
// on it.
extern "C" int parsec_gemm_update(const void* a, const void* b, const void* c,
                                  void* out, const void* const* ptrs,
                                  const void* tile_maps, int batch, int m,
                                  int n, int k, int in_dtype, int out_dtype,
                                  int add_c, int trans_b, int subtract,
                                  int variant, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || batch > 65535 || m <= 0 || n <= 0 || k < 0 ||
      in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return bad;
  const int tb = trans_b != 0, sub = subtract != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tensor-core variants move 16-byte chunks: their strided operands
  // must sit on 16-byte boundaries (the caller checks the tiles of a list)
  const bool vec_ok = ptrs || (aligned16(a) && aligned16(b) &&
                               aligned16(out) && (!add_c || aligned16(c)));
  int rc;
  if (variant == 0) {
    if (in_dtype == 0 && out_dtype == 0)
      simt::launch<float, float>(a, b, c, out, ptrs, batch, m, n, k, add_c,
                                 tb, sub, s);
    else if (in_dtype == 1 && out_dtype == 0)
      simt::launch<__nv_bfloat16, float>(a, b, c, out, ptrs, batch, m, n, k,
                                         add_c, tb, sub, s);
    else if (in_dtype == 0 && out_dtype == 1)
      simt::launch<float, __nv_bfloat16>(a, b, c, out, ptrs, batch, m, n, k,
                                         add_c, tb, sub, s);
    else
      simt::launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, out, ptrs, batch, m,
                                                 n, k, add_c, tb, sub, s);
    rc = 0;
  } else if (variant == 1) {
    if (in_dtype != 0 || k % 4 || n % 4 || !vec_ok) return bad;
    rc = out_dtype == 0
             ? tf32::launch<float>(a, b, c, out, ptrs, batch, m, n, k, add_c,
                                   tb, sub, s)
             : tf32::launch<__nv_bfloat16>(a, b, c, out, ptrs, batch, m, n,
                                           k, add_c, tb, sub, s);
  } else if (variant == 2) {
    if (in_dtype != 1 || k % 8 || n % 8 || !vec_ok || tb || sub) return bad;
    rc = out_dtype == 0
             ? wg::launch<float>(a, b, c, out, ptrs, tile_maps, batch, m, n,
                                 k, add_c, s)
             : wg::launch<__nv_bfloat16>(a, b, c, out, ptrs, tile_maps,
                                         batch, m, n, k, add_c, s);
  } else {
    return bad;
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Encode the tensor maps of a wgmma_bf16 tile list on the host: for tile
// b, maps[2b] reads A tile ptrs[b] (m x k) and maps[2b + 1] B tile
// ptrs[batch + b] (k x n), as parsec_gemm_update's tile_maps expects
// them.  maps is 64-byte aligned host memory for 2*batch maps (128 B
// each).  Returns 0, or a cudaError_t when a tile cannot be mapped (a
// base off a 16-byte boundary, or no driver entry point).
extern "C" int parsec_gemm_encode_tiles(const int64_t* ptrs, void* maps,
                                        int batch, int m, int n, int k) {
  if (batch <= 0 || m <= 0 || n <= 0 || k < 0 || k % 8 || n % 8 ||
      reinterpret_cast<uintptr_t>(maps) % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap* out = static_cast<CUtensorMap*>(maps);
  for (int i = 0; i < batch; ++i) {
    const int rc = wg::encode_pair(
        out + 2 * i, reinterpret_cast<const void*>(ptrs[i]),
        reinterpret_cast<const void*>(ptrs[batch + i]), 1, m, n, k);
    if (rc) return rc;
  }
  return 0;
}

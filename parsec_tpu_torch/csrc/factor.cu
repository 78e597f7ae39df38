// The dense factorizations' diagonal-tile work, for Hopper (sm_90a): the
// lower Cholesky factor of a batch of n x n fp32 tiles, and the inverse of
// a batch of lower, non-unit triangular n x n fp32 tiles.
//
// Replaces no TPU kernel: the JAX package leaves both to XLA's library
// calls (parsec_tpu/models/cholesky.py, the POTRF body and the TRSM's
// inverse).  The port called torch.linalg.cholesky_ex and
// torch.linalg.solve_triangular against an identity; on an H100 each call
// on one 512 x 512 tile took 150-190 us for about 45 MFLOP, with the rest
// of the card idle, on the lowered Cholesky's critical path.
//
// What bounds them: a 512 x 512 tile is 1 MiB and n^3/3 flops (about 45
// MFLOP each), 0.7 us at the card's fp32 rate, 0.6 us at its memory rate.
// Neither is near: the work is a chain of n dependent pivots, each a
// square root and a broadcast, and one tile is too little work to fill
// more than a cluster of SMs.  So each tile goes to one thread-block
// cluster of n/32 CTAs (at most 16: n <= 512) that keeps the tile in their
// shared memory, and the design shortens the chain:
//
// POTRF (potrf_kernel), right-looking over 32-wide panels.  CTA p holds
// block row p (rows 32p..32p+31, columns 0..32p+31) in shared memory and
// walks the steps j < p: once L_jj is there, it solves its panel block
// L_pj = A_pj L_jj^-T (one row a lane) and writes it to the output; once
// the panel blocks of the rows above are there, it updates its row, A_pq
// -= L_pj L_qj^T (j < q <= p); then it factors its diagonal block (one
// row a lane in registers, the pivot's reciprocal square root on the
// chain).  Blocks travel through the output, written once where they
// belong and read from L2 by the CTAs that need them, except that CTA p
// also writes its factor straight into CTA p+1's shared memory: the next
// pivot chain starts without a trip through L2.  Each CTA keeps flags in
// its shared memory of what is ready (raised by the writers, a release at
// cluster scope), so a CTA waits only for the blocks it reads, and the
// diagonal CTAs run ahead of the long rows below, whose trailing updates
// overlap the next pivots' chain.  On its last step a CTA splits: half
// its threads hand its panel block on, the other half update its
// diagonal block, which warp 0 then factors.
//
// Inverse (trinv_kernel), by column strips.  CTA k inverts diagonal block
// k (one column a lane), a cluster barrier, then computes two 16-column
// strips of the inverse side by side, k and 2(n/32)-1-k (so that long and
// short strips pair up), by right-looking blocked forward substitution:
// X_I = inv(L_II) R_I, then R_J -= L_JI X_I for every block row J below,
// from a right side R that starts as the identity's columns.  The next
// column block of L (asynchronous copies) and the next diagonal inverse
// (another CTA's shared memory) load while a step updates, and a strip
// takes part only from its first block row on.
//
// Every product is fp32 FFMA (no TF32): the library's arithmetic, in
// another order.  A POTRF whose pivot is not positive and finite writes a
// whole tile of NaNs, as the port's library route masks a failed factor.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 512;   // 16 CTAs of 32 rows: the largest cluster
constexpr int kBP = 36;      // pitch of 32-wide blocks (16 B rows)
constexpr int kBlk = 32 * kBP;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows 0..31, columns 0..w-1 (w a multiple of 32, at most kMaxN) of a
// global matrix (16-byte rows, pitch ld) into shared memory (pitch lds),
// rows spread over the warps: every load of a thread in flight before its
// stores.
__device__ void load_rows(float* dst, int lds, const float* src,
                          long long ld, int w) {
  constexpr int R = 32 / kWarps, C = kMaxN / 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 v[C][R];
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (4 * lane + 128 * j < w)
        v[j][i] = __ldg(reinterpret_cast<const float4*>(
            &src[(warp + kWarps * i) * ld + 4 * lane + 128 * j]));
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (4 * lane + 128 * j < w)
        st4(&dst[(warp + kWarps * i) * lds + 4 * lane + 128 * j],
            v[j][i]);
}

// A 16-byte copy from global to shared memory that the thread does not
// wait for (cp.async; completed by cp_async_wait)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Factor the 32 x 32 diagonal block at a (shared memory, pitch lda) in
// place, its upper triangle zeroed, and write the reciprocals of its
// diagonal into rinv.  Warp 0 only, one row a lane; col is a scratch of
// 64 floats (16-byte aligned) through which each scaled column reaches
// the other lanes, 16 bytes a read.  Returns whether a pivot was not
// positive and finite.
__device__ bool chol32(float* a, int lda, float* rinv, float* col) {
  const int lane = threadIdx.x & 31;
  float r[32];
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    const float4 v = ld4(&a[lane * lda + k]);
    r[k] = v.x, r[k + 1] = v.y, r[k + 2] = v.z, r[k + 3] = v.w;
  }
  bool bad = false;
  float mine = 0.f;
  float d = __shfl_sync(kFull, r[0], 0);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    bad |= !(d > 0.f && d < __int_as_float(0x7f800000));
    // the pivot's reciprocal square root, one Newton step from rsqrt's
    // (within an ulp or two of the IEEE quotient, and short on the chain)
    float q = rsqrtf(d);
    q *= fmaf(-0.5f * d * q, q, 1.5f);
    if (lane == k) mine = q;
    r[k] = lane > k ? r[k] * q : (lane == k ? d * q : 0.f);
    // the next pivot first, from lane k+1's own l_(k+1,k): the chain waits
    // for one shuffle a column
    if (k < 31) d = __shfl_sync(kFull, fmaf(-r[k], r[k], r[k + 1]), k + 1);
    float* c = col + 32 * (k & 1);
    c[lane] = r[k];
    __syncwarp();
#pragma unroll
    for (int j4 = (k + 1) & ~3; j4 < 32; j4 += 4) {
      const float4 l = ld4(&c[j4]);
      const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j4 + u > k) r[j4 + u] = fmaf(-r[k], lv[u], r[j4 + u]);
    }
  }
#pragma unroll
  for (int k = 0; k < 32; k += 4)
    st4(&a[lane * lda + k],
        make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]));
  rinv[lane] = mine;
  return bad;
}

// X = A L^-T in place for the 32 x 32 block A at a (pitch lda), L lower
// (pitch kBP) with its diagonal's reciprocals in rinv.  Warp 0 only: lane
// r solves row r by forward substitution.
__device__ void trsm32(float* a, int lda, const float* L, const float* rinv) {
  const int lane = threadIdx.x & 31;
  float x[32];
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    const float4 v = ld4(&a[lane * lda + k]);
    x[k] = v.x, x[k + 1] = v.y, x[k + 2] = v.z, x[k + 3] = v.w;
  }
  // four columns at a time: their own triangle, then the columns right of
  // them, L read 16 bytes a row
#pragma unroll
  for (int m = 0; m < 32; m += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[m + i] *= rinv[m + i];
#pragma unroll
      for (int c = m + i + 1; c < m + 4; ++c)
        x[c] = fmaf(-x[m + i], L[c * kBP + m + i], x[c]);
    }
#pragma unroll
    for (int c = m + 4; c < 32; ++c) {
      const float4 l = ld4(&L[c * kBP + m]);
      x[c] = fmaf(-x[m], l.x, x[c]);
      x[c] = fmaf(-x[m + 1], l.y, x[c]);
      x[c] = fmaf(-x[m + 2], l.z, x[c]);
      x[c] = fmaf(-x[m + 3], l.w, x[c]);
    }
  }
#pragma unroll
  for (int k = 0; k < 32; k += 4)
    st4(&a[lane * lda + k], make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]));
}

// X = inv(L) for the lower 32 x 32 block L (pitch ldl), its diagonal's
// reciprocals rv (the same in every lane), into X (pitch kBP, zeros above
// the diagonal).  Warp-wide: lane c computes column c.
__device__ void lower_inv32(const float* L, int ldl, const float (&rv)[32],
                            float* X) {
  const int lane = threadIdx.x & 31;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = (i == lane) ? 1.f : 0.f;
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    acc[m] *= rv[m];
#pragma unroll
    for (int i = m + 1; i < 32; ++i)
      acc[i] = fmaf(-L[i * ldl + m], acc[m], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) X[i * kBP + lane] = acc[i];
}

// C -= A B^T for C the 32 x 32m blocks of s from column c0, A the 32 x 32
// block of s at column a0, B the 32m x 32 rows of p (pitch kBP): tiles of
// TR x TC outputs, rows strided by 32/TR and columns by 32m/TC, so that a
// warp reads consecutive rows of B (16 bytes a lane: no bank conflict)
// and few rows of A (broadcast).
template <int TR, int TC>
__device__ void sub_abt(float* s, int lds, int a0, int c0, const float* p,
                        int m) {
  constexpr int RS = 32 / TR;
  const int CS = 32 * m / TC;
  for (int t = threadIdx.x; t < RS * CS; t += kThreads) {
    const int ct = t % CS, rt = t / CS;
    float acc[TR][TC] = {};
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      float4 a[TR], b[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        a[i] = ld4(&s[(rt + RS * i) * lds + a0 + k]);
#pragma unroll
      for (int jj = 0; jj < TC; ++jj)
        b[jj] = ld4(&p[(ct + CS * jj) * kBP + k]);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int jj = 0; jj < TC; ++jj) {
          acc[i][jj] = fmaf(a[i].x, b[jj].x, acc[i][jj]);
          acc[i][jj] = fmaf(a[i].y, b[jj].y, acc[i][jj]);
          acc[i][jj] = fmaf(a[i].z, b[jj].z, acc[i][jj]);
          acc[i][jj] = fmaf(a[i].w, b[jj].w, acc[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int jj = 0; jj < TC; ++jj)
        s[(rt + RS * i) * lds + c0 + ct + CS * jj] -= acc[i][jj];
  }
}

// sub_abt with tiles as large as keep the CTA's threads busy
__device__ void sub_abt_any(float* s, int lds, int a0, int c0,
                            const float* p, int m) {
  if (m <= 2)
    sub_abt<2, 2>(s, lds, a0, c0, p, m);
  else if (m <= 4)
    sub_abt<4, 4>(s, lds, a0, c0, p, m);
  else
    sub_abt<8, 4>(s, lds, a0, c0, p, m);
}

// Point-to-point signals between the CTAs of a cluster: counters in each
// CTA's shared memory, raised by other CTAs (a release at cluster scope)
// and read by their own CTA (an acquire).
__device__ __forceinline__ unsigned ld_acquire(const unsigned* c) {
  unsigned v;
  asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(c)))
               : "memory");
  return v;
}

__device__ __forceinline__ void raise_in(unsigned* c, unsigned rank) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(c)), ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra)
               : "r"(a), "r"(rank));
  asm volatile("red.release.cluster.shared::cluster.add.u32 [%0], 1;\n" ::"r"(
                   ra)
               : "memory");
}

// The CTA waits until its counter c reaches want (thread 0 polls; a wait
// of about a second, a lost signal, traps rather than hangs).
__device__ void wait_count(const unsigned* c, unsigned want) {
  if (threadIdx.x == 0)
    for (long long spins = 0; ld_acquire(c) < want;)
      if (++spins > (1LL << 26)) __trap();
  __syncthreads();
}

// The CTA's stores so far (to global memory or another CTA's shared
// memory) made visible to the cluster, then counter c raised in the CTAs
// of ranks q0..q1-1 (none: a CTA barrier).
__device__ void publish(unsigned* c, int q0, int q1) {
  if (q1 > q0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < q1 - q0)
    raise_in(c, q0 + threadIdx.x);
}

// A barrier of the 256 threads of one half of the CTA (id 1 or 2)
__device__ __forceinline__ void half_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kThreads / 2) : "memory");
}

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// Hand the factored diagonal block at a (pitch lds; CTA p's) on: on and
// below its diagonal into CTA p+1's dnext, which it is waiting for, then
// whole into the output at o (pitch n) for the CTAs further below; the
// flag `ready` (this block's) raised in each once its copy is there.
template <typename Cluster>
__device__ void hand_on(Cluster& cluster, const float* a, int lds,
                        float* dnext, float* o, int n, int p, int nt,
                        unsigned* ready) {
  if (p + 1 < nt) {
    float* dst = cluster.map_shared_rank(dnext, p + 1);
    for (int e = threadIdx.x; e < 256; e += kThreads) {
      const int r = e >> 3, c = 4 * (e & 7);
      if (c <= r) st4(&dst[r * kBP + c], ld4(&a[r * lds + c]));
    }
    publish(ready, p + 1, p + 2);
  }
  for (int e = threadIdx.x; e < 256; e += kThreads) {
    const int r = e >> 3, c = 4 * (e & 7);
    st4(&o[r * n + c], ld4(&a[r * lds + c]));
  }
  publish(ready, p + 2, nt);
}

__host__ __device__ __forceinline__ int potrf_pitch(int n) { return n + 8; }

__global__ void __launch_bounds__(kThreads, 1)
    potrf_kernel(const float* __restrict__ in, long long bstride,
                 long long ld, float* out, int n) {
  extern __shared__ __align__(16) float smem[];
  // by step j: L_jj here, and the panel blocks L_qj (j < q < p) ready
  __shared__ unsigned lready[kMaxN / 32], pready[kMaxN / 32];
  __shared__ int flag, any_bad;
  __shared__ __align__(16) float rinv[32], col[64];
  cg::cluster_group cluster = cg::this_cluster();
  const int nt = n / 32;
  const int p = static_cast<int>(cluster.block_rank());
  const int lds = potrf_pitch(n);
  const int wp = 32 * (p + 1);
  float* s = smem;                      // [32][lds]: block row p
  float* pan = s + 32 * lds;            // nt - 1 blocks: the panel rows
  float* dl = pan + (nt - 1) * kBlk;    // L_jj
  float* dnext = dl + kBlk;             // L_(p-1,p-1), sent by CTA p-1
  float* o = out + static_cast<long long>(blockIdx.y) * n * n;
  float* op = o + 32LL * p * n;         // this CTA's rows of the output
  load_rows(s, lds, in + blockIdx.y * bstride + 32LL * p * ld, ld, wp);
  if (threadIdx.x == 0) flag = 0;
  if (threadIdx.x < kMaxN / 32) lready[threadIdx.x] = pready[threadIdx.x] = 0;
  __syncthreads();
  cluster.sync();  // every CTA runs, its counters zero
  if (p == 0) {
    if (threadIdx.x < 32 && chol32(s, lds, rinv, col) && threadIdx.x == 0)
      flag = 1;
    __syncthreads();
    hand_on(cluster, s, lds, dnext, op, n, 0, nt, &lready[0]);
  }
  for (int j = 0; j < p; ++j) {
    const int m = p - j;
    // L_pj = A_pj L_jj^-T, once L_jj is here: CTA j sends it to CTA j+1's
    // shared memory, and the others read it from the output
    const float* L = m == 1 ? dnext : dl;
    wait_count(&lready[j], 1);
    if (m > 1) {
      for (int e = threadIdx.x; e < 256; e += kThreads) {
        const int r = e >> 3, c = 4 * (e & 7);
        if (c <= r)
          st4(&dl[r * kBP + c], ldcg4(&o[(32LL * j + r) * n + 32 * j + c]));
      }
      __syncthreads();
    }
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      rinv[lane] = 1.f / L[lane * kBP + lane];
      __syncwarp();
      trsm32(s + 32 * j, lds, L, rinv);
    }
    __syncthreads();
    if (m == 1) {
      // the next diagonal block: one half of the CTA hands L_pj on
      // through the output, while the other updates the block and its
      // warp 0 factors it
      const int e = threadIdx.x & (kThreads / 2 - 1);
      const int r = e >> 3, c = 4 * (e & 7);
      const float4 v = ld4(&s[r * lds + 32 * j + c]);
      if (threadIdx.x >= kThreads / 2) {
        st4(&op[r * n + 32 * j + c], v);
        asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
        half_sync(1);
        if (e < nt - p - 1) raise_in(&pready[j], p + 1 + e);
      } else {
        st4(&pan[r * kBP + c], v);
        half_sync(2);
        sub_abt<2, 2>(s, lds, 32 * j, 32 * p, pan, 1);
        half_sync(2);
        if (threadIdx.x < 32 && chol32(s + 32 * p, lds, rinv, col) &&
            threadIdx.x == 0)
          flag = 1;
      }
      __syncthreads();
      hand_on(cluster, s + 32 * p, lds, dnext, op + 32 * p, n, p, nt,
              &lready[p]);
      break;
    }
    // L_pj into the output for the CTAs below, and into this CTA's own
    // panel slot
    for (int e = threadIdx.x; e < 256; e += kThreads) {
      const int r = e >> 3, c = 4 * (e & 7);
      const float4 v = ld4(&s[r * lds + 32 * j + c]);
      st4(&op[r * n + 32 * j + c], v);
      st4(&pan[(32 * (m - 1) + r) * kBP + c], v);
    }
    publish(&pready[j], p + 1, nt);
    // A_pq -= L_pj L_qj^T, j < q <= p, once the rows above have theirs
    wait_count(&pready[j], m - 1);
    for (int e = threadIdx.x; e < (m - 1) * 256; e += kThreads) {
      const int q = j + 1 + (e >> 8), r = (e >> 3) & 31, c = 4 * (e & 7);
      st4(&pan[(e >> 3) * kBP + c],
          ldcg4(&o[(32LL * q + r) * n + 32 * j + c]));
    }
    __syncthreads();
    sub_abt_any(s, lds, 32 * j, 32 * (j + 1), pan, m);
    __syncthreads();
  }
  cluster.sync();  // every block of the factor is in the output
  if (threadIdx.x < 32) {
    const bool bad =
        threadIdx.x < nt && *cluster.map_shared_rank(&flag, threadIdx.x);
    const bool any = __any_sync(kFull, bad);
    if (threadIdx.x == 0) any_bad = any;
  }
  __syncthreads();
  // above the diagonal zeros, or the whole tile NaN
  const float nan = __int_as_float(0x7fffffff);
  const float4 fill = any_bad ? make_float4(nan, nan, nan, nan)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = threadIdx.x >> 5; r < 32; r += kWarps)
    for (int c = 4 * (threadIdx.x & 31); c < n; c += 128)
      if (any_bad || c >= wp) st4(&op[r * n + c], fill);
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// C[0:M, 0:W] -= A[0:M, 0:32] B[0:32, 0:W] (pitches kBP; W 16 or 32):
// tiles of TR x 8 outputs, rows strided by M/TR so that a warp reads
// consecutive rows of A (16 bytes a lane) and one or few rows of B.
template <int TR>
__device__ void sub_ab(float* c, const float* a, const float* b, int M,
                       int W) {
  const int CT = W / 8, RS = M / TR;
  for (int t = threadIdx.x; t < RS * CT; t += kThreads) {
    const int ct = t % CT, rt = t / CT;
    float acc[TR][8] = {};
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      float4 x[TR], y[4][2];
#pragma unroll
      for (int i = 0; i < TR; ++i) x[i] = ld4(&a[(rt + RS * i) * kBP + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        y[kk][0] = ld4(&b[(k + kk) * kBP + 8 * ct]);
        y[kk][1] = ld4(&b[(k + kk) * kBP + 8 * ct + 4]);
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float xi[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float yk[8] = {y[kk][0].x, y[kk][0].y, y[kk][0].z,
                               y[kk][0].w, y[kk][1].x, y[kk][1].y,
                               y[kk][1].z, y[kk][1].w};
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            acc[i][jj] = fmaf(xi[kk], yk[jj], acc[i][jj]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        c[(rt + RS * i) * kBP + 8 * ct + jj] -= acc[i][jj];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    trinv_kernel(const float* __restrict__ in, long long bstride,
                 long long ld, float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nt = n / 32;
  const int k = static_cast<int>(cluster.block_rank());
  // strip a: 16 columns from ca, block rows from ia; strip b from cb, ib
  const int ca = 16 * k, ia = k / 2;
  const int cb = 16 * (2 * nt - 1 - k), ib = cb / 32;
  const int mmax = n - 32 * (ia + 1);   // rows below block row ia
  float* dinv = smem;                   // inv(L_kk)
  float* dbuf = dinv + kBlk;            // two: inv(L_II), by I's parity
  float* R = dbuf + 2 * kBlk;           // [n - 32 ia][kBP]: both strips
  float* lc = R + (n - 32 * ia) * kBP;  // two [mmax][kBP]: L's column block
  const float* L = in + blockIdx.y * bstride;
  const int lane = threadIdx.x & 31;
  // L[32(I+1):, 32I:32I+32] into lc's buffer I % 2: asynchronous copies
  auto fetch_lc = [&](int I) {
    float* dst = lc + (I & 1) * mmax * kBP;
    const float* src = L + 32LL * (I + 1) * ld + 32 * I;
    for (int e = threadIdx.x; e < (n - 32 * (I + 1)) * 8; e += kThreads)
      cp_async16(&dst[(e >> 3) * kBP + 4 * (e & 7)],
                 &src[(e >> 3) * ld + 4 * (e & 7)]);
    cp_async_commit();
  };
  // phase 1: invert diagonal block k; the right side starts as the
  // identity's columns of both strips
  load_rows(dbuf, kBP, L + 32LL * k * ld + 32 * k, ld, 32);
  for (int e = threadIdx.x; e < (n - 32 * ia) * 32; e += kThreads) {
    const int r = 32 * ia + (e >> 5), c = e & 31;
    R[(e >> 5) * kBP + c] = r == (c < 16 ? ca + c : cb + c - 16) ? 1.f : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const float mine = 1.f / dbuf[lane * kBP + lane];  // IEEE
    float rv[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) rv[m] = __shfl_sync(kFull, mine, m);
    lower_inv32(dbuf, kBP, rv, dinv);
  }
  cluster.sync();
  constexpr int kB4 = kBlk / 4;
  auto fetch_dinv = [&](int I) -> float4 {
    return threadIdx.x < kB4
               ? ld4(cluster.map_shared_rank(dinv, I) + 4 * threadIdx.x)
               : float4{};
  };
  float4 dnext = fetch_dinv(ia);
  if (threadIdx.x < kB4) st4(&dbuf[(ia & 1) * kBlk + 4 * threadIdx.x], dnext);
  if (ia + 1 < nt) fetch_lc(ia);
  // phase 2: the block rows I = ia.., strip b from ib on
  for (int I = ia; I < nt; ++I) {
    const int W = I >= ib ? 32 : 16;
    const int M = n - 32 * (I + 1);
    float* ri = R + 32 * (I - ia) * kBP;
    cp_async_wait();
    __syncthreads();
    // X_I = inv(L_II) R_I, in place
    {
      const float* d = dbuf + (I & 1) * kBlk;
      float x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = threadIdx.x + u * kThreads, r = o / W, c = o % W;
        float x0 = 0.f, x1 = 0.f;   // two sums: half the chain
        if (o < 32 * W) {
#pragma unroll
          for (int m = 0; m < 32; m += 2) {
            x0 = fmaf(d[r * kBP + m], ri[m * kBP + c], x0);
            x1 = fmaf(d[r * kBP + m + 1], ri[(m + 1) * kBP + c], x1);
          }
        }
        x[u] = x0 + x1;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = threadIdx.x + u * kThreads;
        if (o < 32 * W) ri[(o / W) * kBP + o % W] = x[u];
      }
    }
    // the next step's diagonal inverse and column block of L load while
    // this one updates the rows below
    if (I + 1 < nt) dnext = fetch_dinv(I + 1);
    if (I + 2 < nt) fetch_lc(I + 1);
    __syncthreads();
    // one strip: tiles of 2 rows, so that as many threads take part
    if (M > 0 && W == 16)
      sub_ab<2>(ri + 32 * kBP, lc + (I & 1) * mmax * kBP, ri, M, W);
    else if (M > 0)
      sub_ab<4>(ri + 32 * kBP, lc + (I & 1) * mmax * kBP, ri, M, W);
    if (I + 1 < nt && threadIdx.x < kB4)
      st4(&dbuf[((I + 1) & 1) * kBlk + 4 * threadIdx.x], dnext);
  }
  __syncthreads();
  float* o = out + static_cast<long long>(blockIdx.y) * n * n;
  for (int e = threadIdx.x; e < n * 8; e += kThreads) {
    const int row = e >> 3, c = 4 * (e & 7);
    const float4 v = row >= 32 * ia ? ld4(&R[(row - 32 * ia) * kBP + c])
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    st4(&o[static_cast<long long>(row) * n + (c < 16 ? ca + c : cb + c - 16)],
        v);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

size_t potrf_smem(int n) {
  const int nt = n / 32;
  return sizeof(float) * (32 * potrf_pitch(n) + (nt + 1) * kBlk);
}

size_t trinv_smem(int n) {
  // CTA 0 holds the most: strips of n rows and L's widest column blocks
  return sizeof(float) * (3 * kBlk + (n + 2 * (n - 32)) * kBP);
}

constexpr int kMaxDevices = 64;

// One launch a chunk of at most 65535 tiles (the grid's y), on stream;
// ready flags, by device, the kernel's attributes once set (the largest
// tile's shared memory, clusters of 16).
template <typename Kernel>
int launch(Kernel kernel, bool (&ready)[kMaxDevices], size_t smem,
           size_t max_smem, const float* in, long long bstride, long long ld,
           float* out, int n, int batch, cudaStream_t stream) {
  if (n < 32 || n > kMaxN || n % 32 != 0 || batch <= 0 || ld < n ||
      bstride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernels read 16-byte pieces of the tiles' rows
  if (reinterpret_cast<uintptr_t>(in) % 16 != 0 || ld % 4 != 0 ||
      (batch > 1 && bstride % 4 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(max_smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  constexpr int kMaxGridY = 65535;
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int nb = batch - b0 < kMaxGridY ? batch - b0 : kMaxGridY;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n / 32, nb, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n / 32;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, in + b0 * bstride, bstride, ld,
                             out + static_cast<long long>(b0) * n * n, n);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The lower Cholesky factor of `batch` n x n fp32 tiles (tile b at in + b *
// bstride, rows ld apart, columns adjacent, each row 16-byte aligned; its
// lower triangle read) into
// out, contiguous [batch][n][n], zeros above the diagonal; a tile whose
// pivot is not positive and finite comes out all NaN.  32 <= n <= 512, n a
// multiple of 32.  Returns a cudaError_t.
extern "C" int parsec_potrf_tiles(const float* in, long long bstride,
                                  long long ld, float* out, int n, int batch,
                                  void* stream) {
  static bool ready[kMaxDevices];
  return launch(potrf_kernel, ready, potrf_smem(n), potrf_smem(kMaxN), in,
                bstride, ld, out, n, batch,
                static_cast<cudaStream_t>(stream));
}

// The inverse of `batch` lower, non-unit triangular n x n fp32 tiles (laid
// out as for parsec_potrf_tiles; only the lower triangle read) into out,
// contiguous [batch][n][n], zeros above the diagonal.
extern "C" int parsec_trinv_tiles(const float* in, long long bstride,
                                  long long ld, float* out, int n, int batch,
                                  void* stream) {
  static bool ready[kMaxDevices];
  return launch(trinv_kernel, ready, trinv_smem(n), trinv_smem(kMaxN), in,
                bstride, ld, out, n, batch,
                static_cast<cudaStream_t>(stream));
}

// Sketched-density score and gradient at a swarm of candidates, on Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/sketch_shift.py:sketch_shift_kernel (the Pallas
// TPU kernel, body _shift_kernel).  For candidates c (P, n), frequencies
// w (n, m) and the two halves z1, z2 (m,) of a stacked-real sketch, all
// float32, computes the unnormalised sums
//     f[p]    = sum_j  cos(c_p . w_j) z1_j - sin(c_p . w_j) z2_j
//     g[p, k] = sum_j (-sin(c_p . w_j) z1_j - cos(c_p . w_j) z2_j) w_kj
// (the caller divides by m).
//
// What bounds it on this card: at the decoder's shapes (P = 80, n = 10,
// m = 1000) the launch and the latency of one dependent round of loads,
// reductions and barriers: the whole call is ~0.4 MFLOP and ~50 KB, and it
// runs 1,510 times a decode inside a CUDA graph.  At wide shapes (n = 2048,
// m = 20,000) operations: 2n FMAs per (candidate, frequency) for the phase
// and the gradient, two (P, n) x (n, m)-sized products in FP32.  Both use
// FP32 FMAs only: TF32 would break the phase at n = 2048.
//
// Narrow path (n <= 64), one launch, shift_cluster:
//  * A thread-block cluster of up to 8 CTAs owns kCands = 2 candidates; its
//    CTAs split m into equal contiguous slices (the wrapper sizes it,
//    sketch_shift.shift_grid: at P = 80, m = 1000, 40 clusters of 8 CTAs
//    of 125 frequencies, 320 CTAs on 132 SMs).
//  * A CTA of 128 threads stages its candidates and a chunk of 128
//    frequencies of w in shared memory (one coalesced round of loads), then
//    pass 1: a thread takes one frequency, forms the phases of the 2
//    candidates (k ascending), takes sin and cos from the SFU after the
//    exact reduction (sincos_reduced.cuh) and writes the density's term
//    cos z1 - sin z2 and the gradient's t = -sin z1 - cos z2 to shared
//    memory; pass 2: 8 lanes own a sum of g[., k] (k = n: f), 4 rows a
//    warp at once, each lane summing every 8th frequency of the chunk,
//    then xor shuffles over the 8 lanes; one lane adds the chunk's sum to
//    the CTA's partial in shared memory.
//  * The cluster adds its CTAs' partials (2 (n + 1) floats each) in rank
//    order: every other rank stores its partial into rank 0's shared memory
//    (distributed shared memory, st.async), each store counting down the
//    bytes that an mbarrier of rank 0 waits for, and leaves; a cluster
//    barrier arrived at when the kernel starts makes sure every CTA has
//    started, and rank 0's mbarrier is initialised, before the stores.  One
//    launch: no second kernel, no atomics, no arrival counter.  Two
//    launches give the same bits, and a CUDA graph captures the cluster
//    launch as one kernel node, so a graphed decode gives the eager one's
//    bits.
//
// Wide path (n > 64), three launches, the operator read twice in all:
//  * shift_phase_a: a CTA takes a tile of 64 frequencies and 16 TP
//    candidates (all of them for P <= 128), streams c and w through shared
//    memory in chunks of 16 coordinates (cp.async, 16 bytes a copy where
//    the rows are aligned, double buffered) and keeps its TP x 8 phases in
//    registers (k ascending).  Then the trig,
//    f's partial per (tile, candidate) and t = -sin z1 - cos z2, (P, m), to
//    device memory.
//  * shift_phase_b: g = t W^T, tiled over (P, 64 coordinates) with a fixed
//    split over m, the same staging and register tile; each split writes
//    its partial g.
//  * shift_finish adds f's tile partials and g's split partials in a fixed
//    order, in double.  No float atomics: bitwise repeatable.
//
// Ragged P, n and m are masked here (padding candidates and frequencies are
// zero and write nothing); nothing is padded in device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sincos_reduced.cuh"

namespace cg = cooperative_groups;

namespace {

// Narrow path.
constexpr int kThreads = 128;   // frequencies a CTA takes per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kCands = 2;       // candidates per cluster
constexpr int kMaxN = 64;       // its widths
constexpr int kMaxCluster = 8;  // CTAs per cluster (the portable limit)
constexpr int kWsLd = kThreads + 8;  // ws's row, padded: pass 2's 4 rows a warp
                                     // read 32 distinct banks
constexpr int kRowLanes = 8;         // pass 2: lanes a row (4 rows a warp)

// Wide path.
constexpr int kTileThreads = 128;  // 8 (columns) x 16 (candidates)
constexpr int kCols = 64;          // output columns a CTA owns (8 a thread)
constexpr int kDepth = 16;         // contraction depth staged per step
constexpr int kMaxTp = 8;          // candidates a thread owns, at most

// The cluster barrier in two halves (PTX barrier.cluster): every thread
// arrives, and a thread that waits returns once every thread of the cluster
// that has not exited has arrived.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// An mbarrier of one arrival that also waits for `bytes` of transactions:
// rank 0 arrives at once, and the other ranks' st.async stores count down
// the bytes.  The init is made visible to the cluster (for the remote
// stores) by the barrier arrive that follows it.
__device__ __forceinline__ void mbar_init_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// Rank `rank`'s shared::cluster address of this CTA's shared address.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// One float into another CTA's shared memory, counted on its mbarrier.
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
// Waits for the mbarrier's first phase, with acquire at cluster scope (the
// remote stores are visible after it).  Bounded: a phase that never
// completes traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait_first_phase(unsigned bar) {
  for (int i = 0; i < (1 << 20); ++i) {
    unsigned done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar) : "memory");
    if (done) return;
  }
  __trap();
}

// out receives f (p_cand,) and then g (p_cand, n).  Cluster rank r (=
// blockIdx.x) takes frequencies [r * split_len, min(m, (r + 1) * split_len)),
// cluster blockIdx.y candidates [2 y, 2 y + 2).  Entry e = p (n + 1) + k of
// a partial is g[p, k] for k < n and f[p] for k = n.
__global__ void __launch_bounds__(kThreads)
shift_cluster(const float* __restrict__ c, const float* __restrict__ w,
              const float* __restrict__ z1, const float* __restrict__ z2, int p_cand, int n,
              int m, int split_len, float* __restrict__ out) {
  constexpr int kEntries = kCands * (kMaxN + 1);
  __shared__ float cs[kCands][kMaxN];
  __shared__ float ws[kMaxN][kWsLd];
  __shared__ float ts[kCands][kThreads];  // t = -sin z1 - cos z2
  __shared__ float fv[kCands][kThreads];  // cos z1 - sin z2
  // Rank 0 receives every rank's partial sums here, rank r in row r.  A
  // CTA builds its own partial in row 0 of its own inbox, which no other
  // CTA writes (rank 0's is its slot; the others' inboxes are unused).
  __shared__ float inbox[kMaxCluster][kEntries];
  __shared__ __align__(8) unsigned long long arrived;  // rank 0: the others' stores
  float* part = inbox[0];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int entries = kCands * (n + 1);
  if (rank == 0 && threadIdx.x == 0)
    mbar_init_expect(smem_addr(&arrived), 4u * entries * (ranks - 1));
  // First half of a barrier that the remote stores below wait on: every CTA
  // of the cluster has started, and rank 0's mbarrier is initialised.
  cluster_arrive_release();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.y * kCands;
  const int np = min(kCands, p_cand - p0);
  const int j_begin = blockIdx.x * split_len;
  const int j_end = min(m, j_begin + split_len);

  for (int e = threadIdx.x; e < kCands * n; e += kThreads) {
    const int p = e / n, k = e - p * n;
    cs[p][k] = p < np ? c[(int64_t)(p0 + p) * n + k] : 0.0f;
  }
  for (int e = threadIdx.x; e < entries; e += kThreads) part[e] = 0.0f;

  const int jj = threadIdx.x;
  for (int j0 = j_begin; j0 < j_end; j0 += kThreads) {
    const int len = min(kThreads, j_end - j0);
    const bool active = jj < len;
    for (int k = 0; k < n; ++k) ws[k][jj] = active ? w[(int64_t)k * m + j0 + jj] : 0.0f;
    const float a1 = active ? z1[j0 + jj] : 0.0f, a2 = active ? z2[j0 + jj] : 0.0f;
    __syncthreads();  // the chunk of w (and the candidates) are staged
    // Pass 1: a thread's frequency: phases, trig, the density's and the
    // gradient's terms into shared memory.
    float ph[kCands];
#pragma unroll
    for (int p = 0; p < kCands; ++p) ph[p] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float wk = ws[k][jj];
#pragma unroll
      for (int p = 0; p < kCands; ++p) ph[p] = fmaf(cs[p][k], wk, ph[p]);
    }
#pragma unroll
    for (int p = 0; p < kCands; ++p) {
      float s, co;
      sincos_reduced(ph[p], &s, &co);
      fv[p][jj] = co * a1 - s * a2;
      ts[p][jj] = -s * a1 - co * a2;
    }
    __syncthreads();
    // Pass 2: the chunk's sums of g[., k] (and, as k = n, of f): 8 lanes a
    // row k, 4 rows a warp, 16 rows a round; a lane sums every 8th frequency
    // of the chunk, then xor shuffles over the row's 8 lanes.
    const int sub = lane / kRowLanes, l8 = lane % kRowLanes;
    for (int k = 4 * warp + sub; k < 4 * kWarps * ((n + 4 * kWarps) / (4 * kWarps));
         k += 4 * kWarps) {
      const bool row = k <= n;
      const float(*src)[kThreads] = k < n ? ts : fv;
      float acc[kCands];
#pragma unroll
      for (int p = 0; p < kCands; ++p) acc[p] = 0.0f;
      if (row) {
#pragma unroll 4
        for (int q = l8; q < len; q += kRowLanes) {
          const float wv = k < n ? ws[k][q] : 1.0f;
#pragma unroll
          for (int p = 0; p < kCands; ++p) acc[p] = fmaf(src[p][q], wv, acc[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kCands; ++p) {
#pragma unroll
        for (int o = kRowLanes / 2; o > 0; o >>= 1)
          acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], o);
      }
      if (row && l8 == 0) {
#pragma unroll
        for (int p = 0; p < kCands; ++p) part[p * (n + 1) + k] += acc[p];
      }
    }
    if (j0 + kThreads < j_end) __syncthreads();  // the next chunk overwrites ws, ts, fv
  }
  __syncthreads();  // part is complete

  // Every other rank's partial into rank 0's inbox through distributed
  // shared memory, each store counted on rank 0's mbarrier; those ranks then
  // leave (nothing reads their shared memory).  Rank 0 waits for the bytes,
  // adds the partials in rank order and writes f and g.
  if (rank != 0) {
    cluster_wait();
    const unsigned dst = map_rank(smem_addr(&inbox[rank][0]), 0);
    const unsigned bar = map_rank(smem_addr(&arrived), 0);
    for (int e = threadIdx.x; e < entries; e += kThreads) st_async(dst + 4 * e, part[e], bar);
    return;
  }
  if (ranks > 1) mbar_wait_first_phase(smem_addr(&arrived));
  for (int e = threadIdx.x; e < entries; e += kThreads) {
    float s = inbox[0][e];
    for (int q = 1; q < ranks; ++q) s += inbox[q][e];
    const int p = e / (n + 1), k = e - p * (n + 1);
    if (p < np) {
      if (k == n) out[p0 + p] = s;
      else out[p_cand + (int64_t)(p0 + p) * n + k] = s;
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}
// 16 bytes, of which the first `bytes` are read and the rest zero-filled;
// src and dst 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive floats from src (the first `count` of them, 0..4; the
// rest zero) into dst: one 16-byte copy where `vec` (src 16-byte aligned),
// else four 4-byte ones.
__device__ __forceinline__ void stage4(float* dst, const float* src, const float* base,
                                       int count, bool vec) {
  if (vec) {
    cp_async16(dst, count > 0 ? src : base, 4 * count);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) cp_async4(dst + u, u < count ? src + u : base, u < count);
  }
}

// The wide path's register tile: acc[i][q] = sum over d in [d0, d1) of
// A[p0 + ty + 16 i][d] * B(d, col0 + col(q)), with col(q) = 4 tx + q for
// q < 4 and 32 + 4 tx + q - 4 above, tx = threadIdx.x % 8, ty =
// threadIdx.x / 8, d ascending.  A is (rows_a, lda) row-major (the
// contraction contiguous), staged as it lies ([p][d], 16-byte copies where
// aligned); B(d, col) is B[d * ldb + col] (staged as it lies, [d][col],
// 16-byte copies where aligned) or, with B_T, B[col * ldb + d] (staged
// transposed to [d][col], 4-byte copies).  Rows, columns and depths out of
// range read as zero.
template <int TP, bool B_T>
__device__ __forceinline__ void tile_product(const float* __restrict__ a, int lda, int rows_a,
                                             int p0, const float* __restrict__ b, int ldb,
                                             int cols_b, int col0, int d0, int d1,
                                             float (&acc)[TP][8]) {
  constexpr int BP = 16 * TP;
  constexpr int AS = kDepth + 4;  // as's row: 16-byte aligned, 4 rows of a warp in 4 banks
  __shared__ __align__(16) float as[2][BP][AS];
  __shared__ __align__(16) float bs[2][kDepth][kCols + 4];
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const bool vec_a = (lda & 3) == 0 && (d0 & 3) == 0 && ((uintptr_t)a & 15) == 0;
  const bool vec_b = !B_T && (ldb & 3) == 0 && ((uintptr_t)b & 15) == 0;
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;

  auto stage = [&](int buf, int dbase) {
    for (int e = threadIdx.x; e < BP * kDepth / 4; e += kTileThreads) {
      const int p = e / (kDepth / 4), d = 4 * (e % (kDepth / 4));
      const int count = p0 + p < rows_a ? max(0, min(4, d1 - dbase - d)) : 0;
      stage4(&as[buf][p][d], a + (int64_t)(p0 + p) * lda + dbase + d, a, count, vec_a);
    }
    if (B_T) {
#pragma unroll
      for (int r = 0; r < kCols * kDepth / kTileThreads; ++r) {
        const int e = threadIdx.x + r * kTileThreads;
        const int col = e / kDepth, d = e % kDepth;
        const bool ok = col0 + col < cols_b && dbase + d < d1;
        cp_async4(&bs[buf][d][col], ok ? b + (int64_t)(col0 + col) * ldb + dbase + d : b, ok);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kCols * kDepth / 4 / kTileThreads; ++r) {
        const int e = threadIdx.x + r * kTileThreads;
        const int d = e / (kCols / 4), col = 4 * (e % (kCols / 4));
        const int count = dbase + d < d1 ? max(0, min(4, cols_b - col0 - col)) : 0;
        stage4(&bs[buf][d][col], b + (int64_t)(dbase + d) * ldb + col0 + col, b, count, vec_b);
      }
    }
    cp_async_commit();
  };

  const int steps = (d1 - d0 + kDepth - 1) / kDepth;
  if (steps > 0) stage(0, d0);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {
      stage(buf ^ 1, d0 + (s + 1) * kDepth);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step s has landed for every thread
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      float av[TP];
#pragma unroll
      for (int i = 0; i < TP; ++i) av[i] = as[buf][ty + 16 * i][d];
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][d][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][d][32 + 4 * tx]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
    }
    __syncthreads();  // step s is read before its buffer is refilled
  }
}

__device__ __forceinline__ int tile_col(int q) {
  return q < 4 ? 4 * (threadIdx.x & 7) + q : 32 + 4 * (threadIdx.x & 7) + q - 4;
}

// Phase A: blockIdx.x a tile of 64 frequencies, blockIdx.y a tile of 16 TP
// candidates.  t (p_cand, m); f_part (m tiles, p_cand).
template <int TP>
__global__ void __launch_bounds__(kTileThreads)
shift_phase_a(const float* __restrict__ c, const float* __restrict__ w,
              const float* __restrict__ z1, const float* __restrict__ z2, int p_cand, int n,
              int m, float* __restrict__ t, float* __restrict__ f_part) {
  const int j0 = blockIdx.x * kCols, p0 = blockIdx.y * 16 * TP;
  float acc[TP][8];
  tile_product<TP, false>(c, n, p_cand, p0, w, m, m, j0, 0, n, acc);
  const int ty = threadIdx.x >> 3;
  float a1[8], a2[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j = j0 + tile_col(q);
    a1[q] = j < m ? z1[j] : 0.0f;
    a2[q] = j < m ? z2[j] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int p = p0 + ty + 16 * i;
    float f = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + tile_col(q);
      float s, co;
      sincos_reduced(acc[i][q], &s, &co);
      f += co * a1[q] - s * a2[q];
      if (p < p_cand && j < m) t[(int64_t)p * m + j] = -s * a1[q] - co * a2[q];
    }
    // The tile's 64 frequencies: the 8 threads of a candidate, by shuffles.
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) f += __shfl_xor_sync(0xffffffffu, f, o);
    if ((threadIdx.x & 7) == 0 && p < p_cand) f_part[(int64_t)blockIdx.x * p_cand + p] = f;
  }
}

// Phase B: blockIdx.x a tile of 64 coordinates, blockIdx.y a tile of 16 TP
// candidates, blockIdx.z a split of the frequencies.  g_part (splits,
// p_cand, n).
template <int TP>
__global__ void __launch_bounds__(kTileThreads)
shift_phase_b(const float* __restrict__ t, const float* __restrict__ w, int p_cand, int n,
              int m, int split_len, float* __restrict__ g_part) {
  const int k0 = blockIdx.x * kCols, p0 = blockIdx.y * 16 * TP;
  const int d0 = blockIdx.z * split_len, d1 = min(m, d0 + split_len);
  float acc[TP][8];
  tile_product<TP, true>(t, m, p_cand, p0, w, m, n, k0, d0, d1, acc);
  const int ty = threadIdx.x >> 3;
  float* dst = g_part + (int64_t)blockIdx.z * p_cand * n;
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int p = p0 + ty + 16 * i;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = k0 + tile_col(q);
      if (p < p_cand && k < n) dst[(int64_t)p * n + k] = acc[i][q];
    }
  }
}

// out[p] = sum over the m tiles of f_part, out[p_cand + e] = sum over the
// splits of g_part, each in order, in double.
__global__ void __launch_bounds__(256)
shift_finish(const float* __restrict__ f_part, int tiles, const float* __restrict__ g_part,
             int splits, int p_cand, int n, float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * 256 + threadIdx.x;
  const int64_t g_count = (int64_t)p_cand * n;
  if (e >= p_cand + g_count) return;
  double s = 0.0;
  if (e < p_cand) {
    for (int q = 0; q < tiles; ++q) s += (double)f_part[(int64_t)q * p_cand + e];
  } else {
    for (int q = 0; q < splits; ++q) s += (double)g_part[q * g_count + e - p_cand];
  }
  out[e] = (float)s;
}

template <int TP>
cudaError_t launch_wide(const float* c, const float* w, const float* z1, const float* z2,
                        int p_cand, int n, int m, int splits, int split_len, float* scratch,
                        float* out, cudaStream_t stream) {
  const int p_tiles = (p_cand + 16 * TP - 1) / (16 * TP);
  const int m_tiles = (m + kCols - 1) / kCols, n_tiles = (n + kCols - 1) / kCols;
  float* t = scratch;
  float* f_part = t + (int64_t)p_cand * m;
  float* g_part = f_part + (int64_t)m_tiles * p_cand;
  shift_phase_a<TP><<<dim3(m_tiles, p_tiles), kTileThreads, 0, stream>>>(c, w, z1, z2, p_cand,
                                                                          n, m, t, f_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  shift_phase_b<TP><<<dim3(n_tiles, p_tiles, splits), kTileThreads, 0, stream>>>(
      t, w, p_cand, n, m, split_len, g_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t count = (int64_t)p_cand * (n + 1);
  shift_finish<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(f_part, m_tiles, g_part,
                                                                    splits, p_cand, n, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The narrow path (n <= 64): c (p_cand, n), w (n, m), z1 and z2 (m,)
// float32, contiguous, on the device.  out (p_cand * (n + 1),) float32
// receives f (p_cand,) and then g (p_cand, n).  `cluster` CTAs (1..8) split
// the frequencies into slices of split_len, none empty.  Returns a
// cudaError_t code.
int sketch_shift_narrow(const float* c, const float* w, const float* z1, const float* z2,
                        int p_cand, int n, int m, int cluster, int split_len, float* out,
                        void* stream_ptr) {
  const int groups = (p_cand + kCands - 1) / kCands;
  if (n < 1 || n > kMaxN || m < 1 || p_cand < 0 || groups > 65535 || cluster < 1 ||
      cluster > kMaxCluster || split_len < 1 || (int64_t)split_len * cluster < m ||
      (int64_t)split_len * (cluster - 1) >= m)
    return (int)cudaErrorInvalidValue;
  if (p_cand == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)groups, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream_ptr);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, shift_cluster, c, w, z1, z2, p_cand, n, m,
                                       split_len, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The wide path (any n; the wrapper sends n > 64): as above, with tp the
// candidates a thread owns (1..8, 16 tp a CTA), `splits` splits of
// split_len frequencies (none empty; a multiple of 16 keeps the staging
// whole) for the gradient,
// and scratch of p_cand * m + ceil(m / 64) * p_cand + splits * p_cand * n
// floats.  Returns a cudaError_t code.
int sketch_shift_wide(const float* c, const float* w, const float* z1, const float* z2,
                      int p_cand, int n, int m, int tp, int splits, int split_len,
                      float* scratch, float* out, void* stream_ptr) {
  if (n < 1 || m < 1 || p_cand < 0 || tp < 1 || tp > kMaxTp || splits < 1 ||
      splits > 65535 || split_len < 1 ||
      (int64_t)split_len * splits < m || (int64_t)split_len * (splits - 1) >= m ||
      (p_cand + 16 * tp - 1) / (16 * tp) > 65535 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (p_cand == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (tp) {
#define CASE(TT)                                                                          \
  case TT:                                                                                \
    err = launch_wide<TT>(c, w, z1, z2, p_cand, n, m, splits, split_len, scratch, out,   \
                          stream);                                                        \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* sketch_shift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

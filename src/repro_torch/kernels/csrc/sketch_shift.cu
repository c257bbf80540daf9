// Sketched-density score and gradient at a swarm of candidates, on Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/sketch_shift.py:sketch_shift_kernel (the Pallas
// TPU kernel, body _shift_kernel).  For candidates c (P, n), frequencies
// w (n, m) and the two halves z1, z2 (m,) of a stacked-real sketch, all
// float32, computes the unnormalised sums
//     f[p]    = sum_j  cos(c_p . w_j) z1_j - sin(c_p . w_j) z2_j
//     g[p, k] = sum_j (-sin(c_p . w_j) z1_j - cos(c_p . w_j) z2_j) w_kj
// (the caller divides by m).  The (P, m) trig matrices never reach device
// memory.
//
// What bounds it on this card: at the decoder's shapes (P = 80, n = 10,
// m = 1000) nothing but the launch: the whole call is ~0.4 MFLOP and ~50 KB.
// At the wide shape (n = 2048, m = 20,000) operations: per (candidate,
// frequency) 2n FMAs for the phase and the gradient, one sincosf and a few
// multiply-adds, against 4 bytes of w per (k, j) shared by the candidates.
//
// Design:
//  * One block per kCands candidates and per split of the frequencies, 256
//    threads over the frequencies.  The TPU kernel carries f and g in
//    resident output blocks across a sequential grid axis over m; here a
//    block loops over its split in chunks of kChunk frequencies.
//  * Pass 1 of a chunk: each thread takes frequencies j, forms the phases of
//    all kCands candidates with an FMA chain over k (each w_kj read once for
//    the kCands candidates), calls sincosf once per phase, adds its share of
//    f in registers, and writes t = -sin z1 - cos z2 to shared memory.
//  * Pass 2 of a chunk: warp q owns coordinates k = q, q + 8, ...; its lanes
//    stride over the chunk's frequencies (coalesced reads of row k of w),
//    reduce by xor shuffles, and lane 0 adds the chunk's sum to g[p, k] in
//    device memory.  Only that thread ever touches g[p, k] of its split, so
//    g needs no atomics and any n works: no register array is sized by n.
//  * f: per-thread register sums, reduced by xor shuffles and then over the
//    warps in a fixed order.
//  * Splits: at the decoder's shapes (m <= kChunk) there is one, and the
//    block writes f and g directly: one launch per call.  For a long m the
//    wrapper splits the chunks so that the grid fills the card; each split
//    writes its partial f and g, and a second kernel adds the partials in
//    split order, in double precision.  No float atomics anywhere: two
//    launches give the same bits.
//  * Ragged P and m are masked here (a padding candidate slot computes the
//    last real candidate's values and writes nothing); nothing is padded in
//    device memory.
//  * sincosf, never __sinf/__cosf: phases reach tens of radians.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCands = 4;     // candidates per block
constexpr int kChunk = 1024;  // frequencies per chunk staged in shared memory

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Outputs of split s: f at out + s * p_cand * (n + 1), g right after it.
__global__ void __launch_bounds__(kThreads)
sketch_shift_kernel(const float* __restrict__ c, const float* __restrict__ w,
                    const float* __restrict__ z1, const float* __restrict__ z2,
                    int p_cand, int n, int m, int split_len,
                    float* __restrict__ out) {
  __shared__ float ts[kCands][kChunk];
  __shared__ float fs[kWarps][kCands];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * kCands;
  const int np = min(kCands, p_cand - p0);
  const int j_begin = blockIdx.y * split_len;
  const int j_end = min(m, j_begin + split_len);
  float* f_out = out + (int64_t)blockIdx.y * p_cand * (n + 1);
  float* g_out = f_out + p_cand;
  const float* cp[kCands];
#pragma unroll
  for (int p = 0; p < kCands; ++p) cp[p] = c + (int64_t)(p0 + min(p, np - 1)) * n;

  float f_acc[kCands];
#pragma unroll
  for (int p = 0; p < kCands; ++p) f_acc[p] = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += kChunk) {
    const int len = min(kChunk, j_end - j0);
    // Pass 1: phases, trig, the density, and t into shared memory.
    for (int jj = threadIdx.x; jj < len; jj += kThreads) {
      const int j = j0 + jj;
      float ph[kCands];
#pragma unroll
      for (int p = 0; p < kCands; ++p) ph[p] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float wk = __ldg(w + (int64_t)k * m + j);
#pragma unroll
        for (int p = 0; p < kCands; ++p) ph[p] = fmaf(__ldg(cp[p] + k), wk, ph[p]);
      }
      const float a1 = __ldg(z1 + j), a2 = __ldg(z2 + j);
#pragma unroll
      for (int p = 0; p < kCands; ++p) {
        float s, co;
        sincosf(ph[p], &s, &co);
        f_acc[p] += co * a1 - s * a2;
        ts[p][jj] = -s * a1 - co * a2;
      }
    }
    __syncthreads();
    // Pass 2: the chunk's share of the gradient, one coordinate per warp.
    for (int k = warp; k < n; k += kWarps) {
      const float* wk = w + (int64_t)k * m + j0;
      float acc[kCands];
#pragma unroll
      for (int p = 0; p < kCands; ++p) acc[p] = 0.0f;
      for (int jj = lane; jj < len; jj += 32) {
        const float wv = __ldg(wk + jj);
#pragma unroll
        for (int p = 0; p < kCands; ++p) acc[p] = fmaf(ts[p][jj], wv, acc[p]);
      }
#pragma unroll
      for (int p = 0; p < kCands; ++p) acc[p] = warp_sum(acc[p]);
      if (lane == 0) {
        for (int p = 0; p < np; ++p) {
          float* dst = g_out + (int64_t)(p0 + p) * n + k;
          *dst = (j0 == j_begin ? 0.0f : *dst) + acc[p];
        }
      }
    }
    __syncthreads();  // the next chunk overwrites ts
  }

  // The density: shuffles within each warp, then the warps in a fixed order.
#pragma unroll
  for (int p = 0; p < kCands; ++p) {
    const float v = warp_sum(f_acc[p]);
    if (lane == 0) fs[warp][p] = v;
  }
  __syncthreads();
  if (threadIdx.x < np) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += fs[q][threadIdx.x];
    f_out[p0 + threadIdx.x] = s;
  }
}

// out[i] = sum over the splits of part[s * count + i], in split order.
__global__ void __launch_bounds__(kThreads)
sum_splits(const float* __restrict__ part, int64_t count, int splits,
           float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  double s = 0.0;
  for (int q = 0; q < splits; ++q) s += (double)part[(int64_t)q * count + i];
  out[i] = (float)s;
}

}  // namespace

extern "C" {

// c (p_cand, n), w (n, m), z1 and z2 (m,) float32, contiguous, on the
// device.  out (p_cand * (n + 1),) float32 receives f (p_cand,) and then g
// (p_cand, n).  The frequencies go to `splits` blocks along y of split_len
// each (a multiple of the chunk); with splits > 1, part (splits *
// p_cand * (n + 1),) float32 holds the partials.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for bad sizes.
int sketch_shift_sums(const float* c, const float* w, const float* z1,
                      const float* z2, int p_cand, int n, int m, int split_len,
                      int splits, float* part, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || m < 1 || p_cand < 0 || splits < 1 || splits > 65535 ||
      split_len < 1 || split_len % kChunk != 0 ||
      (int64_t)split_len * splits < m || (int64_t)split_len * (splits - 1) >= m ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p_cand == 0) return 0;
  const dim3 grid((unsigned)((p_cand + kCands - 1) / kCands), (unsigned)splits);
  sketch_shift_kernel<<<grid, kThreads, 0, stream>>>(
      c, w, z1, z2, p_cand, n, m, split_len, splits > 1 ? part : out);
  if (splits > 1) {
    const int64_t count = (int64_t)p_cand * (n + 1);
    const unsigned blocks = (unsigned)((count + kThreads - 1) / kThreads);
    sum_splits<<<blocks, kThreads, 0, stream>>>(part, count, splits, out);
  }
  return (int)cudaGetLastError();
}

const char* sketch_shift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused random-Fourier-feature sketch sums on Hopper (sm_90a).
//
// Replaces src/repro/kernels/fourier_sketch.py:fourier_sketch_kernel (the
// Pallas TPU kernel, body _sketch_kernel).  Computes, for x (N, n), w (n, m)
// and beta (N,), all float32:
//     cos_out[j] = sum_i beta_i cos(x_i . w_j),   sin_out[j] = sum_i beta_i sin(x_i . w_j)
//
// What bounds it on this card: operations.  Per (row, frequency) pair it does
// n FMAs for the phase, one sincosf and two weighted accumulates, and reads
// only 4(n+1) bytes per row, so at n = 10, m = 1000 the work is FMA- and
// trig-bound, roughly 600 operations per byte moved.  With n = 10 the
// projection is too shallow for tensor cores, and TF32 would break the 1e-4
// bar anyway: every product is a full-precision FP32 FMA.
//
// Design:
//  * The TPU kernel carries the sum over N in its resident output block
//    across a sequential grid axis.  Blocks here run in parallel in no
//    order, so each block owns a tile of 256 frequencies (one per thread,
//    its column of w held in registers) and a contiguous range of rows.
//    Each thread accumulates beta*cos and beta*sin over its rows in
//    registers, and the block writes one partial per frequency to
//    (row_blocks, m) scratch.  A second kernel sums the partials over the
//    row blocks in a fixed order, in double precision.  No float atomics:
//    the sums are bitwise repeatable from run to run.
//  * Rows are staged 64 at a time in shared memory, padded to NP floats (a
//    multiple of 4), so every thread reads each row as NP/4 broadcast
//    16-byte loads.  Global loads of the tile are coalesced.
//  * The ragged edges of N and m are masked here; nothing is padded in
//    device memory.  Feature widths above 64 take a generic kernel that
//    reads w and x through the read-only cache.
//  * sincosf, never __sinf/__cosf: phases reach tens of radians, where the
//    fast intrinsics lose accuracy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // frequencies per block, one per thread
constexpr int kRowsTile = 64;  // rows staged in shared memory per step

template <int NP>
__global__ void __launch_bounds__(kThreads)
sketch_partials(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ beta, int64_t n_pts, int n, int m,
                int64_t rows_per_block, float* __restrict__ cos_part,
                float* __restrict__ sin_part) {
  __shared__ __align__(16) float xs[kRowsTile * NP];
  __shared__ float bs[kRowsTile];

  const int j = blockIdx.y * kThreads + threadIdx.x;
  const bool active = j < m;
  float wr[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    wr[k] = (active && k < n) ? w[(int64_t)k * m + j] : 0.0f;
  }
  // Padding columns of the tile stay zero: 0 * 0 adds nothing to a phase.
  for (int e = threadIdx.x; e < kRowsTile * NP; e += kThreads) xs[e] = 0.0f;

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(n_pts, r0 + rows_per_block);
  float acc_c = 0.0f, acc_s = 0.0f;
  for (int64_t t0 = r0; t0 < r1; t0 += kRowsTile) {
    const int rows = (int)min((int64_t)kRowsTile, r1 - t0);
    __syncthreads();  // the previous tile has been read by every thread
    const float* src = x + t0 * n;
    for (int e = threadIdx.x; e < rows * n; e += kThreads) {
      const int r = e / n;
      xs[r * NP + (e - r * n)] = src[e];
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) bs[r] = beta[t0 + r];
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float4* xr = reinterpret_cast<const float4*>(xs + r * NP);
      float p = 0.0f;
#pragma unroll
      for (int q = 0; q < NP / 4; ++q) {
        const float4 v = xr[q];
        p = fmaf(v.x, wr[4 * q + 0], p);
        p = fmaf(v.y, wr[4 * q + 1], p);
        p = fmaf(v.z, wr[4 * q + 2], p);
        p = fmaf(v.w, wr[4 * q + 3], p);
      }
      float s, c;
      sincosf(p, &s, &c);
      const float b = bs[r];
      acc_c = fmaf(b, c, acc_c);
      acc_s = fmaf(b, s, acc_s);
    }
  }
  if (active) {
    cos_part[(int64_t)blockIdx.x * m + j] = acc_c;
    sin_part[(int64_t)blockIdx.x * m + j] = acc_s;
  }
}

// Any feature width: w and x through the read-only cache, no staging.
__global__ void __launch_bounds__(kThreads)
sketch_partials_generic(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ beta, int64_t n_pts, int n,
                        int m, int64_t rows_per_block,
                        float* __restrict__ cos_part,
                        float* __restrict__ sin_part) {
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= m) return;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(n_pts, r0 + rows_per_block);
  float acc_c = 0.0f, acc_s = 0.0f;
  for (int64_t r = r0; r < r1; ++r) {
    const float* xr = x + r * n;
    float p = 0.0f;
    for (int k = 0; k < n; ++k) p = fmaf(__ldg(xr + k), __ldg(w + (int64_t)k * m + j), p);
    float s, c;
    sincosf(p, &s, &c);
    const float b = __ldg(beta + r);
    acc_c = fmaf(b, c, acc_c);
    acc_s = fmaf(b, s, acc_s);
  }
  cos_part[(int64_t)blockIdx.x * m + j] = acc_c;
  sin_part[(int64_t)blockIdx.x * m + j] = acc_s;
}

// Second pass: sum the per-block partials in row-block order, in double.
__global__ void reduce_partials(const float* __restrict__ cos_part,
                                const float* __restrict__ sin_part,
                                int row_blocks, int m, float* __restrict__ cos_out,
                                float* __restrict__ sin_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  double c = 0.0, s = 0.0;
  for (int b = 0; b < row_blocks; ++b) {
    c += (double)cos_part[(int64_t)b * m + j];
    s += (double)sin_part[(int64_t)b * m + j];
  }
  cos_out[j] = (float)c;
  sin_out[j] = (float)s;
}

template <int NP>
void launch_partials(dim3 grid, cudaStream_t stream, const float* x,
                     const float* w, const float* beta, int64_t n_pts, int n,
                     int m, int64_t rows_per_block, float* cos_part,
                     float* sin_part) {
  sketch_partials<NP><<<grid, kThreads, 0, stream>>>(
      x, w, beta, n_pts, n, m, rows_per_block, cos_part, sin_part);
}

}  // namespace

extern "C" {

// x (n_pts, n), w (n, m), beta (n_pts,) float32, contiguous, on the device.
// cos_part / sin_part: (row_blocks, m) scratch; cos_out / sin_out: (m,).
// row_blocks * rows_per_block must cover n_pts.  Returns cudaGetLastError().
int fourier_sketch_sums(const float* x, const float* w, const float* beta,
                        int64_t n_pts, int n, int m, int64_t rows_per_block,
                        int row_blocks, float* cos_part, float* sin_part,
                        float* cos_out, float* sin_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(row_blocks, (m + kThreads - 1) / kThreads);
  if (n <= 4) {
    launch_partials<4>(grid, stream, x, w, beta, n_pts, n, m, rows_per_block, cos_part, sin_part);
  } else if (n <= 8) {
    launch_partials<8>(grid, stream, x, w, beta, n_pts, n, m, rows_per_block, cos_part, sin_part);
  } else if (n <= 12) {
    launch_partials<12>(grid, stream, x, w, beta, n_pts, n, m, rows_per_block, cos_part, sin_part);
  } else if (n <= 16) {
    launch_partials<16>(grid, stream, x, w, beta, n_pts, n, m, rows_per_block, cos_part, sin_part);
  } else if (n <= 32) {
    launch_partials<32>(grid, stream, x, w, beta, n_pts, n, m, rows_per_block, cos_part, sin_part);
  } else if (n <= 64) {
    launch_partials<64>(grid, stream, x, w, beta, n_pts, n, m, rows_per_block, cos_part, sin_part);
  } else {
    sketch_partials_generic<<<grid, kThreads, 0, stream>>>(
        x, w, beta, n_pts, n, m, rows_per_block, cos_part, sin_part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<(m + 255) / 256, 256, 0, stream>>>(cos_part, sin_part,
                                                       row_blocks, m, cos_out,
                                                       sin_out);
  return (int)cudaGetLastError();
}

const char* fourier_sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

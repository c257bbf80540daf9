// Fused random-Fourier-feature sketch sums on Hopper (sm_90a).
//
// Replaces src/repro/kernels/fourier_sketch.py:fourier_sketch_kernel (the
// Pallas TPU kernel, body _sketch_kernel).  Computes, for x (N, n), w (n, m)
// and beta (N,), all float32:
//     cos_out[j] = sum_i beta_i cos(x_i . w_j),   sin_out[j] = sum_i beta_i sin(x_i . w_j)
//
// What bounds it on this card: instructions.  Per (row, frequency) pair it
// does n FMAs for the phase, the trig and two weighted accumulates, and reads
// only 4(n+1) bytes per row, so at n = 10, m = 1000 it is some 600
// operations per byte moved.  With n = 10 the projection is too shallow for
// tensor cores, and TF32 would break the 1e-4 bar anyway: every product is a
// full-precision FP32 FMA.  A full-precision sincosf is tens of FP32-pipe
// instructions while the special-function unit (SFU) idles, so the trig
// goes to the SFU after an exact phase reduction: sincos_reduced()
// (sincos_reduced.cuh, shared with the structured kernels) reduces the
// phase to [-pi, pi] in four FP32 instructions and calls __sincosf there,
// within 1.2e-7 + 3.6e-7 of sin and cos for |p| <= 1e5, some 300x under
// the 1e-4 bar on sums / N.  Per pair the FP32 pipe then does n FMAs, four
// for the reduction, one scaling the argument into the SFU's units and two
// accumulates; the SFU does two (sin, cos) at 16 per clock per SM.
//
// Design:
//  * The TPU kernel carries the sum over N in its resident output block
//    across a sequential grid axis.  Blocks here run in parallel in no
//    order, so each block owns 256 frequencies (a thread owns F = 2 of them
//    for n <= 16, else 1, its columns of w held in registers) and a
//    contiguous range of rows.  The wrapper sizes the grid to one wave of
//    the blocks that fit on the card at once (kernels/_launch.py::grid_rows
//    with the occupancy this library reports), so every SM gets equal work
//    at any N; each block's range may then be millions of rows long.  A
//    thread sums beta*cos and beta*sin over a tile of 128 rows in float32
//    registers and adds each tile's sums into double registers, so the
//    accuracy does not depend on the range's length.  The block writes one
//    double partial per frequency to (groups, m) scratch, whose size does
//    not grow with N; a second kernel sums the partials over the groups in
//    a fixed order, in double.  No atomics: the sums are bitwise repeatable
//    on one card.
//  * Rows are staged 128 at a time in shared memory as [x_i, beta_i, 0...]
//    padded to XS floats (a multiple of 4), so every thread reads a row and
//    its weight as XS/4 broadcast 16-byte loads.  n <= 16 takes an instance
//    per width; n up to 64 takes one padded to 24, 32, 48 or 64.
//  * Feature widths above 64 take a chunked kernel: x is staged 16 rows by
//    128 features at a time (one step for n <= 128), walked in chunks of 16
//    features whose entries of w sit in the thread's registers, and each of
//    the 16 rows' partial phases is carried in a register across the
//    chunks.  Nothing is read from device memory per
//    pair.
//  * The ragged edges of N, n and m are masked here; nothing is padded in
//    device memory.
//  * The fleet entry (fourier_sketch_sums_fleet) sketches T tenants' batches,
//    each against its own w and beta, in one launch: the counterpart of the
//    reference's vmap of the Pallas kernel over the tenant axis
//    (src/repro/core/fleet.py:_tenant_part).  The tenant rides in the grid's
//    x axis, blockIdx.x = tenant * groups + group, with groups =
//    ceil(n_pts / rows_per_group), and each block offsets its pointers by
//    its tenant's strides, which follow from n_pts, n, m and groups.  Each
//    tenant gets the grid that an isolated call of B rows gets (the wrapper
//    asks sketch_grid for B, never for T B, with the single kernel's
//    occupancy), and the second pass adds its partials in group order, so
//    every tenant's sums are bitwise those of its own launch.  The offsets sit behind a template
//    flag (FLEET): a single call runs instances whose signature and code are
//    those the kernel had before the fleet entry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sincos_reduced.cuh"

namespace {

constexpr int kFreqs = 256;       // frequencies per block
constexpr int kRowsTile = 128;    // rows staged in shared memory per step
constexpr int kChunkRows = 16;    // the chunked kernel's rows per step,
constexpr int kStage = 128;       // features staged per step
constexpr int kChunk = 16;        // and features of w in registers per step
// Rows [blockIdx.x * rows_per_group, ...) of x against frequencies
// blockIdx.y * 256 + threadIdx.x + f * T.  N is the width or, when the
// instance is padded, at least the runtime n (w and x read as 0 past n).
template <int N, int F, bool FLEET>
__global__ void __launch_bounds__(kFreqs / F)
sketch_partials(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ beta, int64_t n_pts, int n, int m,
                int64_t rows_per_group, double* __restrict__ cos_part,
                double* __restrict__ sin_part) {
  constexpr int T = kFreqs / F;
  constexpr int XS = (N + 4) / 4 * 4;  // N values, beta, zero pad to 16 bytes
  __shared__ __align__(16) float xs[kRowsTile * XS];

  int64_t group = blockIdx.x;
  if constexpr (FLEET) {
    const int64_t groups = (n_pts + rows_per_group - 1) / rows_per_group;
    const int64_t tenant = group / groups;
    group -= tenant * groups;
    x += tenant * n_pts * n;
    w += tenant * n * m;
    beta += tenant * n_pts;
    cos_part += tenant * groups * m;
    sin_part += tenant * groups * m;
  }
  const int j0 = blockIdx.y * kFreqs + threadIdx.x;
  float wr[F][N];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int j = j0 + f * T;
#pragma unroll
    for (int k = 0; k < N; ++k) wr[f][k] = (j < m && k < n) ? w[(int64_t)k * m + j] : 0.0f;
  }
  // Columns the staging never writes (n..N-1 and the pad) stay zero.
  for (int e = threadIdx.x; e < kRowsTile * XS; e += T) xs[e] = 0.0f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r0 = group * rows_per_group;
  const int64_t r1 = min(n_pts, r0 + rows_per_group);
  double dc[F], ds[F];
#pragma unroll
  for (int f = 0; f < F; ++f) dc[f] = ds[f] = 0.0;
  for (int64_t t0 = r0; t0 < r1; t0 += kRowsTile) {
    const int rows = (int)min((int64_t)kRowsTile, r1 - t0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int r = warp; r < rows; r += T / 32) {
      const float* src = x + (t0 + r) * n;
      for (int c = lane; c < n; c += 32) xs[r * XS + c] = src[c];
      if (lane == 0) xs[r * XS + N] = beta[t0 + r];
    }
    __syncthreads();
    float ac[F], as[F];
#pragma unroll
    for (int f = 0; f < F; ++f) ac[f] = as[f] = 0.0f;
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float xv[XS];
      const float4* xr = reinterpret_cast<const float4*>(xs + r * XS);
#pragma unroll
      for (int q = 0; q < XS / 4; ++q) {
        const float4 v = xr[q];
        xv[4 * q] = v.x;
        xv[4 * q + 1] = v.y;
        xv[4 * q + 2] = v.z;
        xv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float p = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) p = fmaf(xv[k], wr[f][k], p);
        float s, c;
        sincos_reduced(p, &s, &c);
        ac[f] = fmaf(xv[N], c, ac[f]);
        as[f] = fmaf(xv[N], s, as[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      dc[f] += (double)ac[f];
      ds[f] += (double)as[f];
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int j = j0 + f * T;
    if (j < m) {
      cos_part[group * m + j] = dc[f];
      sin_part[group * m + j] = ds[f];
    }
  }
}

// Any feature width: x staged in (16 rows, 128 features) blocks, walked in
// chunks of 16 features whose w entries sit in registers; each row's
// partial phase is carried across the chunks.
template <bool FLEET>
__global__ void __launch_bounds__(kFreqs, 2)
sketch_partials_chunked(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ beta, int64_t n_pts, int n, int m,
                        int64_t rows_per_group, double* __restrict__ cos_part,
                        double* __restrict__ sin_part) {
  __shared__ __align__(16) float xs[kChunkRows * kStage];
  __shared__ float bs[kChunkRows];

  int64_t group = blockIdx.x;
  if constexpr (FLEET) {
    const int64_t groups = (n_pts + rows_per_group - 1) / rows_per_group;
    const int64_t tenant = group / groups;
    group -= tenant * groups;
    x += tenant * n_pts * n;
    w += tenant * n * m;
    beta += tenant * n_pts;
    cos_part += tenant * groups * m;
    sin_part += tenant * groups * m;
  }
  const int j = blockIdx.y * kFreqs + threadIdx.x;
  const bool active = j < m;
  const int64_t r0 = group * rows_per_group;
  const int64_t r1 = min(n_pts, r0 + rows_per_group);
  double dc = 0.0, ds = 0.0;
  for (int64_t t0 = r0; t0 < r1; t0 += kChunkRows) {
    const int rows = (int)min((int64_t)kChunkRows, r1 - t0);
    float ph[kChunkRows];
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) ph[r] = 0.0f;
    for (int s0 = 0; s0 < n; s0 += kStage) {
      const int sw = min(kStage, n - s0);
      __syncthreads();  // the previous block of x (and bs) has been read
      for (int e = threadIdx.x; e < kChunkRows * kStage; e += kFreqs) {
        const int r = e / kStage, c = e % kStage;
        xs[e] = (r < rows && c < sw) ? x[(t0 + r) * n + s0 + c] : 0.0f;
      }
      if (s0 == 0 && threadIdx.x < kChunkRows)
        bs[threadIdx.x] = threadIdx.x < rows ? beta[t0 + threadIdx.x] : 0.0f;
      __syncthreads();
      for (int c0 = 0; c0 < sw; c0 += kChunk) {
        float wr[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          wr[c] = (active && c0 + c < sw) ? w[(int64_t)(s0 + c0 + c) * m + j] : 0.0f;
#pragma unroll
        for (int r = 0; r < kChunkRows; ++r) {
          const float4* xr = reinterpret_cast<const float4*>(xs + r * kStage + c0);
#pragma unroll
          for (int q = 0; q < kChunk / 4; ++q) {
            const float4 v = xr[q];
            ph[r] = fmaf(v.x, wr[4 * q], ph[r]);
            ph[r] = fmaf(v.y, wr[4 * q + 1], ph[r]);
            ph[r] = fmaf(v.z, wr[4 * q + 2], ph[r]);
            ph[r] = fmaf(v.w, wr[4 * q + 3], ph[r]);
          }
        }
      }
    }
    float ac = 0.0f, as = 0.0f;
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) {
      if (r < rows) {
        float s, c;
        sincos_reduced(ph[r], &s, &c);
        ac = fmaf(bs[r], c, ac);
        as = fmaf(bs[r], s, as);
      }
    }
    dc += (double)ac;
    ds += (double)as;
  }
  if (active) {
    cos_part[group * m + j] = dc;
    sin_part[group * m + j] = ds;
  }
}

// Second pass: sum the per-group partials in group order, in double; a
// tenant's (groups, m) partials and (m,) outputs follow the previous
// tenant's, blockIdx.x = tenant * col_blocks + column block.
__global__ void reduce_partials(const double* __restrict__ cos_part,
                                const double* __restrict__ sin_part, int groups, int m,
                                int col_blocks, float* __restrict__ cos_out,
                                float* __restrict__ sin_out) {
  const int tenant = blockIdx.x / col_blocks;
  const int j = (blockIdx.x - tenant * col_blocks) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  cos_part += (int64_t)tenant * groups * m;
  sin_part += (int64_t)tenant * groups * m;
  cos_out += (int64_t)tenant * m;
  sin_out += (int64_t)tenant * m;
  double c = 0.0, s = 0.0;
#pragma unroll 8
  for (int g = 0; g < groups; ++g) {
    c += cos_part[(int64_t)g * m + j];
    s += sin_part[(int64_t)g * m + j];
  }
  cos_out[j] = (float)c;
  sin_out[j] = (float)s;
}

using PartialsFn = void (*)(const float*, const float*, const float*, int64_t, int, int,
                            int64_t, double*, double*);

// The instance for width n (the fleet's or the single call's) and its
// threads per block.
template <bool FLEET>
void pick(int n, PartialsFn* fn, int* threads) {
#define CASE(NN, FF)                              \
  case NN:                                        \
    *fn = sketch_partials<NN, FF, FLEET>;         \
    *threads = kFreqs / FF;                       \
    return;
  switch (n) {
    CASE(1, 2) CASE(2, 2) CASE(3, 2) CASE(4, 2) CASE(5, 2) CASE(6, 2) CASE(7, 2) CASE(8, 2)
    CASE(9, 2) CASE(10, 2) CASE(11, 2) CASE(12, 2) CASE(13, 2) CASE(14, 2) CASE(15, 2)
    CASE(16, 2)
    default:
      break;
  }
#undef CASE
  *threads = kFreqs;
  if (n <= 24) *fn = sketch_partials<24, 1, FLEET>;
  else if (n <= 32) *fn = sketch_partials<32, 1, FLEET>;
  else if (n <= 48) *fn = sketch_partials<48, 1, FLEET>;
  else if (n <= 64) *fn = sketch_partials<64, 1, FLEET>;
  else *fn = sketch_partials_chunked<FLEET>;
}

constexpr int kReduceThreads = 256;

// Both passes over `tenants` tenants of n_pts rows each (see the entry
// points below).
int launch(const float* x, const float* w, const float* beta, int tenants, int64_t n_pts,
           int n, int m, int64_t rows_per_group, int groups, double* cos_part,
           double* sin_part, float* cos_out, float* sin_out, void* stream_ptr) {
  if (n < 1 || m < 1 || tenants < 1 || groups < 1 || rows_per_group < 1 ||
      (int64_t)groups * rows_per_group < n_pts)
    return (int)cudaErrorInvalidValue;
  const int col_blocks = (m + kFreqs - 1) / kFreqs;
  const int reduce_blocks = (m + kReduceThreads - 1) / kReduceThreads;
  if ((int64_t)tenants * groups > INT32_MAX || (int64_t)tenants * reduce_blocks > INT32_MAX ||
      col_blocks > 65535 ||
      (tenants > 1 && groups != (n_pts + rows_per_group - 1) / rows_per_group))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  PartialsFn fn;
  int threads;
  if (tenants > 1) pick<true>(n, &fn, &threads);
  else pick<false>(n, &fn, &threads);
  const dim3 grid(tenants * groups, col_blocks);
  fn<<<grid, threads, 0, stream>>>(x, w, beta, n_pts, n, m, rows_per_group, cos_part,
                                   sin_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<tenants * reduce_blocks, kReduceThreads, 0, stream>>>(
      cos_part, sin_part, groups, m, reduce_blocks, cos_out, sin_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the width-n kernel that fit on one SM of the current device
// at once, into *out.  Returns a cudaError_t code.
int fourier_sketch_resident(int n, int* out) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  PartialsFn fn;
  int threads;
  pick<false>(n, &fn, &threads);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads, 0);
}

// x (n_pts, n), w (n, m), beta (n_pts,) float32, contiguous, on the device.
// cos_part / sin_part: (groups, m) double scratch; cos_out / sin_out: (m,).
// groups * rows_per_group must cover n_pts; groups <= 2^31 - 1 and
// ceil(m / 256) <= 65535.  Returns a cudaError_t code.
int fourier_sketch_sums(const float* x, const float* w, const float* beta, int64_t n_pts,
                        int n, int m, int64_t rows_per_group, int groups, double* cos_part,
                        double* sin_part, float* cos_out, float* sin_out, void* stream_ptr) {
  return launch(x, w, beta, 1, n_pts, n, m, rows_per_group, groups, cos_part, sin_part,
                cos_out, sin_out, stream_ptr);
}

// The fleet: x (tenants, n_pts, n), w (tenants, n, m), beta (tenants, n_pts)
// float32, contiguous, on the device; each tenant's rows against its own w.
// cos_part / sin_part: (tenants, groups, m) double scratch; cos_out /
// sin_out: (tenants, m).  rows_per_group and groups are one tenant's, as for
// an isolated call of n_pts rows (groups = ceil(n_pts / rows_per_group));
// tenants * groups <= 2^31 - 1.  Returns a cudaError_t code.
int fourier_sketch_sums_fleet(const float* x, const float* w, const float* beta, int tenants,
                              int64_t n_pts, int n, int m, int64_t rows_per_group, int groups,
                              double* cos_part, double* sin_part, float* cos_out,
                              float* sin_out, void* stream_ptr) {
  return launch(x, w, beta, tenants, n_pts, n, m, rows_per_group, groups, cos_part, sin_part,
                cos_out, sin_out, stream_ptr);
}

const char* fourier_sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

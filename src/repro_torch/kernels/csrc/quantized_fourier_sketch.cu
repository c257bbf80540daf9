// Quantized (QCKM) random-Fourier-feature sketch sums on Hopper (sm_90a).
//
// Replaces src/repro/kernels/fourier_sketch.py:quantized_fourier_sketch_kernel
// (the Pallas TPU kernel, body _quantized_sketch_kernel).  Computes, for
// x (N, n), w (n, m), dither (m,) and an optional row mask valid (N,), all
// float32, and the static code scale S:
//     theta_ij = x_i . w_j + dither_j
//     1 bit:  qcos_j = sum_i valid_i * (cos theta_ij >= 0 ? 1 : -1)   (same for sin)
//     b bits: qcos_j = sum_i valid_i * rint(S * cos theta_ij)          (same for sin)
// with int32 outputs.  valid is truncated to int as the reference's
// astype(int32) does; a null valid pointer means every row counts.
//
// What bounds it on this card: instructions.  It reads only 4(n+1) bytes a
// row; per (row, frequency) pair it does n FMAs for the phase, the dither
// add, the four-instruction phase reduction, and then either two compares
// and two predicated integer adds (1 bit: no trig at all) or two SFU
// operations, two scaled roundings and two integer multiply-adds (b bits).
//
// Design (kernel 1's, fourier_sketch.cu, with integer sums):
//  * A block of 128 threads owns 128 F frequencies (a thread owns F of
//    them, their columns of w and their dither in registers: F = 4 at 1 bit
//    and 2 at b bits for n <= 16, else 1) and a contiguous range of rows.  The wrapper sizes the grid to one wave of
//    the blocks that fit on the card at once (fourier_sketch.sketch_grid,
//    kernel 1's, with the occupancy that quantized_fourier_sketch_resident
//    reports), so every SM gets equal work at any N.  Int32 sums are exact
//    at any range length: no cap on the rows of a block.
//  * Rows are staged 128 at a time in shared memory as [x_i, valid_i, 0...]
//    padded to XS floats (a multiple of 4), valid already truncated to int
//    and stored as its bits, so every thread reads a row and its mask as
//    XS/4 broadcast 16-byte loads, four rows at a time (16 independent
//    phase chains a thread at F = 2).  n <= 16 takes an instance per width;
//    n up to 64 one padded to 24, 32, 48 or 64.
//  * Feature widths above 64 take kernel 1's chunked path: x staged 16 rows
//    by 128 features at a time, walked in chunks of 16 features whose
//    entries of w sit in the thread's registers, each row's partial phase
//    carried in a register across the chunks.  Nothing is read from device
//    memory per pair.
//  * 1 bit: one_bit_signs() (sincos_reduced.cuh, shared with the structured
//    kernel) reads both signs off the reduced phase.  A thread counts
//    sum valid over the rows whose code is +1 and sum valid over all its
//    rows; the code sum is 2 * count - total, the same integer as the sum of
//    +-valid.  b bits: sincos_reduced() (the SFU after the exact reduction),
//    then __float2int_rn(__fmul_rn(c, S)): rint semantics (half to even, as
//    torch.round / jnp.round), never roundf; a NaN phase gives the code 0,
//    as the reference's.
//  * The dither add and the S * c product are explicit _rn operations, never
//    contracted into an FMA: the reference rounds each.
//  * Each thread sums its codes in int32 registers and adds them once to the
//    zeroed int32 outputs with atomicAdd.  Integer addition is exact and
//    associative (modulo 2^32, as the reference's int32 sums wrap), so the
//    sums are bitwise repeatable in any order and any split of the rows adds
//    up to the same bits.  A thread's partial covers a subset of the rows,
//    so it stays within accumulator_capacity wherever the total does.
//  * The ragged edges of N, n and m are masked here; nothing is padded in
//    device memory.
//  * The fleet entry (quantized_fourier_sketch_sums_fleet) sketches T
//    tenants' batches, each against its own w and dither, in one launch: the
//    counterpart of the reference's vmap of the Pallas kernel over the
//    tenant axis (src/repro/core/fleet.py:_tenant_qpart).  The tenant rides
//    in the grid's x axis, blockIdx.x = tenant * groups + group, with
//    groups = ceil(n_pts / rows_per_group), and each block offsets its
//    pointers by its tenant's strides, which follow from n_pts, n and m.
//    Integer sums are exact under any split of the rows, so every tenant's
//    sums are those of its own launch.  The offsets sit behind a template
//    flag (FLEET): a single call runs instances whose signature and code are
//    those the kernel had before the fleet entry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sincos_reduced.cuh"

namespace {

constexpr int kThreads = 128;   // threads per block of the per-width kernels
constexpr int kFreqs = 256;     // frequencies per block of the chunked kernel
constexpr int kRowsTile = 128;  // rows staged in shared memory per step
constexpr int kChunkRows = 16;  // the chunked kernel's rows per step,
constexpr int kStage = 128;     // features staged per step
constexpr int kChunk = 16;      // and features of w in registers per step

// A thread's running sums for one frequency: at 1 bit the valid-weighted
// counts of +1 codes (the total of valid is kept once per thread), at b bits
// the code sums themselves.
template <bool ONE_BIT>
__device__ __forceinline__ void add_codes(float p, float dth, float scale, int vr,
                                          int* acc_c, int* acc_s) {
  const float theta = __fadd_rn(p, dth);
  if (ONE_BIT) {
    bool cos_pos, sin_pos;
    one_bit_signs(theta, &cos_pos, &sin_pos);
    if (cos_pos) *acc_c += vr;
    if (sin_pos) *acc_s += vr;
  } else {
    float s, c;
    sincos_reduced(theta, &s, &c);
    *acc_c += __float2int_rn(__fmul_rn(c, scale)) * vr;
    *acc_s += __float2int_rn(__fmul_rn(s, scale)) * vr;
  }
}

// The code sums of one frequency into the outputs: at 1 bit
// sum(+-valid) = 2 * count(+1, weighted) - sum(valid).
template <bool ONE_BIT>
__device__ __forceinline__ void flush(int j, int acc_c, int acc_s, int total,
                                      int* __restrict__ qcos, int* __restrict__ qsin) {
  if (ONE_BIT) {
    acc_c = 2 * acc_c - total;
    acc_s = 2 * acc_s - total;
  }
  atomicAdd(qcos + j, acc_c);
  atomicAdd(qsin + j, acc_s);
}

__device__ __forceinline__ int valid_at(const float* __restrict__ valid, int64_t r) {
  return valid ? (int)valid[r] : 1;
}

// Rows [blockIdx.x * rows_per_group, ...) of x against frequencies
// blockIdx.y * 128 F + threadIdx.x + 128 f.  N is the width or, when the
// instance is padded, at least the runtime n (w and x read as 0 past n).
template <int N, int F, bool ONE_BIT, bool FLEET>
__global__ void __launch_bounds__(kThreads)
qsketch(const float* __restrict__ x, const float* __restrict__ w,
        const float* __restrict__ dither, const float* __restrict__ valid, int64_t n_pts,
        int n, int m, float scale, int64_t rows_per_group, int* __restrict__ qcos,
        int* __restrict__ qsin) {
  constexpr int T = kThreads;
  constexpr int XS = (N + 4) / 4 * 4;  // N values, valid, zero pad to 16 bytes
  __shared__ __align__(16) float xs[kRowsTile * XS];

  int64_t group = blockIdx.x;
  if constexpr (FLEET) {
    const int64_t groups = (n_pts + rows_per_group - 1) / rows_per_group;
    const int64_t tenant = group / groups;
    group -= tenant * groups;
    x += tenant * n_pts * n;
    w += tenant * n * m;
    if (valid) valid += tenant * n_pts;
    dither += tenant * m;
    qcos += tenant * m;
    qsin += tenant * m;
  }
  const int j0 = blockIdx.y * T * F + threadIdx.x;
  float wr[F][N], dth[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int j = j0 + f * T;
#pragma unroll
    for (int k = 0; k < N; ++k) wr[f][k] = (j < m && k < n) ? w[(int64_t)k * m + j] : 0.0f;
    dth[f] = j < m ? dither[j] : 0.0f;
  }
  // Columns the staging never writes (n..N-1 and the pad) stay zero.
  for (int e = threadIdx.x; e < kRowsTile * XS; e += T) xs[e] = 0.0f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r0 = group * rows_per_group;
  const int64_t r1 = min(n_pts, r0 + rows_per_group);
  int acc_c[F], acc_s[F], total = 0;
#pragma unroll
  for (int f = 0; f < F; ++f) acc_c[f] = acc_s[f] = 0;
  for (int64_t t0 = r0; t0 < r1; t0 += kRowsTile) {
    const int rows = (int)min((int64_t)kRowsTile, r1 - t0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int r = warp; r < rows; r += T / 32) {
      const float* src = x + (t0 + r) * n;
      for (int c = lane; c < n; c += 32) xs[r * XS + c] = src[c];
      if (lane == 0) xs[r * XS + N] = __int_as_float(valid_at(valid, t0 + r));
    }
    __syncthreads();
#pragma unroll 4
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
      const int vr = __float_as_int(xv[N]);
      total += vr;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float p = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) p = fmaf(xv[k], wr[f][k], p);
        add_codes<ONE_BIT>(p, dth[f], scale, vr, &acc_c[f], &acc_s[f]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int j = j0 + f * T;
    if (j < m) flush<ONE_BIT>(j, acc_c[f], acc_s[f], total, qcos, qsin);
  }
}

// Any feature width: x staged in (16 rows, 128 features) blocks, walked in
// chunks of 16 features whose w entries sit in registers; each row's
// partial phase is carried across the chunks.
template <bool ONE_BIT, bool FLEET>
__global__ void __launch_bounds__(kFreqs, 2)
qsketch_chunked(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ dither, const float* __restrict__ valid,
                int64_t n_pts, int n, int m, float scale, int64_t rows_per_group,
                int* __restrict__ qcos, int* __restrict__ qsin) {
  __shared__ __align__(16) float xs[kChunkRows * kStage];
  __shared__ int vs[kChunkRows];

  int64_t group = blockIdx.x;
  if constexpr (FLEET) {
    const int64_t groups = (n_pts + rows_per_group - 1) / rows_per_group;
    const int64_t tenant = group / groups;
    group -= tenant * groups;
    x += tenant * n_pts * n;
    w += tenant * n * m;
    if (valid) valid += tenant * n_pts;
    dither += tenant * m;
    qcos += tenant * m;
    qsin += tenant * m;
  }
  const int j = blockIdx.y * kFreqs + threadIdx.x;
  const bool active = j < m;
  const float dth = active ? dither[j] : 0.0f;
  const int64_t r0 = group * rows_per_group;
  const int64_t r1 = min(n_pts, r0 + rows_per_group);
  int acc_c = 0, acc_s = 0, total = 0;
  for (int64_t t0 = r0; t0 < r1; t0 += kChunkRows) {
    const int rows = (int)min((int64_t)kChunkRows, r1 - t0);
    float ph[kChunkRows];
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) ph[r] = 0.0f;
    for (int s0 = 0; s0 < n; s0 += kStage) {
      const int sw = min(kStage, n - s0);
      __syncthreads();  // the previous block of x (and vs) has been read
      for (int e = threadIdx.x; e < kChunkRows * kStage; e += kFreqs) {
        const int r = e / kStage, c = e % kStage;
        xs[e] = (r < rows && c < sw) ? x[(t0 + r) * n + s0 + c] : 0.0f;
      }
      if (s0 == 0 && threadIdx.x < kChunkRows)
        vs[threadIdx.x] = threadIdx.x < rows ? valid_at(valid, t0 + threadIdx.x) : 0;
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
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) {
      if (r < rows) {
        total += vs[r];
        add_codes<ONE_BIT>(ph[r], dth, scale, vs[r], &acc_c, &acc_s);
      }
    }
  }
  if (active) flush<ONE_BIT>(j, acc_c, acc_s, total, qcos, qsin);
}

using QsketchFn = void (*)(const float*, const float*, const float*, const float*, int64_t,
                           int, int, float, int64_t, int*, int*);

// The instance for width n and the code, its threads and frequencies per
// block.  n <= 16: F = 4 frequencies a thread at 1 bit, 2 at b bits (the
// b-bit pair's trig and rounding need the registers); wider: 1.
template <bool ONE_BIT, bool FLEET>
void pick(int n, QsketchFn* fn, int* threads, int* freqs) {
  constexpr int F = ONE_BIT ? 4 : 2;
  *threads = kThreads;
  *freqs = kThreads * F;
#define CASE(NN)                                  \
  case NN:                                        \
    *fn = qsketch<NN, F, ONE_BIT, FLEET>;         \
    return;
  switch (n) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)
    CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    default:
      break;
  }
#undef CASE
  *freqs = kThreads;
  if (n <= 24) *fn = qsketch<24, 1, ONE_BIT, FLEET>;
  else if (n <= 32) *fn = qsketch<32, 1, ONE_BIT, FLEET>;
  else if (n <= 48) *fn = qsketch<48, 1, ONE_BIT, FLEET>;
  else if (n <= 64) *fn = qsketch<64, 1, ONE_BIT, FLEET>;
  else {
    *fn = qsketch_chunked<ONE_BIT, FLEET>;
    *threads = *freqs = kFreqs;
  }
}

// The instance for width n, the code and the call (the fleet's or a single
// one's).
void pick_code(int n, int one_bit, bool fleet, QsketchFn* fn, int* threads, int* freqs) {
  if (one_bit) {
    if (fleet) pick<true, true>(n, fn, threads, freqs);
    else pick<true, false>(n, fn, threads, freqs);
  } else {
    if (fleet) pick<false, true>(n, fn, threads, freqs);
    else pick<false, false>(n, fn, threads, freqs);
  }
}

// One launch over `tenants` tenants of n_pts rows each (see the entry
// points below).
int launch(const float* x, const float* w, const float* dither, const float* valid,
           int tenants, int64_t n_pts, int n, int m, int one_bit, float scale,
           int64_t rows_per_group, int groups, int* qcos, int* qsin, void* stream_ptr) {
  if (n < 1 || m < 1 || tenants < 1 || groups < 1 || rows_per_group < 1 ||
      (int64_t)groups * rows_per_group < n_pts || (int64_t)tenants * groups > INT32_MAX ||
      (tenants > 1 && groups != (n_pts + rows_per_group - 1) / rows_per_group))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  QsketchFn fn;
  int threads, freqs;
  pick_code(n, one_bit, tenants > 1, &fn, &threads, &freqs);
  const dim3 grid(tenants * groups, (m + freqs - 1) / freqs);
  fn<<<grid, threads, 0, stream>>>(x, w, dither, valid, n_pts, n, m, scale, rows_per_group,
                                   qcos, qsin);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the width-n kernel (1-bit or b-bit codes) that fit on one SM of
// the current device at once, into *out, and the frequencies a block owns,
// into *freqs.  Returns a cudaError_t code.
int quantized_fourier_sketch_resident(int n, int one_bit, int* out, int* freqs) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  QsketchFn fn;
  int threads;
  pick_code(n, one_bit, false, &fn, &threads, freqs);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads, 0);
}

// x (n_pts, n), w (n, m), dither (m,) float32; valid (n_pts,) float32 or
// null; all contiguous on the device.  qcos / qsin: (m,) int32, zeroed by the
// caller.  groups * rows_per_group must cover n_pts; groups <= 2^31 - 1 and
// ceil(m / freqs) <= 65535 (freqs as quantized_fourier_sketch_resident
// reports).  scale is S (1 for the sign code).  Returns a cudaError_t code.
int quantized_fourier_sketch_sums(const float* x, const float* w, const float* dither,
                                  const float* valid, int64_t n_pts, int n, int m,
                                  int one_bit, float scale, int64_t rows_per_group,
                                  int groups, int* qcos, int* qsin, void* stream_ptr) {
  return launch(x, w, dither, valid, 1, n_pts, n, m, one_bit, scale, rows_per_group, groups,
                qcos, qsin, stream_ptr);
}

// The fleet: x (tenants, n_pts, n), w (tenants, n, m), dither (tenants, m)
// float32, contiguous, on the device; each tenant's rows against its own w
// and dither, every row counted.  qcos / qsin: (tenants, m) int32, zeroed by
// the caller.  rows_per_group and groups are one tenant's, groups =
// ceil(n_pts / rows_per_group); tenants * groups <= 2^31 - 1.  Returns a
// cudaError_t code.
int quantized_fourier_sketch_sums_fleet(const float* x, const float* w, const float* dither,
                                        int tenants, int64_t n_pts, int n, int m, int one_bit,
                                        float scale, int64_t rows_per_group, int groups,
                                        int* qcos, int* qsin, void* stream_ptr) {
  return launch(x, w, dither, nullptr, tenants, n_pts, n, m, one_bit, scale, rows_per_group,
                groups, qcos, qsin, stream_ptr);
}

const char* quantized_fourier_sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

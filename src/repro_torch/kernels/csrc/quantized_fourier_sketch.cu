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
// What bounds it on this card: operations.  Per (row, frequency) pair it does
// n FMAs for the phase, the dither add, one sincosf, two codes and two integer
// adds, and reads only 4(n+1) bytes per row: at n = 10, m = 1000 it is
// trig-bound, like the float kernel (fourier_sketch.cu).
//
// Design:
//  * The structure of fourier_sketch.cu: a block owns 256 frequencies (one
//    per thread, its column of w and its dither in registers) and a
//    contiguous range of rows, staged 64 at a time in shared memory and read
//    as broadcast 16-byte loads.  Codes accumulate in int32 registers.
//  * Across blocks the integer sums combine with atomicAdd on the int32
//    outputs, which the wrapper zeroes.  Integer addition is exact and
//    associative, so the sums are bitwise repeatable in any order; no second
//    pass is needed.
//  * The wrapper sizes the grid from N, m and the SM count (not a fixed row
//    count), so small calls still fill the card.
//  * Rounding: rint semantics via __float2int_rn (half to even, as
//    jnp.round / torch.round), never roundf.  The 1-bit code is
//    c >= 0 ? 1 : -1, so -0.0 gives +1 and NaN gives -1, as jnp.where does.
//    The dither add and the S * c product are explicit _rn operations, never
//    contracted into an FMA: the reference rounds each.
//  * sincosf at full precision: phases reach tens of radians.
//  * Ragged N and m are masked here; nothing is padded in device memory.
//    Feature widths above 64 take a generic kernel that reads w and x
//    through the read-only cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // frequencies per block, one per thread
constexpr int kRowsTile = 64;  // rows staged in shared memory per step

template <bool ONE_BIT>
__device__ __forceinline__ int code(float v, float scale) {
  if (ONE_BIT) return v >= 0.0f ? 1 : -1;
  return __float2int_rn(__fmul_rn(v, scale));
}

template <int NP, bool ONE_BIT>
__global__ void __launch_bounds__(kThreads)
qsketch(const float* __restrict__ x, const float* __restrict__ w,
        const float* __restrict__ dither, const float* __restrict__ valid,
        int64_t n_pts, int n, int m, float scale, int64_t rows_per_block,
        int* __restrict__ qcos, int* __restrict__ qsin) {
  __shared__ __align__(16) float xs[kRowsTile * NP];
  __shared__ int vs[kRowsTile];

  const int j = blockIdx.y * kThreads + threadIdx.x;
  const bool active = j < m;
  float wr[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    wr[k] = (active && k < n) ? w[(int64_t)k * m + j] : 0.0f;
  }
  const float dth = active ? dither[j] : 0.0f;
  // Padding columns of the tile stay zero: 0 * 0 adds nothing to a phase.
  for (int e = threadIdx.x; e < kRowsTile * NP; e += kThreads) xs[e] = 0.0f;

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(n_pts, r0 + rows_per_block);
  int acc_c = 0, acc_s = 0;
  for (int64_t t0 = r0; t0 < r1; t0 += kRowsTile) {
    const int rows = (int)min((int64_t)kRowsTile, r1 - t0);
    __syncthreads();  // the previous tile has been read by every thread
    const float* src = x + t0 * n;
    for (int e = threadIdx.x; e < rows * n; e += kThreads) {
      const int r = e / n;
      xs[r * NP + (e - r * n)] = src[e];
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      vs[r] = valid ? (int)valid[t0 + r] : 1;
    }
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
      sincosf(__fadd_rn(p, dth), &s, &c);
      const int vr = vs[r];
      acc_c += code<ONE_BIT>(c, scale) * vr;
      acc_s += code<ONE_BIT>(s, scale) * vr;
    }
  }
  if (active) {
    atomicAdd(qcos + j, acc_c);
    atomicAdd(qsin + j, acc_s);
  }
}

// Any feature width: w and x through the read-only cache, no staging.
template <bool ONE_BIT>
__global__ void __launch_bounds__(kThreads)
qsketch_generic(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ dither,
                const float* __restrict__ valid, int64_t n_pts, int n, int m,
                float scale, int64_t rows_per_block, int* __restrict__ qcos,
                int* __restrict__ qsin) {
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= m) return;
  const float dth = dither[j];
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(n_pts, r0 + rows_per_block);
  int acc_c = 0, acc_s = 0;
  for (int64_t r = r0; r < r1; ++r) {
    const float* xr = x + r * n;
    float p = 0.0f;
    for (int k = 0; k < n; ++k) p = fmaf(__ldg(xr + k), __ldg(w + (int64_t)k * m + j), p);
    float s, c;
    sincosf(__fadd_rn(p, dth), &s, &c);
    const int vr = valid ? (int)__ldg(valid + r) : 1;
    acc_c += code<ONE_BIT>(c, scale) * vr;
    acc_s += code<ONE_BIT>(s, scale) * vr;
  }
  atomicAdd(qcos + j, acc_c);
  atomicAdd(qsin + j, acc_s);
}

template <bool ONE_BIT>
void launch(dim3 grid, cudaStream_t stream, const float* x, const float* w,
            const float* dither, const float* valid, int64_t n_pts, int n,
            int m, float scale, int64_t rows_per_block, int* qcos, int* qsin) {
#define QSKETCH_ARGS x, w, dither, valid, n_pts, n, m, scale, rows_per_block, qcos, qsin
  if (n <= 4) {
    qsketch<4, ONE_BIT><<<grid, kThreads, 0, stream>>>(QSKETCH_ARGS);
  } else if (n <= 8) {
    qsketch<8, ONE_BIT><<<grid, kThreads, 0, stream>>>(QSKETCH_ARGS);
  } else if (n <= 12) {
    qsketch<12, ONE_BIT><<<grid, kThreads, 0, stream>>>(QSKETCH_ARGS);
  } else if (n <= 16) {
    qsketch<16, ONE_BIT><<<grid, kThreads, 0, stream>>>(QSKETCH_ARGS);
  } else if (n <= 32) {
    qsketch<32, ONE_BIT><<<grid, kThreads, 0, stream>>>(QSKETCH_ARGS);
  } else if (n <= 64) {
    qsketch<64, ONE_BIT><<<grid, kThreads, 0, stream>>>(QSKETCH_ARGS);
  } else {
    qsketch_generic<ONE_BIT><<<grid, kThreads, 0, stream>>>(QSKETCH_ARGS);
  }
#undef QSKETCH_ARGS
}

}  // namespace

extern "C" {

// x (n_pts, n), w (n, m), dither (m,) float32; valid (n_pts,) float32 or
// null; all contiguous on the device.  qcos / qsin: (m,) int32, zeroed by the
// caller.  row_blocks * rows_per_block must cover n_pts.  scale is S (1 for
// the sign code).  Returns cudaGetLastError().
int quantized_fourier_sketch_sums(const float* x, const float* w,
                                  const float* dither, const float* valid,
                                  int64_t n_pts, int n, int m, int one_bit,
                                  float scale, int64_t rows_per_block,
                                  int row_blocks, int* qcos, int* qsin,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(row_blocks, (m + kThreads - 1) / kThreads);
  if (one_bit) {
    launch<true>(grid, stream, x, w, dither, valid, n_pts, n, m, scale, rows_per_block, qcos, qsin);
  } else {
    launch<false>(grid, stream, x, w, dither, valid, n_pts, n, m, scale, rows_per_block, qcos, qsin);
  }
  return (int)cudaGetLastError();
}

const char* quantized_fourier_sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

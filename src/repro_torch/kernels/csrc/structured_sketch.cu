// Structured (fast Walsh-Hadamard) sketch sums on Hopper (sm_90a), float and
// quantized.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/freq_transform.py:
//  * structured_sketch_kernel (body _structured_sketch_kernel): for x (N, n),
//    Rademacher signs diags (nblocks, 3, d), radii (nblocks, d) and weights
//    beta (N,), all float32, per frequency block b and coordinate j
//        v     = c H D2 . c H D1 . c H D0 . x_pad      (c = d^-1/2, H Sylvester)
//        cos_out[b, j] = sum_i beta_i cos(v_ij * radii[b, j])   (same for sin)
//  * quantized_structured_sketch_kernel (body
//    _quantized_structured_sketch_kernel): the same chain, then the phase
//    theta = v * radii + dither[b, j] goes through the QCKM code of
//    quantized_fourier_sketch.cu (sign, or rint(S * cos)), masked by valid
//    and summed in int32.
// x_pad is x zero-padded from n to d columns; the padding is done in
// registers, never in device memory.
//
// What bounds it on this card: operations.  Per (row, frequency) pair each of
// the three stages does one sign multiply, log2(d) butterfly adds and one
// scale, then one radius multiply, one sincosf and the accumulates, while a
// row brings only 4(n+1) bytes.
//
// Design:
//  * The transform is the O(d log d) butterfly, not the reference's
//    Kronecker matmuls (H_a x H_b): with d = 32 (the main path's n = 10) a
//    block of 32 frequencies is exactly one warp, one coordinate per lane,
//    and the five butterfly stages are __shfl_xor_sync exchanges.  The sums
//    come in another order than the reference's, so results differ in the
//    last bits; the tests hold them to 1e-4 on sums / N.
//  * Wider blocks (d = 64 .. 2048): TPF = min(d, 256) threads share one
//    frequency block, and a thread holds EPT = d / TPF coordinates
//    e = t + TPF * k.  Stages h < 32 run by shuffles, stages 32 <= h < TPF
//    through a ping-pong buffer in shared memory (one barrier a stage), and
//    stages h >= TPF between a thread's own registers.
//  * A block of 256 threads owns FB = 256 / TPF frequency blocks (their signs,
//    radii and dither in registers) and a contiguous range of rows, staged a
//    tile at a time in shared memory so that all FB frequency blocks share one
//    coalesced read of x.
//  * Float sums: each block writes a partial per frequency to a
//    (groups, nblocks * d) scratch and a second kernel sums the partials in
//    group order in double.  No float atomics, so the sums are bitwise
//    repeatable.  Integer sums: atomicAdd on the zeroed int32 outputs, exact
//    in any order.  The wrapper sizes the grid from N, nblocks and the SM
//    count, a fixed function of the shape on one card.
//  * The radius multiply and the dither add are explicit _rn operations
//    (the reference rounds each); rounding of codes is __float2int_rn (half
//    to even), never roundf; the 1-bit code is c >= 0 ? 1 : -1.
//  * sincosf at full precision: phases reach tens of radians.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 4096;  // floats of x staged per tile (16 KB)
constexpr int kMaxTileRows = 1024;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Layout {
  static constexpr int TPF = D < kThreads ? D : kThreads;  // threads per frequency block
  static constexpr int FB = kThreads / TPF;                // frequency blocks per CUDA block
  static constexpr int EPT = D / TPF;                      // coordinates per thread
};

// In-place unnormalised WHT of one frequency block held across the TPF
// threads of a group: coordinate e = t + TPF * k lives in v[k] of thread t.
template <int D>
__device__ __forceinline__ void wht(float (&v)[Layout<D>::EPT], int t,
                                    float* buf, int& parity) {
  using L = Layout<D>;
  const int lane = threadIdx.x & 31;
  // Stages within a warp: partner lane ^ h.
#pragma unroll
  for (int h = 1; h < 32 && h < D; h <<= 1) {
#pragma unroll
    for (int k = 0; k < L::EPT; ++k) {
      const float o = __shfl_xor_sync(kFull, v[k], h);
      v[k] = (lane & h) ? o - v[k] : v[k] + o;
    }
  }
  // Stages across the warps of a group: through shared memory.
  if (L::TPF > 32) {
    const int g = threadIdx.x / L::TPF;
#pragma unroll
    for (int h = 32; h < L::TPF; h <<= 1) {
      float* b = buf + parity * (kThreads * L::EPT) + g * D;
#pragma unroll
      for (int k = 0; k < L::EPT; ++k) b[t + L::TPF * k] = v[k];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < L::EPT; ++k) {
        const float o = b[(t ^ h) + L::TPF * k];
        v[k] = (t & h) ? o - v[k] : v[k] + o;
      }
      parity ^= 1;
    }
  }
  // Stages within a thread's own registers: partner k ^ (h / TPF).
#pragma unroll
  for (int hk = 1; hk < L::EPT; hk <<= 1) {
#pragma unroll
    for (int k = 0; k < L::EPT; ++k) {
      if ((k & hk) == 0) {
        const float a = v[k], b2 = v[k | hk];
        v[k] = a + b2;
        v[k | hk] = a - b2;
      }
    }
  }
}

template <bool ONE_BIT>
__device__ __forceinline__ int code(float v, float scale) {
  if (ONE_BIT) return v >= 0.0f ? 1 : -1;
  return __float2int_rn(__fmul_rn(v, scale));
}

// QUANT: false -> float sums (beta weights, partials); true -> int32 codes.
template <int D, bool QUANT, bool ONE_BIT>
__global__ void __launch_bounds__(kThreads)
structured(const float* __restrict__ x, const float* __restrict__ diags,
           const float* __restrict__ radii, const float* __restrict__ dither,
           const float* __restrict__ rowv, int64_t n_pts, int n, int nblocks,
           float cscale, float qscale, int64_t rows_per_group,
           float* __restrict__ part_c, float* __restrict__ part_s,
           int* __restrict__ qcos, int* __restrict__ qsin) {
  using L = Layout<D>;
  __shared__ __align__(16) float xs[kTileFloats];
  __shared__ float rs[kMaxTileRows];
  __shared__ float buf[L::TPF > 32 ? 2 * kThreads * L::EPT : 1];

  const int g = threadIdx.x / L::TPF;  // frequency block within this CUDA block
  const int t = threadIdx.x % L::TPF;  // thread within the group
  const int fb = blockIdx.y * L::FB + g;
  const bool live = fb < nblocks;
  const int64_t fbase = (int64_t)(live ? fb : 0) * D;

  float sg[3][L::EPT], rad[L::EPT], dth[L::EPT];
#pragma unroll
  for (int k = 0; k < L::EPT; ++k) {
    const int e = t + L::TPF * k;
#pragma unroll
    for (int s = 0; s < 3; ++s) sg[s][k] = live ? diags[fbase * 3 + s * D + e] : 0.0f;
    rad[k] = live ? radii[fbase + e] : 0.0f;
    dth[k] = (QUANT && live) ? dither[fbase + e] : 0.0f;
  }
  float acc_c[L::EPT], acc_s[L::EPT];
  int iacc_c[L::EPT], iacc_s[L::EPT];
#pragma unroll
  for (int k = 0; k < L::EPT; ++k) {
    acc_c[k] = acc_s[k] = 0.0f;
    iacc_c[k] = iacc_s[k] = 0;
  }

  const int tile_rows = min(kMaxTileRows, kTileFloats / n);
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_group;
  const int64_t r1 = min(n_pts, r0 + rows_per_group);
  int parity = 0;
  for (int64_t t0 = r0; t0 < r1; t0 += tile_rows) {
    const int rows = (int)min((int64_t)tile_rows, r1 - t0);
    __syncthreads();  // the previous tile has been read by every thread
    const float* src = x + t0 * n;
    for (int e = threadIdx.x; e < rows * n; e += kThreads) xs[e] = src[e];
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      rs[r] = rowv ? rowv[t0 + r] : 1.0f;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      float v[L::EPT];
#pragma unroll
      for (int k = 0; k < L::EPT; ++k) {
        const int e = t + L::TPF * k;
        v[k] = e < n ? xs[r * n + e] : 0.0f;
      }
#pragma unroll
      for (int s = 0; s < 3; ++s) {
#pragma unroll
        for (int k = 0; k < L::EPT; ++k) v[k] *= sg[s][k];
        wht<D>(v, t, buf, parity);
#pragma unroll
        for (int k = 0; k < L::EPT; ++k) v[k] = __fmul_rn(v[k], cscale);
      }
      const float rw = rs[r];
#pragma unroll
      for (int k = 0; k < L::EPT; ++k) {
        float theta = __fmul_rn(v[k], rad[k]);
        if (QUANT) theta = __fadd_rn(theta, dth[k]);
        float s, c;
        sincosf(theta, &s, &c);
        if (QUANT) {
          const int vr = (int)rw;
          iacc_c[k] += code<ONE_BIT>(c, qscale) * vr;
          iacc_s[k] += code<ONE_BIT>(s, qscale) * vr;
        } else {
          acc_c[k] = fmaf(rw, c, acc_c[k]);
          acc_s[k] = fmaf(rw, s, acc_s[k]);
        }
      }
    }
  }
  if (!live) return;
  const int64_t width = (int64_t)nblocks * D;
#pragma unroll
  for (int k = 0; k < L::EPT; ++k) {
    const int64_t j = fbase + t + L::TPF * k;
    if (QUANT) {
      atomicAdd(qcos + j, iacc_c[k]);
      atomicAdd(qsin + j, iacc_s[k]);
    } else {
      part_c[(int64_t)blockIdx.x * width + j] = acc_c[k];
      part_s[(int64_t)blockIdx.x * width + j] = acc_s[k];
    }
  }
}

// Second pass of the float sums: partials summed in group order, in double.
__global__ void reduce_partials(const float* __restrict__ part_c,
                                const float* __restrict__ part_s, int groups,
                                int64_t width, float* __restrict__ out_c,
                                float* __restrict__ out_s) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  double c = 0.0, s = 0.0;
  for (int b = 0; b < groups; ++b) {
    c += (double)part_c[(int64_t)b * width + j];
    s += (double)part_s[(int64_t)b * width + j];
  }
  out_c[j] = (float)c;
  out_s[j] = (float)s;
}

template <bool QUANT, bool ONE_BIT>
int launch(int d, dim3 grid_rows, cudaStream_t stream, const float* x,
           const float* diags, const float* radii, const float* dither,
           const float* rowv, int64_t n_pts, int n, int nblocks, float cscale,
           float qscale, int64_t rows_per_group, float* part_c, float* part_s,
           int* qcos, int* qsin) {
#define STRUCTURED_CASE(DD)                                                   \
  case DD: {                                                                  \
    const dim3 grid(grid_rows.x, (nblocks + Layout<DD>::FB - 1) / Layout<DD>::FB); \
    structured<DD, QUANT, ONE_BIT><<<grid, kThreads, 0, stream>>>(            \
        x, diags, radii, dither, rowv, n_pts, n, nblocks, cscale, qscale,     \
        rows_per_group, part_c, part_s, qcos, qsin);                          \
    break;                                                                    \
  }
  switch (d) {
    STRUCTURED_CASE(32)
    STRUCTURED_CASE(64)
    STRUCTURED_CASE(128)
    STRUCTURED_CASE(256)
    STRUCTURED_CASE(512)
    STRUCTURED_CASE(1024)
    STRUCTURED_CASE(2048)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef STRUCTURED_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n_pts, n), diags (nblocks, 3, d), radii (nblocks, d), beta (n_pts,)
// float32, contiguous on the device; d a power of two in [32, 2048], n <= d.
// part_c / part_s: (groups, nblocks * d) scratch; out_c / out_s:
// (nblocks * d,).  groups * rows_per_group must cover n_pts.  cscale is the
// float32 d^-1/2.  Returns a cudaError_t code.
int structured_sketch_sums(const float* x, const float* diags,
                           const float* radii, const float* beta,
                           int64_t n_pts, int n, int d, int nblocks,
                           float cscale, int64_t rows_per_group, int groups,
                           float* part_c, float* part_s, float* out_c,
                           float* out_s, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = launch<false, false>(d, dim3(groups), stream, x, diags, radii,
                                 nullptr, beta, n_pts, n, nblocks, cscale,
                                 1.0f, rows_per_group, part_c, part_s, nullptr,
                                 nullptr);
  if (err != 0) return err;
  const int64_t width = (int64_t)nblocks * d;
  reduce_partials<<<(unsigned)((width + 255) / 256), 256, 0, stream>>>(
      part_c, part_s, groups, width, out_c, out_s);
  return (int)cudaGetLastError();
}

// As structured_sketch_sums, plus dither (nblocks, d) float32 and the code
// scale S (one_bit selects the sign code); valid (n_pts,) float32 or null.
// qcos / qsin: (nblocks * d,) int32, zeroed by the caller.
int quantized_structured_sketch_sums(const float* x, const float* diags,
                                     const float* radii, const float* dither,
                                     const float* valid, int64_t n_pts, int n,
                                     int d, int nblocks, float cscale,
                                     int one_bit, float scale,
                                     int64_t rows_per_group, int groups,
                                     int* qcos, int* qsin, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (one_bit) {
    return launch<true, true>(d, dim3(groups), stream, x, diags, radii, dither,
                              valid, n_pts, n, nblocks, cscale, scale,
                              rows_per_group, nullptr, nullptr, qcos, qsin);
  }
  return launch<true, false>(d, dim3(groups), stream, x, diags, radii, dither,
                             valid, n_pts, n, nblocks, cscale, scale,
                             rows_per_group, nullptr, nullptr, qcos, qsin);
}

const char* structured_sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

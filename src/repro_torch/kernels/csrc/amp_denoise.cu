// Truncated-normal posterior moments under a box prior (the CL-AMP input
// channel), on Hopper (sm_90a).
//
// Replaces src/repro/kernels/amp_denoise.py:amp_denoise_kernel (the Pallas
// TPU kernel, body _denoise_kernel).  For pseudo-data r (K, n), a scalar
// pseudo-variance q (read from device memory, already clamped positive by
// the caller) and box bounds lo, hi (n,), all float32, computes per entry
//     a = (lo - r)/sig,  b = (hi - r)/sig,        sig = sqrt(q)
//     Z = Phi(b) - Phi(a)                          (tail-stable, via erfc)
//     mean = r + sig (phi(a) - phi(b)) / Z
//     var  = q [1 + (a phi(a) - b phi(b))/Z - ((phi(a) - phi(b))/Z)^2]
// with the reference's three guards kept exactly:
//  1. Z from the erfc branch whose arguments are positive, chosen on
//     a + b > 0; a NaN a + b (an open box, a = -inf, b = +inf) fails the
//     comparison and takes the second branch, as XLA's select does;
//  2. a phi(a) and b phi(b) are 0 where a or b is not finite (inf * 0);
//  3. where Z <= 1e-12 the posterior collapses to clip(r, lo, hi) with
//     variance q 1e-6; finally mean is clipped to [lo, hi] and var to
//     [q 1e-12, q].
// Clips are max-then-min with comparisons that let a NaN through, as
// jnp.clip does.  expf, erfcf and sqrtf, never the fast __expf family; the
// two multiply-adds are explicit _rn operations, never contracted into an
// FMA, so every operation rounds where PyTorch's elementwise plain version
// rounds (the variance cancels terms of size frac^2, up to ~50, in the
// tails, which would magnify a contraction's different rounding).
//
// What bounds it on this card: the launch.  At the decoder's shape (K = n =
// 10) it is 100 entries of ~30 operations; even at (256, 130) it moves
// 400 KB.  Design: one thread per entry, one launch per call, the edges of
// K * n masked here (the TPU wrapper pads to (8, 128) tiles).  Five other
// designs were timed against it inside CUDA graphs (tools/amp_variants.py,
// amp_variants.cu: the a and b halves of an entry on a lane pair joined by
// shuffles; reciprocals of sigma and Z; a programmatic dependent launch;
// their combinations).  The reciprocals break the 1e-5 bar (1.05e-4 at
// q = 0.5: the variance's cancellation magnifies their rounding), and no
// other design moved the graphed GAMP iteration beyond its run-to-run
// spread (~2 us of ~818): the kernel sits at its launch's ceiling.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__global__ void __launch_bounds__(kThreads)
amp_denoise_kernel(const float* __restrict__ r, const float* __restrict__ q_ptr,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   int64_t total, int n, float* __restrict__ mean_out,
                   float* __restrict__ var_out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int l = (int)(i % n);
  const float q = __ldg(q_ptr);
  const float ri = r[i], lo_l = lo[l], hi_l = hi[l];
  const float sig = sqrtf(q);
  const float a = (lo_l - ri) / sig;
  const float b = (hi_l - ri) / sig;
  const float pa = kInvSqrt2Pi * expf(-0.5f * a * a);
  const float pb = kInvSqrt2Pi * expf(-0.5f * b * b);
  float z = 0.5f * (a + b > 0.0f
                        ? erfcf(a * kInvSqrt2) - erfcf(b * kInvSqrt2)
                        : erfcf(-b * kInvSqrt2) - erfcf(-a * kInvSqrt2));
  z = z < 1e-30f ? 1e-30f : z;
  const bool inside = z > 1e-12f;
  const float apa = isfinite(a) ? a * pa : 0.0f;
  const float bpb = isfinite(b) ? b * pb : 0.0f;
  const float frac = (pa - pb) / z;
  float mean = __fadd_rn(ri, __fmul_rn(sig, frac));
  float var = q * __fsub_rn(1.0f + (apa - bpb) / z, __fmul_rn(frac, frac));
  if (!inside) {
    mean = clip(ri, lo_l, hi_l);
    var = q * 1e-6f;
  }
  mean_out[i] = clip(mean, lo_l, hi_l);
  var_out[i] = clip(var, q * 1e-12f, q);
}

}  // namespace

extern "C" {

// r (k, n) float32, q a float32 scalar, lo and hi (n,) float32, all
// contiguous on the device; mean_out and var_out (k, n) float32 outputs.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for n < 1 or k < 0.
int amp_denoise(const float* r, const float* q, const float* lo, const float* hi,
                int64_t k, int n, float* mean_out, float* var_out,
                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || k < 0) return (int)cudaErrorInvalidValue;
  const int64_t total = k * n;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  amp_denoise_kernel<<<blocks, kThreads, 0, stream>>>(r, q, lo, hi, total, n,
                                                      mean_out, var_out);
  return (int)cudaGetLastError();
}

const char* amp_denoise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Designs of kernel 7 (amp_denoise, the CL-AMP truncated-normal denoiser)
// measured against each other by tools/amp_variants.py: one template, three
// choices, each entry point with the C interface of
// kernels/csrc/amp_denoise.cu's amp_denoise().
//
//  * PAIR: the a (lower edge) and b (upper edge) halves of an entry on two
//    neighbouring lanes: each computes its edge's standardised distance t,
//    phi(t), t phi(t) and its erfc term, and the pair joins them by
//    __shfl_xor_sync; the lower lane writes the mean, the upper the
//    variance.  Otherwise one thread an entry.
//  * PDL: programmatic dependent launch (sm_90): launched by
//    cudaLaunchKernelEx with programmatic stream serialization, the kernel
//    reads lo and hi and does its index math, then waits
//    (griddepcontrol.wait) for the kernel before it, which writes r and q.
//  * RCP: one reciprocal of sigma and one of Z (__frcp_rn), and multiplies
//    by them where the plain version divides: a, b, the mean's and the
//    variance's fractions round differently from the plain version.
//
// Every choice keeps the reference's three guards (the erfc branch on
// a + b > 0, a NaN taking the second; zero boundary terms at infinite
// edges; the collapse at Z <= 1e-12) and the NaN-passing clips.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ void wait_for_producer() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float divide(float x, float y, float inv, bool rcp) {
  return rcp ? __fmul_rn(x, inv) : x / y;
}

// The moments of one entry from its a, b terms (pa = phi(a), apa = a phi(a),
// ...) and erfc difference z; writes the mean (want_mean) and/or the var.
template <bool RCP>
__device__ __forceinline__ void moments(float ri, float q, float sig, float lo_l, float hi_l,
                                        float pa, float pb, float apa, float bpb, float z,
                                        float* mean_out, float* var_out, bool want_mean,
                                        bool want_var) {
  z = z < 1e-30f ? 1e-30f : z;
  const bool inside = z > 1e-12f;
  const float iz = RCP ? __frcp_rn(z) : 0.0f;
  const float frac = divide(pa - pb, z, iz, RCP);
  float mean = __fadd_rn(ri, __fmul_rn(sig, frac));
  float var = q * __fsub_rn(__fadd_rn(1.0f, divide(apa - bpb, z, iz, RCP)), __fmul_rn(frac, frac));
  if (!inside) {
    mean = clip(ri, lo_l, hi_l);
    var = q * 1e-6f;
  }
  if (want_mean) *mean_out = clip(mean, lo_l, hi_l);
  if (want_var) *var_out = clip(var, q * 1e-12f, q);
}

template <bool PAIR, bool PDL, bool RCP>
__global__ void __launch_bounds__(kThreads)
amp_denoise_kernel(const float* __restrict__ r, const float* __restrict__ q_ptr,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   int64_t total, int n, float* __restrict__ mean_out,
                   float* __restrict__ var_out) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (!PAIR) {
    if (g >= total) return;
    const int l = (int)(g % n);
    const float lo_l = __ldg(lo + l), hi_l = __ldg(hi + l);
    if (PDL) wait_for_producer();
    const float q = __ldg(q_ptr);
    const float ri = r[g];
    const float sig = sqrtf(q);
    const float is = RCP ? __frcp_rn(sig) : 0.0f;
    const float a = divide(lo_l - ri, sig, is, RCP);
    const float b = divide(hi_l - ri, sig, is, RCP);
    const float pa = kInvSqrt2Pi * expf(-0.5f * a * a);
    const float pb = kInvSqrt2Pi * expf(-0.5f * b * b);
    const float z = 0.5f * (a + b > 0.0f ? erfcf(a * kInvSqrt2) - erfcf(b * kInvSqrt2)
                                         : erfcf(-b * kInvSqrt2) - erfcf(-a * kInvSqrt2));
    const float apa = isfinite(a) ? a * pa : 0.0f;
    const float bpb = isfinite(b) ? b * pb : 0.0f;
    moments<RCP>(ri, q, sig, lo_l, hi_l, pa, pb, apa, bpb, z, mean_out + g, var_out + g, true,
                 true);
    return;
  }
  // A lane pair an entry: every lane runs to the shuffles, and a pair past
  // the end computes entry 0 and writes nothing.
  const int64_t i = g >> 1;
  const bool upper = g & 1, live = i < total;
  const int64_t ic = live ? i : 0;
  const int l = (int)(ic % n);
  const float lo_l = __ldg(lo + l), hi_l = __ldg(hi + l);
  if (PDL) wait_for_producer();
  const float q = __ldg(q_ptr);
  const float ri = r[ic];
  const float sig = sqrtf(q);
  const float is = RCP ? __frcp_rn(sig) : 0.0f;
  const float t = divide((upper ? hi_l : lo_l) - ri, sig, is, RCP);  // a or b
  const float o = __shfl_xor_sync(kFull, t, 1);
  const float a = upper ? o : t, b = upper ? t : o;
  const bool right = a + b > 0.0f;  // NaN: false, the second branch
  const float p = kInvSqrt2Pi * expf(-0.5f * t * t);
  // The branch's erfc term of this lane's edge: erfc(a/sqrt2), erfc(b/sqrt2)
  // or erfc(-a/sqrt2), erfc(-b/sqrt2).
  const float e = erfcf((right ? t : -t) * kInvSqrt2);
  const float tp = isfinite(t) ? t * p : 0.0f;
  const float po = __shfl_xor_sync(kFull, p, 1);
  const float eo = __shfl_xor_sync(kFull, e, 1);
  const float tpo = __shfl_xor_sync(kFull, tp, 1);
  const float ea = upper ? eo : e, eb = upper ? e : eo;
  const float z = 0.5f * (right ? ea - eb : eb - ea);
  if (live)
    moments<RCP>(ri, q, sig, lo_l, hi_l, upper ? po : p, upper ? p : po, upper ? tpo : tp,
                 upper ? tp : tpo, z, mean_out + ic, var_out + ic, !upper, upper);
}

template <bool PAIR, bool PDL, bool RCP>
int launch(const float* r, const float* q, const float* lo, const float* hi, int64_t k, int n,
           float* mean_out, float* var_out, void* stream_ptr) {
  if (n < 1 || k < 0) return (int)cudaErrorInvalidValue;
  const int64_t total = k * n;
  if (total == 0) return 0;
  const int64_t threads = PAIR ? 2 * total : total;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((threads + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream_ptr);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = PDL ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, amp_denoise_kernel<PAIR, PDL, RCP>, r, q, lo, hi, total,
                                 n, mean_out, var_out);
}

}  // namespace

extern "C" {

#define AMP_VARIANT(NAME, PAIR, PDL, RCP)                                                    \
  int NAME(const float* r, const float* q, const float* lo, const float* hi, int64_t k,      \
           int n, float* mean_out, float* var_out, void* stream) {                           \
    return launch<PAIR, PDL, RCP>(r, q, lo, hi, k, n, mean_out, var_out, stream);           \
  }

AMP_VARIANT(amp_denoise_single, false, false, false)
AMP_VARIANT(amp_denoise_single_pdl, false, true, false)
AMP_VARIANT(amp_denoise_pair, true, false, false)
AMP_VARIANT(amp_denoise_pair_pdl, true, true, false)
AMP_VARIANT(amp_denoise_pair_pdl_rcp, true, true, true)
AMP_VARIANT(amp_denoise_single_pdl_rcp, false, true, true)

const char* amp_denoise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

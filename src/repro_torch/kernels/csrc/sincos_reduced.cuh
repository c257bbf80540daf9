// sin and cos of a float32 phase on the special-function unit (SFU), after an
// exact reduction to [-pi, pi], and the 1-bit QCKM codes of the same phase
// without trig.  Included by fourier_sketch.cu (kernel 1),
// quantized_fourier_sketch.cu (kernel 3), structured_sketch.cu (kernels 4-5)
// and sketch_shift.cu (kernel 6); the one place in the kernels where a fast
// trig intrinsic appears.
//
// A full-precision sincosf is tens of FP32-pipe instructions while the SFU
// idles, and the SFU's __sincosf is accurate only on [-pi, pi] (sketch phases
// reach tens of radians, and the smoke run's large-phase cases 10^3-10^4).
//
//  * reduce_2pi(): k = rint(p / 2pi) comes from one FMA against 1.5 * 2^23
//    (round to nearest on the FP32 pipe, no conversion instruction);
//    r = p - 2pi k is a two-constant Cody-Waite step in fmaf, with
//    2pi = kTwoPiHi + kTwoPiLo (the rest, 6.9e-15, is dropped).  The first
//    fmaf is exact: kTwoPiHi k and p both lie on the 2^-21 grid and |r| < 4.
//    The second rounds once.  For |p| <= 1e5 (|k| <= 15,916) r lies within
//    [-pi - 0.004, pi + 0.004] and within 1.2e-7 of the exact p mod 2pi
//    (tests/test_torch_kernels.py emulates the reduction in float32 up to
//    |p| = 1e6).  Past |p| = 1e5 the bound still holds up to about 2.6e7,
//    where the rounding of p / 2pi starts to misplace k.
//  * sincos_reduced(): __sincosf on r adds at most 2^-21.41 = 3.6e-7 on
//    [-pi, pi] (CUDA Programming Guide), some 300x under the 1e-4 bar on
//    sums / N.  Per phase: four FP32 instructions for the reduction, one
//    scaling the argument into the SFU's units, and two SFU operations
//    (sin, cos) at 16 per clock per SM.
//  * one_bit_signs(): the signs of cos p and sin p, read off the reduced r
//    in [-pi - 0.004, pi + 0.004] with no trig at all: cos r >= 0 <=>
//    |r| <= pi/2, and sin r >= 0 <=> (r >= 0) != (|r| > pi).  A NaN phase
//    (or an infinite one, which reduces to NaN) gives false for both, the
//    code -1, as c >= 0 ? 1 : -1 does for the NaN that cos and sin return.
//    A code can differ from the sign of the exact cos or sin only within
//    about 1e-6 rad of a boundary (tests/test_torch_structured.py holds the
//    rule against float64 signs up to |p| = 1e5).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kInv2Pi = 0.15915493667125702f;       // float(1 / 2pi)
constexpr float kTwoPiHi = 6.2831854820251465f;       // float(2pi)
constexpr float kTwoPiLo = -1.7484555314695172e-07f;  // float(2pi - kTwoPiHi)
constexpr float kRoundMagic = 12582912.0f;            // 1.5 * 2^23
constexpr float kHalfPi = 1.5707963705062866f;        // float(pi / 2)
constexpr float kPi = 3.1415927410125732f;            // float(pi)

// p - 2pi rint(p / 2pi), as described above.
__device__ __forceinline__ float reduce_2pi(float p) {
  const float k = fmaf(p, kInv2Pi, kRoundMagic) - kRoundMagic;
  const float r = fmaf(-k, kTwoPiHi, p);
  return fmaf(-k, kTwoPiLo, r);
}

// sin(p) and cos(p) on the SFU after the exact reduction.
__device__ __forceinline__ void sincos_reduced(float p, float* s, float* c) {
  __sincosf(reduce_2pi(p), s, c);
}

// Whether cos(p) >= 0 and sin(p) >= 0 (the 1-bit codes +1), as described
// above.
__device__ __forceinline__ void one_bit_signs(float p, bool* cos_pos, bool* sin_pos) {
  const float r = reduce_2pi(p);
  *cos_pos = fabsf(r) <= kHalfPi;
  *sin_pos = (r >= 0.0f) != (fabsf(r) > kPi);
}

}  // namespace

// Flash attention, forward (online softmax), on Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_kernel (the
// Pallas TPU kernel, body _flash_kernel).  For q (BH, S_q, hd) and k, v
// (BKV, S_kv, hd), all float32 or all bfloat16, contiguous, q row h reading
// k/v row h / rep (GQA), computes
//     o[h, i]   = sum_j softmax_j(s_ij) v[h / rep, j]      (in q's dtype)
//     lse[h, i] = m_i + log(l_i)                            (float32)
// with s_ij = (q_i * scale) . k_j, scale = 1/sqrt(hd), and the causal
// (i >= j) and sliding-window (i - j < window) masks from absolute
// positions.  As in the reference, a masked score is -1e30 (never -inf):
// while a row has met no key its running max is -1e30 and every masked
// entry weighs exp(0) = 1, and the first real key wipes that with
// alpha = exp(-1e30 - m) = 0.  A row with no key at all (causal with a
// window and S_q > S_kv) thus ends with the mean of V over its S_kv keys
// and lse = -1e30 + log(S_kv), which is -1e30 in float32.  Positions at or
// past S_kv are absent, not masked: they weigh 0 (the ragged edge is
// masked here; the TPU wrapper pads).  Accumulators, the running max and
// sum are float32; the output divides by max(l, 1e-30), as the reference
// does.
//
// What bounds it on this card: operations.  Per (q, k) pair it does hd
// multiply-adds for the score and hd for the output; at S = 4096 a causal
// head of width 64 is ~2e9 operations and reads under 2 MB.  The tensor
// cores would bound it (989 TFLOP/s in bf16); this first version uses
// plain float32 FMA for both dtypes (67 TFLOP/s peak), and its inner
// products read both operands from shared memory, so shared-memory
// bandwidth, not the FMA rate, is its ceiling.  wgmma and TMA are later
// work.
//
// Design: one block of 256 threads per (bh, tile of 64 q rows).  The q
// tile (pre-scaled, float32) and each 64-row K / V tile are staged in
// dynamic shared memory (above 48 KB: 209 KB at hd = 256), zero-filled past
// hd and past S_kv, so no padding copy is made.  A 16 x 16 thread grid
// computes the 64 x 64 score tile as 4 x 4 register micro-tiles (rows
// ty + 16 i, columns tx + 16 j; the q and k tiles' rows are padded to an
// odd stride, so the strided reads hit distinct banks), reduces each row's
// max and sum across its 16 lanes with xor shuffles (the same value in
// every lane), stages P in shared memory and accumulates O (rows ty + 16 i,
// columns tx + 16 j) in registers.  hd is a multiple of 8 up to 256; the
// tiles are padded to the next of 32, 64, 128, 256 (a template argument).
// KV tiles that the masks cover wholly for every row of the block are
// skipped: before a row's first key they would be wiped by alpha = 0,
// after it they add exp(-1e30 - m) = 0, so the result is unchanged.  A
// block holding a row with no key visits every tile, so that row keeps the
// reference's mean over all S_kv keys.  No atomics: each output is written
// by one thread, so the result repeats bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // k / v rows per tile
constexpr int kPS = kBK + 1;  // row stride of the P tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(2 * kBQ * (HDP + 1) + kBK * HDP + kBQ * kPS);
}

// Sum or max over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int s_q, int s_kv, int hd,
          int rep, int causal, int window, float scale) {
  constexpr int QS = HDP + 1;  // odd row stride of the q and k tiles
  constexpr int OD = HDP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // (kBQ, QS)
  float* ks = qs + kBQ * QS;   // (kBK, QS)
  float* vs = ks + kBK * QS;   // (kBK, HDP)
  float* ps = vs + kBK * HDP;  // (kBQ, kPS)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int64_t qbase = (int64_t)bh * s_q * hd;
  const int64_t kbase = (int64_t)(bh / rep) * s_kv * hd;

  for (int e = tid; e < kBQ * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP;
    float x = 0.0f;
    if (q0 + r < s_q && d < hd) x = to_f32(q[qbase + (int64_t)(q0 + r) * hd + d]) * scale;
    qs[r * QS + d] = x;
  }

  float acc[4][OD];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kMasked;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < OD; ++j) acc[i][j] = 0.0f;
  }

  // The kv range the masks leave open for some row of this block; every
  // tile when a row has no key at all.
  const int q_last = min(q0 + kBQ, s_q) - 1;
  int k_begin = 0, k_end = s_kv;
  const bool keyless_row = window > 0 && q_last - window + 1 > s_kv - 1;
  if (!keyless_row) {
    if (window > 0) k_begin = max(0, q0 - window + 1) / kBK * kBK;
    if (causal) k_end = min(s_kv, q_last + 1);
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * HDP; e += kThreads) {
      const int r = e / HDP, d = e % HDP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < s_kv && d < hd) {
        const int64_t off = kbase + (int64_t)(k0 + r) * hd + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[r * QS + d] = kx;
      vs[r * HDP + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool masked = causal && qp < kp;
        masked |= window > 0 && qp - kp >= window;
        s[i][j] = kp >= s_kv ? -INFINITY : (masked ? kMasked : s[i][j]);
        mx = fmaxf(mx, s[i][j]);
      }
      // Column k0 is present in every tile, so the max is >= -1e30.
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // absent: exp(-inf) = 0
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + row_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < OD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int c_end = min(kBK, s_kv - k0);
#pragma unroll 2
    for (int c = 0; c < c_end; ++c) {
      float p[4], vv[OD];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < OD; ++j) vv[j] = vs[c * HDP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OD; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= s_q) continue;
    const float l_safe = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < OD; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(&o[qbase + (int64_t)qp * hd + d], acc[i][j] / l_safe);
    }
    if (tx == 0) lse[(int64_t)bh * s_q + qp] = m_run[i] + logf(l_safe);
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
           int s_q, int s_kv, int hd, int rep, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + kBQ - 1) / kBQ, bh);
  flash_fwd<T, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, s_q, s_kv, hd, rep, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
             int s_q, int s_kv, int hd, int rep, int causal, int window, float scale,
             cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, lse, bh, s_q, s_kv, hd, rep, causal, window, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, lse, bh, s_q, s_kv, hd, rep, causal, window, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, lse, bh, s_q, s_kv, hd, rep, causal, window, scale, stream);
  return launch<T, 256>(q, k, v, o, lse, bh, s_q, s_kv, hd, rep, causal, window, scale, stream);
}

}  // namespace

extern "C" {

// q (bh, s_q, hd), k and v (bh / rep, s_kv, hd), o like q: float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1), contiguous on the device; lse
// (bh, s_q) float32.  hd a multiple of 8 in [8, 256], s_q, s_kv >= 1,
// bh <= 65535, window >= 0 (0: none).  scale is the float32 1/sqrt(hd).
// Returns a cudaError_t code.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int bh, int s_q, int s_kv, int hd, int rep, int causal, int window,
                        float scale, int is_bf16, cudaStream_t stream) {
  if (hd < 8 || hd > 256 || hd % 8 != 0 || s_q < 1 || s_kv < 1 || bh < 1 || bh > 65535 ||
      rep < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, s_q, s_kv, hd, rep, causal, window,
                                   scale, stream);
  return dispatch<float>(q, k, v, o, lse, bh, s_q, s_kv, hd, rep, causal, window, scale,
                         stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

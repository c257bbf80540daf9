// Fused nearest-centroid assignment on Hopper (sm_90a).
//
// Replaces src/repro/kernels/assign_argmin.py:assign_argmin_kernel (the
// Pallas TPU kernel, body _assign_kernel).  For x (N, n) and c (K, n), both
// float32, computes per point
//     labels[i] = argmin_k (||c_k||^2 - 2 x_i . c_k)      (int32, ties -> lowest k)
//     dist[i]   = min_k    (||c_k||^2 - 2 x_i . c_k) + ||x_i||^2
// with the same expression order as the TPU kernel; the (N, K) distance
// matrix never reaches device memory.
//
// What bounds it on this card: bytes.  It reads each point once (4n bytes)
// and writes 8 bytes a point; with K = 10 centroids that is 2nK = 200 FLOP
// per 48 bytes, about 4 FLOP per byte, far below the ~20 FLOP per byte at
// which FP32 arithmetic would become the limit.
//
// Design: one thread per point, its row held in registers (padded to NP, a
// multiple of 4, with zeros that add nothing to a dot product).  The
// centroids and their squared norms sit in shared memory, in tiles when K is
// large, and every thread loops over exactly K centroids with broadcast
// 16-byte loads: no phantom centroids pad K (the TPU wrapper pads K with
// 1e18 rows).  The argmin takes strict '<', so ties go to the lowest index
// as jnp.argmin does.  Feature widths above 64 take a generic kernel that
// reads the point through the read-only cache.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // points per block, one per thread
constexpr int kSmemFloats = 48 * 1024 / 4;  // static-launch shared budget

template <int NP>
__global__ void __launch_bounds__(kThreads)
assign_argmin_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int64_t n_pts, int n, int k, int k_tile,
                     int* __restrict__ labels, float* __restrict__ dist) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                  // (k_tile, NP) centroid tile
  float* c2s = smem + k_tile * NP;   // (k_tile,) squared norms

  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n_pts;
  float xr[NP];
#pragma unroll
  for (int f = 0; f < NP; ++f) xr[f] = (active && f < n) ? x[i * n + f] : 0.0f;

  float best = INFINITY;
  int best_k = 0;
  for (int k0 = 0; k0 < k; k0 += k_tile) {
    const int kt = min(k_tile, k - k0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int e = threadIdx.x; e < kt * NP; e += kThreads) {
      const int q = e / NP, f = e - q * NP;
      cs[e] = f < n ? c[(int64_t)(k0 + q) * n + f] : 0.0f;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < kt; q += kThreads) {
      float s = 0.0f;
      for (int f = 0; f < n; ++f) s = fmaf(cs[q * NP + f], cs[q * NP + f], s);
      c2s[q] = s;
    }
    __syncthreads();
    for (int q = 0; q < kt; ++q) {
      const float4* cq = reinterpret_cast<const float4*>(cs + q * NP);
      float xc = 0.0f;
#pragma unroll
      for (int v = 0; v < NP / 4; ++v) {
        const float4 cv = cq[v];
        xc = fmaf(xr[4 * v + 0], cv.x, xc);
        xc = fmaf(xr[4 * v + 1], cv.y, xc);
        xc = fmaf(xr[4 * v + 2], cv.z, xc);
        xc = fmaf(xr[4 * v + 3], cv.w, xc);
      }
      const float d = c2s[q] - 2.0f * xc;
      if (d < best) {
        best = d;
        best_k = k0 + q;
      }
    }
  }
  if (active) {
    float x2 = 0.0f;
#pragma unroll
    for (int f = 0; f < NP; ++f) x2 = fmaf(xr[f], xr[f], x2);
    labels[i] = best_k;
    dist[i] = best + x2;
  }
}

// Any feature width: the point is read through the read-only cache.
__global__ void __launch_bounds__(kThreads)
assign_argmin_generic(const float* __restrict__ x, const float* __restrict__ c,
                      int64_t n_pts, int n, int k, int k_tile,
                      int* __restrict__ labels, float* __restrict__ dist) {
  extern __shared__ float smem_g[];
  float* cs = smem_g;               // (k_tile, n)
  float* c2s = smem_g + k_tile * n;  // (k_tile,)

  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n_pts;
  const float* xi = x + (active ? i : 0) * n;
  float best = INFINITY;
  int best_k = 0;
  for (int k0 = 0; k0 < k; k0 += k_tile) {
    const int kt = min(k_tile, k - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < kt * n; e += kThreads) cs[e] = c[(int64_t)k0 * n + e];
    __syncthreads();
    for (int q = threadIdx.x; q < kt; q += kThreads) {
      float s = 0.0f;
      for (int f = 0; f < n; ++f) s = fmaf(cs[q * n + f], cs[q * n + f], s);
      c2s[q] = s;
    }
    __syncthreads();
    for (int q = 0; q < kt; ++q) {
      float xc = 0.0f;
      for (int f = 0; f < n; ++f) xc = fmaf(__ldg(xi + f), cs[q * n + f], xc);
      const float d = c2s[q] - 2.0f * xc;
      if (d < best) {
        best = d;
        best_k = k0 + q;
      }
    }
  }
  if (active) {
    float x2 = 0.0f;
    for (int f = 0; f < n; ++f) x2 = fmaf(__ldg(xi + f), __ldg(xi + f), x2);
    labels[i] = best_k;
    dist[i] = best + x2;
  }
}

template <int NP>
int launch(const float* x, const float* c, int64_t n_pts, int n, int k,
           int* labels, float* dist, cudaStream_t stream) {
  const int k_tile = min(k, kSmemFloats / (NP + 1));
  const size_t smem = (size_t)k_tile * (NP + 1) * sizeof(float);
  const unsigned blocks = (unsigned)((n_pts + kThreads - 1) / kThreads);
  assign_argmin_kernel<NP><<<blocks, kThreads, smem, stream>>>(
      x, c, n_pts, n, k, k_tile, labels, dist);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n_pts, n), c (k, n) float32, contiguous, on the device; labels (n_pts,)
// int32 and dist (n_pts,) float32 outputs.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue when k < 1 or one centroid row does not fit in
// shared memory.
int assign_argmin(const float* x, const float* c, int64_t n_pts, int n, int k,
                  int* labels, float* dist, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || n < 1 || n + 1 > kSmemFloats) return (int)cudaErrorInvalidValue;
  if (n_pts == 0) return 0;
  if (n <= 4) return launch<4>(x, c, n_pts, n, k, labels, dist, stream);
  if (n <= 8) return launch<8>(x, c, n_pts, n, k, labels, dist, stream);
  if (n <= 12) return launch<12>(x, c, n_pts, n, k, labels, dist, stream);
  if (n <= 16) return launch<16>(x, c, n_pts, n, k, labels, dist, stream);
  if (n <= 32) return launch<32>(x, c, n_pts, n, k, labels, dist, stream);
  if (n <= 64) return launch<64>(x, c, n_pts, n, k, labels, dist, stream);
  const int k_tile = min(k, kSmemFloats / (n + 1));
  const size_t smem = (size_t)k_tile * (n + 1) * sizeof(float);
  const unsigned blocks = (unsigned)((n_pts + kThreads - 1) / kThreads);
  assign_argmin_generic<<<blocks, kThreads, smem, stream>>>(
      x, c, n_pts, n, k, k_tile, labels, dist);
  return (int)cudaGetLastError();
}

const char* assign_argmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused nearest-centroid assignment on Hopper (sm_90a).
//
// Replaces src/repro/kernels/assign_argmin.py:assign_argmin_kernel (the
// Pallas TPU kernel, body _assign_kernel).  For x (N, n) and c (K, n), both
// float32, computes per point
//     labels[i] = argmin_k (||c_k||^2 - 2 x_i . c_k)      (int32, ties -> lowest k)
//     dist[i]   = min_k    (||c_k||^2 - 2 x_i . c_k) + ||x_i||^2
// with the TPU kernel's expression order; the (N, K) distance matrix never
// reaches device memory.  The argmin takes strict '<' from a best of +inf,
// so a NaN never wins (a row with no distance below +inf gets label 0); a
// merge across threads compares (d, k) pairs, so the lowest index still
// wins a tie.  No atomics and a fixed reduction order: two
// launches give the same bits.
//
// What bounds it on this card.  A point costs 4n + 8 bytes (its row, its
// label and distance) and 2nK FLOP, so the work is bound by bytes while
// 2nK / (4n + 8) stays under the card's 67 TFLOP/s / 3.35 TB/s = 20 FLOP a
// byte, i.e. K below about 40 at any n, and by FP32 operations above.  The
// TPU kernel does the (bN, n) x (n, K) tile on the MXU; here TF32 tensor
// cores would keep about three digits, too few for the distance bar, so the
// products are FP32 FFMAs.  Two paths, picked by the wrapper's launch plan
// (kernels/assign_argmin.py, assign_plan), which this file checks:
//
// The point path (n <= 16, or n <= 64 and n K < 1536; the main path's
// n = K = 10):
// one thread a point, its row in registers (padded to NP, a multiple of 4,
// with zeros that add nothing to a dot product); the centroids and their
// squared norms in shared memory, in tiles when K is large, read by
// broadcast 16-byte loads.  One row is read once, coalesced enough at
// small n: the kernel runs at the byte bound's pace there.
//
// The tile path (n > 64, or 16 < n and n K >= 1536): an SGEMM-shaped
// kernel.  The switch is where the tile path started to win at N = 10^6:
// from K = 48 at n = 32, from K = 32 at n = 64, at no K up to 128 at
// n <= 16, where a chunk of 32 features is mostly padding.
//  * A CTA of 256 threads owns kBM = 64 points; N = 8129 (the LM's KV
//    shape) makes 128 CTAs for the 132 SMs.  A 128-point tile would leave
//    half the card idle there; splitting K across CTAs would need a second
//    pass to merge.
//  * Centroids come in tiles of kBN = 64; the feature axis in chunks of
//    kBK = 32.  Each chunk of centroids (and of points) is copied by
//    cp.async (16-byte granules where rows are 16-byte aligned, else 4-byte
//    ones, each a template instance; zero-filled past N, K and n) into a
//    double-buffered ring in dynamic shared memory: the next chunk in
//    flight while this one is used, one barrier a chunk.  Rings of 3 and 4
//    stages were no faster (tools/kernel_variants.py).
//  * Points are staged once: with one centroid tile every point chunk is
//    read once anyway, and with several the point rows stay resident
//    (kBM x n floats) while the centroid tiles stream past them, where two
//    CTAs still fit an SM (n <= 352).  Wider rows stream with the
//    centroids and are re-read per centroid tile, from L2: at K = 300,
//    resident rows won at n = 256 and lost at n = 512 and 736 (one CTA an
//    SM).
//  * Each thread keeps a 4 x 4 register micro-tile of dot products (points
//    ty + 16 i, centroids tx + 16 j), fed by 16-byte shared loads from rows
//    of stride 4 (mod 8) floats, so a quarter-warp's loads hit distinct
//    banks: 16 independent FFMA chains, 64 FFMAs per 8 loads.  (An 8 x 8
//    micro-tile, with the CTA's threads split into four slices of the
//    feature axis whose sums meet in shared memory, halves the loads an
//    FFMA but was slower at every timed shape: it spilled at 128 registers
//    and, given 255, left one CTA an SM.)
//  * Squared norms come from the same staged chunks (a thread sums 8
//    features of one row, four threads combine by shuffles); a tile's
//    epilogue forms c2 - 2 x.c and keeps a running (min, argmin) per point
//    in registers; at the end the 16 threads of a point merge their pairs
//    by shuffles and one exchange through shared memory, and add ||x||^2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

// ---------------------------------------------------------------- point path

constexpr int kThreads = 256;            // points per block, one per thread
constexpr int kSmemFloats = 48 * 1024 / 4;  // static-launch shared budget

template <int NP>
__global__ void __launch_bounds__(kThreads)
assign_points(const float* __restrict__ x, const float* __restrict__ c,
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

// The row width a point-path instance holds, or 0 past 64.
int point_np(int n) {
  return n <= 4 ? 4 : n <= 8 ? 8 : n <= 12 ? 12 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 0;
}

int point_k_tile(int np, int k) { return min(k, kSmemFloats / (np + 1)); }

template <int NP>
void launch_points(const float* x, const float* c, int64_t n_pts, int n, int k,
                   int64_t grid, size_t smem, int* labels, float* dist, cudaStream_t stream) {
  assign_points<NP><<<(unsigned)grid, kThreads, smem, stream>>>(
      x, c, n_pts, n, k, point_k_tile(NP, k), labels, dist);
}

// ----------------------------------------------------------------- tile path

constexpr int kBM = 64;             // points a CTA
constexpr int kBN = 64;             // centroids a tile
constexpr int kBK = 32;             // features a chunk
constexpr int kStages = 2;          // chunks in the ring: one in flight
constexpr int kCStride = kBK + 4;   // floats a staged centroid row (36 = 4 mod 8)

// Floats a staged point row: the whole padded row when resident, else one
// chunk a stage of the ring; 4 mod 8 either way, so rows fall on distinct
// banks.
__host__ __device__ inline int x_stride(int n, bool resident) {
  return resident ? (n + kBK - 1) / kBK * kBK + 4 : kStages * kBK + 4;
}

// Dynamic shared memory of the tile kernel: the point rows, the ring's
// centroid chunks, the tile's c2, the points' x2, and the (d, k) pairs of
// the cross-warp merge.
size_t tile_smem(int n, bool resident) {
  return sizeof(float) * ((size_t)kBM * x_stride(n, resident) + kStages * kBN * kCStride + kBN +
                          2 * kBM) +
         sizeof(int) * kBM;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Rows [row0, row0 + 64) and features [f0, f0 + kBK) of src (rows x n) into
// dst (row stride `stride` floats), zero past `rows` and n.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* __restrict__ src,
                                           int64_t row0, int64_t rows, int n, int f0) {
  static_assert(kBM == kBN, "points and centroids are staged by one routine");
  const int tid = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < kBM * kBK / 4 / kThreads; ++s) {
      const int g = tid + kThreads * s, r = g / (kBK / 4), q = g % (kBK / 4);
      const int64_t row = row0 + r;
      const int f = f0 + 4 * q;
      const bool ok = row < rows && f < n;  // n % 4 == 0: a granule is all in or all out
      cp_async16(dst + r * stride + 4 * q, ok ? src + row * n + f : src, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kBM * kBK / kThreads; ++s) {
      const int e = tid + kThreads * s, r = e / kBK, q = e % kBK;
      const int64_t row = row0 + r;
      const int f = f0 + q;
      const bool ok = row < rows && f < n;
      cp_async4(dst + r * stride + q, ok ? src + row * n + f : src, ok ? 4 : 0);
    }
  }
}

// (d, k) pairs: the smaller d, and the lower k on a tie.  best is never NaN.
__device__ __forceinline__ void take_min(float& best, int& best_k, float d, int kk) {
  if (d < best || (d == best && kk < best_k)) {
    best = d;
    best_k = kk;
  }
}

// VEC: rows are staged in 16-byte granules (n % 4 == 0, 16-byte aligned
// bases), else in 4-byte ones.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
assign_tiles(const float* __restrict__ x, const float* __restrict__ c, int64_t n_pts, int n,
             int k, int resident, int* __restrict__ labels, float* __restrict__ dist) {
  extern __shared__ __align__(16) float smem[];
  const int xstr = x_stride(n, resident);
  float* xs = smem;                      // (kBM, xstr) point rows
  float* cs = xs + kBM * xstr;                 // kStages x (kBN, kCStride) centroid chunks
  float* c2s = cs + kStages * kBN * kCStride;  // (kBN,) the tile's ||c||^2
  float* x2s = c2s + kBN;                // (kBM,) ||x||^2
  float* red_d = x2s + kBM;              // (kBM,) odd warps' pairs
  int* red_k = reinterpret_cast<int*>(red_d + kBM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (lane & 7) + 8 * (warp & 1);    // centroids tx + 16 j of a tile
  const int ty = (lane >> 3) + 4 * (warp >> 1);  // points ty + 16 i of the CTA
  const int sr = tid >> 2, sf = 8 * (tid & 3);   // squares: row sr, features sf..sf+7
  const int64_t p0 = (int64_t)blockIdx.x * kBM;
  const int nch = (n + kBK - 1) / kBK;
  const int tiles = (k + kBN - 1) / kBN;
  const int steps = tiles * nch;

  // Step t stages chunk ch of centroid tile kt (and of the points) into
  // ring stage t % kStages, as one cp.async group (empty past the last step).
  auto issue = [&](int t) {
    if (t < steps) {
      const int kt = t / nch, ch = t - kt * nch, stage = t % kStages;
      if (!resident || kt == 0)
        stage_rows<VEC>(xs + (resident ? ch : stage) * kBK, xstr, x, p0, n_pts, n, ch * kBK);
      stage_rows<VEC>(cs + stage * kBN * kCStride, kCStride, c, (int64_t)kt * kBN, k, n,
                      ch * kBK);
    }
    cp_async_commit();
  };

  float acc[4][4];
  float best[4];
  int best_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    best_k[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  float c2p = 0.0f, x2p = 0.0f;

  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    // Step t has landed for every thread, and every thread is done with
    // step t - 1, whose stage the next issue refills.
    __syncthreads();
    issue(t + kStages - 1);
    const int kt = t / nch, ch = t - kt * nch, stage = t % kStages;
    const float* xb = xs + (resident ? ch : stage) * kBK;
    const float* cb = cs + stage * kBN * kCStride;

    {  // partial squared norms of this chunk
      const float4 a = *reinterpret_cast<const float4*>(cb + sr * kCStride + sf);
      const float4 b = *reinterpret_cast<const float4*>(cb + sr * kCStride + sf + 4);
      c2p = fmaf(a.x, a.x, c2p); c2p = fmaf(a.y, a.y, c2p);
      c2p = fmaf(a.z, a.z, c2p); c2p = fmaf(a.w, a.w, c2p);
      c2p = fmaf(b.x, b.x, c2p); c2p = fmaf(b.y, b.y, c2p);
      c2p = fmaf(b.z, b.z, c2p); c2p = fmaf(b.w, b.w, c2p);
      if (kt == 0) {
        const float4 u = *reinterpret_cast<const float4*>(xb + sr * xstr + sf);
        const float4 v = *reinterpret_cast<const float4*>(xb + sr * xstr + sf + 4);
        x2p = fmaf(u.x, u.x, x2p); x2p = fmaf(u.y, u.y, x2p);
        x2p = fmaf(u.z, u.z, x2p); x2p = fmaf(u.w, u.w, x2p);
        x2p = fmaf(v.x, v.x, x2p); x2p = fmaf(v.y, v.y, x2p);
        x2p = fmaf(v.z, v.z, x2p); x2p = fmaf(v.w, v.w, x2p);
      }
    }

#pragma unroll
    for (int f = 0; f < kBK; f += 4) {
      float4 xv[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xb + (ty + 16 * i) * xstr + f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cv[j] = *reinterpret_cast<const float4*>(cb + (tx + 16 * j) * kCStride + f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(xv[i].x, cv[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv[i].y, cv[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv[i].z, cv[j].z, acc[i][j]);
          acc[i][j] = fmaf(xv[i].w, cv[j].w, acc[i][j]);
        }
    }

    if (ch == nch - 1) {  // the tile's epilogue
      c2p += __shfl_xor_sync(0xffffffffu, c2p, 1);
      c2p += __shfl_xor_sync(0xffffffffu, c2p, 2);
      if (kt == 0) {
        x2p += __shfl_xor_sync(0xffffffffu, x2p, 1);
        x2p += __shfl_xor_sync(0xffffffffu, x2p, 2);
        if ((tid & 3) == 0) x2s[sr] = x2p;
      }
      if ((tid & 3) == 0) c2s[sr] = c2p;
      c2p = 0.0f;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = kt * kBN + tx + 16 * j;
        const float c2 = c2s[tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = c2 - 2.0f * acc[i][j];
          if (kk < k && d < best[i]) {
            best[i] = d;
            best_k[i] = kk;
          }
          acc[i][j] = 0.0f;
        }
      }
    }
  }

  // The 16 threads of a point: 8 lanes of a warp, then the warp pair.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float d = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int kk = __shfl_xor_sync(0xffffffffu, best_k[i], off);
      take_min(best[i], best_k[i], d, kk);
    }
  }
  if ((warp & 1) && (lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red_d[ty + 16 * i] = best[i];
      red_k[ty + 16 * i] = best_k[i];
    }
  }
  __syncthreads();
  if (!(warp & 1) && (lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      take_min(best[i], best_k[i], red_d[r], red_k[r]);
      if (p0 + r < n_pts) {
        labels[p0 + r] = best_k[i];
        dist[p0 + r] = best[i] + x2s[r];
      }
    }
  }
}

}  // namespace

extern "C" {

// Lifts the tile kernel's dynamic shared-memory limit to what a block may
// have on the current device.  The wrapper calls it once a device, before
// the first launch there.
int assign_argmin_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (auto kernel : {assign_tiles<true>, assign_tiles<false>})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return (int)err;
}

// x (n_pts, n), c (k, n) float32, contiguous, on the device; labels (n_pts,)
// int32 and dist (n_pts,) float32 outputs.  (tile, resident, grid, smem) is
// the wrapper's launch plan; it must be the one this file derives from
// (n_pts, n, k), else nothing is launched.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for k < 1, n < 1 or a plan that does not match.
int assign_argmin(const float* x, const float* c, int64_t n_pts, int n, int k, int tile,
                  int resident, int64_t grid, int64_t smem, int* labels, float* dist,
                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || n < 1 || n_pts < 0) return (int)cudaErrorInvalidValue;
  if (n_pts == 0) return 0;
  if (tile) {
    if (grid != (n_pts + kBM - 1) / kBM || smem != (int64_t)tile_smem(n, resident) ||
        (resident && k <= kBN))
      return (int)cudaErrorInvalidValue;
    const bool vec = n % 4 == 0 && ((uintptr_t)x | (uintptr_t)c) % 16 == 0;
    (vec ? assign_tiles<true> : assign_tiles<false>)<<<(unsigned)grid, kThreads, (size_t)smem,
                                                       stream>>>(x, c, n_pts, n, k, resident,
                                                                 labels, dist);
    return (int)cudaGetLastError();
  }
  const int np = point_np(n);
  if (np == 0 || resident || grid != (n_pts + kThreads - 1) / kThreads ||
      smem != (int64_t)point_k_tile(np, k) * (np + 1) * (int64_t)sizeof(float))
    return (int)cudaErrorInvalidValue;
  switch (np) {
    case 4: launch_points<4>(x, c, n_pts, n, k, grid, smem, labels, dist, stream); break;
    case 8: launch_points<8>(x, c, n_pts, n, k, grid, smem, labels, dist, stream); break;
    case 12: launch_points<12>(x, c, n_pts, n, k, grid, smem, labels, dist, stream); break;
    case 16: launch_points<16>(x, c, n_pts, n, k, grid, smem, labels, dist, stream); break;
    case 32: launch_points<32>(x, c, n_pts, n, k, grid, smem, labels, dist, stream); break;
    default: launch_points<64>(x, c, n_pts, n, k, grid, smem, labels, dist, stream); break;
  }
  return (int)cudaGetLastError();
}

const char* assign_argmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

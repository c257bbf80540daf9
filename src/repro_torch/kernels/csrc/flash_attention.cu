// Flash attention, forward (online softmax), on Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_kernel (the
// Pallas TPU kernel, body _flash_kernel).  For q (BH, S_q, hd) and k, v
// (BKV, S_kv, hd), all float32 or all bfloat16, contiguous, q row h reading
// k/v row h / rep (GQA), computes
//     o[h, i]   = sum_j softmax_j(s_ij) v[h / rep, j]      (in q's dtype)
//     lse[h, i] = m_i + log(l_i)                            (float32)
// with s_ij = scale (q_i . k_j), scale = 1/sqrt(hd), and the causal
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
// does.  KV tiles that the masks cover wholly for every row of a block are
// skipped: before a row's first key they would be wiped by alpha = 0,
// after it they add exp(-1e30 - m) = 0, so the result is unchanged.  A
// block holding a row with no key visits every tile, so that row keeps the
// reference's mean over all S_kv keys.  No atomics: each output is written
// by one thread, so the result repeats bitwise.
//
// bfloat16: the tensor cores (flash_fwd_tc).  What bounds it on this card:
// bf16 tensor-core operations, 989 TFLOP/s dense (4 hd multiply-adds per
// unmasked (q, k) pair, 2 for the scores and 2 for the output; at S = 4096
// a causal head of width 64 is ~2e9 of them and reads under 2 MB).
//  * mma.sync.m16n8k16 (bf16 in, f32 accumulate) with FlashAttention-2's
//    layout: a block of 8 warps owns 128 q rows (4 warps and 64 rows at
//    hd = 256), each warp 16 of them and the whole head width, so a row's
//    softmax never leaves its warp.  Q's fragments are loaded once into
//    registers (hd <= 128) and stay there for the whole KV loop; K's come
//    from shared memory through ldmatrix, V's through ldmatrix.trans.
//    mma.sync rather than wgmma: it needs no warpgroup-wide shared-memory
//    operand layouts or descriptors, and lets the scores stay in the
//    registers where the softmax reads them (the C fragment of S is the A
//    fragment of P).  What is left to a later version: wgmma (m64nNk16, one
//    warpgroup per 64 q rows) fed by TMA into an mbarrier ring with a
//    producer warp, which is the only way to the card's full tensor-core
//    rate.
//  * Scores: S = Q K^T from the raw bf16 q and k with f32 accumulation,
//    then times scale in f32 (pre-scaling q in bf16 would round it at
//    hd = 128): on tiles that meet a mask, S is scaled and masked in place;
//    elsewhere the scale goes into the row max (max(S) scale, exact as
//    scale > 0) and the exponent, expf(fmaf(s, scale, -m)).  Head widths
//    are zero-filled to a multiple of 16 in shared memory (the k depth of
//    one MMA); an instance per padded width, and a second one when hd is
//    that width, whose step loops have no runtime bound.
//  * Loads: K and V tiles of 64 rows (32 at hd = 256) go through cp.async
//    into a double-buffered ring in shared memory, the next tile in flight
//    while this one is computed; rows are padded by 16 bytes, so the 8 rows
//    an ldmatrix reads start on distinct banks (no conflicts).  Positions
//    past S_kv and columns past hd are zero-filled by the copy.  A thread
//    copies one 16-byte column of every few rows, so its column checks are
//    made once a tile; shared addresses are computed once a block.
//  * The instructions, not the tensor cores, set the pace: per 16 x 64
//    tile a warp issues 96 MMAs and several times as many other
//    instructions, the accurate expf of each score the largest share.  O's
//    rescale is skipped when no row of the warp found a new max (alpha = 1
//    exactly).
//  * Softmax: online, in registers on the S fragments; each thread holds
//    two rows' columns, and a row's max takes two xor shuffles across the
//    4 lanes of its quad.  expf and logf, as the plain version rounds.
//  * P V: P is split into hi = bf16(P) and lo = bf16(P - hi), and two MMAs
//    add hi V and lo V into one f32 O accumulator; the row sum l is taken
//    from the f32 P.  P rounded to bf16 alone (as FlashAttention-2 and SDPA
//    do) moves o by up to ~9x the bar that chip_smoke.py holds the kernel
//    to (2^-7 |o| + 1e-4, from the plain version's f32 P); the split leaves
//    hi + lo within 2^-16 of P, so o keeps the one-rounding error of its
//    final cast to bf16.  The split makes the P V half of the MMAs twice as
//    many: 1.5x those of an unsplit kernel.
//  * hd = 256: Q is read from shared memory at every tile (its 64
//    registers would not fit beside the 128 of O), KV tiles are 32 rows and
//    blocks 4 warps, so O, the scores and the P fragments fit in registers
//    without spills.
//  * Causal q tiles run longest first: the grid's y index counts from the
//    last tile down, and blocks launch in index order.
//
// float32: plain FMA (flash_fwd_f32), since TF32 would break the reference's
// 2e-5 bar.  One block of 256 threads per (bh, tile of 64 q rows); the q
// tile (pre-scaled) and each 64-row K / V tile are staged in dynamic shared
// memory (up to 209 KB at hd = 256), zero-filled past hd and past S_kv.  A
// 16 x 16 thread grid computes the 64 x 64 score tile as 4 x 4 register
// micro-tiles (rows ty + 16 i, columns tx + 16 j; the q and k tiles' rows
// are padded to an odd stride, so the strided reads hit distinct banks),
// reduces each row's max and sum across its 16 lanes with xor shuffles,
// stages P in shared memory and accumulates O in registers.  Its inner
// products read both operands from shared memory, so shared-memory
// bandwidth, not the FP32 FMA rate (67 TFLOP/s), is its ceiling.
//
// hd is a multiple of 8 up to 256; the tiles are padded to the next of 32,
// 64, 128, 256 (a template argument).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------- float32

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // k / v rows per tile
constexpr int kPS = kBK + 1;  // row stride of the P tile

template <int HDP>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (size_t)(2 * kBQ * (HDP + 1) + kBK * HDP + kBQ * kPS);
}

// Sum or max over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The kv range [k_begin, k_end) the masks leave open for some row of the
// q tile [q0, q0 + bq); every tile when a row has no key at all.  k_begin
// is a multiple of bk.
__device__ __forceinline__ void kv_range(int q0, int bq, int bk, int s_q, int s_kv,
                                         int causal, int window, int* k_begin, int* k_end) {
  const int q_last = min(q0 + bq, s_q) - 1;
  *k_begin = 0;
  *k_end = s_kv;
  const bool keyless_row = window > 0 && q_last - window + 1 > s_kv - 1;
  if (!keyless_row) {
    if (window > 0) *k_begin = max(0, q0 - window + 1) / bk * bk;
    if (causal) *k_end = min(s_kv, q_last + 1);
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int s_q, int s_kv, int hd, int rep, int causal, int window, float scale) {
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
    if (q0 + r < s_q && d < hd) x = q[qbase + (int64_t)(q0 + r) * hd + d] * scale;
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

  int k_begin, k_end;
  kv_range(q0, kBQ, kBK, s_q, s_kv, causal, window, &k_begin, &k_end);

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * HDP; e += kThreads) {
      const int r = e / HDP, d = e % HDP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < s_kv && d < hd) {
        const int64_t off = kbase + (int64_t)(k0 + r) * hd + d;
        kx = k[off];
        vx = v[off];
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
      const float m_new = fmaxf(m_run[i], row_max16(mx));
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // absent: exp(-inf) = 0
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + row_sum16(sum);
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
      if (d < hd) o[qbase + (int64_t)qp * hd + d] = acc[i][j] / l_safe;
    }
    if (tx == 0) lse[(int64_t)bh * s_q + qp] = m_run[i] + logf(l_safe);
  }
}

// Lifts Kernel's dynamic shared-memory limit to bytes, once per device (a
// driver call per launch would cost more than a small launch itself).
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int HDP>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
               int s_q, int s_kv, int hd, int rep, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<HDP>();
  cudaError_t err = allow_smem<flash_fwd_f32<HDP>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + kBQ - 1) / kBQ, bh);
  flash_fwd_f32<HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, s_q, s_kv, hd, rep, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

template <int HDP>
struct TcConfig {
  static constexpr int kWarps = HDP == 256 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;            // q rows per block, 16 a warp
  static constexpr int kBK = HDP == 256 ? 32 : 64;   // k / v rows per tile
  static constexpr bool kQInRegs = HDP <= 128;
  static constexpr int kLd = HDP + 8;                // shared row, bf16 (+16 bytes)
  // Q, then two stages of K and two of V.
  static constexpr size_t kSmem = sizeof(bf16) * (size_t)(kBQ + 4 * kBK) * kLd;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory (a shared-window address), zero-
// filled past src_bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices from shared memory (shared-window addresses).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B (column
// fragment) and a 16x8 f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as hi = bf16(x, y) and lo = bf16((x, y) - hi), each packed with x
// in the low half (the lower column of an A fragment).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  *hi = as_u32(h);
  *lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Rows [row0, row0 + ROWS) of a (n_rows, hd) bf16 matrix into the shared
// tile at dst (row stride LD), columns [0, kd): zero past hd and past
// n_rows.  Each thread copies one 16-byte column chunk of every
// (THREADS / chunks)-th row, so its column checks are made once and the row
// loop is unrolled.
template <int ROWS, int HDP, int LD, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int row0, int n_rows,
                                          int hd, int kd) {
  constexpr int kChunks = HDP / 8;  // 16-byte chunks a row
  constexpr int kRowStep = THREADS / kChunks;
  static_assert(THREADS % kChunks == 0 && ROWS % kRowStep == 0, "tile split");
  const int c8 = (threadIdx.x % kChunks) * 8, r0 = threadIdx.x / kChunks;
  if (c8 >= kd) return;
  const bool col_ok = c8 < hd;
  const bf16* s = src + (int64_t)(row0 + r0) * hd + c8;
  dst += (uint32_t)(r0 * LD + c8) * sizeof(bf16);
#pragma unroll
  for (int it = 0; it < ROWS / kRowStep; ++it) {
    const bool ok = col_ok && row0 + r0 + it * kRowStep < n_rows;
    cp_async16(dst + it * kRowStep * LD * sizeof(bf16), ok ? s + it * kRowStep * hd : src,
               ok ? 16 : 0);
  }
}

// FULL: hd == HDP, so every 16-deep step of the head width is present and
// the step loops need no runtime bound.
template <int HDP, bool FULL>
__global__ void __launch_bounds__(TcConfig<HDP>::kThreads)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, float* __restrict__ lse, int s_q, int s_kv, int hd, int rep,
             int causal, int window, float scale) {
  using C = TcConfig<HDP>;
  constexpr int BQ = C::kBQ, BK = C::kBK, LD = C::kLd, TH = C::kThreads;
  constexpr int NT = BK / 8;        // 8-column tiles of S per warp
  constexpr int KSTEPS = HDP / 16;  // 16-deep steps of the head width
  constexpr int OT = HDP / 8;       // 8-column tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Shared-window byte addresses: Q (BQ, LD), then 2 x K and 2 x V (BK, LD).
  constexpr uint32_t kTileBytes = BK * LD * sizeof(bf16);
  const uint32_t qs = smem_addr(smem_raw);
  const uint32_t kbuf = qs + BQ * LD * sizeof(bf16);
  const uint32_t vbuf = kbuf + 2 * kTileBytes;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // the fragment's row group and column pair
  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int wq = warp * 16;  // the warp's first row in the q tile
  const int kd = FULL ? HDP : (hd + 15) & ~15;
  const int ksteps = FULL ? KSTEPS : kd >> 4;
  const int64_t qbase = (int64_t)bh * s_q * hd;
  const bf16* kh = k + (int64_t)(bh / rep) * s_kv * hd;
  const bf16* vh = v + (int64_t)(bh / rep) * s_kv * hd;

  int k_begin, k_end;
  kv_range(q0, BQ, BK, s_q, s_kv, causal, window, &k_begin, &k_end);

  load_tile<BQ, HDP, LD, TH>(qs, q + qbase, q0, s_q, hd, kd);
  load_tile<BK, HDP, LD, TH>(kbuf, kh, k_begin, s_kv, hd, kd);
  load_tile<BK, HDP, LD, TH>(vbuf, vh, k_begin, s_kv, hd, kd);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // A fragments of the warp's 16 q rows: ldmatrix lane l addresses row
  // l % 16, columns 8 (l / 16) of each 16-deep step (32 bytes apart).
  const uint32_t qa = qs + ((wq + (lane & 15)) * LD + (lane >> 4) * 8) * sizeof(bf16);
  uint32_t qf[C::kQInRegs ? KSTEPS : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      if (kk < ksteps) ldsm_x4(qf[kk], qa + kk * 32);
  }
  // B fragments: K rows 16 jp + (l & 7) + 8 (l / 16), columns + 8 ((l / 8) & 1);
  // V (transposed) rows (l & 7) + 8 ((l / 8) & 1), columns + 8 (l / 16).
  const uint32_t k_off =
      (((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8) * sizeof(bf16);
  const uint32_t v_off =
      (((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8) * sizeof(bf16);

  float oacc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t) oacc[t][0] = oacc[t][1] = oacc[t][2] = oacc[t][3] = 0.0f;
  float m_run[2] = {kMasked, kMasked};  // rows g and g + 8 of the warp
  float l_part[2] = {0.0f, 0.0f};       // this thread's share of each row's sum

  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK, stage ^= 1) {
    if (k0 + BK < k_end) {  // the next tile, in flight while this one is used
      load_tile<BK, HDP, LD, TH>(kbuf + (stage ^ 1) * kTileBytes, kh, k0 + BK, s_kv, hd, kd);
      load_tile<BK, HDP, LD, TH>(vbuf + (stage ^ 1) * kTileBytes, vh, k0 + BK, s_kv, hd, kd);
    }
    cp_async_commit();
    const uint32_t ks = kbuf + stage * kTileBytes + k_off;
    const uint32_t vs = vbuf + stage * kTileBytes + v_off;

    // S = Q K^T, 16 x BK for this warp.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk < ksteps) {
        uint32_t a[4];
        if constexpr (C::kQInRegs) {
          a[0] = qf[kk][0];
          a[1] = qf[kk][1];
          a[2] = qf[kk][2];
          a[3] = qf[kk][3];
        } else {
          ldsm_x4(a, qa + kk * 32);
        }
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t b[4];
          ldsm_x4(b, ks + (jp * 16 * LD + kk * 16) * sizeof(bf16));
          mma_bf16(s[2 * jp], a, b[0], b[1]);
          mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }

    // Where this tile meets a mask or the ragged edge, scale and mask S in
    // place (sc = 1 below); elsewhere the scale is folded into the
    // softmax's max and exponent (sc = scale).
    const bool edge = k0 + BK > s_kv || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window);
    const float sc = edge ? 1.0f : scale;
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q0 + wq + g + (e >> 1) * 8;
          const int kp = k0 + j * 8 + t4 * 2 + (e & 1);
          bool masked = causal && qp < kp;
          masked |= window > 0 && qp - kp >= window;
          s[j][e] = kp >= s_kv ? -INFINITY : (masked ? kMasked : s[j][e] * scale);
        }
      }
    }

    // Online softmax: the row max over the quad, P = exp(S - m) in place.
    float alphas[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // Column k0 is present in every tile, so the max is >= -1e30.  As
      // scale > 0, max(S) * scale is the max of the scaled S.
      const float m_new = fmaxf(m_run[i], mx * sc);
      const float alpha = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(fmaf(s[j][2 * i + c], sc, -m_new));  // absent: 0
          s[j][2 * i + c] = p;
          sum += p;
        }
      }
      l_part[i] = l_part[i] * alpha + sum;
      alphas[i] = alpha;
    }
    // Rescale O unless no row of the warp found a new max (alpha = 1 is
    // exact, so skipping it changes no bit).
    if (__any_sync(0xffffffffu, alphas[0] != 1.0f || alphas[1] != 1.0f)) {
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        oacc[t][0] *= alphas[0];
        oacc[t][1] *= alphas[0];
        oacc[t][2] *= alphas[1];
        oacc[t][3] *= alphas[1];
      }
    }

    // O += P V with P = hi + lo: the C fragments of S tiles 2kk, 2kk + 1
    // are the A fragment of P's 16-deep step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], &hi[0], &lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], &hi[1], &lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], &hi[2], &lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], &hi[3], &lo[3]);
#pragma unroll
      for (int tp = 0; tp < KSTEPS; ++tp) {
        if (tp < ksteps) {
          uint32_t b[4];
          ldsm_x4_trans(b, vs + (kk * 16 * LD + tp * 16) * sizeof(bf16));
          mma_bf16(oacc[2 * tp], hi, b[0], b[1]);
          mma_bf16(oacc[2 * tp], lo, b[0], b[1]);
          mma_bf16(oacc[2 * tp + 1], hi, b[2], b[3]);
          mma_bf16(oacc[2 * tp + 1], lo, b[2], b[3]);
        }
      }
    }

    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this stage's readers are done
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    const int qp = q0 + wq + g + 8 * i;
    if (qp >= s_q) continue;
    bf16* orow = o + qbase + (int64_t)qp * hd + t4 * 2;
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      if (t * 8 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + t * 8) =
            __floats2bfloat162_rn(oacc[t][2 * i] / l_safe, oacc[t][2 * i + 1] / l_safe);
      }
    }
    if (t4 == 0) lse[(int64_t)bh * s_q + qp] = m_run[i] + logf(l_safe);
  }
}

template <int HDP, bool FULL>
int launch_tc_as(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
              int s_q, int s_kv, int hd, int rep, int causal, int window, float scale,
              cudaStream_t stream) {
  using C = TcConfig<HDP>;
  cudaError_t err = allow_smem<flash_fwd_tc<HDP, FULL>>(C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (s_q + C::kBQ - 1) / C::kBQ;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, q_tiles);
  flash_fwd_tc<HDP, FULL><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, s_q, s_kv, hd, rep, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
              int s_q, int s_kv, int hd, int rep, int causal, int window, float scale,
              cudaStream_t stream) {
  if (hd == HDP)
    return launch_tc_as<HDP, true>(q, k, v, o, lse, bh, s_q, s_kv, hd, rep, causal, window,
                                   scale, stream);
  return launch_tc_as<HDP, false>(q, k, v, o, lse, bh, s_q, s_kv, hd, rep, causal, window,
                                  scale, stream);
}

}  // namespace

extern "C" {

// q (bh, s_q, hd), k and v (bh / rep, s_kv, hd), o like q: float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1, each pointer 16-byte aligned),
// contiguous on the device; lse (bh, s_q) float32.  hd a multiple of 8 in
// [8, 256], s_q, s_kv >= 1, bh <= 65535, window >= 0 (0: none).  scale is
// the float32 1/sqrt(hd).  Returns a cudaError_t code.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int bh, int s_q, int s_kv, int hd, int rep, int causal, int window,
                        float scale, int is_bf16, cudaStream_t stream) {
  if (hd < 8 || hd > 256 || hd % 8 != 0 || s_q < 1 || s_kv < 1 || bh < 1 || bh > 65535 ||
      rep < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
#define FLASH_ARGS q, k, v, o, lse, bh, s_q, s_kv, hd, rep, causal, window, scale, stream
  if (is_bf16) {
    if (hd <= 32) return launch_tc<32>(FLASH_ARGS);
    if (hd <= 64) return launch_tc<64>(FLASH_ARGS);
    if (hd <= 128) return launch_tc<128>(FLASH_ARGS);
    return launch_tc<256>(FLASH_ARGS);
  }
  if (hd <= 32) return launch_f32<32>(FLASH_ARGS);
  if (hd <= 64) return launch_f32<64>(FLASH_ARGS);
  if (hd <= 128) return launch_f32<128>(FLASH_ARGS);
  return launch_f32<256>(FLASH_ARGS);
#undef FLASH_ARGS
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

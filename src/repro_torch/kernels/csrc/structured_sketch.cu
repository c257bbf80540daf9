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
// What bounds it on this card: instructions.  A row brings 4(n+1) bytes and
// costs, per (row, frequency) pair, three stages of log2(d) butterfly adds
// and a scale, the radius multiply, the trig and the accumulates: some 26
// FP32 instructions and two SFU operations at d = 32.
//
// Design (the main path's n = 10 gives d = 32 and 32 frequency blocks):
//  * A thread holds kEpt = 32 coordinates of one frequency block and walks
//    its share of the rows, so the butterfly levels h = 1 .. 16 are adds and
//    subtracts between its own registers.  At d = 32 that is the whole
//    transform: no shuffle, no shared memory per row.  Wider blocks take
//    TPF = d / 32 threads a row, coordinates e = 32 t + k in thread t:
//    levels 32 <= h < 1024 cross lanes by __shfl_xor_sync, and h = 1024
//    (d = 2048, whose row spans two warps) goes through shared memory.
//  * The level order and operand order are fixed whatever the thread layout
//    (h = 1, 2, 4, ...; the lower index gets a + b, the upper a - b), so
//    every block width rounds its phases alike.  A lane exchange computes
//    the upper's a - b as fmaf(-1, b, a), which rounds once, as a - b does.
//    The sign of each stage after the first is folded into the previous
//    stage's scale: v * (+-c) equals (v * c) * (+-1) bitwise.  At d = 32 the
//    padding columns 16..31 are known zeros when n <= 16, so an instance with
//    NX = 16 skips the first stage's level h = 16, which only copies a lower
//    value up, and the levels' adds on those zeros (tests/test_torch_structured.py
//    holds both shortcuts to the unshortened arithmetic's bits).
//  * A CTA of 256 threads owns FB frequency blocks (8 at d <= 128, fewer
//    above, so their constants stay within 40 KB) and a contiguous range of
//    rows; each frequency block's threads form RSB row slots (32 lanes of one
//    warp at d = 32).  The signs (times c), radii and dither of the CTA's
//    blocks are staged once in shared memory, laid out so that the threads
//    of a warp that share a block read them as broadcasts and the others
//    without bank conflicts.
//  * Rows are staged a tile at a time in shared memory by cp.async, double
//    buffered (the next tile lands while this one is computed), with a row
//    stride TPF * odd and one pad word per 32 columns, so that the row slots
//    of a warp read their values without bank conflicts.
//  * Float sums: a thread sums beta * cos and beta * sin over its rows of a
//    tile (some 25 at d = 32) in float registers; after each tile the row
//    slots of a frequency are added in slot order and into a double
//    accumulator in shared memory, so the accuracy does not depend on the
//    range's length.  Each CTA writes double partials per frequency to
//    (groups, nblocks * d) scratch, which does not grow with N, and a second
//    kernel sums them over the groups in a fixed order, in double.  No float
//    atomics: the sums are bitwise repeatable.  Integer sums: each thread
//    sums its codes in int32 registers; the row slots are added at the end of
//    the CTA and atomicAdd'ed to the zeroed outputs, exact in any order.  The
//    wrapper sizes the grid to one wave of resident CTAs
//    (freq_transform.structured_grid), a fixed function of the shape on one
//    card.
//  * Trig: the phase is reduced exactly and sin, cos come from the SFU
//    (sincos_reduced.cuh).  The 1-bit code skips the trig: one_bit_signs()
//    (the same header, shared with quantized_fourier_sketch.cu) reads both
//    signs off the reduced phase; a NaN phase gives -1 for both, as
//    c >= 0 ? 1 : -1 does.  The b-bit codes round with
//    __float2int_rn (half to even), never roundf.
//  * The radius multiply and the dither add are explicit _rn operations
//    (the reference rounds each); the stage scales too, so that no multiply
//    is fused into the butterfly's adds.
//  * Wide blocks, d = 4096, 8192 and 16384 (the activation monitor at
//    d_model > 2048; the reference's Pallas kernel holds any block whole),
//    run another kernel, structured_wide, so the instances above keep their
//    code.  A row needs TPF = 128, 256 or 512 threads (a team), and the
//    constants of one block (signs 3d, radii d, dither d) take 256-320 KB
//    at 16384, past the 227 KB a CTA may hold.  A CTA of 512 threads holds
//    one block: its radii and dither in shared memory, and 4, 2 or 1 teams,
//    each with a row buffer of its own (d floats, 4 pad words a 32) and a
//    row group of its own, one row at a time, synchronised by a named
//    barrier of its own, so the teams run as independently as CTAs but
//    share the constants.  Thread t keeps its 3 x 32 signs as three bit
//    masks in registers (so diags must hold +-1, as the operator's draw
//    gives).  Per row and stage, three layouts of the buffer in turn, each
//    with 32 coordinates a thread in registers: A (32 t + k; levels
//    1 .. 16), B (lane + 32 k + 1024 w, t = 32 w + lane; levels 32 .. 512)
//    and C (t + TPF k; levels 1024 .. d / 2), so every level is an add
//    between a thread's own registers and a layout change is one store, one
//    barrier and one load, with no shuffle: 8 changes a row.  The 4-word pad
//    of each 32 keeps A's 128-bit accesses, B's and C's 32-bit ones and the
//    row's 16-byte cp.async copies free of bank conflicts.  The later
//    stages' signs times c are applied in layout C before the change to A.
//    The next row is copied into the buffer by cp.async (zeros past column
//    n) as soon as the team has read the current one in layout C, so the
//    copy runs under the trig.  The level order, the operands and the
//    roundings are those above, so a wide block rounds its phases as the
//    narrow kernel would.  Float sums: thread t owns coordinates t + TPF k
//    of its group's double partials and adds its float sums there every
//    kWideFlushRows (256) rows, in row order, so the sums stay bitwise
//    repeatable and each fleet tenant bitwise its own launch; codes are
//    atomicAdd'ed as above.  The wrapper gives each team one group
//    (structured_grid with one row a group at least), so a few rows, as the
//    monitor folds a step, run in parallel.  Registers: 32 coordinates and
//    64 sums a thread at 512 threads an SM, within the 128 a thread that
//    leaves.  What bounds it: the SM's instruction rate, some 70
//    instructions a (row, coordinate) (39 butterfly adds, the sign flips
//    and scales, the trig, 11 shared-memory accesses), which the butterfly
//    and the layout changes share.
//  * The fleet entries (structured_sketch_sums_fleet,
//    quantized_structured_sketch_sums_fleet) sketch T tenants' batches,
//    each against its own signs, radii and beta or dither, in one launch:
//    the counterpart of the reference's vmap of the Pallas kernels over the
//    tenant axis (src/repro/core/fleet.py:_tenant_part, _tenant_qpart).  The
//    tenant rides in the grid's x axis, blockIdx.x = tenant * groups +
//    group (the wide kernel: tenant * ceil(groups / teams) + CTA), with
//    groups = ceil(n_pts / rows_per_group), and each CTA offsets
//    its pointers by its tenant's strides, which follow from n_pts, n,
//    nblocks and groups.  Each tenant gets the grid that an isolated call of
//    B rows gets (the wrapper asks structured_grid for B, never for T B,
//    with the single kernel's occupancy), the float pass adds its partials
//    in group order and the codes are exact integer sums, so every tenant's
//    sums are bitwise those of its own launch.  The offsets sit behind a
//    template flag (FLEET): a single call runs instances whose signature and
//    code are those the kernel had before the fleet entries.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sincos_reduced.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEpt = 32;            // coordinates a thread holds
constexpr int kTileFloats = 8960;   // x staged per tile and buffer (35 KB)
constexpr int kMaxTileRows = 1024;
constexpr int kFlushLd = kThreads + 1;  // the flush buffer's row, padded
constexpr unsigned kFull = 0xffffffffu;

// float sums (beta weights), b-bit codes, 1-bit codes.
enum Mode { kFloat = 0, kCodes = 1, kSigns = 2 };

template <int D, int MODE>
struct Layout {
  static constexpr int TPF = D / kEpt;                       // threads per row
  static constexpr int UNITS = kThreads / TPF;               // (block, slot) units
  static constexpr int FB = D <= 128 ? 8 : (D >= 1024 ? 1 : 1024 / D);
  static constexpr int RSB = UNITS / FB;                     // row slots per block
  static constexpr int NC = MODE == kFloat ? 4 : 5;          // constants per coordinate
  // Shared memory, in floats: two x tiles, two weight tiles, the constants,
  // the double accumulators (float sums) and the exchange buffer (d = 2048).
  static constexpr int XS = 2 * kTileFloats;
  static constexpr int WS = 2 * kMaxTileRows;
  static constexpr int CS = FB * NC * D;
  static constexpr int DA = MODE == kFloat ? 2 * (FB * 2 * D) : 0;
  static constexpr int EX = TPF > 32 ? kThreads * (kEpt + 1) : 0;
  static constexpr size_t BYTES = sizeof(float) * (size_t)(XS + WS + CS + DA + EX);
  static_assert(TPF >= 1 && TPF * kEpt == D, "block width");
  static_assert(RSB * FB == UNITS, "slots");
  static_assert(kEpt * kFlushLd <= kTileFloats, "flush buffer");
  // The widest row (n = d) takes a stride of at most 33 TPF floats: a tile
  // holds one row for every slot.
  static_assert(RSB * (kEpt + 1) * TPF <= kTileFloats, "tile rows");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Butterfly levels h = 1 .. 16 between a thread's own registers.  Values at
// k >= NX are known zeros: levels h < NX leave them be, and levels h >= NX
// copy each lower value up (a + 0 and a - 0 are a).
template <int NX>
__device__ __forceinline__ void butterfly_regs(float (&v)[kEpt]) {
#pragma unroll
  for (int h = 1; h < kEpt; h <<= 1) {
#pragma unroll
    for (int k = 0; k < kEpt; ++k) {
      if ((k & h) == 0) {
        if (h >= NX) {
          v[k | h] = v[k];
        } else if (k < NX) {
          const float a = v[k], b = v[k | h];
          v[k] = a + b;
          v[k | h] = a - b;
        }
      }
    }
  }
}

// Levels h = 32 .. d / 2 across the TPF threads of a row: by shuffles within
// a warp, through shared memory (ex) between the two warps of a d = 2048 row.
template <int TPF>
__device__ __forceinline__ void butterfly_lanes(float (&v)[kEpt], int t, float* ex) {
#pragma unroll
  for (int g = 1; g < TPF && g < 32; g <<= 1) {
    const float sgn = (t & g) ? -1.0f : 1.0f;
#pragma unroll
    for (int k = 0; k < kEpt; ++k) {
      const float o = __shfl_xor_sync(kFull, v[k], g);
      v[k] = fmaf(sgn, v[k], o);  // lower: v + o; upper: o - v
    }
  }
  if (TPF > 32) {
    const float sgn = (t & 32) ? -1.0f : 1.0f;
    float* mine = ex + threadIdx.x * (kEpt + 1);
    const float* other = ex + (threadIdx.x ^ 32) * (kEpt + 1);
#pragma unroll
    for (int k = 0; k < kEpt; ++k) mine[k] = v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kEpt; ++k) v[k] = fmaf(sgn, v[k], other[k]);
    __syncthreads();  // the partner has read this thread's values
  }
}

// One stage's unnormalised WHT of the row block held by the TPF threads.
template <int TPF, int NX>
__device__ __forceinline__ void stage(float (&v)[kEpt], int t, float* ex) {
  butterfly_regs<NX>(v);
  butterfly_lanes<TPF>(v, t, ex);
}

// Constant s of coordinates 4q .. 4q + 3 of thread t: one 16-byte shared
// load, made where it is used.  The loads are volatile so that the compiler
// does not hoist the 128-160 loop-invariant constants of a thread out of the
// row loop into registers, which cost 255 registers or spills.
template <int TPF>
__device__ __forceinline__ float4 konst(const float4* cs, int s, int q, int t) {
  float4 r;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"(smem_addr(cs + (s * (kEpt / 4) + q) * TPF + t)));
  return r;
}

// v[k] *= w[k] for the 32 coordinates, w the stage's +-c, rounded (not fused
// into the butterfly's adds).
template <int TPF>
__device__ __forceinline__ void scale(float (&v)[kEpt], const float4* cs, int s, int t) {
#pragma unroll
  for (int q = 0; q < kEpt / 4; ++q) {
    const float4 w = konst<TPF>(cs, s, q, t);
    v[4 * q] = __fmul_rn(v[4 * q], w.x);
    v[4 * q + 1] = __fmul_rn(v[4 * q + 1], w.y);
    v[4 * q + 2] = __fmul_rn(v[4 * q + 2], w.z);
    v[4 * q + 3] = __fmul_rn(v[4 * q + 3], w.w);
  }
}

__device__ __forceinline__ float comp(const float4& a, int j) {
  return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w;
}

// One coordinate's share of a row, for both kernels: the phase theta =
// (v c) rad (+ dither), rounded at each step, into the float sums
// (weight rw), the b-bit codes or the 1-bit counts (row weight vr).
template <int MODE>
__device__ __forceinline__ void accumulate(float v, float rad, float dth, float cscale,
                                           float qscale, float rw, int vr, float& acc_c,
                                           float& acc_s, int& iacc_c, int& iacc_s) {
  float theta = __fmul_rn(__fmul_rn(v, cscale), rad);
  if (MODE != kFloat) theta = __fadd_rn(theta, dth);
  if (MODE == kSigns) {
    bool cos_pos, sin_pos;
    one_bit_signs(theta, &cos_pos, &sin_pos);
    if (cos_pos) iacc_c += vr;
    if (sin_pos) iacc_s += vr;
  } else {
    float s, c;
    sincos_reduced(theta, &s, &c);
    if (MODE == kCodes) {
      iacc_c += __float2int_rn(__fmul_rn(c, qscale)) * vr;
      iacc_s += __float2int_rn(__fmul_rn(s, qscale)) * vr;
    } else {
      acc_c = fmaf(rw, c, acc_c);
      acc_s = fmaf(rw, s, acc_s);
    }
  }
}

// D: block width; MODE: kFloat, kCodes or kSigns; NX: the first stage's
// nonzero width (d = 32 only; kEpt elsewhere); FLEET: the tenant axis.
template <int D, int MODE, int NX, bool FLEET>
__global__ void __launch_bounds__(kThreads, 2)
structured(const float* __restrict__ x, const float* __restrict__ diags,
           const float* __restrict__ radii, const float* __restrict__ dither,
           const float* __restrict__ rowv, int64_t n_pts, int n, int nblocks,
           float cscale, float qscale, int64_t rows_per_group,
           double* __restrict__ part_c, double* __restrict__ part_s,
           int* __restrict__ qcos, int* __restrict__ qsin) {
  using L = Layout<D, MODE>;
  constexpr int TPF = L::TPF, FB = L::FB, RSB = L::RSB, NC = L::NC;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                  // 2 x tiles
  float* ws = xs + L::XS;                            // 2 weight tiles
  float4* cs = reinterpret_cast<float4*>(ws + L::WS);  // constants
  double* dacc = reinterpret_cast<double*>(ws + L::WS + L::CS);
  float* ex = ws + L::WS + L::CS + L::DA;

  // FLEET: this CTA's row group within its tenant, and every pointer moved
  // to that tenant's operand (a single call reads blockIdx.x as before).
  [[maybe_unused]] int64_t fleet_group = 0;
  if constexpr (FLEET) {
    const int64_t groups = (n_pts + rows_per_group - 1) / rows_per_group;
    const int64_t tenant = blockIdx.x / groups, width = (int64_t)nblocks * D;
    fleet_group = blockIdx.x - tenant * groups;
    x += tenant * n_pts * n;
    diags += tenant * 3 * width;
    radii += tenant * width;
    if (rowv) rowv += tenant * n_pts;
    if (MODE == kFloat) {
      part_c += tenant * groups * width;
      part_s += tenant * groups * width;
    } else {
      dither += tenant * width;
      qcos += tenant * width;
      qsin += tenant * width;
    }
  }
  const int tid = threadIdx.x;
  const int unit = tid / TPF, t = tid % TPF;
  const int fbl = unit / RSB, slot = unit % RSB;
  const int fb0 = blockIdx.y * FB;

  // The constants of the CTA's blocks: element (fbl, s, e = 32 t + 4 q + j)
  // at float index ((((fbl * NC + s) * 8 + q) * TPF + t) * 4 + j); s = 0 the
  // first stage's signs, 1-2 the later stages' signs times c, 3 the radii,
  // 4 the dither.  Blocks past nblocks read zeros.
  for (int i = tid; i < FB * NC * D; i += kThreads) {
    const int j = i & 3, tt = (i >> 2) % TPF, q = (i >> 2) / TPF % 8;
    const int s = (i >> 2) / TPF / 8 % NC, f = (i >> 2) / TPF / 8 / NC;
    const int e = kEpt * tt + 4 * q + j, fb = fb0 + f;
    float val = 0.0f;
    if (fb < nblocks) {
      const int64_t base = (int64_t)fb * D;
      if (s < 3) val = diags[base * 3 + (int64_t)s * D + e] * (s == 0 ? 1.0f : cscale);
      else if (s == 3) val = radii[base + e];
      else val = dither[base + e];
    }
    reinterpret_cast<float*>(cs)[i] = val;
  }
  if (MODE == kFloat) {
    for (int i = tid; i < FB * 2 * D; i += kThreads) dacc[i] = 0.0;
  }
  const float4* mine = cs + fbl * NC * (kEpt / 4) * TPF;

  // Row stride: TPF times an odd number, at least the row's length with one
  // pad word per 32 columns.
  const int row_len = n + (n - 1) / 32;
  const int stride = ((row_len + TPF - 1) / TPF | 1) * TPF;
  const int tile_rows = min(kMaxTileRows, kTileFloats / stride);
  const int64_t r0 = (FLEET ? fleet_group : (int64_t)blockIdx.x) * rows_per_group;
  const int64_t r1 = min(n_pts, r0 + rows_per_group);

  // Stage rows [a, a + rows) into buffer b, one float per thread and step
  // (coalesced); element i of the tile is row i / n (by the multiply-high
  // with ceil(2^32 / n), exact for i * n < 2^32), column i % n.
  const uint64_t div_n = ((1ull << 32) + n - 1) / n;
  auto stage_tile = [&](int64_t a, int rows, int b) {
    float* xb = xs + b * kTileFloats;
    float* wb = ws + b * kMaxTileRows;
    const float* src = x + a * n;
    for (int i = tid; i < rows * n; i += kThreads) {
      const int r = (int)(((uint64_t)i * div_n) >> 32), c = i - r * n;
      cp_async4(smem_addr(xb + r * stride + c + (c >> 5)), src + i);
    }
    for (int r = tid; r < rows; r += kThreads) {
      if (rowv) cp_async4(smem_addr(wb + r), rowv + a + r);
      else wb[r] = 1.0f;
    }
    cp_async_commit();
  };

  float acc_c[kEpt], acc_s[kEpt];  // float sums (kFloat)
  int iacc_c[kEpt], iacc_s[kEpt];  // code sums, or counts of +1 (kSigns)
  int nvalid = 0;                  // kSigns: sum of the row weights
#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    acc_c[k] = acc_s[k] = 0.0f;
    iacc_c[k] = iacc_s[k] = 0;
  }

  if (r0 < r1) stage_tile(r0, (int)min((int64_t)tile_rows, r1 - r0), 0);
  int buf = 0;
  for (int64_t t0 = r0; t0 < r1; t0 += tile_rows, buf ^= 1) {
    const int rows = (int)min((int64_t)tile_rows, r1 - t0);
    __syncthreads();  // the other buffer is free: its tile and flush are done
    const int64_t t1 = t0 + tile_rows;
    if (t1 < r1) {
      stage_tile(t1, (int)min((int64_t)tile_rows, r1 - t1), buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed, from every thread's copies
    const float* xb = xs + buf * kTileFloats;
    const float* wb = ws + buf * kMaxTileRows;

    const int iters = (rows + RSB - 1) / RSB;
    for (int it = 0; it < iters; ++it) {
      const int r = it * RSB + slot;
      const bool active = r < rows;
      const float* xr = xb + (active ? r : 0) * stride + (kEpt + 1) * t;
      const int c0 = kEpt * t;  // this thread's first column
      float v[kEpt];
#pragma unroll
      for (int q = 0; q < kEpt / 4; ++q) {
        const float4 sg = 4 * q < NX ? konst<TPF>(mine, 0, q, t) : float4{};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * q + j;
          v[k] = (k < NX && active && c0 + k < n) ? xr[k] * comp(sg, j) : 0.0f;
        }
      }
      stage<TPF, NX>(v, t, ex);
      scale<TPF>(v, mine, 1, t);
      stage<TPF, kEpt>(v, t, ex);
      scale<TPF>(v, mine, 2, t);
      stage<TPF, kEpt>(v, t, ex);

      const float rw = active ? wb[r] : 0.0f;
      const int vr = (int)rw;
      if (MODE == kSigns) nvalid += vr;
#pragma unroll
      for (int q = 0; q < kEpt / 4; ++q) {
        const float4 rad = konst<TPF>(mine, 3, q, t);
        const float4 dth = MODE != kFloat ? konst<TPF>(mine, 4, q, t) : float4{};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * q + j;
          accumulate<MODE>(v[k], comp(rad, j), comp(dth, j), cscale, qscale, rw, vr, acc_c[k],
                           acc_s[k], iacc_c[k], iacc_s[k]);
        }
      }
    }

    if (MODE == kFloat) {
      // Flush: the tile's float sums of each frequency, added over its row
      // slots in slot order, into the double accumulators; through this
      // tile's x buffer, half the coordinates at a time.
      float* fl = xs + buf * kTileFloats;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        __syncthreads();  // the buffer's rows (or the previous half) are read
#pragma unroll
        for (int kk = 0; kk < kEpt / 2; ++kk) {
          fl[kk * kFlushLd + tid] = acc_c[half * (kEpt / 2) + kk];
          fl[(kEpt / 2 + kk) * kFlushLd + tid] = acc_s[half * (kEpt / 2) + kk];
        }
        __syncthreads();
        for (int i = tid; i < FB * D; i += kThreads) {
          const int j = i % kEpt, tt = i / kEpt % TPF, f = i / kEpt / TPF;
          float sum = 0.0f;
          for (int sl = 0; sl < RSB; ++sl) sum += fl[j * kFlushLd + (f * RSB + sl) * TPF + tt];
          const int cs_ = j / (kEpt / 2), e = kEpt * tt + half * (kEpt / 2) + j % (kEpt / 2);
          dacc[(f * 2 + cs_) * D + e] += (double)sum;
        }
      }
#pragma unroll
      for (int k = 0; k < kEpt; ++k) acc_c[k] = acc_s[k] = 0.0f;
    }
  }

  const int64_t width = (int64_t)nblocks * D;
  if (MODE == kFloat) {
    __syncthreads();
    for (int i = tid; i < FB * 2 * D; i += kThreads) {
      const int e = i % D, cs_ = i / D % 2, fb = fb0 + i / D / 2;
      if (fb < nblocks) {
        double* part = cs_ ? part_s : part_c;
        const int64_t group = FLEET ? fleet_group : (int64_t)blockIdx.x;
        part[group * width + (int64_t)fb * D + e] = dacc[i];
      }
    }
    return;
  }
  // Integer sums: the row slots of each frequency added, then one atomicAdd
  // per frequency and CTA.
  int* fl = reinterpret_cast<int*>(xs);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kEpt / 2; ++kk) {
      int qc = iacc_c[half * (kEpt / 2) + kk], qs = iacc_s[half * (kEpt / 2) + kk];
      if (MODE == kSigns) {  // sum of +-1 codes = 2 (count of +1) - weight
        qc = 2 * qc - nvalid;
        qs = 2 * qs - nvalid;
      }
      fl[kk * kFlushLd + tid] = qc;
      fl[(kEpt / 2 + kk) * kFlushLd + tid] = qs;
    }
    __syncthreads();
    for (int i = tid; i < FB * D; i += kThreads) {
      const int j = i % kEpt, tt = i / kEpt % TPF, f = i / kEpt / TPF;
      int sum = 0;
      for (int sl = 0; sl < RSB; ++sl) sum += fl[j * kFlushLd + (f * RSB + sl) * TPF + tt];
      const int cs_ = j / (kEpt / 2), e = kEpt * tt + half * (kEpt / 2) + j % (kEpt / 2);
      const int fb = fb0 + f;
      if (fb < nblocks) atomicAdd((cs_ ? qsin : qcos) + (int64_t)fb * D + e, sum);
    }
  }
}

// The wide blocks, d = 4096 .. 16384 (see the file's header): a CTA of
// kWideThreads threads holds TEAMS teams of TPF = d / 32 threads, each team
// one row at a time and one row group of its own.
constexpr int kWideThreads = 512;
template <int D, int MODE>
struct WideLayout {
  static constexpr int TPF = D / kEpt;              // threads a row: a team
  static constexpr int TEAMS = kWideThreads / TPF;  // teams (rows in flight) a CTA
  static constexpr int HM0 = 1024 / TPF;  // register distance of level h = 1024 (layout C)
  static constexpr int SEG = kEpt + 4;    // a 32-coordinate segment of a row buffer, padded
  static constexpr int ROW = D / kEpt * SEG;  // a team's row buffer, in floats
  // Shared memory: the radii, (codes) the dither, the teams' row buffers.
  static constexpr size_t BYTES =
      sizeof(float) * ((size_t)(MODE == kFloat ? 1 : 2) * D + (size_t)TEAMS * ROW);
  static_assert(TPF >= 128 && TPF <= kWideThreads && TPF * kEpt == D, "block width");
  static_assert(TEAMS * TPF == kWideThreads && TEAMS <= 4, "teams");
  static_assert(BYTES <= 232448, "shared memory");
};

// Rows a thread adds in float before it adds them into its group's double
// partials (float sums).
constexpr int kWideFlushRows = 256;

// Butterfly levels h = 1024 .. d / 2 in layout C (thread t holds
// coordinates t + TPF k, so level h pairs registers k and k + h / TPF).
template <int HM0>
__device__ __forceinline__ void butterfly_strided(float (&v)[kEpt]) {
#pragma unroll
  for (int hm = HM0; hm < kEpt; hm <<= 1) {
#pragma unroll
    for (int k = 0; k < kEpt; ++k) {
      if ((k & hm) == 0) {
        const float a = v[k], b = v[k | hm];
        v[k] = a + b;
        v[k | hm] = a - b;
      }
    }
  }
}

// A team of TPF threads over its row buffer, coordinate e at float
// (e / 32) * SEG + e % 32, in three layouts: A, coordinates 32 t + k of
// thread t in register k (128-bit accesses); B, lane + 32 k + 1024 w
// (t = 32 w + lane); C, t + TPF k.  Each is free of bank conflicts.
// STRIDE is the float distance between registers k and k + 1.
template <int STRIDE>
__device__ __forceinline__ void load_regs(float (&v)[kEpt], const float* p) {
#pragma unroll
  for (int k = 0; k < kEpt; ++k) v[k] = p[STRIDE * k];
}

template <int STRIDE>
__device__ __forceinline__ void store_regs(const float (&v)[kEpt], float* p) {
#pragma unroll
  for (int k = 0; k < kEpt; ++k) p[STRIDE * k] = v[k];
}

__device__ __forceinline__ void load_a(float (&v)[kEpt], const float* p) {
#pragma unroll
  for (int q = 0; q < kEpt / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

__device__ __forceinline__ void store_a(const float (&v)[kEpt], float* p) {
#pragma unroll
  for (int q = 0; q < kEpt / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                  v[4 * q + 3]);
}

// Barrier `id` over the `threads` threads of one team.
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// cp.async of `bytes` (0 or the copy's size: 0 writes zeros) from src.
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// A shared-memory float, loaded where it is used: volatile, so that the
// compiler does not hoist a thread's 32-64 loop-invariant radii and dither
// out of the row loop into registers (as konst above).
__device__ __forceinline__ float lds(const float* p) {
  float r;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(r) : "r"(smem_addr(p)));
  return r;
}

// The value of `bits`, opaque to the compiler: sign masks derived from it
// inside the row loop are not hoisted out of it into 96 registers.
__device__ __forceinline__ uint32_t opaque(uint32_t bits) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(bits));
  return bits;
}

// v with its sign flipped where bit k of `neg` is set: v * (-1) exactly,
// and __fmul_rn(u, -c) = -__fmul_rn(u, c) (round to nearest is symmetric).
__device__ __forceinline__ float flip(float v, uint32_t neg, int k) {
  return __uint_as_float(__float_as_uint(v) ^ ((neg << (31 - k)) & 0x80000000u));
}

template <int D, int MODE, bool FLEET>
__global__ void __launch_bounds__(kWideThreads, 1)
structured_wide(const float* __restrict__ x, const float* __restrict__ diags,
                const float* __restrict__ radii, const float* __restrict__ dither,
                const float* __restrict__ rowv, int64_t n_pts, int n, int nblocks,
                float cscale, float qscale, int64_t rows_per_group,
                double* __restrict__ part_c, double* __restrict__ part_s,
                int* __restrict__ qcos, int* __restrict__ qsin) {
  using W = WideLayout<D, MODE>;
  constexpr int TPF = W::TPF, TEAMS = W::TEAMS, SEG = W::SEG;
  extern __shared__ __align__(16) float smem[];
  float* rad = smem;          // radii
  float* dth = rad + D;       // dither (codes)
  const int team = threadIdx.x / TPF, t = threadIdx.x % TPF;
  float* buf = smem + (MODE == kFloat ? 1 : 2) * D + team * W::ROW;

  // Groups of rows_per_group rows (at least one group), TEAMS a CTA: team
  // `team` of the tenant's CTA c takes group c * TEAMS + team.  Rows are
  // indexed across the tenants (row tenant * n_pts + r of x and rowv), and
  // gidx is the tenant's group's partials row (FLEET as in structured<>).
  const int64_t groups = max((int64_t)1, (n_pts + rows_per_group - 1) / rows_per_group);
  const int64_t width = (int64_t)nblocks * D;
  const int64_t ctas = (groups + TEAMS - 1) / TEAMS;  // a tenant's
  const int64_t tenant = FLEET ? blockIdx.x / ctas : 0;
  const int64_t group = (blockIdx.x - tenant * ctas) * TEAMS + team;
  const int64_t base = (int64_t)blockIdx.y * D;  // this CTA's frequency block
  const int64_t opd = tenant * width + base;     // the block in the tenant's operator
  const int64_t r0 = tenant * n_pts + group * rows_per_group;
  const int64_t r1 = tenant * n_pts + min(n_pts, group * rows_per_group + rows_per_group);

  // Stage row r into the team's buffer by cp.async, zeros past column n:
  // 16-byte copies where every row starts 16-byte aligned, else 4-byte.
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const uint32_t sbuf = smem_addr(buf);
  auto stage_row = [&](int64_t r) {
    const float* src = x + r * n;
    if (vec) {
#pragma unroll
      for (int i = 0; i < D / 4 / TPF; ++i) {
        const int e = 4 * (t + TPF * i);
        cp_async16_zfill(sbuf + 4 * ((e >> 5) * SEG + (e & 31)), e < n ? src + e : src,
                         e < n ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < kEpt; ++i) {
        const int e = t + TPF * i;
        cp_async4_zfill(sbuf + 4 * ((e >> 5) * SEG + (e & 31)), e < n ? src + e : src,
                        e < n ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  if (group < groups && r0 < r1) stage_row(r0);

  // The first stage's signs of coordinates 32 t + k (layout A) and the later
  // stages' of t + TPF k (layout C), one bit each (set for -1); the block's
  // radii and dither in shared memory.
  uint32_t neg[3];
  {
    const float4* src = reinterpret_cast<const float4*>(diags + opd * 3 + kEpt * t);
    uint32_t bits = 0;
#pragma unroll
    for (int q = 0; q < kEpt / 4; ++q) {
      const float4 g = __ldg(src + q);
      bits |= (uint32_t)(g.x < 0.0f) << (4 * q) | (uint32_t)(g.y < 0.0f) << (4 * q + 1) |
              (uint32_t)(g.z < 0.0f) << (4 * q + 2) | (uint32_t)(g.w < 0.0f) << (4 * q + 3);
    }
    neg[0] = bits;
  }
#pragma unroll
  for (int s = 1; s < 3; ++s) {
    const float* src = diags + opd * 3 + s * D + t;
    uint32_t bits = 0;
#pragma unroll
    for (int k = 0; k < kEpt; ++k) bits |= (uint32_t)(__ldg(src + TPF * k) < 0.0f) << k;
    neg[s] = bits;
  }
  for (int i = threadIdx.x; i < D; i += kWideThreads) {
    rad[i] = radii[opd + i];
    if (MODE != kFloat) dth[i] = dither[opd + i];
  }
  __syncthreads();
  if (group >= groups) return;

  const int bar = team + 1, lane = t & 31, w = t >> 5;
  float* pa = buf + SEG * t;                 // layout A
  float* pb = buf + SEG * kEpt * w + lane;   // layout B
  float* pc_ = buf + SEG * w + lane;         // layout C
  constexpr int CSTRIDE = SEG * (TPF / kEpt);
  float acc_c[kEpt], acc_s[kEpt];
  int iacc_c[kEpt], iacc_s[kEpt];
  int nvalid = 0;
#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    acc_c[k] = acc_s[k] = 0.0f;
    iacc_c[k] = iacc_s[k] = 0;
  }
  // Float sums: thread t owns coordinates t + TPF k of its group's partials
  // and adds its float sums there every kWideFlushRows rows, in order.
  const int64_t gidx = (tenant * groups + group) * width + base + t;
  bool flushed = false;
  auto flush = [&]() {
#pragma unroll
    for (int k = 0; k < kEpt; ++k) {
      double* gc = part_c + gidx + TPF * k;
      double* gs = part_s + gidx + TPF * k;
      *gc = (flushed ? *gc : 0.0) + (double)acc_c[k];
      *gs = (flushed ? *gs : 0.0) + (double)acc_s[k];
      acc_c[k] = acc_s[k] = 0.0f;
    }
    flushed = true;
  };

  int since = 0;
  for (int64_t r = r0; r < r1; ++r) {
    cp_async_wait<0>();
    team_sync(bar, TPF);  // the row has landed, from every thread's copies
    const uint32_t neg0 = opaque(neg[0]);
    float v[kEpt];
    // Stage 0 in layout A: the row times the first stage's signs.
    load_a(v, pa);
#pragma unroll
    for (int k = 0; k < kEpt; ++k) v[k] = flip(v[k], neg0, k);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (s > 0) {
        // The stage's signs times c, on the previous stage's output (layout
        // C), then back to layout A.
        const uint32_t ns = opaque(neg[s]);
#pragma unroll
        for (int k = 0; k < kEpt; ++k) v[k] = flip(__fmul_rn(v[k], cscale), ns, k);
        store_regs<CSTRIDE>(v, pc_);
        team_sync(bar, TPF);
        load_a(v, pa);
      }
      butterfly_regs<kEpt>(v);  // levels 1 .. 16
      store_a(v, pa);
      team_sync(bar, TPF);
      load_regs<SEG>(v, pb);
      butterfly_regs<kEpt>(v);  // levels 32 .. 512
      store_regs<SEG>(v, pb);
      team_sync(bar, TPF);
      load_regs<CSTRIDE>(v, pc_);
      butterfly_strided<W::HM0>(v);  // levels 1024 .. d / 2
    }
    team_sync(bar, TPF);  // every thread has read the row: the buffer is free
    if (r + 1 < r1) stage_row(r + 1);

    const float rw = rowv ? __ldg(rowv + r) : 1.0f;
    const int vr = (int)rw;
    if (MODE == kSigns) nvalid += vr;
#pragma unroll
    for (int k = 0; k < kEpt; ++k) {
      const int e = t + TPF * k;
      accumulate<MODE>(v[k], lds(rad + e), MODE != kFloat ? lds(dth + e) : 0.0f, cscale, qscale,
                       rw, vr, acc_c[k], acc_s[k], iacc_c[k], iacc_s[k]);
    }
    if (MODE == kFloat && ++since == kWideFlushRows) {
      flush();
      since = 0;
    }
  }

  if (MODE == kFloat) {
    flush();  // also writes a row-less group's zeros
    return;
  }
  if (r0 >= r1) return;
#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    int qc = iacc_c[k], qs = iacc_s[k];
    if (MODE == kSigns) {  // sum of +-1 codes = 2 (count of +1) - weight
      qc = 2 * qc - nvalid;
      qs = 2 * qs - nvalid;
    }
    atomicAdd(qcos + opd + t + TPF * k, qc);
    atomicAdd(qsin + opd + t + TPF * k, qs);
  }
}

// Second pass of the float sums: partials summed in group order, in double;
// a tenant's (groups, width) partials and (width,) outputs follow the
// previous tenant's, blockIdx.x = tenant * col_blocks + column block.
__global__ void reduce_partials(const double* __restrict__ part_c,
                                const double* __restrict__ part_s, int groups,
                                int64_t width, int col_blocks, float* __restrict__ out_c,
                                float* __restrict__ out_s) {
  const int tenant = blockIdx.x / col_blocks;
  const int64_t j = (int64_t)(blockIdx.x - tenant * col_blocks) * blockDim.x + threadIdx.x;
  if (j >= width) return;
  part_c += (int64_t)tenant * groups * width;
  part_s += (int64_t)tenant * groups * width;
  out_c += (int64_t)tenant * width;
  out_s += (int64_t)tenant * width;
  double c = 0.0, s = 0.0;
  for (int b = 0; b < groups; ++b) {
    c += part_c[(int64_t)b * width + j];
    s += part_s[(int64_t)b * width + j];
  }
  out_c[j] = (float)c;
  out_s[j] = (float)s;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*,
                          const float*, int64_t, int, int, float, float, int64_t,
                          double*, double*, int*, int*);

struct Instance {
  KernelFn fn;
  size_t smem;
  int freq_blocks;  // frequency blocks per CTA
  int threads;      // threads per CTA
  int teams;        // row groups per CTA (the wide kernel's teams; 1 elsewhere)
  bool wide;        // structured_wide, which counts its groups from n_pts
};

// Lifts an instance's dynamic shared-memory limit to its size, once per
// device (a cudaFuncSetAttribute per launch would cost more than a small
// launch).  The template arguments name the instance (NX = 0: the wide
// kernel), so that each has its own table.
template <int D, int MODE, int NX, bool FLEET>
cudaError_t allow_smem(KernelFn fn, size_t bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int D, int MODE, int NX, bool FLEET>
cudaError_t instance(Instance* out) {
  *out = {structured<D, MODE, NX, FLEET>, Layout<D, MODE>::BYTES, Layout<D, MODE>::FB,
          kThreads, 1, false};
  return allow_smem<D, MODE, NX, FLEET>(out->fn, out->smem);
}

template <int D, int MODE, bool FLEET>
cudaError_t wide_instance(Instance* out) {
  using W = WideLayout<D, MODE>;
  *out = {structured_wide<D, MODE, FLEET>, W::BYTES, 1, kWideThreads, W::TEAMS, true};
  return allow_smem<D, MODE, 0, FLEET>(out->fn, out->smem);
}

template <int MODE, bool FLEET>
cudaError_t pick_mode(int d, int n, Instance* out) {
  switch (d) {
    case 32:
      if (n <= 16) return instance<32, MODE, 16, FLEET>(out);
      return instance<32, MODE, kEpt, FLEET>(out);
    case 64: return instance<64, MODE, kEpt, FLEET>(out);
    case 128: return instance<128, MODE, kEpt, FLEET>(out);
    case 256: return instance<256, MODE, kEpt, FLEET>(out);
    case 512: return instance<512, MODE, kEpt, FLEET>(out);
    case 1024: return instance<1024, MODE, kEpt, FLEET>(out);
    case 2048: return instance<2048, MODE, kEpt, FLEET>(out);
    case 4096: return wide_instance<4096, MODE, FLEET>(out);
    case 8192: return wide_instance<8192, MODE, FLEET>(out);
    case 16384: return wide_instance<16384, MODE, FLEET>(out);
    default: return cudaErrorInvalidValue;
  }
}

// mode: 0 float sums, 1 b-bit codes, 2 1-bit codes.
template <bool FLEET>
cudaError_t pick(int d, int n, int mode, Instance* out) {
  if (n < 1 || n > d) return cudaErrorInvalidValue;
  if (mode == kFloat) return pick_mode<kFloat, FLEET>(d, n, out);
  if (mode == kCodes) return pick_mode<kCodes, FLEET>(d, n, out);
  if (mode == kSigns) return pick_mode<kSigns, FLEET>(d, n, out);
  return cudaErrorInvalidValue;
}

cudaError_t pick(bool fleet, int d, int n, int mode, Instance* out) {
  return fleet ? pick<true>(d, n, mode, out) : pick<false>(d, n, mode, out);
}

// The first pass over `tenants` tenants of n_pts rows each; fleet selects
// the FLEET instances, whose groups must be ceil(n_pts / rows_per_group), as
// must the wide kernel's (at least 1), whose CTAs hold in.teams groups each.
cudaError_t launch(const Instance& in, bool fleet, int tenants, int nblocks,
                   int64_t rows_per_group, int groups, cudaStream_t stream, const float* x,
                   const float* diags, const float* radii, const float* dither,
                   const float* rowv, int64_t n_pts, int n, float cscale, float qscale,
                   double* part_c, double* part_s, int* qcos, int* qsin) {
  if (tenants < 1 || groups < 1 || rows_per_group < 1 ||
      (int64_t)groups * rows_per_group < n_pts)
    return cudaErrorInvalidValue;
  const int col_blocks = (nblocks + in.freq_blocks - 1) / in.freq_blocks;
  const int64_t exact = (n_pts + rows_per_group - 1) / rows_per_group;
  if ((int64_t)tenants * groups > INT32_MAX || col_blocks > 65535 ||
      (fleet && (n_pts < 1 || groups != exact)) || (!fleet && tenants != 1) ||
      (in.wide && groups != (exact > 1 ? exact : 1)))
    return cudaErrorInvalidValue;
  const int ctas = (groups + in.teams - 1) / in.teams;  // a tenant's
  const dim3 grid(tenants * ctas, col_blocks);
  in.fn<<<grid, in.threads, in.smem, stream>>>(x, diags, radii, dither, rowv, n_pts, n, nblocks,
                                               cscale, qscale, rows_per_group, part_c, part_s,
                                               qcos, qsin);
  return cudaGetLastError();
}

constexpr int kReduceThreads = 256;

// Both passes of the float sums (see the entry points below).
int float_sums(bool fleet, const float* x, const float* diags, const float* radii,
               const float* beta, int tenants, int64_t n_pts, int n, int d, int nblocks,
               float cscale, int64_t rows_per_group, int groups, double* part_c,
               double* part_s, float* out_c, float* out_s, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Instance in;
  cudaError_t err = pick(fleet, d, n, kFloat, &in);
  const int64_t width = (int64_t)nblocks * d;
  const int64_t reduce_blocks = (width + kReduceThreads - 1) / kReduceThreads;
  if (err == cudaSuccess && (int64_t)tenants * reduce_blocks > INT32_MAX)
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = launch(in, fleet, tenants, nblocks, rows_per_group, groups, stream, x, diags, radii,
                 nullptr, beta, n_pts, n, cscale, 1.0f, part_c, part_s, nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<(unsigned)(tenants * reduce_blocks), kReduceThreads, 0, stream>>>(
      part_c, part_s, groups, width, (int)reduce_blocks, out_c, out_s);
  return (int)cudaGetLastError();
}

// The integer code sums (see the entry points below).
int code_sums(bool fleet, const float* x, const float* diags, const float* radii,
              const float* dither, const float* valid, int tenants, int64_t n_pts, int n,
              int d, int nblocks, float cscale, int one_bit, float scale,
              int64_t rows_per_group, int groups, int* qcos, int* qsin, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Instance in;
  cudaError_t err = pick(fleet, d, n, one_bit ? kSigns : kCodes, &in);
  if (err == cudaSuccess)
    err = launch(in, fleet, tenants, nblocks, rows_per_group, groups, stream, x, diags, radii,
                 dither, valid, n_pts, n, cscale, scale, nullptr, nullptr, qcos, qsin);
  return (int)err;
}

}  // namespace

extern "C" {

// Row groups of the instance for (d, n, mode) that run on one SM of the
// current device at once (its CTAs that fit, times the row teams a CTA
// holds: the wide kernel's), into *blocks_per_sm, and the frequency blocks a
// CTA owns, into *freq_blocks.  mode: 0 float sums, 1 b-bit codes, 2 1-bit
// codes.  Returns a cudaError_t code.
int structured_sketch_resident(int d, int n, int mode, int* blocks_per_sm, int* freq_blocks) {
  Instance in;
  cudaError_t err = pick(false, d, n, mode, &in);
  if (err != cudaSuccess) return (int)err;
  *freq_blocks = in.freq_blocks;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, in.fn, in.threads, in.smem);
  *blocks_per_sm *= in.teams;
  return (int)err;
}

// x (n_pts, n), diags (nblocks, 3, d) (entries +-1), radii (nblocks, d),
// beta (n_pts,) float32, contiguous on the device; d a power of two in
// [32, 16384], 1 <= n <= d.  part_c / part_s: (groups, nblocks * d) double
// scratch; out_c / out_s: (nblocks * d,).  groups * rows_per_group must cover
// n_pts.  cscale is the float32 d^-1/2.  Returns a cudaError_t code.
int structured_sketch_sums(const float* x, const float* diags,
                           const float* radii, const float* beta,
                           int64_t n_pts, int n, int d, int nblocks,
                           float cscale, int64_t rows_per_group, int groups,
                           double* part_c, double* part_s, float* out_c,
                           float* out_s, void* stream_ptr) {
  return float_sums(false, x, diags, radii, beta, 1, n_pts, n, d, nblocks, cscale,
                    rows_per_group, groups, part_c, part_s, out_c, out_s, stream_ptr);
}

// The fleet: x (tenants, n_pts, n), diags (tenants, nblocks, 3, d), radii
// (tenants, nblocks, d), beta (tenants, n_pts) float32, contiguous, on the
// device; each tenant's rows against its own operator.  part_c / part_s:
// (tenants, groups, nblocks * d) double scratch; out_c / out_s: (tenants,
// nblocks * d).  rows_per_group and groups are one tenant's, as for an
// isolated call of n_pts >= 1 rows (groups = ceil(n_pts / rows_per_group));
// tenants * groups <= 2^31 - 1.  Returns a cudaError_t code.
int structured_sketch_sums_fleet(const float* x, const float* diags, const float* radii,
                                 const float* beta, int tenants, int64_t n_pts, int n, int d,
                                 int nblocks, float cscale, int64_t rows_per_group, int groups,
                                 double* part_c, double* part_s, float* out_c, float* out_s,
                                 void* stream_ptr) {
  return float_sums(true, x, diags, radii, beta, tenants, n_pts, n, d, nblocks, cscale,
                    rows_per_group, groups, part_c, part_s, out_c, out_s, stream_ptr);
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
  return code_sums(false, x, diags, radii, dither, valid, 1, n_pts, n, d, nblocks, cscale,
                   one_bit, scale, rows_per_group, groups, qcos, qsin, stream_ptr);
}

// The fleet of quantized_structured_sketch_sums: x, diags, radii as for
// structured_sketch_sums_fleet, dither (tenants, nblocks, d) float32, no
// row mask; qcos / qsin: (tenants, nblocks * d) int32, zeroed by the caller.
int quantized_structured_sketch_sums_fleet(const float* x, const float* diags,
                                           const float* radii, const float* dither,
                                           int tenants, int64_t n_pts, int n, int d,
                                           int nblocks, float cscale, int one_bit,
                                           float scale, int64_t rows_per_group, int groups,
                                           int* qcos, int* qsin, void* stream_ptr) {
  return code_sums(true, x, diags, radii, dither, nullptr, tenants, n_pts, n, d, nblocks,
                   cscale, one_bit, scale, rows_per_group, groups, qcos, qsin, stream_ptr);
}

const char* structured_sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

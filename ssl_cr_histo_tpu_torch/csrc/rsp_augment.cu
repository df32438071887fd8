// The whole v1 pretraining augmentation of a tile as one CUDA kernel for
// Hopper (sm_90a): uint8 triplets in, the triplet ordering, the composed
// affine warp, the photometric chain, clip and normalize, float32 or bf16
// planar out.
//
// Replaces, on the pretraining step's path, the JAX package's
//   permute_triplets                            ssl_cr_histo_tpu/parallel/steps.py:51
//   augment_rsp_batch_v1 fused + pallas branch  ssl_cr_histo_tpu/ops/batch.py:59-74
//   warp_affine_mxu_planar (XLA einsums)        ssl_cr_histo_tpu/ops/geometry.py:339
//   the Pallas photometric chain                ssl_cr_histo_tpu/ops/pallas_photometric.py:199
//                                                (_kernel_prng), :261 (_kernel_noise_input)
// The plain PyTorch version is ops/rsp_augment_kernel.py::rsp_augment_plain.
//
// Per output slot n = 3 b + t (block z):
//   0. Ordering and plan.  The slot reads source tile (b, PERM[order[b]][t])
//      (the identity ordering when `order` is null); the inverse map, params,
//      seed and noise are the slot's own.  Thread 0 computes the tile's
//      two-pass plan from its 3x3 inverse map with __fmul_rn / __fdiv_rn /
//      __fadd_rn in ops/geometry.py::warp_pass_coefficients' order, so it is
//      bit-identical to that function (the fix-up flags are discrete
//      decisions: a flipped flag is another decomposition).  `plan_out`, when
//      not null, receives it for checking.  The rot90 and transpose fix-ups
//      become three integers (base, row stride, column stride) of the source
//      address, so a read is two integer multiply-adds.
//   1. Warp.  With (r, c) = swap ? (X, Y) : (Y, X), pass 2 samples row
//      pos2 = fold((d*c + e*r) + f) at its two taps ty; each tap is pass 1 at
//      pos1 = fold((ap*c + bp*ty) + cp) with two taps of the source row, read
//      as u8 * (1/255) (within one ulp of the plain version's u8 / 255) and
//      weighted with the plain version's hat weights.  Positions are formed with __fmul_rn/__fadd_rn, as PyTorch's
//      separate multiply and add kernels round them, so both sample the same
//      taps.  Each thread walks one lattice column c (r increasing) and keeps
//      its last two pass-1 samples: pass 1 at (ty, c) depends on nothing
//      else, so a tap row already held is not sampled again.
//   2. The photometric chain, stages 1-5 (photometric_common.cuh): stages
//      1-3 on each warped pixel inside the column walk, into shared memory;
//      then the blur and brightness/contrast.  The halo pixels the blur needs
//      are warped at their reflect101-folded coordinates, as the chain kernel
//      reads them, and their noise is keyed on those coordinates and the
//      output slot.
//   3. clip to [0, 1], normalize as one multiply-add x * (1/std) - mean/std,
//      round-to-nearest cast, 16-byte stores of the planar output.
//
// What bounds it.  Bytes: at (192, 3, 256, 256) it reads 37.7 MB of uint8
// and writes 75.5 MB of bf16: 33.8 us at 3.35 TB/s.  Arithmetic: the least
// work, as chip_smoke.py counts it (each add, multiply, log, exp ... one;
// one pass-1 sample per intermediate pixel, sliding box sums), about 48 us at
// the 67 TFLOP/s float32 peak with the pretraining law's gates.
// What binds it in practice is instruction issue and latency: the warp's
// folds, hat weights and dependent byte gathers are the larger part, the
// pointwise stages (Philox and Box-Muller, HSV, HED) most of the rest, and
// the blur's halo is 1.30x the pixels.
//
// What the design does about it:
//   - transcendentals on the special-function unit where the error budget
//     allows, divisions by per-tile or per-launch constants as multiplies
//     (error budget: photometric_common.cuh's header; the normalize's
//     multiply-add is within 2 ulp of (x - mean) / std);
//   - the warp's pass-1 reuse (above) and per-thread constants d*c, ap*c;
//   - box sums that slide: the vertical pass carries each column's window
//     (add the entering row, subtract the leaving one), the horizontal pass
//     does the same inside a thread's run of 8 (summation order differs from
//     the plain version's by a few 1e-7);
//   - the pointwise stages run on each pixel as the walk produces it, with
//     no pass over shared memory and no barrier between warp and chain;
//   - one Philox4x32-10 call per pixel for all three channels;
//   - 64x32 output patches with a (64+6) x (32+6) halo (31,920 B of float32
//     in shared memory), four blocks (32 warps) an SM at 64 registers a
//     thread (ptxas: 64, no spills); five blocks would cap a thread at 48
//     registers, below what this source takes; the per-tile params live in
//     shared memory, not registers, and are made by another warp than the
//     plan's;
//   - gates uniform per tile: real branches, no divergence; the blur width
//     and region sizes are template constants.
// No TMA and no tensor cores: the source reads are data-dependent gathers,
// not rectangular tiles, and the colour transforms are 3x3 per pixel, with no
// matrix product for the tensor cores to take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "photometric_common.cuh"

namespace {

using namespace photometric;

constexpr int kPatchH = 32, kPatchW = 64;     // output patch
constexpr int kSpanH = kPatchH + 2 * kHalo;    // halo patch: 38 x 70
constexpr int kSpanW = kPatchW + 2 * kHalo;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;                // 64 registers a thread
constexpr int kRun = 8;                        // output pixels per thread and store
constexpr int kPlan = 8;                       // warp_pass_coefficients row
constexpr int kSmemBytes = 3 * kSpanH * kSpanW * static_cast<int>(sizeof(float));  // 31,920
static_assert(kSmemBytes <= 48 * 1024, "above 48 KB a launch needs cudaFuncSetAttribute");

struct Consts {
  HedMats mats;
  float inv_std[3];
  float shift[3];  // -mean * inv_std
  int perm[6][3];  // ops/rsp_augment_kernel.py::RSP_PERMUTATIONS
  // index of the launch's tile 0 in the global batch: the Philox counter's
  // tile word, so that a process's rows of a data-parallel batch draw the
  // noise a launch over the whole batch draws for them
  int tile0;
};

// The tile's warp plan and what the block derives from it.
struct WarpPlan {
  float ap, bp, cp, d, e, f;
  bool rot, swap;
  int size;
  float period, edge;  // reflect101: 2 (size - 1), and float32(size - 1 + 1e-6)
  int base, row_step, col_step;  // byte offset of lattice pixel (a, b): base + a row_step + b col_step
};

// geometry.py::warp_pass_coefficients on one 3x3 inverse map, operation for
// operation.  The rot90 product R @ m, R = [[0, 1, 0], [-1, 0, size - 1],
// [0, 0, 1]], is written out: its terms with a 0 or 1 factor are exact, so
// only -m0j + (size - 1) m2j rounds, once for an affine map (m2j in {0, 1})
// in any summation order, as PyTorch's product does.
__device__ WarpPlan make_plan(const float* __restrict__ mp, int size) {
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = mp[i];
  WarpPlan w;
  w.rot = __fadd_rn(fabsf(m[0]), fabsf(m[4])) < __fadd_rn(fabsf(m[1]), fabsf(m[3]));
  if (w.rot) {
    const float hi = static_cast<float>(size - 1);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float r1 = __fadd_rn(-m[j], __fmul_rn(hi, m[6 + j]));
      m[j] = m[3 + j];
      m[3 + j] = r1;
    }
  }
  w.swap = fabsf(m[0]) > fabsf(m[4]);
  if (w.swap) {  // S @ m @ S, S swapping x and y: a permutation, exact
    float t;
    t = m[0]; m[0] = m[4]; m[4] = t;
    t = m[1]; m[1] = m[3]; m[3] = t;
    t = m[2]; m[2] = m[5]; m[5] = t;
  }
  const float a = m[0], b = m[1], c = m[2];
  w.d = m[3];
  w.e = m[4];
  w.f = m[5];
  const float es = fabsf(w.e) < 1e-6f ? (w.e < 0.0f ? -1e-6f : 1e-6f) : w.e;
  w.ap = __fsub_rn(a, __fdiv_rn(__fmul_rn(b, w.d), es));
  w.bp = __fdiv_rn(b, es);
  w.cp = __fsub_rn(c, __fdiv_rn(__fmul_rn(b, w.f), es));
  w.size = size;
  w.period = 2.0f * static_cast<float>(size - 1);
  w.edge = static_cast<float>(static_cast<double>(size - 1) + 1e-6);
  // lattice (a, b) of the fixed-up tile: transposed where swap, after a
  // 90-degree turn where rot; the source is (size, size, 3) uint8
  const int row = 3 * size, col = 3, last = 3 * (size - 1);
  if (!w.rot) {
    w.base = 0;
    w.row_step = w.swap ? col : row;
    w.col_step = w.swap ? row : col;
  } else {
    w.base = last;
    w.row_step = w.swap ? row : -col;
    w.col_step = w.swap ? -col : row;
  }
  return w;
}

// geometry.py::_fold_coords, reflect101 (including its 1e-6 edge).
__device__ __forceinline__ float fold_pos(float pos, const WarpPlan& w) {
  if (w.size == 1) return 0.0f;
  pos = fabsf(pos);
  // fmodf, with its common case as one subtraction: exact for
  // period <= pos < 2 period (Sterbenz), as fmodf is
  if (pos >= w.period) pos = pos < 2.0f * w.period ? pos - w.period : fmodf(pos, w.period);
  return pos >= w.edge ? w.period - pos : pos;
}

struct Taps {
  int i0, i1;    // clamped indices
  float w0, w1;  // hat weights, 0 outside [0, size - 1]
};

// The plain version's taps and hat weights for a folded position: pos is in
// [0, edge) with edge < size, so t0 lies in [0, size - 1] and only t1 can
// fall outside (weight 0, index clamped), as the general form computes.
__device__ __forceinline__ Taps taps(float pos, int size) {
  const float hi = static_cast<float>(size - 1);
  const float t0 = floorf(pos), t1 = t0 + 1.0f;
  Taps t;
  t.w0 = fmaxf(1.0f - fabsf(t0 - pos), 0.0f);
  t.w1 = t1 <= hi ? fmaxf(1.0f - fabsf(t1 - pos), 0.0f) : 0.0f;
  t.i0 = static_cast<int>(t0);
  t.i1 = min(t.i0 + 1, size - 1);
  return t;
}

// A byte as a float in [0, 1], within one ulp of u8 / 255.0f: the byte is
// made exact in the mantissa of 2^23, with no conversion instruction.
__device__ __forceinline__ float unit_u8(uint32_t u8) {
  return (__int_as_float(0x4B000000u | u8) - 8388608.0f) * (1.0f / 255.0f);
}

// Pass 1 at row ty of the fixed-up lattice, for the column whose ap * c is
// `apc`: three channels.
__device__ __forceinline__ void pass1(const uint8_t* __restrict__ tile, const WarpPlan& w, float apc, int ty,
                                      float out[3]) {
  const Taps t = taps(fold_pos(__fadd_rn(__fadd_rn(apc, __fmul_rn(w.bp, static_cast<float>(ty))), w.cp), w),
                      w.size);
  const uint8_t* row = tile + w.base + ty * w.row_step;
  const uint8_t* p0 = row + t.i0 * w.col_step;
  const uint8_t* p1 = row + t.i1 * w.col_step;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    out[ch] = __fadd_rn(__fmul_rn(unit_u8(__ldg(p0 + ch)), t.w0), __fmul_rn(unit_u8(__ldg(p1 + ch)), t.w1));
}

__device__ __forceinline__ void store_run(float* dst, const float v[kRun], int count, bool vec) {
  if (vec && count == kRun) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (j < count) dst[j] = v[j];
  }
}

__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float v[kRun], int count, bool vec) {
  if (vec && count == kRun) {
    alignas(16) __nv_bfloat162 q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(q);
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (j < count) dst[j] = __float2bfloat16_rn(v[j]);
  }
}

// Per-block state, in shared memory.
struct BlockShared {
  WarpPlan wp;
  TileParams tp;
  const uint8_t* tile;  // the slot's source tile: (size, size, 3) uint8
};

using Span = float (*)[kSpanH][kSpanW];  // [3][kSpanH][kSpanW] in dynamic shared memory

// v[c] without a dynamic index into the kernel's parameter space.
__device__ __forceinline__ float pick3(const float (&v)[3], int c) { return c == 0 ? v[0] : c == 1 ? v[1] : v[2]; }

// The last two pass-1 samples of a column walk: rows ka and kb.
struct WalkCache {
  int ka, kb;
  float va[3], vb[3];
};

// One pixel of a column walk: pass 2 at lattice row r of the column whose
// d * c and ap * c are dc and apc, taking pass-1 rows from the cache where
// it holds them.
__device__ __forceinline__ void walk_step(WalkCache& q, const BlockShared& sh, const WarpPlan& w, float apc,
                                          float dc, int r, float v[3]) {
  const Taps t = taps(fold_pos(__fadd_rn(__fadd_rn(dc, __fmul_rn(w.e, static_cast<float>(r))), w.f), w), w.size);
  const bool need0 = t.i0 != q.ka && t.i0 != q.kb;
  const bool need1 = t.i1 != t.i0 && t.i1 != q.ka && t.i1 != q.kb;
  float n0[3], n1[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    n0[ch] = t.i0 == q.ka ? q.va[ch] : q.vb[ch];
    n1[ch] = t.i1 == q.ka ? q.va[ch] : q.vb[ch];
  }
  if (need0 || need1) {  // one call site for either tap: a warp pays once when its lanes differ
    float p[3];
    pass1(sh.tile, w, apc, need0 ? t.i0 : t.i1, p);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (need0) n0[ch] = p[ch];
      else n1[ch] = p[ch];
    }
  }
  if (need0 && need1) pass1(sh.tile, w, apc, t.i1, n1);
  q.ka = t.i0;
  q.kb = t.i1;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    if (t.i1 == t.i0) n1[ch] = n0[ch];
    q.va[ch] = n0[ch];
    q.vb[ch] = n1[ch];
    v[ch] = __fadd_rn(__fmul_rn(n0[ch], t.w0), __fmul_rn(n1[ch], t.w1));
  }
}

// Warp and stages 1-3 into s over an H x W region of the halo patch starting
// at (lo, lo): the full halo with the blur, only the patch without it.  Each
// thread walks part of one lattice column c (a column of the patch, or a row
// where swap); the region's columns split into as many segments as keep
// every thread busy at most once.  The two pass-1 samples held are reused
// whenever the next pixel's pass-2 taps land on them.
template <int H, int W>
__device__ __forceinline__ void warp_region(Span s, const BlockShared& sh, const HedMats& mats,
                                            const float* __restrict__ noise, uint32_t seed, int n, int ctr_n,
                                            int y0, int x0, int lo) {
  const WarpPlan w = sh.wp;
  const int lines = w.swap ? H : W, len = w.swap ? W : H;
  const int segs = max(1, kThreads / lines);
  const int seg_len = (len + segs - 1) / segs;
  const int line = threadIdx.x % lines, seg = threadIdx.x / lines;
  if (seg >= segs) return;
  const int hl = lo + line;
  const int c = fold101((w.swap ? y0 : x0) - kHalo + hl, w.size);
  const float apc = __fmul_rn(w.ap, static_cast<float>(c)), dc = __fmul_rn(w.d, static_cast<float>(c));
  const int walk0 = (w.swap ? x0 : y0) - kHalo;
  WalkCache cache;
  cache.ka = cache.kb = -1;
  for (int k = seg * seg_len; k < min(len, (seg + 1) * seg_len); ++k) {
    const int hw = lo + k;
    const int r = fold101(walk0 + hw, w.size);
    float v[3];
    walk_step(cache, sh, w, apc, dc, r, v);
    pointwise_stages(v, sh.tp, mats, noise, seed, n, ctr_n, w.size, w.size, w.swap ? c : r, w.swap ? r : c);
    const int hy = w.swap ? hl : hw, hx = w.swap ? hw : hl;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s[ch][hy][hx] = v[ch];
  }
}

// Vertical box-blur pass of half-width HALF >= 1, in place: output row r
// reads rows r+3-HALF .. r+3+HALF (all >= r).  Each thread walks one
// column top to bottom carrying the window's sum; the leaving row is read
// before row r is written (they are the same row when HALF = 3).
template <int HALF>
__device__ __forceinline__ void vertical_pass(Span s) {
  constexpr float kInv = 1.0f / (2 * HALF + 1);
  for (int i = threadIdx.x; i < 3 * kSpanW; i += kThreads) {
    float(*col)[kSpanW] = s[i / kSpanW];
    const int cx = i % kSpanW;
    float acc = 0.0f;
#pragma unroll
    for (int dy = -HALF; dy <= HALF; ++dy) acc += col[kHalo + dy][cx];
    for (int r = 0; r < kPatchH; ++r) {
      const float leaving = col[r + kHalo - HALF][cx];
      col[r][cx] = acc * kInv;
      if (r + 1 < kPatchH) acc += col[r + kHalo + HALF + 1][cx] - leaving;
    }
  }
}

// Horizontal box-blur pass of half-width HALF (none for 0), sliding inside
// a thread's run of kRun pixels of one row and channel; brightness /
// contrast, clip, normalize, store.  `row_off` is the shared-memory row of
// output row 0 (0 after the vertical pass, kHalo without it).
template <int HALF, typename OutT>
__device__ __forceinline__ void output_pass(Span s, const BlockShared& sh, const Consts& k,
                                            OutT* __restrict__ out, int n, int size, int y0, int x0,
                                            int row_off) {
  constexpr float kInv = 1.0f / (2 * HALF + 1);
  constexpr int kRunsPerRow = kPatchW / kRun;
  const bool bc = sh.tp.bc;
  const float gain = sh.tp.gain, bias = sh.tp.bias;
  const size_t plane = static_cast<size_t>(size) * size;
  const bool vec = size % kRun == 0;
  for (int i = threadIdx.x; i < 3 * kPatchH * kRunsPerRow; i += kThreads) {
    const int c = i / (kPatchH * kRunsPerRow);
    const int r = (i / kRunsPerRow) % kPatchH;
    const int xr = (i % kRunsPerRow) * kRun;
    const int gy = y0 + r, gx = x0 + xr;
    if (gy >= size || gx >= size) continue;
    const float* row = s[c][r + row_off] + xr + kHalo;
    const float scale = pick3(k.inv_std, c), shift = pick3(k.shift, c);
    float v[kRun];
    float acc = 0.0f;
    if (HALF > 0) {
#pragma unroll
      for (int dx = -HALF; dx <= HALF; ++dx) acc += row[dx];
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      float x;
      if (HALF == 0) {
        x = row[j];
      } else {
        if (j > 0) acc += row[j + HALF] - row[j - 1 - HALF];
        x = acc * kInv;
      }
      if (bc) x = clip01(x * gain + bias);
      v[j] = clip01(x) * scale + shift;
    }
    OutT* dst = out + (static_cast<size_t>(n) * 3 + c) * plane + static_cast<size_t>(gy) * size + gx;
    store_run(dst, v, min(kRun, size - gx), vec);
  }
}

template <int HALF, typename OutT>
__device__ __forceinline__ void blur_and_output(Span s, const BlockShared& sh, const Consts& k,
                                                OutT* __restrict__ out, int n, int size, int y0, int x0) {
  vertical_pass<HALF>(s);
  __syncthreads();
  output_pass<HALF>(s, sh, k, out, n, size, y0, x0, 0);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rsp_augment_kernel(const uint8_t* __restrict__ src, const float* __restrict__ mats,
                   const int32_t* __restrict__ order, const float* __restrict__ noise,
                   const int32_t* __restrict__ seeds, const float* __restrict__ params,
                   OutT* __restrict__ out, float* __restrict__ plan_out, int size, Consts k) {
  extern __shared__ float s_dyn[];
  __shared__ BlockShared sh;

  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sh.wp = make_plan(mats + static_cast<size_t>(n) * 9, size);
    if (plan_out != nullptr && blockIdx.x == 0 && blockIdx.y == 0) {
      const WarpPlan& w = sh.wp;
      float* row = plan_out + static_cast<size_t>(n) * kPlan;
      row[0] = w.ap;
      row[1] = w.bp;
      row[2] = w.cp;
      row[3] = w.d;
      row[4] = w.e;
      row[5] = w.f;
      row[6] = w.rot ? 1.0f : 0.0f;
      row[7] = w.swap ? 1.0f : 0.0f;
    }
  }
  if (tid == 32) {  // another warp than the plan's
    sh.tp = tile_params(params + static_cast<size_t>(n) * kParams);
    const int t = n % 3;
    int src_t = t;
    if (order != nullptr) {
      const int o = order[n / 3];
#pragma unroll
      for (int oi = 0; oi < 6; ++oi)
#pragma unroll
        for (int ti = 0; ti < 3; ++ti)
          if (oi == o && ti == t) src_t = k.perm[oi][ti];
    }
    sh.tile = src + static_cast<size_t>(n - t + src_t) * size * size * 3;
  }
  __syncthreads();

  const Span s = reinterpret_cast<Span>(s_dyn);
  const uint32_t seed = static_cast<uint32_t>(seeds[n]);
  const int x0 = blockIdx.x * kPatchW, y0 = blockIdx.y * kPatchH;
  // Gates are uniform per tile: these branches do not diverge.
  if (sh.tp.blur) {
    warp_region<kSpanH, kSpanW>(s, sh, k.mats, noise, seed, n, n + k.tile0, y0, x0, 0);
    __syncthreads();
    switch (sh.tp.half) {  // k = 3, 5, 7 -> 1, 2, 3
      case 0: output_pass<0>(s, sh, k, out, n, size, y0, x0, kHalo); break;
      case 1: blur_and_output<1>(s, sh, k, out, n, size, y0, x0); break;
      case 2: blur_and_output<2>(s, sh, k, out, n, size, y0, x0); break;
      default: blur_and_output<3>(s, sh, k, out, n, size, y0, x0); break;
    }
  } else {
    warp_region<kPatchH, kPatchW>(s, sh, k.mats, noise, seed, n, n + k.tile0, y0, x0, kHalo);
    __syncthreads();
    output_pass<0>(s, sh, k, out, n, size, y0, x0, kHalo);
  }
}

template <typename OutT>
int launch(const uint8_t* src, const float* mats, const int32_t* order, const float* noise,
           const int32_t* seeds, const float* params, OutT* out, float* plan_out, int n, int size,
           const Consts& k, cudaStream_t stream) {
  const dim3 grid((size + kPatchW - 1) / kPatchW, (size + kPatchH - 1) / kPatchH, n);
  rsp_augment_kernel<OutT><<<grid, kThreads, kSmemBytes, stream>>>(src, mats, order, noise, seeds, params, out,
                                                                   plan_out, size, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`.  src: (n / 3, 3, size, size, 3) uint8 triplets in the
// sampler's order; mats: (n, 3, 3) float32 inverse maps; order: (n / 3,)
// int32 ordering indices in [0, 6), or null for the identity ordering;
// noise: (n, 3, size, size) float32 or null (Philox mode); seeds: (n,)
// int32; params: (n, 16) float32; out: (n, 3, size, size), bfloat16 if
// out_bf16 else float32; tile0: the index of tile 0 in the global batch
// whose rows these are (0 for a whole batch), the Philox counter's tile
// word; plan_out: (n, 8) float32 or null, receives each tile's warp plan.  Every device array is contiguous; n is a multiple of 3.
// host_consts: 24 floats in host memory, HED_FROM_RGB and RGB_FROM_HED
// (row-major), then mean[3] and std[3]; host_perms: 18 int32 in host memory,
// the six orderings.  Returns a cudaError_t as int (0 on success).
extern "C" int launch_rsp_augment(const uint8_t* src, const float* mats, const int32_t* order,
                                  const float* noise, const int32_t* seeds, const float* params, void* out,
                                  int out_bf16, int n, int size, int tile0, const float* host_consts,
                                  const int32_t* host_perms, float* plan_out, void* stream) {
  Consts k;
  k.tile0 = tile0;
  for (int i = 0; i < 9; ++i) {
    k.mats.hed_from_rgb[i] = host_consts[i];
    k.mats.rgb_from_hed[i] = host_consts[9 + i];
  }
  for (int c = 0; c < 3; ++c) {
    k.inv_std[c] = 1.0f / host_consts[21 + c];
    k.shift[c] = -host_consts[18 + c] * k.inv_std[c];
  }
  for (int i = 0; i < 18; ++i) k.perm[i / 3][i % 3] = host_perms[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch(src, mats, order, noise, seeds, params, static_cast<__nv_bfloat16*>(out), plan_out, n, size,
                  k, s);
  return launch(src, mats, order, noise, seeds, params, static_cast<float*>(out), plan_out, n, size, k, s);
}

// The whole v1 pretraining augmentation of a tile as one CUDA kernel for
// Hopper (sm_90a): uint8 triplets in, the composed affine warp, the
// photometric chain, clip and normalize, float32 or bf16 planar out.
//
// Replaces, on the pretraining step's path, the JAX package's
//   augment_rsp_batch_v1 fused + pallas branch  ssl_cr_histo_tpu/ops/batch.py:59-74
//   warp_affine_mxu_planar (XLA einsums)        ssl_cr_histo_tpu/ops/geometry.py:339
//   the Pallas photometric chain                ssl_cr_histo_tpu/ops/pallas_photometric.py:199
//                                                (_kernel_prng), :261 (_kernel_noise_input)
// and the port's five steps around them (uint8 -> float32 planar copy, the
// plain two-pass warp, the chain kernel, clip, normalize).  The plain
// PyTorch version is ops/rsp_augment_kernel.py::rsp_augment_plain.
//
// Per output pixel (Y, X) of tile n, in the plain version's order:
//   1. Warp.  ops/geometry.py::warp_pass_coefficients gives the tile's
//      two-pass plan [ap, bp, cp, d, e, f, rot_dominant, swap].  With
//      (r, c) = swap ? (X, Y) : (Y, X), pass 2 samples row
//      pos2 = fold((d*c + e*r) + f) at its two taps ty, each tap is pass 1
//      at pos1 = fold((ap*c + bp*ty) + cp) with two taps of the source row,
//      so 4 uint8 reads per channel, each converted as u8 / 255.0f (a table
//      filled with IEEE divisions) and weighted with the hat weights of the
//      plain version.  Positions are formed with __fmul_rn/__fadd_rn, as
//      PyTorch's separate multiply and add kernels round them, so both sample
//      the same taps.  The rot90 and transpose fix-ups are index remaps of
//      the source read and of the output coordinate: no data moves for them.
//   2. The photometric chain of photometric_chain.cu, stages 1-5
//      (photometric_common.cuh).  The halo pixels the blur needs are warped
//      at their reflect101-folded coordinates, as the chain kernel reads
//      them, and their noise is keyed on those coordinates.
//   3. clip to [0, 1], (x - mean) / std, round-to-nearest cast to the output
//      type, 16-byte vector stores of the planar output.
//
// What bounds it.  Bytes: at (192, 3, 256, 256) it reads 37.7 MB of uint8
// and writes 75.5 MB of bf16 (151 MB of float32): 33.8 us (56.3 us) at
// 3.35 TB/s.  Arithmetic: counted from this code, a pixel costs about 105
// operations of warp, 60 of HED, 12 of normalize, and with their gates 45
// of HSV, 138 of Philox noise and 2k + 2 per channel of blur; with the
// pretraining law's gates that is about 54 us at the 67 TFLOP/s float32
// peak, so on paper the arithmetic, not the bytes, bounds it.  What binds
// it in practice is instruction issue and latency: the accurate logf, expf,
// sincosf and IEEE divisions expand to dozens of instructions each, and the
// blur's halo and passes add more.  Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py, PERF.md): with every gate off the kernel takes 244 us on
// identity warps and 274 us on the drawn ones, so the data-dependent
// gathers cost about a tenth; the blur at k = 7 adds 105 us, the noise
// 84 us, the HSV shift 37 us.
//
// What the design does about it:
//   - one Philox4x32-10 call per pixel for all three channels (the chain
//     kernel used one per channel), keyed on the folded coordinate so that
//     halo recompute draws the same noise;
//   - 64x32 output patches with a (64+6) x (32+6) halo (31,920 B of float32
//     in shared memory): the halo recompute is 1.30x the pixels, not the
//     32x32 patches' 1.41x, and with 64 registers four blocks (32 warps) fit
//     on an SM, where a 64x64 patch (1.20x, 58,800 B) fits three.  Without
//     the blur only the patch is computed;
//   - the vertical blur pass runs in place in shared memory, one column per
//     thread, top to bottom (a row is overwritten only after every window
//     that reads it), so one buffer serves both passes;
//   - gates are uniform per tile: real branches, no divergence; the blur
//     width and the region sizes are template constants, so its loops
//     unroll and the index arithmetic has no runtime division;
//   - reflect101 folds take fmodf's common case as one exact subtraction;
//   - the source is read through the read-only path (__ldg) and is not
//     staged in shared memory: the gathers are data dependent, so TMA tile
//     loads do not apply, and the measurement above shows they do not bind.
// Tensor cores: there is no matrix product here for them, only 3x3 colour
// matrices per pixel.
//
// Built without --use_fast_math: logf/expf/sincosf/division stay
// IEEE-accurate, so the kernel agrees with the plain version to a few ulp.

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
constexpr int kCoefs = 8;                      // warp_pass_coefficients row
constexpr int kSmemBytes = 3 * kSpanH * kSpanW * static_cast<int>(sizeof(float));  // 31,920
static_assert(kSmemBytes <= 48 * 1024, "above 48 KB a launch needs cudaFuncSetAttribute");

struct Consts {
  HedMats mats;
  float mean[3];
  float std[3];
};

struct WarpPlan {
  float ap, bp, cp, d, e, f;
  bool rot, swap;
  int size;
  float period, edge;  // reflect101: 2 (size - 1), and float32(size - 1 + 1e-6)
};

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

__device__ __forceinline__ Taps taps(float pos, int size) {
  const float hi = static_cast<float>(size - 1);
  const float t0 = floorf(pos), t1 = t0 + 1.0f;
  Taps t;
  t.w0 = (t0 >= 0.0f && t0 <= hi) ? fmaxf(1.0f - fabsf(t0 - pos), 0.0f) : 0.0f;
  t.w1 = (t1 >= 0.0f && t1 <= hi) ? fmaxf(1.0f - fabsf(t1 - pos), 0.0f) : 0.0f;
  t.i0 = static_cast<int>(fminf(fmaxf(t0, 0.0f), hi));
  t.i1 = static_cast<int>(fminf(fmaxf(t1, 0.0f), hi));
  return t;
}

// (a*x + b*y) + c, each operation rounded on its own.
__device__ __forceinline__ float affine_rn(float a, float x, float b, float y, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// Byte offset in the (size, size, 3) uint8 tile of pixel (a, b) of the
// fixed-up lattice: transposed where swap, after a 90-degree turn where rot.
__device__ __forceinline__ int src_offset(int a, int b, const WarpPlan& w) {
  const int a1 = w.swap ? b : a, b1 = w.swap ? a : b;
  const int row = w.rot ? b1 : a1, col = w.rot ? w.size - 1 - a1 : b1;
  return 3 * (row * w.size + col);
}

// Pass 1 at row ty, column c of the fixed-up lattice, three channels.
__device__ __forceinline__ void pass1(const uint8_t* __restrict__ tile, const float* lut,
                                      const WarpPlan& w, int ty, int c, float out[3]) {
  const Taps t = taps(fold_pos(affine_rn(w.ap, static_cast<float>(c), w.bp, static_cast<float>(ty), w.cp), w),
                      w.size);
  const uint8_t* p0 = tile + src_offset(ty, t.i0, w);
  const uint8_t* p1 = tile + src_offset(ty, t.i1, w);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    out[ch] = __fadd_rn(__fmul_rn(lut[__ldg(p0 + ch)], t.w0), __fmul_rn(lut[__ldg(p1 + ch)], t.w1));
}

// The warped tile's value at output pixel (y, x), three channels.
__device__ __forceinline__ void warp_pixel(const uint8_t* __restrict__ tile, const float* lut,
                                           const WarpPlan& w, int y, int x, float out[3]) {
  const int r = w.swap ? x : y, c = w.swap ? y : x;
  const Taps t = taps(fold_pos(affine_rn(w.d, static_cast<float>(c), w.e, static_cast<float>(r), w.f), w),
                      w.size);
  float v0[3], v1[3];
  pass1(tile, lut, w, t.i0, c, v0);
  pass1(tile, lut, w, t.i1, c, v1);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[ch] = __fadd_rn(__fmul_rn(v0[ch], t.w0), __fmul_rn(v1[ch], t.w1));
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

// Per-block state shared by the stages below.
struct Block {
  float (*s)[kSpanH][kSpanW];  // [3][kSpanH][kSpanW] in dynamic shared memory
  const float* lut;            // u8 -> u8 / 255.0f
  const uint8_t* tile;         // this tile's (size, size, 3) uint8 pixels
  const float* p;              // its 16 params (registers)
  WarpPlan wp;
  int n, size, y0, x0;
  uint32_t seed;
};

// Warp and stages 1-3 over an H x W region of the halo patch starting at
// (lo, lo): the full halo with the blur, only the patch without it.  H and
// W are constants, so the index arithmetic is multiplies and shifts.
template <int H, int W>
__device__ __forceinline__ void pointwise_region(const Block& b, const float* __restrict__ noise,
                                                 const Consts& k, int lo) {
  for (int i = threadIdx.x; i < H * W; i += kThreads) {
    const int hy = lo + i / W, hx = lo + i % W;
    const int gy = fold101(b.y0 - kHalo + hy, b.size), gx = fold101(b.x0 - kHalo + hx, b.size);
    float v[3];
    warp_pixel(b.tile, b.lut, b.wp, gy, gx, v);
    pointwise_stages(v, b.p, k.mats, noise, b.seed, b.n, b.size, b.size, gy, gx);
    b.s[0][hy][hx] = v[0];
    b.s[1][hy][hx] = v[1];
    b.s[2][hy][hx] = v[2];
  }
}

// Vertical box-blur pass of half-width HALF, in place: output row r reads
// rows r+3-HALF .. r+3+HALF (all >= r), so writing row r after reading its
// window destroys no input a later row still needs.  One column per thread.
template <int HALF>
__device__ __forceinline__ void vertical_pass(const Block& b) {
  constexpr float kNorm = 2 * HALF + 1;
  for (int i = threadIdx.x; i < 3 * kSpanW; i += kThreads) {
    float(*col)[kSpanW] = b.s[i / kSpanW];
    const int cx = i % kSpanW;
    for (int r = 0; r < kPatchH; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int dy = -HALF; dy <= HALF; ++dy) acc += col[r + kHalo + dy][cx];
      col[r][cx] = acc / kNorm;
    }
  }
}

// Horizontal box-blur pass of half-width HALF (none for 0), brightness /
// contrast, clip, normalize, store.  Each thread writes a run of kRun
// pixels of one row and channel; `row_off` is the shared-memory row of
// output row 0 (0 after the vertical pass, kHalo without the blur).
template <int HALF, typename OutT>
__device__ __forceinline__ void output_pass(const Block& b, const Consts& k, OutT* __restrict__ out,
                                            int row_off) {
  constexpr float kNorm = 2 * HALF + 1;
  constexpr int kRunsPerRow = kPatchW / kRun;
  const bool bc = b.p[13] > 0.5f;
  const float gain = 1.0f + b.p[12], bias = b.p[11];
  const size_t plane = static_cast<size_t>(b.size) * b.size;
  const bool vec = b.size % kRun == 0;
  for (int i = threadIdx.x; i < 3 * kPatchH * kRunsPerRow; i += kThreads) {
    const int c = i / (kPatchH * kRunsPerRow);
    const int r = (i / kRunsPerRow) % kPatchH;
    const int xr = (i % kRunsPerRow) * kRun;
    const int gy = b.y0 + r, gx = b.x0 + xr;
    if (gy >= b.size || gx >= b.size) continue;
    const float* row = b.s[c][r + row_off] + xr + kHalo;
    float v[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      float x;
      if (HALF == 0) {
        x = row[j];
      } else {
        float acc = 0.0f;
#pragma unroll
        for (int dx = -HALF; dx <= HALF; ++dx) acc += row[j + dx];
        x = acc / kNorm;
      }
      if (bc) x = clip01(x * gain + bias);
      v[j] = (clip01(x) - k.mean[c]) / k.std[c];
    }
    OutT* dst = out + (static_cast<size_t>(b.n) * 3 + c) * plane + static_cast<size_t>(gy) * b.size + gx;
    store_run(dst, v, min(kRun, b.size - gx), vec);
  }
}

template <int HALF, typename OutT>
__device__ __forceinline__ void blur_and_output(const Block& b, const Consts& k, OutT* __restrict__ out) {
  vertical_pass<HALF>(b);
  __syncthreads();
  output_pass<HALF>(b, k, out, 0);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rsp_augment_kernel(const uint8_t* __restrict__ src, const float* __restrict__ coefs,
                   const float* __restrict__ noise, const int32_t* __restrict__ seeds,
                   const float* __restrict__ params, OutT* __restrict__ out, int size, Consts k) {
  extern __shared__ float s_dyn[];
  __shared__ float s_lut[256];
  __shared__ float s_p[kParams + kCoefs];

  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  s_lut[tid] = static_cast<float>(tid) / 255.0f;  // kThreads == 256
  if (tid < kParams) s_p[tid] = params[static_cast<size_t>(n) * kParams + tid];
  if (tid < kCoefs) s_p[kParams + tid] = coefs[static_cast<size_t>(n) * kCoefs + tid];
  __syncthreads();

  float p[kParams];
#pragma unroll
  for (int j = 0; j < kParams; ++j) p[j] = s_p[j];
  Block b;
  b.s = reinterpret_cast<float(*)[kSpanH][kSpanW]>(s_dyn);
  b.lut = s_lut;
  b.p = p;
  b.n = n;
  b.size = size;
  b.y0 = blockIdx.y * kPatchH;
  b.x0 = blockIdx.x * kPatchW;
  b.seed = static_cast<uint32_t>(seeds[n]);
  b.tile = src + static_cast<size_t>(n) * size * size * 3;
  b.wp.ap = s_p[kParams + 0];
  b.wp.bp = s_p[kParams + 1];
  b.wp.cp = s_p[kParams + 2];
  b.wp.d = s_p[kParams + 3];
  b.wp.e = s_p[kParams + 4];
  b.wp.f = s_p[kParams + 5];
  b.wp.rot = s_p[kParams + 6] > 0.5f;
  b.wp.swap = s_p[kParams + 7] > 0.5f;
  b.wp.size = size;
  b.wp.period = 2.0f * static_cast<float>(size - 1);
  b.wp.edge = static_cast<float>(static_cast<double>(size - 1) + 1e-6);

  // Gates are uniform per tile: these branches do not diverge.
  if (p[10] > 0.5f) {
    pointwise_region<kSpanH, kSpanW>(b, noise, k, 0);
    __syncthreads();
    switch (min((static_cast<int>(p[9]) - 1) / 2, kHalo)) {  // k = 3, 5, 7 -> 1, 2, 3
      case 0: blur_and_output<0>(b, k, out); break;
      case 1: blur_and_output<1>(b, k, out); break;
      case 2: blur_and_output<2>(b, k, out); break;
      default: blur_and_output<3>(b, k, out); break;
    }
  } else {
    pointwise_region<kPatchH, kPatchW>(b, noise, k, kHalo);
    __syncthreads();
    output_pass<0>(b, k, out, kHalo);
  }
}

template <typename OutT>
int launch(const uint8_t* src, const float* coefs, const float* noise, const int32_t* seeds,
           const float* params, OutT* out, int n, int size, const Consts& k, cudaStream_t stream) {
  const dim3 grid((size + kPatchW - 1) / kPatchW, (size + kPatchH - 1) / kPatchH, n);
  rsp_augment_kernel<OutT><<<grid, kThreads, kSmemBytes, stream>>>(src, coefs, noise, seeds, params, out,
                                                                   size, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`.  src: (n, size, size, 3) uint8 (the (B, 3, S, S, 3)
// triplets, contiguous); coefs: (n, 8) float32 from warp_pass_coefficients;
// noise: (n, 3, size, size) float32 or null (Philox mode); seeds: (n,)
// int32; params: (n, 16) float32; out: (n, 3, size, size), bfloat16 if
// out_bf16 else float32.  All on the device and contiguous.  host_consts:
// 24 floats in host memory, HED_FROM_RGB and RGB_FROM_HED (row-major), then
// mean[3] and std[3].  Returns a cudaError_t as int (0 on success).
extern "C" int launch_rsp_augment(const uint8_t* src, const float* coefs, const float* noise,
                                  const int32_t* seeds, const float* params, void* out, int out_bf16,
                                  int n, int size, const float* host_consts, void* stream) {
  Consts k;
  for (int i = 0; i < 9; ++i) {
    k.mats.hed_from_rgb[i] = host_consts[i];
    k.mats.rgb_from_hed[i] = host_consts[9 + i];
  }
  for (int c = 0; c < 3; ++c) {
    k.mean[c] = host_consts[18 + c];
    k.std[c] = host_consts[21 + c];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch(src, coefs, noise, seeds, params, static_cast<__nv_bfloat16*>(out), n, size, k, s);
  return launch(src, coefs, noise, seeds, params, static_cast<float*>(out), n, size, k, s);
}

// Device code shared by photometric_chain.cu and rsp_augment.cu: reflect101
// folding, Philox4x32-10 and its Box-Muller normals, RGB<->HSV, the per-tile
// parameters, and the chain's pointwise stages 1-3 (HSV shift, Gaussian
// noise, HED shift), one function a stage and pointwise_stages over all
// three.  Both kernels include it, so they draw the same noise
// and apply the same arithmetic.  ops/photometric_kernel.py is the plain
// PyTorch version of everything here.
//
// Error budget against the plain version (outputs in [0, 1]; the kernels are
// held to 1e-4 absolute, a bf16 output to one bf16 ulp).  Built without
// --use_fast_math, which would also reach the Box-Muller log, flush
// subnormals and approximate every division; the fast forms are chosen one
// by one:
//   - HED shift: __logf on x + 2 in [2, 3] and __expf on results in about
//     [1, 3] (lg2.approx / ex2.approx): a few 1e-7 relative, a few 1e-7 on
//     the output after the 3x3 products.
//   - Box-Muller: the log stays the accurate logf.  uniform_open reaches
//     1 - 2^-24, where log(u) ~ -6e-8 lies below __logf's absolute error, so
//     -2 __logf(u) could turn negative and sqrtf give NaN.  The angles use
//     sincospif(2u) / cospif(2u) (no large-argument reduction) in place of
//     sincosf(2 pi u): the plain version rounds 2 pi u to float32 first, a
//     difference of at most 4e-7 rad, so at most 2e-6 of noise (|z| < 5.7)
//     and 2e-7 on the output (sigma <= 0.1).
//   - HSV: the divisions by delta and v are __fdividef (2 ulp), with both
//     operands scaled by 2^64 where the divisor is subnormal (div.approx
//     flushes subnormals); the "v == r / v == g" decisions read the inputs,
//     so no branch moves.  h / 6 is a multiply by 1/6 (1 ulp).  The two
//     Python-style modulos are exact for their ranges (see hue6 / wrap01).
//     Both conversions pick their case with selects, not branches: the case
//     varies from pixel to pixel, and a branch would diverge.
//   - Per-tile constants (p[0] / 180, p[1] / 255, p[2] / 255) are divided
//     once per tile with IEEE division, as the plain version does.
#pragma once

#include <cstddef>
#include <cstdint>

namespace photometric {

constexpr int kParams = 16;  // params layout: ops/photometric_kernel.py
constexpr int kHalo = 3;     // max box-blur radius (k = 7)

struct HedMats {
  float hed_from_rgb[9];  // row-major 3x3
  float rgb_from_hed[9];
};

// A tile's 16 params in the form the stages use, made once per block.
struct TileParams {
  float hue, sat, val;  // p[0] / 180, p[1] / 255, p[2] / 255
  float sigma;          // p[4]
  float hed[3];         // p[6..8]
  float gain, bias;     // 1 + p[12], p[11]
  int half;             // blur half-width (k - 1) / 2 for k = p[9], at most kHalo
  bool hsv, noise, blur, bc;
};

__device__ __forceinline__ TileParams tile_params(const float* __restrict__ p) {
  TileParams t;
  t.hue = p[0] / 180.0f;
  t.sat = p[1] / 255.0f;
  t.val = p[2] / 255.0f;
  t.sigma = p[4];
  t.hed[0] = p[6];
  t.hed[1] = p[7];
  t.hed[2] = p[8];
  t.gain = 1.0f + p[12];
  t.bias = p[11];
  t.half = min(max((static_cast<int>(p[9]) - 1) / 2, 0), kHalo);
  t.hsv = p[3] > 0.5f;
  t.noise = p[5] > 0.5f;
  t.blur = p[10] > 0.5f;
  t.bc = p[13] > 0.5f;
  return t;
}

__device__ __forceinline__ int fold101(int i, int size) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(size)) return i;  // inside the tile: most pixels
  if (size == 1) return 0;
  const int period = 2 * (size - 1);
  i = abs(i);
  if (i >= period) i %= period;  // rare: only tiles smaller than the halo
  return i >= size ? period - i : i;
}

// torch.remainder(x, 6) for x in [-1, 1]: fmodf returns x there, so one
// compare and add is bit-equal.
__device__ __forceinline__ float hue6(float x) { return x < 0.0f ? x + 6.0f : x; }

// torch.remainder(y, 1) for |y| < 2: y - floor(y) rounds as fmodf's result
// plus 1 does (a zero may come out +0 where fmodf gives -0).
__device__ __forceinline__ float wrap01(float y) { return y - floorf(y); }

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// a / b for |a| <= b within 2 ulp: __fdividef, on operands scaled by 2^64
// (exact) where b is subnormal, which div.approx would flush to zero.
__device__ __forceinline__ float div_le(float a, float b) {
  const float k = b < 1.17549435e-38f ? 18446744073709551616.0f : 1.0f;
  return __fdividef(a * k, b * k);
}

__device__ __forceinline__ void mulhilo(uint32_t m, uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = __umulhi(m, x);
  lo = m * x;
}

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(0xD2511F53u, c[0], hi0, lo0);
    mulhilo(0xCD9E8D57u, c[2], hi1, lo1);
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ float uniform_open(uint32_t bits) {
  return (static_cast<float>(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
}

// Philox4x32-10 keyed on (seed, 0) at counter (x, y, n, 0): the bits of
// pixel (y, x) of tile n.
__device__ __forceinline__ void philox_pixel(uint32_t seed, int n, int y, int x, uint32_t ctr[4]) {
  ctr[0] = static_cast<uint32_t>(x);
  ctr[1] = static_cast<uint32_t>(y);
  ctr[2] = static_cast<uint32_t>(n);
  ctr[3] = 0u;
  philox4x32_10(ctr, seed, 0u);
}

// Box-Muller on one Philox output: words 0-1 give channels 0 (cos) and 1
// (sin), words 2-3 channel 2 (cos).
__device__ __forceinline__ void box_muller3(const uint32_t ctr[4], float nz[3]) {
  const float r01 = sqrtf(-2.0f * logf(uniform_open(ctr[0])));
  const float r2 = sqrtf(-2.0f * logf(uniform_open(ctr[2])));
  float s, c;
  sincospif(2.0f * uniform_open(ctr[1]), &s, &c);
  nz[0] = r01 * c;
  nz[1] = r01 * s;
  nz[2] = r2 * cospif(2.0f * uniform_open(ctr[3]));
}

// The three channels' N(0, 1) noise of pixel (y, x) of tile n.
__device__ __forceinline__ void philox_normal3(uint32_t seed, int n, int y, int x, float nz[3]) {
  uint32_t ctr[4];
  philox_pixel(seed, n, y, x, ctr);
  box_muller3(ctr, nz);
}

__device__ __forceinline__ void rgb2hsv(float r, float g, float b, float& h, float& s, float& v) {
  v = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float delta = v - mn;
  const float safe = delta == 0.0f ? 1.0f : delta;
  const float x = div_le(v == r ? g - b : v == g ? b - r : r - g, safe);
  const float hh = v == r ? hue6(x) : x + (v == g ? 2.0f : 4.0f);
  h = delta == 0.0f ? 0.0f : hh * (1.0f / 6.0f);
  s = v == 0.0f ? 0.0f : div_le(delta, v);
}

__device__ __forceinline__ void hsv2rgb(float h, float s, float v, float& r, float& g, float& b) {
  const float h6 = wrap01(h) * 6.0f;
  const float fi = floorf(h6);
  const float f = h6 - fi;
  const float p = v * (1.0f - s);
  const float q = v * (1.0f - s * f);
  const float t = v * (1.0f - s * (1.0f - f));
  int i = static_cast<int>(fi);
  if (i >= 6) i -= 6;  // h6 is in [0, 6]
  // sector i: (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)
  r = (i == 0 || i == 5) ? v : i == 1 ? q : i == 4 ? t : p;
  g = (i == 1 || i == 2) ? v : i == 0 ? t : i == 3 ? q : p;
  b = (i == 3 || i == 4) ? v : i == 2 ? t : i == 5 ? q : p;
}

// Stage 1, the HSV shift, on one pixel in place.
__device__ __forceinline__ void hsv_shift(float& r, float& g, float& b, const TileParams& tp) {
  float hh, ss, vv;
  rgb2hsv(r, g, b, hh, ss, vv);
  hh = wrap01(hh + tp.hue);
  ss = clip01(ss + tp.sat);
  vv = clip01(vv + tp.val);
  hsv2rgb(hh, ss, vv, r, g, b);
}

// Stage 2, N(0, 1) noise scaled by sigma and clipped, on one pixel in place.
__device__ __forceinline__ void add_noise(float& r, float& g, float& b, const float nz[3], float sigma) {
  r = clip01(r + nz[0] * sigma);
  g = clip01(g + nz[1] * sigma);
  b = clip01(b + nz[2] * sigma);
}

// Stage 3, the HED shift: stains = -log(rgb + 2) @ HED_FROM_RGB; shift;
// back through RGB_FROM_HED; clip((exp(.) - 1) / 2).  (r, g, b) in, rgb out.
__device__ __forceinline__ void hed_shift(float r, float g, float b, const TileParams& tp, const HedMats& m,
                                          float rgb[3]) {
  const float l0 = -__logf(r + 2.0f), l1 = -__logf(g + 2.0f), l2 = -__logf(b + 2.0f);
  const float* A = m.hed_from_rgb;
  const float* B = m.rgb_from_hed;
  const float hs = l0 * A[0] + l1 * A[3] + l2 * A[6] + tp.hed[0];
  const float es = l0 * A[1] + l1 * A[4] + l2 * A[7] + tp.hed[1];
  const float ds = l0 * A[2] + l1 * A[5] + l2 * A[8] + tp.hed[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lc = (-hs) * B[c] + (-es) * B[3 + c] + (-ds) * B[6 + c];
    rgb[c] = clip01((__expf(lc) - 1.0f) * 0.5f);
  }
}

// Stages 1-3 on one pixel, in place: (y, x) is the pixel's folded
// coordinate in tile n, and its noise is drawn at Philox counter
// (x, y, ctr_n, 0) (ctr_n is n plus the launch's first tile's index in the
// global batch).  With a non-null `noise` ((n, 3, h, w) float32) the noise
// is read at noise[n, c, y, x] instead of drawn.
__device__ __forceinline__ void pointwise_stages(float rgb[3], const TileParams& tp, const HedMats& m,
                                                 const float* __restrict__ noise, uint32_t seed,
                                                 int n, int ctr_n, int h, int w, int y, int x) {
  float r = rgb[0], g = rgb[1], b = rgb[2];
  if (tp.hsv) hsv_shift(r, g, b, tp);

  if (tp.noise) {
    float nz[3];
    if (noise != nullptr) {
      const size_t plane = static_cast<size_t>(h) * w;
      const size_t base = static_cast<size_t>(n) * 3 * plane + static_cast<size_t>(y) * w + x;
      nz[0] = noise[base];
      nz[1] = noise[base + plane];
      nz[2] = noise[base + 2 * plane];
    } else {
      philox_normal3(seed, ctr_n, y, x, nz);
    }
    add_noise(r, g, b, nz, tp.sigma);
  }

  hed_shift(r, g, b, tp, m, rgb);
}

}  // namespace photometric

// Device code shared by photometric_chain.cu and rsp_augment.cu: reflect101
// folding, Python-style modulo, Philox4x32-10 and its Box-Muller normals,
// RGB<->HSV, and the chain's pointwise stages 1-3 (HSV shift, Gaussian noise,
// HED shift).  Both kernels include it, so they draw the same noise and apply
// the same arithmetic.  ops/photometric_kernel.py is the plain PyTorch
// version of everything here.
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

__device__ __forceinline__ int fold101(int i, int size) {
  if (size == 1) return 0;
  const int period = 2 * (size - 1);
  i = abs(i);
  if (i >= period) i %= period;  // rare: only tiles smaller than the halo
  return i >= size ? period - i : i;
}

// Python-style float modulo (sign of the divisor), as jnp.remainder and
// torch.remainder compute it.
__device__ __forceinline__ float pymod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ void mulhilo(uint32_t m, uint32_t x, uint32_t& hi, uint32_t& lo) {
  const uint64_t p = static_cast<uint64_t>(m) * static_cast<uint64_t>(x);
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
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

// The three channels' N(0, 1) noise of pixel (y, x) of tile n: one Philox
// call keyed on (seed, 0) at counter (x, y, n, 0); Box-Muller on words 0-1
// gives channels 0 (cos) and 1 (sin), on words 2-3 channel 2 (cos).
__device__ __forceinline__ void philox_normal3(uint32_t seed, int n, int y, int x, float nz[3]) {
  uint32_t ctr[4] = {static_cast<uint32_t>(x), static_cast<uint32_t>(y), static_cast<uint32_t>(n), 0u};
  philox4x32_10(ctr, seed, 0u);
  const float r01 = sqrtf(-2.0f * logf(uniform_open(ctr[0])));
  const float r2 = sqrtf(-2.0f * logf(uniform_open(ctr[2])));
  float s, c;
  sincosf(6.283185307179586f * uniform_open(ctr[1]), &s, &c);
  nz[0] = r01 * c;
  nz[1] = r01 * s;
  nz[2] = r2 * cosf(6.283185307179586f * uniform_open(ctr[3]));
}

__device__ __forceinline__ void rgb2hsv(float r, float g, float b, float& h, float& s, float& v) {
  v = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float delta = v - mn;
  const float safe = delta == 0.0f ? 1.0f : delta;
  float hh;
  if (v == r) {
    hh = pymod((g - b) / safe, 6.0f);
  } else if (v == g) {
    hh = (b - r) / safe + 2.0f;
  } else {
    hh = (r - g) / safe + 4.0f;
  }
  h = delta == 0.0f ? 0.0f : hh / 6.0f;
  s = v == 0.0f ? 0.0f : delta / v;
}

__device__ __forceinline__ void hsv2rgb(float h, float s, float v, float& r, float& g, float& b) {
  const float h6 = pymod(h, 1.0f) * 6.0f;
  const float fi = floorf(h6);
  const float f = h6 - fi;
  const float p = v * (1.0f - s);
  const float q = v * (1.0f - s * f);
  const float t = v * (1.0f - s * (1.0f - f));
  int i = static_cast<int>(fi) % 6;
  if (i < 0) i += 6;
  switch (i) {
    case 0: r = v; g = t; b = p; break;
    case 1: r = q; g = v; b = p; break;
    case 2: r = p; g = v; b = t; break;
    case 3: r = p; g = q; b = v; break;
    case 4: r = t; g = p; b = v; break;
    default: r = v; g = p; b = q; break;
  }
}

// Stages 1-3 on one pixel, in place: (y, x) is the pixel's folded
// coordinate in tile n, which keys its noise.  With a non-null `noise`
// ((n, 3, h, w) float32) the noise is read at noise[n, c, y, x] instead of
// drawn.
__device__ __forceinline__ void pointwise_stages(float rgb[3], const float* p, const HedMats& m,
                                                 const float* __restrict__ noise, uint32_t seed,
                                                 int n, int h, int w, int y, int x) {
  float r = rgb[0], g = rgb[1], b = rgb[2];
  if (p[3] > 0.5f) {
    float hh, ss, vv;
    rgb2hsv(r, g, b, hh, ss, vv);
    hh = pymod(hh + p[0] / 180.0f, 1.0f);
    ss = clip01(ss + p[1] / 255.0f);
    vv = clip01(vv + p[2] / 255.0f);
    hsv2rgb(hh, ss, vv, r, g, b);
  }

  if (p[5] > 0.5f) {
    float nz[3];
    if (noise != nullptr) {
      const size_t plane = static_cast<size_t>(h) * w;
      const size_t base = static_cast<size_t>(n) * 3 * plane + static_cast<size_t>(y) * w + x;
      nz[0] = noise[base];
      nz[1] = noise[base + plane];
      nz[2] = noise[base + 2 * plane];
    } else {
      philox_normal3(seed, n, y, x, nz);
    }
    r = clip01(r + nz[0] * p[4]);
    g = clip01(g + nz[1] * p[4]);
    b = clip01(b + nz[2] * p[4]);
  }

  // HED shift: stains = -log(rgb + 2) @ HED_FROM_RGB; shift; back through
  // RGB_FROM_HED; clip((exp(.) - 1) / 2).
  const float l0 = -logf(r + 2.0f), l1 = -logf(g + 2.0f), l2 = -logf(b + 2.0f);
  const float* A = m.hed_from_rgb;
  const float* B = m.rgb_from_hed;
  const float hs = l0 * A[0] + l1 * A[3] + l2 * A[6] + p[6];
  const float es = l0 * A[1] + l1 * A[4] + l2 * A[7] + p[7];
  const float ds = l0 * A[2] + l1 * A[5] + l2 * A[8] + p[8];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lc = (-hs) * B[c] + (-es) * B[3 + c] + (-ds) * B[6 + c];
    rgb[c] = clip01((expf(lc) - 1.0f) / 2.0f);
  }
}

}  // namespace photometric

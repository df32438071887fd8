// The v1 pretraining photometric chain as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssl_cr_histo_tpu/ops/pallas_photometric.py
// (_kernel_prng, :199-258, and its host-noise mode _kernel_noise_input,
// :261-272, both launched from pretrain_photometric_pallas :302-351).  Per
// tile, with 16 per-tile parameters (layout in ops/photometric_kernel.py):
//
//   1. HSV shift                  if p[3]  > 0.5
//   2. Gaussian noise, clipped    if p[5]  > 0.5
//   3. legacy-skimage HED shift   always
//   4. box blur k in {3,5,7}, reflect101 borders, if p[10] > 0.5
//   5. brightness / contrast      if p[13] > 0.5
//
// Its bytes: a 3x256x256 float32 tile is 768 KiB read and 768 KiB written
// (1.5 MiB per tile, 288 MiB for the 192 tiles of a batch-64 triplet step),
// against roughly 150 flops per pixel, so on paper the chain is bound by
// memory.  Measured on an H100 80GB HBM3 at 700 W it is not: in Philox mode
// it reaches about 20% of the HBM peak, and the host-noise mode moves 1.5x
// the bytes in 25% less time.  The 10 Philox rounds per pixel and channel,
// recomputed on the halo, bound it (PERF.md, section 6).
//
// What the design does about the bytes: one read and one write per pixel.  The
// TPU kernel keeps a whole tile in VMEM; a Hopper block has at most 227 KB
// of shared memory, so here one block covers a 32x32 output patch of one
// tile and loads its (32+6)^2 halo (reflect101-folded source coordinates)
// once, applying the pointwise stages 1-3 as it loads (17 KB of float32 in
// shared memory).  The blur then runs separably in shared memory, stage 5 in
// registers, and the block writes its patch.  Halo pixels are recomputed by
// neighbouring blocks instead of being written out and read back.  Gates are
// uniform per tile, so they are real branches with no divergence.
//
// Noise: counter-based Philox4x32-10 keyed on (seed[n], 0), counter
// (x, y, c, n) at the FOLDED source coordinate, so a halo pixel recomputed by
// a neighbouring block gets the same value.  Uniforms in (0, 1) are
// (top 23 bits + 0.5) * 2^-23, then Box-Muller.  ops/photometric_kernel.py
// philox_normal computes the same numbers in plain PyTorch.  With a non-null
// noise pointer the kernel reads noise[n, c, y', x'] at the folded
// coordinate instead.
//
// Built without --use_fast_math: logf/expf/division stay IEEE-accurate so the
// kernel agrees with PyTorch's versions to a few ulp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;              // output patch edge
constexpr int kHalo = 3;               // max blur radius (k = 7)
constexpr int kIn = kTile + 2 * kHalo; // 38: halo patch edge
constexpr int kThreads = 256;
constexpr int kParams = 16;

struct HedMats {
  float hed_from_rgb[9];  // row-major 3x3
  float rgb_from_hed[9];
};

__device__ __forceinline__ int fold101(int i, int size) {
  if (size == 1) return 0;
  const int period = 2 * (size - 1);
  i = abs(i) % period;
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

__device__ __forceinline__ float philox_normal(uint32_t seed, int n, int c, int y, int x) {
  uint32_t ctr[4] = {static_cast<uint32_t>(x), static_cast<uint32_t>(y), static_cast<uint32_t>(c),
                     static_cast<uint32_t>(n)};
  philox4x32_10(ctr, seed, 0u);
  const float u1 = uniform_open(ctr[0]), u2 = uniform_open(ctr[1]);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
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

// Stages 1-3 on one pixel at folded source coordinate (y, x) of tile n.
__device__ __forceinline__ void pointwise_stages(const float* __restrict__ img, const float* __restrict__ noise,
                                 uint32_t seed, const float* p, const HedMats& m, int n, int h,
                                 int w, int y, int x, float out[3]) {
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t base = static_cast<size_t>(n) * 3 * plane + static_cast<size_t>(y) * w + x;
  float r = img[base], g = img[base + plane], b = img[base + 2 * plane];

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
      nz[0] = noise[base];
      nz[1] = noise[base + plane];
      nz[2] = noise[base + 2 * plane];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) nz[c] = philox_normal(seed, n, c, y, x);
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
    out[c] = clip01((expf(lc) - 1.0f) / 2.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
photometric_chain_kernel(const float* __restrict__ img, const float* __restrict__ noise,
                         const int32_t* __restrict__ seeds, const float* __restrict__ params,
                         float* __restrict__ out, int h, int w, HedMats mats) {
  __shared__ float s_in[3][kIn][kIn];      // stages 1-3 over the halo patch
  __shared__ float s_rows[3][kTile][kIn];  // after the vertical blur pass
  __shared__ float s_p[kParams];

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  if (tid < kParams) s_p[tid] = params[static_cast<size_t>(n) * kParams + tid];
  __syncthreads();
  const uint32_t seed = static_cast<uint32_t>(seeds[n]);

  float p[kParams];
#pragma unroll
  for (int j = 0; j < kParams; ++j) p[j] = s_p[j];
  const bool blur = p[10] > 0.5f;

  // Without blur only the patch itself is needed; with it, the full halo.
  const int lo = blur ? 0 : kHalo, hi = blur ? kIn : kHalo + kTile;
  const int span = hi - lo;
  for (int i = tid; i < span * span; i += kThreads) {
    const int hy = lo + i / span, hx = lo + i % span;
    const int gy = fold101(y0 - kHalo + hy, h), gx = fold101(x0 - kHalo + hx, w);
    float v[3];
    pointwise_stages(img, noise, seed, p, mats, n, h, w, gy, gx, v);
    s_in[0][hy][hx] = v[0];
    s_in[1][hy][hx] = v[1];
    s_in[2][hy][hx] = v[2];
  }
  __syncthreads();

  const int half = blur ? (static_cast<int>(p[9]) - 1) / 2 : 0;
  const float norm = static_cast<float>(2 * half + 1);
  if (blur) {
    // vertical pass: rows of the patch, every halo column
    for (int i = tid; i < kTile * kIn; i += kThreads) {
      const int r = i / kIn, cx = i % kIn;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        for (int dy = -half; dy <= half; ++dy) acc += s_in[c][r + kHalo + dy][cx];
        s_rows[c][r][cx] = acc / norm;
      }
    }
    __syncthreads();
  }

  const bool bc = p[13] > 0.5f;
  const size_t plane = static_cast<size_t>(h) * w;
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, cx = i % kTile;
    const int gy = y0 + r, gx = x0 + cx;
    if (gy >= h || gx >= w) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v;
      if (blur) {
        float acc = 0.0f;
        for (int dx = -half; dx <= half; ++dx) acc += s_rows[c][r][cx + kHalo + dx];
        v = acc / norm;
      } else {
        v = s_in[c][r + kHalo][cx + kHalo];
      }
      if (bc) v = clip01(v * (1.0f + p[12]) + p[11]);
      out[static_cast<size_t>(n) * 3 * plane + c * plane + static_cast<size_t>(gy) * w + gx] = v;
    }
  }
}

}  // namespace

// Launch on `stream`.  img/noise/out: (n, 3, h, w) float32, contiguous, on the
// device; noise may be null (Philox mode).  seeds: (n,) int32, params:
// (n, 16) float32, on the device.  hed_mats_host: 18 floats in host memory,
// HED_FROM_RGB then RGB_FROM_HED, row-major.  Returns cudaGetLastError().
extern "C" int launch_photometric_chain(const float* img, const float* noise, const int32_t* seeds,
                                        const float* params, float* out, int n, int h, int w,
                                        const float* hed_mats_host, void* stream) {
  HedMats mats;
  for (int i = 0; i < 9; ++i) {
    mats.hed_from_rgb[i] = hed_mats_host[i];
    mats.rgb_from_hed[i] = hed_mats_host[9 + i];
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  photometric_chain_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, noise, seeds, params, out, h, w, mats);
  return static_cast<int>(cudaGetLastError());
}

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
// memory.  Measured on an H100 80GB HBM3 at 700 W it is not: with one
// Philox call per pixel and channel it reached about 20% of the HBM peak,
// and the host-noise mode moved 1.5x the bytes in 25% less time, so the
// Philox rounds, recomputed on the halo, bound it (PERF.md, section 6).  It
// now makes one Philox call per pixel for all three channels.
//
// This kernel is the counterpart of pretrain_photometric_pallas.  The
// pretraining step runs the chain inside rsp_augment.cu instead, which
// shares this file's arithmetic through photometric_common.cuh.
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
// (x, y, n, 0) at the FOLDED source coordinate, so a halo pixel recomputed by
// a neighbouring block gets the same value.  Uniforms in (0, 1) are
// (top 23 bits + 0.5) * 2^-23, then two Box-Muller pairs give the three
// channels (photometric_common.cuh).  ops/photometric_kernel.py
// philox_normal computes the same numbers in plain PyTorch.  With a non-null
// noise pointer the kernel reads noise[n, c, y', x'] at the folded
// coordinate instead.
//
// Built without --use_fast_math; the special-function forms chosen one by one
// in photometric_common.cuh keep it within a few 1e-7 of the plain chain
// (that header's error budget).  Its blur divides by k as a multiply by 1/k.

#include <cstdint>
#include <cuda_runtime.h>

#include "photometric_common.cuh"

namespace {

using namespace photometric;

constexpr int kTile = 32;              // output patch edge
constexpr int kIn = kTile + 2 * kHalo; // 38: halo patch edge
constexpr int kThreads = 256;

// Stages 1-3 on one pixel at folded source coordinate (y, x) of tile n.
__device__ __forceinline__ void load_pointwise(const float* __restrict__ img, const float* __restrict__ noise,
                                               uint32_t seed, const TileParams& tp, const HedMats& m, int n,
                                               int h, int w, int y, int x, float out[3]) {
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t base = static_cast<size_t>(n) * 3 * plane + static_cast<size_t>(y) * w + x;
  out[0] = img[base];
  out[1] = img[base + plane];
  out[2] = img[base + 2 * plane];
  pointwise_stages(out, tp, m, noise, seed, n, h, w, y, x);
}

__global__ void __launch_bounds__(kThreads)
photometric_chain_kernel(const float* __restrict__ img, const float* __restrict__ noise,
                         const int32_t* __restrict__ seeds, const float* __restrict__ params,
                         float* __restrict__ out, int h, int w, HedMats mats) {
  __shared__ float s_in[3][kIn][kIn];      // stages 1-3 over the halo patch
  __shared__ float s_rows[3][kTile][kIn];  // after the vertical blur pass
  __shared__ TileParams s_tp;

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  if (tid == 0) s_tp = tile_params(params + static_cast<size_t>(n) * kParams);
  __syncthreads();
  const uint32_t seed = static_cast<uint32_t>(seeds[n]);
  const TileParams& tp = s_tp;
  const bool blur = tp.blur;

  // Without blur only the patch itself is needed; with it, the full halo.
  const int lo = blur ? 0 : kHalo, hi = blur ? kIn : kHalo + kTile;
  const int span = hi - lo;
  for (int i = tid; i < span * span; i += kThreads) {
    const int hy = lo + i / span, hx = lo + i % span;
    const int gy = fold101(y0 - kHalo + hy, h), gx = fold101(x0 - kHalo + hx, w);
    float v[3];
    load_pointwise(img, noise, seed, tp, mats, n, h, w, gy, gx, v);
    s_in[0][hy][hx] = v[0];
    s_in[1][hy][hx] = v[1];
    s_in[2][hy][hx] = v[2];
  }
  __syncthreads();

  const int half = blur ? tp.half : 0;
  const float inv_norm = 1.0f / static_cast<float>(2 * half + 1);
  if (blur) {
    // vertical pass: rows of the patch, every halo column
    for (int i = tid; i < kTile * kIn; i += kThreads) {
      const int r = i / kIn, cx = i % kIn;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        for (int dy = -half; dy <= half; ++dy) acc += s_in[c][r + kHalo + dy][cx];
        s_rows[c][r][cx] = acc * inv_norm;
      }
    }
    __syncthreads();
  }

  const bool bc = tp.bc;
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
        v = acc * inv_norm;
      } else {
        v = s_in[c][r + kHalo][cx + kHalo];
      }
      if (bc) v = clip01(v * tp.gain + tp.bias);
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

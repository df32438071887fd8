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
// This kernel is the counterpart of pretrain_photometric_pallas.  The
// pretraining step runs the chain inside rsp_augment.cu instead, which
// shares this file's arithmetic through photometric_common.cuh.
//
// What bounds it on an H100.  A 3x256x256 float32 tile is 768 KiB read and
// 768 KiB written (288 MiB for the 192 tiles of a batch-64 triplet step,
// 90 us at 3.35 TB/s; the host-noise mode reads 1.5x that).  The work is
// some 170 float operations a pixel on average over drawn params, a third
// of them Philox4x32-10 and Box-Muller on noise tiles, plus the special
// functions (3 logs and 3 exps of the HED shift, a log, two square roots
// and a sine and cosine of Box-Muller): on paper memory bound, but close
// enough to the instruction rate that arithmetic spent twice (stages 1-3 run
// again on a blur halo), latency left unhidden (one dependent Philox chain
// a thread) or scalar accesses set the pace.  Measured, it reaches half the
// byte bound in Philox mode; what is left is the last of 7 waves of
// clusters and the noise and blur tiles' arithmetic (PERF.md, section 6).
//
// The design.  The TPU kernel keeps a whole tile in VMEM; a Hopper block has
// at most 227 KB of shared memory.  Here a thread block cluster covers one
// tile: CTA q of a cluster of C owns `rows` consecutive full-width rows
// (C = 8 and 32 rows at 256x256: 99 KB of float32 a CTA, two CTAs an SM).
//   - Stages 1-3 run once for every pixel of the tile (halo ratio 1.00;
//     (4 * ceil(w / 4)) / w where w is not a multiple of 4).  Each thread
//     takes 4 consecutive pixels of a row: one 16-byte load a plane,
//     prefetched one group ahead, and four independent Philox / Box-Muller
//     and log / exp chains to hide each other's latency.  Gates are uniform
//     per tile, so every stage is one branch around all four pixels.
//   - Without blur, stage 5 follows in registers and the group is stored
//     with one 16-byte store a plane.  Nothing touches shared memory.
//   - With blur, stages 1-3 go to the CTA's rows in dynamic shared memory,
//     each row stored with 4 halo columns on either side, which the CTA then
//     fills with the row's reflect101 fold (of the whole row: it folds more
//     than once where the row is narrower than the halo).  The horizontal
//     pass runs in place, a warp a row: each lane reads the 4 + 2 half
//     columns of its groups with three 16-byte reads, keeps its sums in
//     registers until the warp has read the row, then writes them back.
//     Each group's sum restarts, so rounding does not drift along a row.
//     (Folding at each read would put the warps that hold a row's ends on
//     a divergent scalar path on every row.)  After a cluster barrier the
//     vertical pass reads the rows above and below, folded reflect101 over
//     the whole tile, from whichever CTA owns them (distributed shared
//     memory), as sliding sums down a run of up to 8 rows, applies stage 5
//     and stores.  A second cluster barrier keeps every CTA's rows alive
//     until its neighbours are done.  k is uniform per tile: one template
//     instance per half-width.
// The planning (C, rows, shared bytes) is ops/photometric_kernel.py's
// chain_launch_plan; the kernel takes rows of at most 256 pixels.
//
// Noise: counter-based Philox4x32-10 keyed on (seed[n], 0), counter
// (x, y, n, 0) of the pixel, one call for its three channels; uniforms in
// (0, 1) are (top 23 bits + 0.5) * 2^-23, then two Box-Muller pairs
// (photometric_common.cuh).  ops/photometric_kernel.py philox_normal
// computes the same numbers in plain PyTorch.  With a non-null noise
// pointer the kernel reads noise[n, c, y, x] instead.
//
// Built without --use_fast_math; the special-function forms chosen one by one
// in photometric_common.cuh keep it within a few 1e-7 of the plain chain
// (that header's error budget).  The blur's horizontal pass comes before its
// vertical one (the plain chain's after it) and it multiplies by 1/k: a few
// ulp apart.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "photometric_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace photometric;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 2;              // row groups a lane blurs: rows of at most 32 * 4 * kSlots pixels
constexpr int kMaxWidth = 32 * 4 * kSlots;
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr int kMaxSmem = 231424;       // dynamic shared memory: 227 KB a block, less 1 KB for s_tp
constexpr int kPad = 4;                // halo columns stored on each side of a shared-memory row

// A shared-memory row's pitch in floats: the row padded to whole groups of 4
// pixels, and kPad halo columns on each side.
__host__ __device__ constexpr int row_pitch(int w) { return 4 * ((w + 3) / 4) + 2 * kPad; }

// Four pixels of one channel plane.  Vec: one 16-byte access (w % 4 == 0 and
// 16-byte aligned bases); otherwise scalars, the pixels past the row's end
// read as 0 and never written.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int left) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  v.x = __ldg(p);
  if (left > 1) v.y = __ldg(p + 1);
  if (left > 2) v.z = __ldg(p + 2);
  if (left > 3) v.w = __ldg(p + 3);
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ p, int left, float4 v) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (left > 1) p[1] = v.y;
  if (left > 2) p[2] = v.z;
  if (left > 3) p[3] = v.w;
}

__device__ __forceinline__ float& lane(float4& v, int p) { return (&v.x)[p]; }

__device__ __forceinline__ float4 bc4(float4 v, const TileParams& tp) {
  if (!tp.bc) return v;
  return make_float4(clip01(v.x * tp.gain + tp.bias), clip01(v.y * tp.gain + tp.bias),
                     clip01(v.z * tp.gain + tp.bias), clip01(v.w * tp.gain + tp.bias));
}

// Stages 1-3 on the four pixels (y, x0 .. x0 + 3) of tile n, in place; nz
// holds the caller's noise (host-noise mode) where the noise gate is on.
template <bool kHostNoise>
__device__ __forceinline__ void stages4(float4 v[3], const float4 nz[3], const TileParams& tp, const HedMats& m,
                                        uint32_t seed, int n, int y, int x0) {
  if (tp.hsv) {
#pragma unroll
    for (int p = 0; p < 4; ++p) hsv_shift(lane(v[0], p), lane(v[1], p), lane(v[2], p), tp);
  }
  if (tp.noise) {
    float z[4][3];
    if (kHostNoise) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < 3; ++c) z[p][c] = (&nz[c].x)[p];
    } else {
      // four Philox calls first, then four Box-Mullers: independent chains
      uint32_t ctr[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) philox_pixel(seed, n, y, x0 + p, ctr[p]);
#pragma unroll
      for (int p = 0; p < 4; ++p) box_muller3(ctr[p], z[p]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) add_noise(lane(v[0], p), lane(v[1], p), lane(v[2], p), z[p], tp.sigma);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float rgb[3];
    hed_shift(lane(v[0], p), lane(v[1], p), lane(v[2], p), tp, m, rgb);
    lane(v[0], p) = rgb[0];
    lane(v[1], p) = rgb[1];
    lane(v[2], p) = rgb[2];
  }
}

// Horizontal box sums of the group at x0 = 4 g of one halo-padded shared
// memory row (column x at row[kPad + x], its reflect101 halo filled):
// out[p] = sum of columns x0 + p + d for |d| <= HALF, times 1/k.  Three
// 16-byte reads give columns x0 - 4 .. x0 + 7.
template <int HALF>
__device__ __forceinline__ float4 hsum4(const float* __restrict__ row, int x0, float inv_k) {
  float c[12];  // columns x0 - 4 .. x0 + 7
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float4 q = *reinterpret_cast<const float4*>(row + kPad + x0 - 4 + 4 * j);
    c[4 * j] = q.x;
    c[4 * j + 1] = q.y;
    c[4 * j + 2] = q.z;
    c[4 * j + 3] = q.w;
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 4 - HALF; j <= 4 + HALF; ++j) s += c[j];
  float4 out;
  out.x = s * inv_k;
#pragma unroll
  for (int p = 1; p < 4; ++p) {
    s += c[4 + p + HALF] - c[3 + p - HALF];
    lane(out, p) = s * inv_k;
  }
  return out;
}

// Stage 4 on the tile whose rows [y0, y0 + my_rows) this CTA holds in S
// (3 planes of `rows` rows of row_pitch(w) floats, halo columns filled),
// then stage 5 and the store.
template <int HALF, bool kVec>
__device__ __forceinline__ void blur_tile(cg::cluster_group& cluster, float* S, float* __restrict__ dst,
                                          const TileParams& tp, int h, int w, int rows, int y0, int my_rows) {
  const int G = (w + 3) >> 2, Wp = row_pitch(w);
  const int pitch = rows * Wp;  // one plane of S
  const float inv_k = 1.0f / static_cast<float>(2 * HALF + 1);
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;

  // horizontal, in place: a warp a row, every read of the row before any write
  for (int r = warp; r < my_rows; r += kWarps) {
    float4 acc[kSlots][3];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int g = ln + 32 * k;
      if (g < G)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[k][c] = hsum4<HALF>(S + c * pitch + r * Wp, 4 * g, inv_k);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int g = ln + 32 * k;
      if (g < G)
#pragma unroll
        for (int c = 0; c < 3; ++c) *reinterpret_cast<float4*>(S + c * pitch + r * Wp + kPad + 4 * g) = acc[k][c];
    }
  }
  cluster.sync();

  // vertical: thread (run, g) slides down a run of this CTA's rows; row fy
  // of the tile lives in CTA fy / rows of the cluster
  const int runs = kThreads / G;
  const int run = tid / G, g = tid - run * G;
  const int per_run = (my_rows + runs - 1) / runs;
  const int ys = y0 + run * per_run, ye = min(ys + per_run, y0 + my_rows);
  if (run < runs && ys < ye) {
    const unsigned rank = cluster.block_rank();
    auto row_ptr = [&](int fy) -> const float* {
      const unsigned owner = static_cast<unsigned>(fy / rows);
      const float* base = owner == rank ? S : cluster.map_shared_rank(S, owner);
      return base + (fy - static_cast<int>(owner) * rows) * Wp + kPad + 4 * g;
    };
    float4 acc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int d = -HALF; d <= HALF; ++d) {
      const float* p = row_ptr(fold101(ys + d, h));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 q = *reinterpret_cast<const float4*>(p + c * pitch);
        acc[c].x += q.x;
        acc[c].y += q.y;
        acc[c].z += q.z;
        acc[c].w += q.w;
      }
    }
    const size_t plane = static_cast<size_t>(h) * w;
    const int x0 = 4 * g;
    for (int y = ys; y < ye; ++y) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 o = make_float4(acc[c].x * inv_k, acc[c].y * inv_k, acc[c].z * inv_k, acc[c].w * inv_k);
        store4<kVec>(dst + c * plane + static_cast<size_t>(y) * w + x0, w - x0, bc4(o, tp));
      }
      if (y + 1 < ye) {
        const float* in = row_ptr(fold101(y + HALF + 1, h));
        const float* out = row_ptr(fold101(y - HALF, h));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4 a = *reinterpret_cast<const float4*>(in + c * pitch);
          const float4 b = *reinterpret_cast<const float4*>(out + c * pitch);
          acc[c].x += a.x - b.x;
          acc[c].y += a.y - b.y;
          acc[c].z += a.z - b.z;
          acc[c].w += a.w - b.w;
        }
      }
    }
  }
  cluster.sync();  // neighbours may still read this CTA's rows
}

// One cluster of gridDim.x / n CTAs per tile; CTA `rank` owns tile rows
// [rank * rows, rank * rows + rows).
template <bool kVec, bool kHostNoise>
__global__ void __launch_bounds__(kThreads, 2)
photometric_chain_kernel(const float* __restrict__ img, const float* __restrict__ noise,
                         const int32_t* __restrict__ seeds, const float* __restrict__ params,
                         float* __restrict__ out, int h, int w, int rows, HedMats mats) {
  extern __shared__ float4 s_dyn[];
  __shared__ TileParams s_tp;
  float* S = reinterpret_cast<float*>(s_dyn);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / cluster.num_blocks();
  const int tid = threadIdx.x;
  if (tid == 0) s_tp = tile_params(params + static_cast<size_t>(n) * kParams);
  __syncthreads();
  const TileParams tp = s_tp;
  const uint32_t seed = static_cast<uint32_t>(seeds[n]);

  const int G = (w + 3) >> 2, Wp = row_pitch(w);
  const int y0 = rank * rows, my_rows = max(0, min(rows, h - y0));
  const size_t plane = static_cast<size_t>(h) * w;
  const float* src = img + static_cast<size_t>(n) * 3 * plane;
  const float* nsrc = kHostNoise ? noise + static_cast<size_t>(n) * 3 * plane : nullptr;
  float* dst = out + static_cast<size_t>(n) * 3 * plane;
  const bool read_noise = kHostNoise && tp.noise;

  // stages 1-3 once a pixel; group i is row i / G, columns 4 (i % G) ..
  const int count = my_rows * G;
  int i = tid;
  float4 nx[3], nn[3] = {};
  auto fetch = [&](int j, float4 v[3], float4 z[3]) {
    const int r = j / G, x0 = 4 * (j - r * G);
    const size_t off = static_cast<size_t>(y0 + r) * w + x0;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = load4<kVec>(src + c * plane + off, w - x0);
    if (read_noise)
#pragma unroll
      for (int c = 0; c < 3; ++c) z[c] = load4<kVec>(nsrc + c * plane + off, w - x0);
  };
  if (i < count) fetch(i, nx, nn);
  for (; i < count; i += kThreads) {
    float4 v[3] = {nx[0], nx[1], nx[2]};
    float4 z[3] = {nn[0], nn[1], nn[2]};
    if (i + kThreads < count) fetch(i + kThreads, nx, nn);  // the next group's loads in flight
    const int r = i / G, x0 = 4 * (i - r * G);
    stages4<kHostNoise>(v, z, tp, mats, seed, n, y0 + r, x0);
    if (tp.blur) {
#pragma unroll
      for (int c = 0; c < 3; ++c) *reinterpret_cast<float4*>(S + (c * rows + r) * Wp + kPad + x0) = v[c];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        store4<kVec>(dst + c * plane + static_cast<size_t>(y0 + r) * w + x0, w - x0, bc4(v[c], tp));
    }
  }
  if (!tp.blur) return;  // uniform over the cluster: its CTAs all hold one tile
  __syncthreads();
  // each row's halo: columns -kPad .. -1 and w .. Wp - kPad - 1, folded
  // reflect101 into the row (more than once where the row is narrower than
  // the halo)
  const int halo = Wp - w;
  for (int j = tid; j < 3 * my_rows * halo; j += kThreads) {
    const int q = j / halo, e = j - q * halo;
    const int c = q / my_rows, r = q - c * my_rows;
    const int x = e < kPad ? e - kPad : w + e - kPad;
    float* line = S + (c * rows + r) * Wp + kPad;
    line[x] = line[fold101(x, w)];
  }
  __syncthreads();
  switch (tp.half) {
    case 0: blur_tile<0, kVec>(cluster, S, dst, tp, h, w, rows, y0, my_rows); break;
    case 1: blur_tile<1, kVec>(cluster, S, dst, tp, h, w, rows, y0, my_rows); break;
    case 2: blur_tile<2, kVec>(cluster, S, dst, tp, h, w, rows, y0, my_rows); break;
    default: blur_tile<3, kVec>(cluster, S, dst, tp, h, w, rows, y0, my_rows); break;
  }
}

using Kernel = void (*)(const float*, const float*, const int32_t*, const float*, float*, int, int, int, HedMats);

Kernel pick(bool vec, bool host_noise) {
  if (vec) return host_noise ? photometric_chain_kernel<true, true> : photometric_chain_kernel<true, false>;
  return host_noise ? photometric_chain_kernel<false, true> : photometric_chain_kernel<false, false>;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The launch configuration of one cluster a tile; sets the kernel's dynamic
// shared memory limit.  Returns a CUDA error code, cudaErrorInvalidValue for
// a plan the kernel does not take.
int configure(Kernel kernel, int n, int h, int w, int cluster, int rows, int smem, cudaStream_t stream,
              cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const int wp = row_pitch(w);
  if (n < 1 || h < 1 || w < 1 || w > kMaxWidth || cluster < 1 || cluster > kMaxCluster || rows < 1 ||
      (cluster - 1) * rows >= h || cluster * rows < h || smem != 3 * rows * wp * 4 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * static_cast<unsigned>(n));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

}  // namespace

// Launch on `stream`.  img/noise/out: (n, 3, h, w) float32, contiguous, on the
// device; noise may be null (Philox mode).  seeds: (n,) int32, params:
// (n, 16) float32, on the device.  cluster, rows, smem: the launch plan
// (ops/photometric_kernel.py chain_launch_plan).  hed_mats_host: 18 floats in
// host memory, HED_FROM_RGB then RGB_FROM_HED, row-major.  Returns a CUDA
// error code (0 on success).
extern "C" int launch_photometric_chain(const float* img, const float* noise, const int32_t* seeds,
                                        const float* params, float* out, int n, int h, int w, int cluster,
                                        int rows, int smem, const float* hed_mats_host, void* stream) {
  HedMats mats;
  for (int i = 0; i < 9; ++i) {
    mats.hed_from_rgb[i] = hed_mats_host[i];
    mats.rgb_from_hed[i] = hed_mats_host[9 + i];
  }
  const bool vec = w % 4 == 0 && aligned16(img) && aligned16(out) && (noise == nullptr || aligned16(noise));
  const Kernel kernel = pick(vec, noise != nullptr);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = configure(kernel, n, h, w, cluster, rows, smem, static_cast<cudaStream_t>(stream), cfg, attr);
  if (rc != 0) return rc;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, img, noise, seeds, params, out, h, w, rows, mats);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of this plan the card runs at once (the 16-byte,
// Philox-mode instance), into *clusters.  Returns a CUDA error code.
extern "C" int photometric_chain_max_clusters(int h, int w, int cluster, int rows, int smem, int* clusters) {
  const Kernel kernel = pick(w % 4 == 0, false);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = configure(kernel, 1, h, w, cluster, rows, smem, nullptr, cfg, attr);
  if (rc != 0) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

// The consistency step's weak and strong views as one CUDA kernel for Hopper
// (sm_90a): uint8 images in, each image's strong stages in its drawn order,
// one two-pass warp, weak and strong out as float32 planar.
//
// Replaces no TPU kernel: in the JAX package these views are XLA ops
// (ssl_cr_histo_tpu/ops/batch.py::transform_fix_batch, ops/fused.py's v1
// strong pool), and the port ran them as PyTorch ops grouped on the host by
// stage and op (ops/fused.py::randaugment_v1_fused), some 1250 small
// launches a consistency step whose host time left the card idle.  The plain
// version is ops/fused.py::transform_fix_fused with randaugment_v1_fused, on
// the same draws; ops/strong_views_kernel.py packs them into the table read
// here and launches this kernel.
//
// Per image n (one thread block cluster), with its row of the stage table
// (layout in ops/strong_views_kernel.py):
//   1. weak = clip(image mirrored where weak_flip), written straight out;
//   2. the strong view starts as the image mirrored where strong_flip, held
//      in the cluster's shared memory, and runs the image's active
//      photometric stages in stage order: HSV shift, noise from the image's
//      own field noise[slot], HED shift, box blur 3 or 5 with reflect101
//      borders, brightness/contrast.  HSV, noise and HED are
//      photometric_common.cuh's functions, the chain kernel's;
//   3. one reflect101 two-pass warp by the image's composed inverse map, its
//      plan made by warp_plan.cuh::make_plan (bit-identical to
//      geometry.warp_pass_coefficients), sampled at the plain version's
//      positions with its hat weights, the products and sums rounded one by
//      one as PyTorch's separate kernels round them;
//   4. clip to [0, 1] and store.
//
// What bounds it on an H100.  At the consistency step's 112 images of 256^2
// with NAug 7: 22 MB of uint8 read, ~68 MB of noise fields (one a noise
// stage: 112 x 7 / 9, ~87 of 786 KB), 176 MB of float32 weak and strong
// written: ~266 MB, 80 us at 3.35 TB/s.  The arithmetic is a few hundred
// operations a pixel at most (the HSV and HED conversions, four pass-1 taps a
// warped pixel).  The views were host-bound; what matters is one launch where
// there were some 1250.
//
// The design.  A 3 x 256 x 256 float32 image is 768 KiB, more than a block's
// 227 KB of shared memory, so a cluster of up to 8 CTAs holds one image, CTA
// q owning `rows` full rows of the three planes (32 rows at 256^2: 112 KB with
// two halo rows above and below and two halo columns on each side; two CTAs an
// SM).  Stages are uniform per image, so per cluster: no divergence.
//   - A run of pointwise stages is one pass over the CTA's pixels, the
//     stages applied in order in registers.
//   - A blur stage: a cluster barrier; each CTA copies the two (or one) rows
//     above and below its own, folded reflect101 over the whole image, from
//     whichever CTA owns them (distributed shared memory) into its halo rows;
//     a second barrier, after which no CTA reads another's rows; then the
//     vertical pass in place, a thread walking a (channel, column) with the
//     window's inputs in registers, and the horizontal pass in place, a warp
//     a row, each row's halo columns folded first.  Each output is the tap
//     sum in ascending offset order divided by k, as the plain version's
//     masked-tap sum computes it, so the blur is the plain version's bit for
//     bit on the same input.
//   - The warp: after a cluster barrier each CTA computes its own output rows,
//     reading the four pass-1 taps of each pixel from whichever CTA holds
//     them; a last barrier keeps every CTA's rows alive until its neighbours
//     are done.
// The launch plan (cluster, rows, shared bytes) is
// ops/strong_views_kernel.py::launch_plan; rows of at most 256 pixels.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "photometric_common.cuh"
#include "warp_plan.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace photometric;
using namespace two_pass;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxWidth = 256;     // the horizontal pass keeps 8 columns a lane
constexpr int kMaxStages = 32;
constexpr int kMaxHalf = 2;        // blur k <= 5 (randaugment.V1_MAX_BLUR)
constexpr int kMaxSmem = 232448 - 4096;  // dynamic: 227 KB a block, less room for the static part

// The stage table (ops/strong_views_kernel.py): a row per image of kHead
// floats (weak_flip, strong_flip, the composed 3x3 inverse map) and kStage a
// stage (op, active, the op's 6 parameters, noise slot).
constexpr int kHead = 11;
constexpr int kStage = 9;

// randaugment.V1_POOL's photometric ops
constexpr int kHsv = 0, kNoise = 1, kColor = 4, kBlur = 5, kBrightness = 6, kContrast = 7;

struct Stage {
  int op;    // V1_POOL index, -1 where the stage does not run
  int slot;  // the noise stage's field
  TileParams tp;
};

// A stage's parameters in the form its op uses (the unused fields are
// whatever the op's slots hold).
__device__ Stage make_stage(const float* __restrict__ st) {
  Stage s;
  s.op = st[1] > 0.5f ? static_cast<int>(st[0]) : -1;
  s.slot = static_cast<int>(st[8]);
  const float* p = st + 2;
  TileParams& t = s.tp;
  t.hue = p[0] / 180.0f;
  t.sat = p[1] / 255.0f;
  t.val = p[2] / 255.0f;
  t.sigma = p[0];
  t.hed[0] = p[0];
  t.hed[1] = p[1];
  t.hed[2] = p[2];
  t.gain = 1.0f + p[1];  // brightness p[0], contrast p[1]
  t.bias = p[0];
  t.half = min(max((static_cast<int>(p[0]) - 1) / 2, 0), kMaxHalf);
  return s;
}

// The shared memory of one CTA: three planes of (rows + 2 kMaxHalf) rows of
// Wp = size + 2 kMaxHalf floats; `body` points at row 0, column 0 of plane 0,
// so local row r in [-kMaxHalf, rows + kMaxHalf) and column x in
// [-kMaxHalf, size + kMaxHalf) of plane c is body[c * plane + r * Wp + x].
struct Slab {
  float* body;
  int plane, Wp, size, rows, y0, my_rows;
  unsigned rank;
};

// Pixel (y, x) of plane 0 of the image, in whichever CTA of the cluster owns
// row y.
__device__ __forceinline__ const float* pixel(cg::cluster_group& cluster, const Slab& s, int y, int x) {
  const unsigned owner = static_cast<unsigned>(y / s.rows);
  const float* base = owner == s.rank ? s.body : cluster.map_shared_rank(s.body, owner);
  return base + (y - static_cast<int>(owner) * s.rows) * s.Wp + x;
}

// Stages [j0, j1), none a blur, on every pixel of the CTA's rows, in place.
__device__ void pointwise_run(const Slab& s, const Stage* st, int j0, int j1, const HedMats& m,
                              const float* __restrict__ noise) {
  const size_t ps = static_cast<size_t>(s.size) * s.size;
  for (int i = threadIdx.x; i < s.my_rows * s.size; i += kThreads) {
    const int r = i / s.size, x = i - r * s.size;
    float* p = s.body + r * s.Wp + x;
    float rgb[3] = {p[0], p[s.plane], p[2 * s.plane]};
    for (int j = j0; j < j1; ++j) {
      const Stage& g = st[j];
      switch (g.op) {
        case kHsv:
          hsv_shift(rgb[0], rgb[1], rgb[2], g.tp);
          break;
        case kNoise: {
          const float* f = noise + static_cast<size_t>(g.slot) * 3 * ps + static_cast<size_t>(s.y0 + r) * s.size + x;
          const float nz[3] = {f[0], f[ps], f[2 * ps]};
          add_noise(rgb[0], rgb[1], rgb[2], nz, g.tp.sigma);
          break;
        }
        case kColor: {
          float out[3];
          hed_shift(rgb[0], rgb[1], rgb[2], g.tp, m, out);
          rgb[0] = out[0];
          rgb[1] = out[1];
          rgb[2] = out[2];
          break;
        }
        case kBrightness:
        case kContrast:
#pragma unroll
          for (int c = 0; c < 3; ++c) rgb[c] = clip01(__fadd_rn(__fmul_rn(rgb[c], g.tp.gain), g.tp.bias));
          break;
        default:
          break;
      }
    }
    p[0] = rgb[0];
    p[s.plane] = rgb[1];
    p[2 * s.plane] = rgb[2];
  }
}

// The box blur of half-width H (k = 2 H + 1) with reflect101 borders, in
// place: vertical pass, then horizontal, each output the tap sum in
// ascending offset order divided by k.
template <int H>
__device__ void blur(cg::cluster_group& cluster, const Slab& s) {
  constexpr int K = 2 * H + 1;
  const int tid = threadIdx.x;
  cluster.sync();  // every CTA's rows hold this stage's input
  // halo rows -H .. -1 and my_rows .. my_rows + H - 1, folded over the image
  for (int i = tid; i < 3 * 2 * H * s.size; i += kThreads) {
    const int q = i / s.size, x = i - q * s.size;
    const int c = q / (2 * H), k = q - c * 2 * H;
    const int lr = k < H ? k - H : s.my_rows + k - H;
    s.body[c * s.plane + lr * s.Wp + x] = pixel(cluster, s, fold101(s.y0 + lr, s.size), x)[c * s.plane];
  }
  cluster.sync();  // from here to the next stage no CTA reads another's rows

  // vertical: a thread walks a (channel, column) down the CTA's rows,
  // holding the window's K inputs, and writes each output over its input
  for (int i = tid; i < 3 * s.size; i += kThreads) {
    const int c = i / s.size, x = i - c * s.size;
    float* col = s.body + c * s.plane + x;
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = col[(k - H) * s.Wp];
    for (int r = 0; r < s.my_rows; ++r) {
      float sum = v[0];
#pragma unroll
      for (int k = 1; k < K; ++k) sum = __fadd_rn(sum, v[k]);
#pragma unroll
      for (int k = 0; k + 1 < K; ++k) v[k] = v[k + 1];
      if (r + 1 < s.my_rows) v[K - 1] = col[(r + H + 1) * s.Wp];
      col[r * s.Wp] = sum / static_cast<float>(K);
    }
  }
  __syncthreads();
  // each row's halo columns, folded reflect101 within the row
  for (int i = tid; i < 3 * s.my_rows * 2 * H; i += kThreads) {
    const int q = i / (2 * H), e = i - q * 2 * H;
    const int c = q / s.my_rows, r = q - c * s.my_rows;
    const int x = e < H ? e - H : s.size + e - H;
    float* line = s.body + c * s.plane + r * s.Wp;
    line[x] = line[fold101(x, s.size)];
  }
  __syncthreads();
  // horizontal: a warp a (channel, row), every read of the row before any write
  const int lane = tid & 31;
  for (int q = tid >> 5; q < 3 * s.my_rows; q += kWarps) {
    float* line = s.body + (q / s.my_rows) * s.plane + (q % s.my_rows) * s.Wp;
    float out[kMaxWidth / 32];
#pragma unroll
    for (int k = 0; k < kMaxWidth / 32; ++k) {
      const int x = lane + 32 * k;
      if (x < s.size) {
        float sum = line[x - H];
#pragma unroll
        for (int d = 1; d < K; ++d) sum = __fadd_rn(sum, line[x - H + d]);
        out[k] = sum / static_cast<float>(K);
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kMaxWidth / 32; ++k) {
      const int x = lane + 32 * k;
      if (x < s.size) line[x] = out[k];
    }
  }
}

// Pass 1 of the warp at row ty of the fixed-up lattice, for the lattice
// column whose ap * c is apc: the three channels.  Lattice pixel (a, b) is
// the image's (a, b), transposed where swap, after a 90-degree turn where
// rot (rot90: lattice (a, b) is the image's (b, size - 1 - a)).
__device__ __forceinline__ void pass1(cg::cluster_group& cluster, const Slab& s, const WarpPlan& w, float apc,
                                      int ty, float out[3]) {
  const Taps t = taps(fold_pos(__fadd_rn(__fadd_rn(apc, __fmul_rn(w.bp, static_cast<float>(ty))), w.cp), w),
                      s.size);
  const float* p[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int b = j == 0 ? t.i0 : t.i1;
    const int a1 = w.swap ? b : ty, b1 = w.swap ? ty : b;  // the lattice before the transpose
    p[j] = w.rot ? pixel(cluster, s, b1, s.size - 1 - a1) : pixel(cluster, s, a1, b1);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = __fadd_rn(__fmul_rn(p[0][c * s.plane], t.w0), __fmul_rn(p[1][c * s.plane], t.w1));
}

__global__ void __launch_bounds__(kThreads, 2)
strong_views_kernel(const uint8_t* __restrict__ imgs, const float* __restrict__ table, int n_stages,
                    const float* __restrict__ noise, float* __restrict__ weak, float* __restrict__ strong,
                    float* __restrict__ plan_out, int size, int rows, HedMats mats) {
  extern __shared__ float s_dyn[];
  __shared__ Stage s_stage[kMaxStages];
  __shared__ WarpPlan s_plan;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = blockIdx.x / cluster.num_blocks();
  const int tid = threadIdx.x;
  const float* row = table + static_cast<size_t>(n) * (kHead + kStage * n_stages);

  Slab s;
  s.Wp = size + 2 * kMaxHalf;
  s.plane = (rows + 2 * kMaxHalf) * s.Wp;
  s.body = s_dyn + kMaxHalf * s.Wp + kMaxHalf;
  s.size = size;
  s.rows = rows;
  s.rank = cluster.block_rank();
  s.y0 = static_cast<int>(s.rank) * rows;
  s.my_rows = max(0, min(rows, size - s.y0));

  if (tid < n_stages) s_stage[tid] = make_stage(row + kHead + kStage * tid);
  if (tid == kThreads - 1) {  // another warp than the stages'
    s_plan = make_plan(row + 2, size);
    if (plan_out != nullptr && s.rank == 0) {
      float* o = plan_out + static_cast<size_t>(n) * 8;
      o[0] = s_plan.ap;
      o[1] = s_plan.bp;
      o[2] = s_plan.cp;
      o[3] = s_plan.d;
      o[4] = s_plan.e;
      o[5] = s_plan.f;
      o[6] = s_plan.rot ? 1.0f : 0.0f;
      o[7] = s_plan.swap ? 1.0f : 0.0f;
    }
  }

  // the weak view out, the strong view's mirrored image into shared memory
  const size_t ps = static_cast<size_t>(size) * size;
  const bool weak_flip = row[0] > 0.5f, strong_flip = row[1] > 0.5f;
  const uint8_t* src = imgs + static_cast<size_t>(n) * ps * 3;
  float* wdst = weak + static_cast<size_t>(n) * 3 * ps;
  for (int i = tid; i < s.my_rows * size; i += kThreads) {
    const int r = i / size, x = i - r * size;
    const size_t at = static_cast<size_t>(s.y0 + r) * size;
    const uint8_t* pw = src + 3 * (at + (weak_flip ? size - 1 - x : x));
    const uint8_t* pst = src + 3 * (at + (strong_flip ? size - 1 - x : x));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wdst[c * ps + at + x] = clip01(static_cast<float>(pw[c]) / 255.0f);
      s.body[c * s.plane + r * s.Wp + x] = static_cast<float>(pst[c]) / 255.0f;
    }
  }
  __syncthreads();  // s_stage, s_plan

  // the stages in order: runs of pointwise stages between the blurs
  for (int j = 0; j < n_stages;) {
    if (s_stage[j].op == kBlur) {
      if (s_stage[j].tp.half == 1) blur<1>(cluster, s);
      else if (s_stage[j].tp.half == 2) blur<2>(cluster, s);
      ++j;
      continue;
    }
    int e = j;
    bool any = false;
    for (; e < n_stages && s_stage[e].op != kBlur; ++e) any |= s_stage[e].op >= 0;
    if (any) {
      __syncthreads();  // the previous pass's writes
      pointwise_run(s, s_stage, j, e, mats, noise);
    }
    j = e;
  }
  cluster.sync();  // every CTA's rows hold the photometric output

  // the warp: this CTA's output rows, each pixel from its four pass-1 taps
  const WarpPlan w = s_plan;
  float* sdst = strong + static_cast<size_t>(n) * 3 * ps;
  for (int i = tid; i < s.my_rows * size; i += kThreads) {
    const int Y = s.y0 + i / size, X = i % size;
    const int r = w.swap ? X : Y, c = w.swap ? Y : X;  // the lattice pixel
    const float apc = __fmul_rn(w.ap, static_cast<float>(c)), dc = __fmul_rn(w.d, static_cast<float>(c));
    const Taps t = taps(fold_pos(__fadd_rn(__fadd_rn(dc, __fmul_rn(w.e, static_cast<float>(r))), w.f), w), size);
    float a[3], b[3];
    pass1(cluster, s, w, apc, t.i0, a);
    pass1(cluster, s, w, apc, t.i1, b);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      sdst[ch * ps + static_cast<size_t>(Y) * size + X] =
          clip01(__fadd_rn(__fmul_rn(a[ch], t.w0), __fmul_rn(b[ch], t.w1)));
  }
  cluster.sync();  // neighbours may still read this CTA's rows
}

}  // namespace

// Launch on `stream`.  imgs: (n, size, size, 3) uint8; table: (n, 11 + 9
// n_stages) float32; noise: (K, 3, size, size) float32, every slot of the
// table's noise stages below K (may be null when none runs); weak, strong:
// (n, 3, size, size) float32; plan_out: (n, 8) float32 or null, receives
// each image's warp plan (geometry.warp_pass_coefficients' rows); all
// contiguous on the device.  cluster, rows, smem: the launch plan
// (ops/strong_views_kernel.py::launch_plan).  hed_mats_host: 18 floats in
// host memory, HED_FROM_RGB then RGB_FROM_HED, row-major.  Returns a CUDA
// error code (0 on success), cudaErrorInvalidValue for a plan or shape the
// kernel does not take.
extern "C" int launch_strong_views(const uint8_t* imgs, const float* table, int n_stages, const float* noise,
                                   float* weak, float* strong, float* plan_out, int n, int size, int cluster,
                                   int rows, int smem, const float* hed_mats_host, void* stream) {
  if (n < 1 || size < 1 || size > kMaxWidth || n_stages < 0 || n_stages > kMaxStages || cluster < 1 ||
      cluster > kMaxCluster || rows < 1 || (cluster - 1) * rows >= size || cluster * rows < size ||
      smem != 3 * (rows + 2 * kMaxHalf) * (size + 2 * kMaxHalf) * 4 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  HedMats mats;
  for (int i = 0; i < 9; ++i) {
    mats.hed_from_rgb[i] = hed_mats_host[i];
    mats.rgb_from_hed[i] = hed_mats_host[9 + i];
  }
  cudaError_t err = cudaFuncSetAttribute(strong_views_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * static_cast<unsigned>(n));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, strong_views_kernel, imgs, table, n_stages, noise, weak, strong, plan_out, size,
                           rows, mats);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The two-pass warp's per-tile plan and its sampling, shared by
// rsp_augment.cu and strong_views.cu: make_plan is
// ops/geometry.py::warp_pass_coefficients operation for operation, fold_pos
// its reflect101 folding and taps its hat weights, so a kernel that samples
// through them lands on the positions and weights of warp_affine_planar bit
// for bit.
#pragma once

namespace two_pass {

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

}  // namespace two_pass

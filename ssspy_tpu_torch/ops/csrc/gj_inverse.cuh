// Pivot-free complex Gauss-Jordan inverse of one small Hermitian system,
// shared by the batched inverse (gj_inverse.cu, K3), the inverse-sandwich
// kernel (inv_sandwich.cu, K4) and the fused dense-MNMF model pass
// (mnmf_model_traces.cu, K5).
//
// Counterpart of the elimination inside ssspy_tpu/ops/pallas_kernels.py
// (_gj_inverse_lanes, :201-235), which runs on the real 2m x 3m embedding
// [E(R) | I] because Mosaic has no complex type. Here the system is the
// complex m x m one, [R | I] in shared memory: a quarter of
// the embedded form's operations. A Hermitian positive definite R has real
// positive pivots, so the embedded form's sign-preserving floor becomes the
// phase-preserving one of ops/kernels.py:gauss_jordan_solve_nopivot: a
// pivot with |p| < tiny becomes p / |p| * tiny (tiny when p = 0).
//
// The elimination is that of ops/kernels.py:_gauss_jordan, step by step:
// for k = 0 .. m-1, row k is divided by its (floored) pivot, then every
// other row i loses aug[i][k] times it. The m threads of a group each own one
// row. Their group lies inside one warp, and every lane of that warp calls
// invert() (lanes without a row pass live = false), so one __syncwarp() per
// step orders the pivot row's write before the other rows read it; a row is
// read by other threads only while it is the pivot row. Callers pad each row
// of [R | I] to 2m + 1 entries: at m = 8 the 16 rows that a half-warp's two
// groups update then fall in 16 different shared-memory banks. Up to m = 32
// a group fits one warp, floor(32 / m) groups to a warp; K4 and K5 keep
// each thread's row of their products in registers and take m <= 16.

#pragma once

#include <cuda_runtime.h>

namespace gj {

constexpr int kMaxM = 32;  // largest system; the group of m threads fits a warp

// The products and quotients below round as PyTorch's complex64 operators
// do on the card (c10::complex as nvcc contracts it), step for step: each
// fused multiply-add is written out with the _rn intrinsics, so that no
// contraction left to the compiler can differ from the plain version's.
// (The plain forms, left to the compiler, gave other bits than PyTorch's
// division in a share of quotients, and the inverse of a few systems in
// 315,504 other bits than the plain version's; PERF.md.)

// a * b as c10::complex<float>::operator*= rounds it
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)), __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 cmadd(float2 acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
  return acc;
}

// The divisor b of a / b in the scaled form PyTorch's complex division
// takes (numpy's): |b|^2 is never formed, so a pivot of 1e-20 divides
// without underflow. Its ratio and reciprocal are formed once, for every
// numerator a that it divides.
struct Divisor {
  bool wide;  // |b.x| >= |b.y|
  float rat, scl;
  __device__ __forceinline__ explicit Divisor(float2 b) {
    wide = fabsf(b.x) >= fabsf(b.y);
    if (wide) {
      rat = __fdiv_rn(b.y, b.x);
      scl = __frcp_rn(__fmaf_rn(b.y, rat, b.x));
    } else {
      rat = __fdiv_rn(b.x, b.y);
      scl = __frcp_rn(__fmaf_rn(b.x, rat, b.y));
    }
  }
  __device__ __forceinline__ float2 operator()(float2 a) const {
    if (wide) return make_float2(__fmul_rn(__fmaf_rn(a.y, rat, a.x), scl), __fmul_rn(__fmaf_rn(-a.x, rat, a.y), scl));
    return make_float2(__fmul_rn(__fmaf_rn(a.x, rat, a.y), scl), __fmul_rn(__fmaf_rn(a.y, rat, -a.x), scl));
  }
};

// a / b as c10::complex<float>::operator/= rounds it (b != 0)
__device__ __forceinline__ float2 cdiv(float2 a, float2 b) { return Divisor(b)(a); }

__device__ __forceinline__ float2 floored_pivot(float2 p, float tiny) {
  const float mag = hypotf(p.x, p.y);
  if (mag >= tiny) return p;
  if (mag > 0.f) {
    const float scl = 1.f / mag;  // p / |p| as PyTorch divides by a real
    return make_float2(p.x * scl * tiny, p.y * scl * tiny);
  }
  return make_float2(tiny, 0.f);
}

// Row stride of [R | I] in shared memory.
__host__ __device__ __forceinline__ int stride(int m) { return 2 * m + 1; }

// aug: this group's [R | I], m rows of 2m entries (row stride stride(m)) in
// shared memory; on return its right half holds R^-1. `row` is the calling
// thread's row (0 .. m-1). Ends with a __syncwarp(), so every row of R^-1 is
// visible to the group.
__device__ __forceinline__ void invert(float2* aug, int m, int row, bool live, float tiny) {
  const int w = 2 * m, ld = stride(m);
  for (int k = 0; k < m; ++k) {
    if (live && row == k) {
      float2* pivot_row = aug + k * ld;
      const Divisor div(floored_pivot(pivot_row[k], tiny));
      for (int c = 0; c < w; ++c) pivot_row[c] = div(pivot_row[c]);
    }
    __syncwarp();
    if (live && row != k) {
      float2* own = aug + row * ld;
      const float2* pivot_row = aug + k * ld;
      const float2 f = own[k];
      for (int c = 0; c < w; ++c) {
        const float2 t = cmul(f, pivot_row[c]);
        own[c] = make_float2(__fsub_rn(own[c].x, t.x), __fsub_rn(own[c].y, t.y));
      }
    }
  }
  __syncwarp();
}

}  // namespace gj

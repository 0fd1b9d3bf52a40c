// Sequential IP1 sweep over the sources of every bin.
//
// Replaces: ssspy_tpu/ops/splitc.py:ip1_sweep_sc, with its solve
// csolve/gauss_jordan_solve_nopivot (XLA ops in the JAX package, not a
// Pallas kernel).
//
// For each bin i and source n in order: solve (W_i U_in) w = e_n by
// pivot-free complex Gauss-Jordan (a pivot with |p| < 1e-20 is floored to
// magnitude 1e-20 keeping its phase, and 0 becomes 1e-20, as in
// gauss_jordan_solve_nopivot), form w^H U_in w, and write
// conj(w) / max(sqrt(w^H U w), eps) into row n. Where w^H U w <= 0 or is
// NaN (a singular U_in: a silent or zero-padded bin) row n is kept as it
// was, the freeze of splitc.py:309-317. Later sources see the updated rows.
//
// Bound on the H100: at the main-path shape (N = M = 8, I = 257 bins) a
// call reads 1 MB of U and 16 KB of W and does about 0.4 MFLOP per bin:
// 0.39 us of bytes. Neither bytes nor flops bound it: each bin is a chain of
// N dependent source updates, each a chain of M dependent elimination
// steps, so latency bounds it.
//
// What held the first design back (one block of 96 threads per bin,
// 0.064 ms between CUDA events and 54.8 us a launch by the profiler on an
// NVIDIA H100 80GB HBM3 at 700 W): ~19 block barriers a source, every
// operand through shared memory between them, and the pivot's hypotf and
// two divisions recomputed by each thread of the pivot row.
//
// Design, two variants chosen by M (ops/kernels.py:ip1_sweep_variant):
// - 1 <= M <= kWarpMaxM (the paths' M = 8): a group of P lanes of one warp
//   owns a bin (P = M rounded up to a power of two; 32 / P bins a warp, one
//   warp a block), with no block barrier anywhere. Lane r holds row r of W_i
//   and row r of [A | e_n] in registers, a template on M with every loop
//   unrolled. The block stages its bins' U_i into shared memory by cp.async
//   (16 bytes at a time at even M; source 0 in its own group, so that the
//   first source starts while the rest arrive), at a stride per bin that
//   puts the groups of a half-warp on distinct banks. For each source: lane
//   r forms row r of A = W U_n from its row of W and U_n, read as
//   broadcasts; each elimination step receives the pivot row's live entries
//   (the columns after the pivot and the right side) from its owner by
//   __shfl_sync over the group, floors the pivot, forms one scaled
//   reciprocal of it (PivotInverse) and updates its own row by selects, the
//   products rounded as gj::invert rounds them; the solution w is gathered
//   by shuffles, lane r forms (U_n w)_r, and w^H U_n w comes from a
//   butterfly over the group (every lane ends with the same bits). Lane n
//   writes its new row.
// - kWarpMaxM < M <= 17 (the shared-memory limit of the size contract):
//   one block per bin keeps W_i and U_i in shared memory, with the
//   augmented system there too (the first design, kept for these sizes).
// No atomics and a fixed order: two launches give the same bits. What the
// elimination step costs is its chain: the shuffle, the pivot's reciprocal
// and one complex product and subtraction. Phases timed by clock64 in a
// throwaway copy on the card showed it at about twice that with the
// correctly rounded division of gj::Divisor and a branch for the pivot
// lane, the forms of the first version of this variant (PERF.md).
// Measured (scripts/torch_kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W): see
// PERF.md, section 6.

#include <cuda_runtime.h>

#include "gj_inverse.cuh"

namespace {

constexpr float kTiny = 1e-20f;
constexpr int kWarpSize = 32;
constexpr int kWarpMaxM = 8;  // largest M of the warp variant; above it the block variant
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 c) {  // a * b + c
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)), fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}

// ---- 1 <= M <= 8: a group of lanes per bin, rows in registers --------------------------

// lanes of a bin's group: M rounded up to a power of two, so that __shfl_sync
// can take the group as its width
__host__ __device__ constexpr int group_width(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

// complex64 stride of a bin's U in shared memory: even M copies 16 bytes at a
// time, so the stride stays even (M^3 + 2); odd M copies 8, at an odd stride
// (M^3, odd). Either way the groups of a half-warp read distinct banks.
__host__ __device__ constexpr int stage_stride(int M) { return M % 2 == 0 ? M * M * M + 2 : M * M * M; }

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Copy entries [lo, hi) of each of the block's `count` bins of U (MMM
// complex64 each, contiguous) into shared memory at stride LD: in pairs
// (16 bytes) at even M, singly at odd M.
template <int M, int LD>
__device__ __forceinline__ void stage(float2* Us, const float2* U_blk, int count, int lo, int hi, int lane) {
  constexpr int MMM = M * M * M, V = M % 2 == 0 ? 2 : 1;
  const int per_bin = (hi - lo) / V;
  for (int e = lane; e < count * per_bin; e += kWarpSize) {
    const int b = e / per_bin, o = lo + V * (e - b * per_bin);
    if constexpr (V == 2) {
      cp_async16(Us + b * LD + o, U_blk + (long long)b * MMM + o);
    } else {
      cp_async8(Us + b * LD + o, U_blk + (long long)b * MMM + o);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float2 shfl(float2 v, int src, int width) {
  return make_float2(__shfl_sync(kFull, v.x, src, width), __shfl_sync(kFull, v.y, src, width));
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// the pivot floor of gauss_jordan_solve_nopivot: only a pivot with both
// parts under tiny can have |p| < tiny; a NaN pivot fails both tests and
// propagates to the freeze. The zero pivots of a silent bin (every step of
// every source) skip hypotf, whose 0 / 0 takes the division's slow path.
__device__ __forceinline__ float2 floor_pivot(float2 p) {
  if (fabsf(p.x) < kTiny && fabsf(p.y) < kTiny)
    return p.x == 0.f && p.y == 0.f ? make_float2(kTiny, 0.f) : gj::floored_pivot(p, kTiny);
  return p;
}

// a / p for every a of one elimination step, from one scaled reciprocal of
// the pivot: q = p c, 1 / p = conj(q) s with s = c / |q|^2, exact for any
// c. c = 1 / max(|Re p|, |Im p|), that maximum capped at 2^126 so that c
// stays a normal number (the reciprocal flushes a subnormal result to 0):
// |q|^2 then lies in [1, 32], so nothing overflows or underflows for a
// floored pivot (|p| >= 1e-20) nor for one up to the largest float, and
// only s, which is 1 / p's own size, may be subnormal. Two approximate
// reciprocals (rcp.approx, ~1 ulp), not the correctly rounded division of
// the gjnp twin: the kernel is held to it within 1e-4, not bit for bit.
struct PivotInverse {
  float2 q;
  float s;
  __device__ __forceinline__ explicit PivotInverse(float2 p) {
    const float scale = rcp_approx(fminf(fmaxf(fabsf(p.x), fabsf(p.y)), 0x1p126f));
    q = make_float2(p.x * scale, p.y * scale);
    s = rcp_approx(fmaf(q.x, q.x, q.y * q.y)) * scale;
  }
  __device__ __forceinline__ float2 operator()(float2 a) const {
    return make_float2(fmaf(a.x, q.x, a.y * q.y) * s, fmaf(a.y, q.x, -a.x * q.y) * s);
  }
};

template <int M>
__global__ void __launch_bounds__(kWarpSize)
    ip1_sweep_kernel_warp(const float2* __restrict__ W_in,  // (I, M, M)
                          const float2* __restrict__ U,     // (I, M, M, M)
                          float2* __restrict__ W_out,       // (I, M, M)
                          int I, float eps) {
  constexpr int P = group_width(M), G = kWarpSize / P;  // lanes a bin, bins a block
  constexpr int MM = M * M, MMM = M * MM, LD = stage_stride(M);
  __shared__ __align__(16) float2 Us[G * LD];

  const int lane = threadIdx.x, g = lane / P, r = lane - g * P;
  const int first = blockIdx.x * G;
  const int count = min(G, I - first);  // bins of this block
  // a group past the last bin repeats the block's first bin and writes nothing;
  // lanes r >= M of a group hold zero rows and write nothing
  const int gb = g < count ? g : 0;
  const bool live = g < count && r < M;

  float2 wrow[M];  // row r of W_i
  const float2* w_src = W_in + ((long long)(first + gb) * M + (r < M ? r : 0)) * M;
#pragma unroll
  for (int c = 0; c < M; ++c) wrow[c] = r < M ? w_src[c] : make_float2(0.f, 0.f);

  // stage U: source 0 of every bin, then sources 1 .. M-1 (two commit groups)
  const float2* U_blk = U + (long long)first * MMM;
  stage<M, LD>(Us, U_blk, count, 0, MM, lane);
  stage<M, LD>(Us, U_blk, count, MM, MMM, lane);

  const float2* Ub = Us + gb * LD;
  const float inv_eps = 1.f / eps;
#pragma unroll 1
  for (int n = 0; n < M; ++n) {
    if (n == 0) {
      cp_async_wait<1>();
      __syncwarp();
    } else if (n == 1) {
      cp_async_wait<0>();
      __syncwarp();
    }
    const float2* Un = Ub + n * MM;

    // row r of [A | e_n], A = W U_n, and below z = U_n w: each sum in the
    // order and rounding of torch.matmul's complex product (gj::cmadd), so
    // that A has the gjnp twin's bits
    float2 a[M], urow[M];
#pragma unroll
    for (int c = 0; c < M; ++c) a[c] = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int c = 0; c < M; ++c) a[c] = gj::cmadd(a[c], wrow[m], Un[m * M + c]);
    }
#pragma unroll
    for (int c = 0; c < M; ++c) urow[c] = Un[(r < M ? r : 0) * M + c];
    float2 b = make_float2(r == n ? 1.f : 0.f, 0.f);

    // Gauss-Jordan: the columns after k and the right side stay live; the
    // pivot lane takes the divided row, the others subtract (selects, no
    // divergent branch)
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const PivotInverse inv(floor_pivot(shfl(a[k], k, P)));
      const bool own = r == k;
      const float2 f = own ? make_float2(0.f, 0.f) : a[k];
#pragma unroll
      for (int c = k + 1; c < M; ++c) {
        const float2 pc = inv(shfl(a[c], k, P));
        const float2 t = gj::cmul(f, pc);
        const float2 u = make_float2(__fsub_rn(a[c].x, t.x), __fsub_rn(a[c].y, t.y));
        a[c] = own ? pc : u;
      }
      const float2 pb = inv(shfl(b, k, P));
      const float2 t = gj::cmul(f, pb);
      const float2 u = make_float2(__fsub_rn(b.x, t.x), __fsub_rn(b.y, t.y));
      b = own ? pb : u;
    }

    // w (lane r holds w_r in b), z_r = (U_n w)_r, w^H U_n w over the group
    // (a butterfly: every lane ends with the same bits)
    float2 w[M];
#pragma unroll
    for (int c = 0; c < M; ++c) w[c] = shfl(b, c, P);
    float2 z = make_float2(0.f, 0.f);
#pragma unroll
    for (int c = 0; c < M; ++c) z = gj::cmadd(z, urow[c], w[c]);
    float part = r < M ? fmaf(b.x, z.x, b.y * z.y) : 0.f;
#pragma unroll
    for (int offset = P / 2; offset > 0; offset >>= 1) part += __shfl_xor_sync(kFull, part, offset, P);
    if (r == n && part > 0.f) {  // false for NaN: the freeze
      const float scale = fminf(rsqrtf(part), inv_eps);  // 1 / max(sqrt(part), eps)
#pragma unroll
      for (int c = 0; c < M; ++c) wrow[c] = make_float2(w[c].x * scale, -w[c].y * scale);
    }
  }

  if (live) {
    float2* w_dst = W_out + ((long long)(first + g) * M + r) * M;
#pragma unroll
    for (int c = 0; c < M; ++c) w_dst[c] = wrow[c];
  }
}

template <int M>
void launch_warp(const float2* W, const float2* U, float2* W_out, int I, float eps, cudaStream_t stream) {
  constexpr int G = kWarpSize / group_width(M);
  ip1_sweep_kernel_warp<M><<<(I + G - 1) / G, kWarpSize, 0, stream>>>(W, U, W_out, I, eps);
}

// ---- 8 < M <= 17: one block per bin, the system in shared memory -----------------------

__global__ void ip1_sweep_kernel(const float2* __restrict__ W_in,  // (I, N, M)
                                 const float2* __restrict__ U,     // (I, N, M, M)
                                 float2* __restrict__ W_out,       // (I, N, M)
                                 int N, int M, float eps) {
  extern __shared__ float2 sm[];
  const int L = M + 1;              // augmented row length [A | e_n]
  float2* Us = sm;                  // (N, M, M)
  float2* Ws = Us + N * M * M;      // (N, M)
  float2* aug = Ws + N * M;         // (M, M + 1)
  float2* prow = aug + M * L;       // normalised pivot row, M + 1
  float2* fac = prow + L;           // elimination factors, M
  float2* z = fac + M;              // U_n w, M

  const int i = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int idx = tid; idx < N * M * M; idx += nt) Us[idx] = U[(long long)i * N * M * M + idx];
  for (int idx = tid; idx < N * M; idx += nt) Ws[idx] = W_in[(long long)i * N * M + idx];
  __syncthreads();

  for (int n = 0; n < N; ++n) {
    const float2* Un = Us + n * M * M;

    // [A | e_n] with A = W U_n
    for (int idx = tid; idx < M * L; idx += nt) {
      const int r = idx / L, c = idx % L;
      float2 v = make_float2(0.f, 0.f);
      if (c < M) {
        for (int m = 0; m < M; ++m) v = cfma(Ws[r * M + m], Un[m * M + c], v);
      } else if (r == n) {
        v.x = 1.f;
      }
      aug[idx] = v;
    }
    __syncthreads();

    for (int k = 0; k < M; ++k) {
      // normalised pivot row and the factors of column k, from the rows
      // as they stand (read only here)
      for (int idx = tid; idx < L + M; idx += nt) {
        if (idx < L) {
          float2 p = aug[k * L + k];
          float h = hypotf(p.x, p.y);
          if (h < kTiny) {  // false for NaN: a NaN pivot propagates to the freeze
            if (h > 0.f) {
              p = make_float2(p.x / h * kTiny, p.y / h * kTiny);
            } else {
              p = make_float2(kTiny, 0.f);
            }
            h = kTiny;
          }
          const float2 inv = make_float2((p.x / h) / h, -(p.y / h) / h);  // 1 / p
          prow[idx] = cmul(aug[k * L + idx], inv);
        } else {
          fac[idx - L] = aug[(idx - L) * L + k];
        }
      }
      __syncthreads();
      for (int idx = tid; idx < M * L; idx += nt) {
        const int r = idx / L, c = idx % L;
        if (r == k) {
          aug[idx] = prow[c];
        } else {
          const float2 f = fac[r];
          aug[idx] = cfma(make_float2(-f.x, -f.y), prow[c], aug[idx]);
        }
      }
      __syncthreads();
    }

    // z = U_n w, with w the last column of aug
    for (int idx = tid; idx < M; idx += nt) {
      float2 v = make_float2(0.f, 0.f);
      for (int c = 0; c < M; ++c) v = cfma(Un[idx * M + c], aug[c * L + M], v);
      z[idx] = v;
    }
    __syncthreads();

    // w^H U_n w (real by Hermitian symmetry), summed in the same order by
    // every thread that writes an element of row n
    for (int idx = tid; idx < M; idx += nt) {
      float wUw = 0.f;
      for (int m = 0; m < M; ++m) {
        const float2 w = aug[m * L + M];
        wUw = fmaf(w.x, z[m].x, fmaf(w.y, z[m].y, wUw));
      }
      if (wUw > 0.f) {
        const float denom = fmaxf(sqrtf(wUw), eps);
        const float2 w = aug[idx * L + M];
        Ws[n * M + idx] = make_float2(w.x / denom, -w.y / denom);
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < N * M; idx += nt) W_out[(long long)i * N * M + idx] = Ws[idx];
}

}  // namespace

extern "C" {

// W: complex64 (I, N, M) with N == M; U: complex64 (I, N, M, M) Hermitian
// per source; W_out: complex64 (I, N, M). All contiguous on `device`.
// M <= 8 runs the warp variant, larger M the block variant. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError(). The
// Python wrapper checks the same limits first.
int ip1_sweep_launch(const void* W, const void* U, void* W_out, int I, int N, int M, float eps,
                     int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (I < 1 || N < 1 || M < 1 || N != M) return (int)cudaErrorInvalidValue;
  const float2* w = (const float2*)W;
  const float2* u = (const float2*)U;
  float2* out = (float2*)W_out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 1: launch_warp<1>(w, u, out, I, eps, s); break;
    case 2: launch_warp<2>(w, u, out, I, eps, s); break;
    case 3: launch_warp<3>(w, u, out, I, eps, s); break;
    case 4: launch_warp<4>(w, u, out, I, eps, s); break;
    case 5: launch_warp<5>(w, u, out, I, eps, s); break;
    case 6: launch_warp<6>(w, u, out, I, eps, s); break;
    case 7: launch_warp<7>(w, u, out, I, eps, s); break;
    case 8: launch_warp<8>(w, u, out, I, eps, s); break;
    default: {
      static_assert(kWarpMaxM == 8, "the cases above launch the warp variant up to kWarpMaxM");
      const int L = M + 1;
      const int smem = (N * M * M + N * M + M * L + L + 2 * M) * (int)sizeof(float2);
      const int work = M * L;
      const int warps_of_work = ((work + 31) / 32) * 32;
      const int threads = warps_of_work < kMaxThreads ? warps_of_work : kMaxThreads;
      if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
      ip1_sweep_kernel<<<I, threads, smem, s>>>(w, u, out, N, M, eps);
    }
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

// Batched inverse of small Hermitian positive definite systems: for each of
// B complex m x m matrices R, R^-1, 1 <= m <= 32.
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:planar_inverse_sc (:284; the
// Pallas kernel _pinv_pallas :244, its pallas_call :269, the elimination
// _gj_inverse_lanes :201), whose one caller is IPSDTA's model inverse
// (ssspy_tpu/ops/splitc.py:_ipsdta_model_sc, :3294-3308): the PSD-projected
// PSDTF model R = sum_k v_kt T_kb of every (source, frame, block), m = J, the
// block's bins. Same function as its "gj" branch: the pivot-free
// Gauss-Jordan inverse with the 1e-20 pivot floor, in the same order.
//
// Bound on the H100: R is read once and R^-1 written once, 2 B m^2 8 bytes:
// 80.8 MB for IPSDTA's model at the timing shape (B = 8 x 626 x 63 systems of
// 4 x 4), 0.024 ms at 3.35 TB/s. The elimination updates the 2m entries of
// the m rows of [R | I] at each of m steps, 16 m^3 B flops: 0.32 GFLOP there,
// 0.005 ms at 67 TFLOP/s in f32. So bytes bound it.
//
// Design. The TPU kernel puts the batch in the 128 lanes, pads it to 1024
// with identity systems and eliminates on the real 2m x 3m embedding,
// because Mosaic has no complex type. Here the matrices are native
// interleaved complex (float2), the batch is not padded, and the
// elimination is the complex m x m one of gj_inverse.cuh, step by step, in
// one of two instances chosen by m:
// - 1 <= m <= 8 (IPSDTA's blocks of 4 and 5 bins): one thread per system,
//   a template on m. [R | I] lives in registers and the elimination is
//   unrolled whole: no dynamic index, no shared memory and no barrier in
//   it. Each step floors the pivot as gj::floored_pivot, forms the
//   divisor's ratio and reciprocal once (gj::Divisor), divides only the
//   entries still alive (the left half after the pivot column, the right
//   half up to it: the others are 0 or never read again, as in K5) and
//   updates them in the other rows as gj::invert does, so R^-1 keeps the
//   plain version's bits. 32 independent systems a warp give the chain the
//   parallelism one system lacks. The block copies its systems' contiguous
//   R into shared memory with 16-byte loads; each thread reads its own
//   system there at an odd stride (m^2, padded to m^2 + 1 at even m)
//   complex64, so the 16 threads of a half-warp hit distinct banks, and
//   R^-1 goes back the same way.
// - 9 <= m <= 32 (the hard tier's 16 and 17, the limit 32): a group of m
//   threads owns one matrix, one row each, and floor(32 / m) groups share a
//   warp; a block of four warps (two above m = 16) stages its groups'
//   [R | I] in shared memory with coalesced loads, each group inverts its
//   system with gj::invert (one __syncwarp() per step), and the block
//   writes R^-1 back with coalesced stores.
// The first design ran every m on the group kernel: at m = 4 one thread of
// each group divided the whole pivot row while the other three waited, and
// every row was updated in shared memory: 0.1145 ms at the timing shape,
// 21% of the bound. This design: 0.0335 ms there (72% of the bound) and
// 0.0082 ms on the 5,008 systems of 5 x 5, from 0.0134 ms
// (scripts/torch_kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md).

#include <cuda_runtime.h>

#include "gj_inverse.cuh"

namespace {

constexpr int kWarpSize = 32;

// ---- 1 <= m <= 8: one thread per system, [R | I] in registers ----------------------

// systems (threads) per block: 128, or 64 from m = 7 on, so that the staged
// systems stay in 48 KB of static shared memory (33.3 KB at m = 8)
__host__ __device__ constexpr int systems_per_block(int m) { return m <= 6 ? 128 : 64; }

template <int M>
__global__ void __launch_bounds__(systems_per_block(M))
    gj_inverse_kernel(const float2* __restrict__ R_in,  // (B, M, M)
                      float2* __restrict__ Rinv_out,    // (B, M, M)
                      int B, float tiny) {
  constexpr int kSystems = systems_per_block(M), kMM = M * M, kLd = kMM | 1;  // odd
  __shared__ float2 stage[kSystems * kLd];  // system g at g * kLd: R, then R^-1
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * kSystems;
  const int count = (int)min((long long)kSystems, (long long)B - first);
  const int n2 = count * kMM;  // complex64 entries of the block's systems
  const float2* src = R_in + first * kMM;
  float2* dst = Rinv_out + first * kMM;
  // the block's systems are contiguous: 16-byte loads where both ends are
  // 16-byte aligned (first * kMM is even, as kSystems is)
  const bool vec = ((reinterpret_cast<unsigned long long>(src) | reinterpret_cast<unsigned long long>(dst)) & 15) == 0;

  if (vec) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int e = tid; e < n2 / 2; e += kSystems) {
      const float4 v = src4[e];
      const int c0 = 2 * e, c1 = c0 + 1;
      stage[(c0 / kMM) * kLd + c0 % kMM] = make_float2(v.x, v.y);
      stage[(c1 / kMM) * kLd + c1 % kMM] = make_float2(v.z, v.w);
    }
    if ((n2 & 1) && tid == 0) stage[((n2 - 1) / kMM) * kLd + (n2 - 1) % kMM] = src[n2 - 1];
  } else {
    for (int e = tid; e < n2; e += kSystems) stage[(e / kMM) * kLd + e % kMM] = src[e];
  }
  __syncthreads();

  if (tid < count) {
    float2* own = stage + tid * kLd;
    float2 L[M][M];  // left half, R on entry; the entries after the pivot column stay live
    float2 Rt[M][M];  // right half; column k joins at step k
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < M; ++c) L[r][c] = own[r * M + c];
#pragma unroll
    for (int k = 0; k < M; ++k) {
#pragma unroll
      for (int r = 0; r < M; ++r) Rt[r][k] = make_float2(r == k ? 1.f : 0.f, 0.f);
      const gj::Divisor div(gj::floored_pivot(L[k][k], tiny));
#pragma unroll
      for (int c = 0; c < M; ++c) {
        if (c > k) L[k][c] = div(L[k][c]);
        if (c <= k) Rt[k][c] = div(Rt[k][c]);
      }
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (r == k) continue;
        const float2 f = L[r][k];
#pragma unroll
        for (int c = 0; c < M; ++c) {
          if (c > k) {
            const float2 t = gj::cmul(f, L[k][c]);
            L[r][c] = make_float2(__fsub_rn(L[r][c].x, t.x), __fsub_rn(L[r][c].y, t.y));
          } else {
            const float2 t = gj::cmul(f, Rt[k][c]);
            Rt[r][c] = make_float2(__fsub_rn(Rt[r][c].x, t.x), __fsub_rn(Rt[r][c].y, t.y));
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < M; ++c) own[r * M + c] = Rt[r][c];
  }
  __syncthreads();

  if (vec) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int e = tid; e < n2 / 2; e += kSystems) {
      const int c0 = 2 * e, c1 = c0 + 1;
      const float2 a = stage[(c0 / kMM) * kLd + c0 % kMM], b = stage[(c1 / kMM) * kLd + c1 % kMM];
      dst4[e] = make_float4(a.x, a.y, b.x, b.y);
    }
    if ((n2 & 1) && tid == 0) dst[n2 - 1] = stage[((n2 - 1) / kMM) * kLd + (n2 - 1) % kMM];
  } else {
    for (int e = tid; e < n2; e += kSystems) dst[e] = stage[(e / kMM) * kLd + e % kMM];
  }
}

template <int M>
void launch_system(const float2* R, float2* Rinv, int B, float tiny, cudaStream_t stream) {
  constexpr int kSystems = systems_per_block(M);
  gj_inverse_kernel<M><<<(B + kSystems - 1) / kSystems, kSystems, 0, stream>>>(R, Rinv, B, tiny);
}

// ---- 9 <= m <= 32: a group of m threads per system, one row each -------------------

__global__ void __launch_bounds__(128)
    gj_inverse_kernel_rows(const float2* __restrict__ R_in,  // (B, m, m)
                      float2* __restrict__ Rinv_out,    // (B, m, m)
                      int B, int m, float tiny) {
  extern __shared__ float2 aug[];  // groups x m x stride(m): [R | I], then [. | R^-1]
  const int mm = m * m, w = gj::stride(m);
  const int per_warp = kWarpSize / m;
  const int groups = (blockDim.x / kWarpSize) * per_warp;  // matrices per block

  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * groups;
  const int count = (int)min((long long)groups, (long long)B - first);
  const float2* R_blk = R_in + first * mm;

  for (int e = tid; e < count * mm; e += blockDim.x) {
    const int g = e / mm, rc = e - g * mm, r = rc / m, c = rc - r * m;
    float2* row = aug + g * m * w + r * w;
    row[c] = R_blk[e];
    row[m + c] = make_float2(r == c ? 1.f : 0.f, 0.f);
  }
  __syncthreads();

  const int warp = tid / kWarpSize, lane = tid - warp * kWarpSize;
  const int gw = lane / m, row = lane - gw * m;
  const int g = warp * per_warp + gw;
  const bool live = gw < per_warp && g < count;
  gj::invert(aug + (live ? g : 0) * m * w, m, row, live, tiny);
  __syncthreads();

  float2* Rinv_blk = Rinv_out + first * mm;
  for (int e = tid; e < count * mm; e += blockDim.x) {
    const int g2 = e / mm, rc = e - g2 * mm, r = rc / m, c = rc - r * m;
    Rinv_blk[e] = aug[g2 * m * w + r * w + m + c];
  }
}

int warps_per_block(int m) { return m > 16 ? 2 : 4; }

// Shared memory one block takes for systems of size m: its groups' padded
// [R | I], m (2m + 1) complex64 each; at most 33.8 KB (m = 16, 32), under
// the 48 KB that needs no opt-in.
int smem_bytes(int m) {
  const int groups = warps_per_block(m) * (kWarpSize / m);
  return groups * m * gj::stride(m) * (int)sizeof(float2);
}

}  // namespace

extern "C" {

// R, Rinv: complex64 (B, m, m), contiguous on `device`, Rinv aliasing no
// input. 1 <= m <= 32. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
int gj_inverse_launch(const void* R, void* Rinv, int B, int m, float tiny, int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (B < 1 || m < 1 || m > gj::kMaxM) return (int)cudaErrorInvalidValue;
  const float2* r = (const float2*)R;
  float2* out = (float2*)Rinv;
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 1: launch_system<1>(r, out, B, tiny, s); break;
    case 2: launch_system<2>(r, out, B, tiny, s); break;
    case 3: launch_system<3>(r, out, B, tiny, s); break;
    case 4: launch_system<4>(r, out, B, tiny, s); break;
    case 5: launch_system<5>(r, out, B, tiny, s); break;
    case 6: launch_system<6>(r, out, B, tiny, s); break;
    case 7: launch_system<7>(r, out, B, tiny, s); break;
    case 8: launch_system<8>(r, out, B, tiny, s); break;
    default: {
      const int warps = warps_per_block(m);
      const int groups = warps * (kWarpSize / m);
      const int blocks = (B + groups - 1) / groups;
      gj_inverse_kernel_rows<<<blocks, warps * kWarpSize, smem_bytes(m), s>>>(r, out, B, m, tiny);
    }
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

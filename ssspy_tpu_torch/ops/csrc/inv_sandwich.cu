// Batched inverse and sandwich of small Hermitian systems: for each of B
// pairs (R, C) of complex m x m matrices, R^-1 and S = R^-1 C R^-1.
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:planar_inv_sandwich_sc (the
// Pallas kernel _pinv_sandwich_kernel, :334-414), which the unfused
// dense-GaussMNMF step runs on its (bins x frames) batch of model
// covariances R and instant covariances C (ssspy_tpu/ops/splitc.py:3034,
// :3085). Same function as its "gj" branch (:369-375): the pivot-free
// Gauss-Jordan inverse with the 1e-20 pivot floor, then (R^-1 C) R^-1.
//
// Bound on the H100: R and C are read once and R^-1 and S written once,
// 4 B m^2 8 bytes: 329 MB at (B, m) = (160,882, 8), 0.098 ms at 3.35 TB/s.
// The elimination updates all 2m entries of the m rows at each of m steps
// (16 m^3 flops) and the two products cost 8 m^3 each: 32 m^3 B flops,
// 2.64 GFLOP, 0.039 ms at 67 TFLOP/s in f32. So bytes bound it.
//
// Design: the TPU kernel puts the batch in the 128 lanes, pads it to 1024
// with identity systems and eliminates on the real 2m x 3m embedding,
// because Mosaic has no complex type. None of that carries over: here the
// matrices are native interleaved complex (float2), the batch is not padded,
// and the elimination is the complex m x m one of gj_inverse.cuh. A group of
// m threads owns one matrix, one row each, and floor(32 / m) groups share a
// warp; a block of four warps (two above m = 8) holds its groups' [R | I]
// and C in shared memory. The block stages its matrices with coalesced loads
// (they are contiguous in memory), each group inverts its system with one
// __syncwarp() per step, then each thread forms its row of R^-1 C and of S
// in registers, and the block writes R^-1 and S back with coalesced stores.
// Keeping whole systems in registers per thread would spill at m = 8.

#include <cuda_runtime.h>

#include "gj_inverse.cuh"

namespace {

// largest system: each thread keeps its row of the products in registers
constexpr int kMaxM = 16;

constexpr int kWarpSize = 32;

__global__ void __launch_bounds__(128)
    inv_sandwich_kernel(const float2* __restrict__ R_in,   // (B, m, m)
                        const float2* __restrict__ C_in,   // (B, m, m)
                        float2* __restrict__ Rinv_out,     // (B, m, m)
                        float2* __restrict__ S_out,        // (B, m, m)
                        int B, int m, float tiny) {
  extern __shared__ float2 smem[];
  const int mm = m * m, w = gj::stride(m);
  const int per_warp = kWarpSize / m;
  const int groups = (blockDim.x / kWarpSize) * per_warp;  // matrices per block
  float2* aug = smem;                    // groups x m x w: [R | I], then [. | R^-1]
  float2* cs = aug + groups * m * w;     // groups x m x m: C, then S

  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * groups;
  const int count = (int)min((long long)groups, (long long)B - first);
  const float2* R_blk = R_in + first * mm;
  const float2* C_blk = C_in + first * mm;

  for (int e = tid; e < count * mm; e += blockDim.x) {
    const int g = e / mm, rc = e - g * mm, r = rc / m, c = rc - r * m;
    float2* row = aug + g * m * w + r * w;
    row[c] = R_blk[e];
    row[m + c] = make_float2(r == c ? 1.f : 0.f, 0.f);
    cs[e] = C_blk[e];
  }
  __syncthreads();

  const int warp = tid / kWarpSize, lane = tid - warp * kWarpSize;
  const int gw = lane / m, row = lane - gw * m;
  const int g = warp * per_warp + gw;
  const bool live = gw < per_warp && g < count;
  float2* sys = aug + (live ? g : 0) * m * w;
  float2* cg = cs + (live ? g : 0) * mm;

  gj::invert(sys, m, row, live, tiny);

  float2 s[kMaxM];
  if (live) {
    const float2* rinv_row = sys + row * w + m;
    float2 m1[kMaxM];
#pragma unroll
    for (int j = 0; j < kMaxM; ++j) {
      if (j < m) {
        float2 acc = make_float2(0.f, 0.f);
        for (int k = 0; k < m; ++k) acc = gj::cmadd(acc, rinv_row[k], cg[k * m + j]);
        m1[j] = acc;
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxM; ++j) {
      if (j < m) {
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kMaxM; ++k)
          if (k < m) acc = gj::cmadd(acc, m1[k], sys[k * w + m + j]);
        s[j] = acc;
      }
    }
  }
  __syncwarp();  // every row of R^-1 C is formed before C is overwritten by S
  if (live) {
#pragma unroll
    for (int j = 0; j < kMaxM; ++j)
      if (j < m) cg[row * m + j] = s[j];
  }
  __syncthreads();

  float2* Rinv_blk = Rinv_out + first * mm;
  float2* S_blk = S_out + first * mm;
  for (int e = tid; e < count * mm; e += blockDim.x) {
    const int g2 = e / mm, rc = e - g2 * mm, r = rc / m, c = rc - r * m;
    Rinv_blk[e] = aug[g2 * m * w + r * w + m + c];
    S_blk[e] = cs[e];
  }
}

int warps_per_block(int m) { return m > 8 ? 2 : 4; }

// Shared memory one block takes for systems of size m: its groups' padded
// [R | I] and C, m (3m + 1) complex64 each.
int smem_bytes(int m) {
  const int groups = warps_per_block(m) * (kWarpSize / m);
  return groups * m * (gj::stride(m) + m) * (int)sizeof(float2);
}

}  // namespace

extern "C" {

// R, C, Rinv, S: complex64 (B, m, m), contiguous on `device`, the outputs
// aliasing no input. 1 <= m <= 16. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
int inv_sandwich_launch(const void* R, const void* C, void* Rinv, void* S, int B, int m, float tiny,
                        int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (B < 1 || m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const int warps = warps_per_block(m);
  const int groups = warps * (kWarpSize / m);
  const int blocks = (B + groups - 1) / groups;
  // at most 25.6 KB (m = 16), under the 48 KB that needs no opt-in
  inv_sandwich_kernel<<<blocks, warps * kWarpSize, smem_bytes(m), (cudaStream_t)stream>>>(
      (const float2*)R, (const float2*)C, (float2*)Rinv, (float2*)S, B, m, tiny);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

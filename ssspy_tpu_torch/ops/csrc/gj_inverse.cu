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
// Design: the TPU kernel puts the batch in the 128 lanes, pads it to 1024
// with identity systems and eliminates on the real 2m x 3m embedding,
// because Mosaic has no complex type. Here the matrices are native
// interleaved complex (float2), the batch is not padded, and the elimination
// is the complex m x m one of gj_inverse.cuh. A group of m threads owns one
// matrix, one row each, and floor(32 / m) groups share a warp (eight at
// m = 4, six at m = 5); a block of four warps (two above m = 16) stages its
// groups' [R | I] in shared memory with coalesced loads (the systems are
// contiguous in memory), each group inverts its system with one __syncwarp()
// per step, and the block writes R^-1 back with coalesced stores. At m = 4 a
// block holds 32 systems in 9.2 KB: many blocks per SM hide the latency of
// the elimination's chain of m dependent steps.

#include <cuda_runtime.h>

#include "gj_inverse.cuh"

namespace {

constexpr int kWarpSize = 32;

__global__ void __launch_bounds__(128)
    gj_inverse_kernel(const float2* __restrict__ R_in,  // (B, m, m)
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
  const int warps = warps_per_block(m);
  const int groups = warps * (kWarpSize / m);
  const int blocks = (B + groups - 1) / groups;
  gj_inverse_kernel<<<blocks, warps * kWarpSize, smem_bytes(m), (cudaStream_t)stream>>>(
      (const float2*)R, (float2*)Rinv, B, m, tiny);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

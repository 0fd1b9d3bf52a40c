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
// (16 m^3 flops; the live ones are half of them) and the two products cost
// 8 m^3 each: 32 m^3 B flops, 2.64 GFLOP, 0.039 ms at 67 TFLOP/s in f32. So
// bytes bound it.
//
// Design. The TPU kernel puts the batch in the 128 lanes, pads it to 1024
// with identity systems and eliminates on the real 2m x 3m embedding,
// because Mosaic has no complex type. None of that carries over: here the
// matrices are native interleaved complex (float2), the batch is not padded,
// and the elimination is the complex m x m one of gj_inverse.cuh, step by
// step and rounded as it rounds, in one of two variants chosen by m
// (ops/kernels.py:inv_sandwich_variant), both a group of lanes per system:
// - "columns" (1 <= m <= kColumnsMaxM = 8, the path's m = 8): a template on
//   m, every loop unrolled. A group of P lanes (m rounded up to a power of
//   two; 32 / P systems a warp) owns a system, lane c holding in registers
//   column c of the live part of [R | I] (column c of R until step c, then
//   column c of the right half, which joins at that step: m complex, the
//   live entries only) and column c of C. At step k the group receives
//   column k (the pivot and the factors) by __shfl_sync from lane k, every
//   lane forms the divisor of the floored pivot once (gj::Divisor), divides
//   the one pivot-row entry of its own column and updates its column; the
//   quotient never leaves the lane. The pivot row is so divided across the
//   group, one division a lane a step, where the first design had the
//   pivot row's owner divide all 2m entries while m - 1 lanes waited. Then
//   lane j forms column j of M1 = R^-1 C and of S = M1 R^-1, the other
//   columns of R^-1 and of M1 coming by shuffle, every sum in k order with
//   gj::cmadd, the order in which torch.matmul's complex product rounds (at
//   m = 1 it rounds its one product as c10's operator*, gj::cmul): no
//   shared-memory read with a bank conflict, and the results bit-identical
//   to inv_sandwich_plain. Each warp walks tiles of 32 / P consecutive
//   systems (a grid of about one wave, persistent): the next tile's R and C
//   come into a second stage of shared memory by cp.async (16 bytes at a
//   time at even m) while this tile is eliminated, each system staged at a
//   stride that puts a warp's column reads on the fewest bank wavefronts,
//   and each lane writes its columns of R^-1 and S straight from registers
//   (a group writes 8 m contiguous bytes a row: whole 32-byte sectors).
//   No block barrier: the warps of a block share nothing.
// - "rows" (9 <= m <= 16): the first design, kept for these sizes. A group
//   of m threads owns one matrix, one row each, and floor(32 / m) groups
//   share a warp; a block of two warps holds its groups' [R | I] and C in
//   shared memory, each group inverts its system with
//   gj::invert (one __syncwarp() per step), each thread forms its row of
//   R^-1 C and of S in registers, and the block writes R^-1 and S back with
//   coalesced stores.
//   At m = 8 it took 0.423 ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md).

#include <cuda_runtime.h>

#include "gj_inverse.cuh"

namespace {

// largest system: each thread keeps its row of the products in registers
constexpr int kMaxM = 16;
constexpr int kWarpSize = 32;
constexpr int kColumnsMaxM = 8;  // the columns variant's largest m; above it the rows variant
constexpr int kColumnsWarps = 4;  // warps a block of the columns variant
constexpr int kStages = 2;  // tiles of a warp in shared memory: one eliminated, one arriving
constexpr int kRowsWarps = 2;  // warps a block of the rows variant
constexpr unsigned kFull = 0xffffffffu;

// ---- 1 <= m <= 8: a group of lanes per system, columns in registers ------------------

// lanes of a system's group: m rounded up to a power of two, so that
// __shfl_sync can take the group as its width
__host__ __device__ constexpr int group_width(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

// complex64 stride of a staged system: the least >= M^2 that is M modulo 16.
// A column read of the warp's 32 / P systems then spreads their rows over
// the banks (at M = 8: two wavefronts, the least for 32 8-byte reads).
__host__ __device__ constexpr int stage_stride(int M) { return M * M + ((M - M * M) % 16 + 16) % 16; }

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

__device__ __forceinline__ float2 shfl(float2 v, int src, int width) {
  return make_float2(__shfl_sync(kFull, v.x, src, width), __shfl_sync(kFull, v.y, src, width));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y)); }

// Copy the `count` consecutive systems of a tile (M^2 complex64 each) from
// `src` into shared memory at stride LD: in pairs (16 bytes) when `vec`.
template <int M, int LD>
__device__ __forceinline__ void stage_tile(float2* dst, const float2* src, int count, int lane, bool vec) {
  constexpr int MM = M * M;
  const int n2 = count * MM;
  if (vec) {
    for (int e = 2 * lane; e < n2; e += 2 * kWarpSize) cp_async16(dst + (e / MM) * LD + e % MM, src + e);
  } else {
    for (int e = lane; e < n2; e += kWarpSize) cp_async8(dst + (e / MM) * LD + e % MM, src + e);
  }
}

template <int M>
__global__ void __launch_bounds__(kColumnsWarps * kWarpSize)
    inv_sandwich_kernel_columns(const float2* __restrict__ R_in,  // (B, M, M)
                                const float2* __restrict__ C_in,  // (B, M, M)
                                float2* __restrict__ Rinv_out,    // (B, M, M)
                                float2* __restrict__ S_out,       // (B, M, M)
                                int B, float tiny, bool vec) {
  constexpr int P = group_width(M), G = kWarpSize / P;  // lanes a system, systems a tile
  constexpr int MM = M * M, LD = stage_stride(M), kTile = G * LD;
  // per warp and stage: the tile's R, then its C
  __shared__ __align__(16) float2 stage[kColumnsWarps][kStages][2 * kTile];

  const int warp = threadIdx.x / kWarpSize, lane = threadIdx.x % kWarpSize;
  const int g = lane / P, c = lane - g * P;
  const int cc = c < M ? c : M - 1;  // lanes c >= M read a column of their system and write nothing
  const int tiles = (int)(((long long)B + G - 1) / G);
  const int step = gridDim.x * kColumnsWarps;
  int t = blockIdx.x * kColumnsWarps + warp;

  if (t < tiles) {
    const int count = (int)min((long long)G, (long long)B - (long long)t * G);
    stage_tile<M, LD>(stage[warp][0], R_in + (long long)t * G * MM, count, lane, vec);
    stage_tile<M, LD>(stage[warp][0] + kTile, C_in + (long long)t * G * MM, count, lane, vec);
  }
  cp_async_commit();

#pragma unroll 1
  for (int i = 0; t < tiles; ++i, t += step) {
    const int next = t + step;
    if (next < tiles) {
      const int count = (int)min((long long)G, (long long)B - (long long)next * G);
      float2* dst = stage[warp][(i + 1) % kStages];
      stage_tile<M, LD>(dst, R_in + (long long)next * G * MM, count, lane, vec);
      stage_tile<M, LD>(dst + kTile, C_in + (long long)next * G * MM, count, lane, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncwarp();

    const int count = (int)min((long long)G, (long long)B - (long long)t * G);
    const int gb = g < count ? g : 0;  // groups past the tile's last system repeat its first
    const float2* Rs = stage[warp][i % kStages] + gb * LD;
    const float2* Cs = Rs + kTile;
    float2 col[M], ccol[M];  // column cc of the live [R | I], and of C
#pragma unroll
    for (int r = 0; r < M; ++r) {
      col[r] = Rs[r * M + cc];
      ccol[r] = Cs[r * M + cc];
    }
    __syncwarp();  // every read of this stage precedes the copy that refills it

    // Gauss-Jordan, step k: column k comes from lane k; lane k then takes up
    // column k of the right half (e_k); each lane divides its pivot-row entry
    // and updates the other rows of its column, as gj::invert rounds them
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float2 f[M];
#pragma unroll
      for (int r = 0; r < M; ++r) f[r] = shfl(col[r], k, P);
      const gj::Divisor div(gj::floored_pivot(f[k], tiny));
      const bool own = c == k;
#pragma unroll
      for (int r = 0; r < M; ++r)
        if (own) col[r] = make_float2(r == k ? 1.f : 0.f, 0.f);
      const float2 q = div(col[k]);
#pragma unroll
      for (int r = 0; r < M; ++r)
        if (r != k) col[r] = csub(col[r], gj::cmul(f[r], q));
      col[k] = q;
    }

    // M1 = R^-1 C and S = M1 R^-1, column c each: M1[r,c] = sum_k R^-1[r,k] C[k,c]
    // and S[r,c] = sum_k M1[r,k] R^-1[k,c], k ascending (at m = 1, torch.matmul
    // rounds the one product as c10's operator* does: gj::cmul)
    float2 m1[M], s[M];
    if constexpr (M == 1) {
      m1[0] = gj::cmul(col[0], ccol[0]);
      s[0] = gj::cmul(m1[0], col[0]);
    } else {
#pragma unroll
      for (int r = 0; r < M; ++r) m1[r] = s[r] = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < M; ++k) {
#pragma unroll
        for (int r = 0; r < M; ++r) m1[r] = gj::cmadd(m1[r], shfl(col[r], k, P), ccol[k]);
      }
#pragma unroll
      for (int k = 0; k < M; ++k) {
#pragma unroll
        for (int r = 0; r < M; ++r) s[r] = gj::cmadd(s[r], shfl(m1[r], k, P), col[k]);
      }
    }

    if (g < count && c < M) {
      const long long at = ((long long)t * G + g) * MM + c;
#pragma unroll
      for (int r = 0; r < M; ++r) {
        Rinv_out[at + r * M] = col[r];
        S_out[at + r * M] = s[r];
      }
    }
  }
  cp_async_wait<0>();
}

template <int M>
int launch_columns(const float2* R, const float2* C, float2* Rinv, float2* S, int B, float tiny, int device,
                   cudaStream_t stream) {
  constexpr int G = kWarpSize / group_width(M);
  static int resident[64];  // blocks an SM can hold, by device (0: not yet asked)
  int sms = 0;
  cudaError_t status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (status != cudaSuccess) return (int)status;
  int& per_sm = resident[device & 63];
  if (per_sm == 0) {
    status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inv_sandwich_kernel_columns<M>,
                                                           kColumnsWarps * kWarpSize, 0);
    if (status != cudaSuccess) return (int)status;
  }
  const long long tiles = ((long long)B + G - 1) / G;
  const long long needed = (tiles + kColumnsWarps - 1) / kColumnsWarps;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(needed < wave ? needed : wave);
  // 16-byte copies: even m and 16-byte aligned tensors keep every tile's
  // start aligned (a tile is G m^2 complex64, an even count)
  const bool vec = M % 2 == 0 && ((reinterpret_cast<unsigned long long>(R) |
                                   reinterpret_cast<unsigned long long>(C)) & 15) == 0;
  inv_sandwich_kernel_columns<M><<<blocks, kColumnsWarps * kWarpSize, 0, stream>>>(R, C, Rinv, S, B, tiny, vec);
  return (int)cudaGetLastError();
}

// ---- 9 <= m <= 16: a group of m threads per system, rows in shared memory ------------

__global__ void __launch_bounds__(kRowsWarps * kWarpSize)
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

// Shared memory one block of the rows variant takes for systems of size m:
// its groups' padded [R | I] and C, m (3m + 1) complex64 each; at most
// 12.8 KB (m = 16).
int rows_smem_bytes(int m) {
  const int groups = kRowsWarps * (kWarpSize / m);
  return groups * m * (gj::stride(m) + m) * (int)sizeof(float2);
}

}  // namespace

extern "C" {

// R, C, Rinv, S: complex64 (B, m, m), contiguous on `device`, the outputs
// aliasing no input. `variant`: 1 the columns variant (1 <= m <= 8), 0 the
// rows variant (9 <= m <= 16); ops/kernels.py:inv_sandwich_variant chooses
// it. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int inv_sandwich_launch(const void* R, const void* C, void* Rinv, void* S, int B, int m, float tiny, int variant,
                        int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (B < 1 || m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const float2* r = (const float2*)R;
  const float2* c = (const float2*)C;
  float2* ri = (float2*)Rinv;
  float2* s = (float2*)S;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    static_assert(kColumnsMaxM == 8, "the cases below launch the columns variant up to kColumnsMaxM");
    switch (m) {
      case 1: return launch_columns<1>(r, c, ri, s, B, tiny, device, st);
      case 2: return launch_columns<2>(r, c, ri, s, B, tiny, device, st);
      case 3: return launch_columns<3>(r, c, ri, s, B, tiny, device, st);
      case 4: return launch_columns<4>(r, c, ri, s, B, tiny, device, st);
      case 5: return launch_columns<5>(r, c, ri, s, B, tiny, device, st);
      case 6: return launch_columns<6>(r, c, ri, s, B, tiny, device, st);
      case 7: return launch_columns<7>(r, c, ri, s, B, tiny, device, st);
      case 8: return launch_columns<8>(r, c, ri, s, B, tiny, device, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (variant != 0 || m <= kColumnsMaxM) return (int)cudaErrorInvalidValue;
  const int groups = kRowsWarps * (kWarpSize / m);
  const int blocks = (B + groups - 1) / groups;
  inv_sandwich_kernel<<<blocks, kRowsWarps * kWarpSize, rows_smem_bytes(m), st>>>(r, c, ri, s, B, m, tiny);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

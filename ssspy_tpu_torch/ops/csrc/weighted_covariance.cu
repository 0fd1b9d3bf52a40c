// Weighted covariance U[i,n] = (1/T) sum_t phi[n,(i),t] x_it x_it^H.
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:weighted_covariance_sc (the
// Pallas kernel _wcov_kernel), which reads each bin block of X into VMEM
// once and issues every source's contraction from that one read.
//
// Bound on the H100: at the main-path shape (M = N = 8 channels/sources,
// I = 257 bins, T = 626 frames) one call reads 10.3 MB of X, writes 1 MB of
// U and does about 0.22 GFLOP: ~3.4 us of HBM traffic at 3.35 TB/s, ~3.3 us
// of FP32 at 67 TFLOP/s. So bytes bound it, but barely: the kernel has to
// keep both the memory and the FMA pipes busy.
//
// What held the first design back (one block of N M(M+1)/2 threads per
// bin, 0.0445 ms on an NVIDIA H100 80GB HBM3 at 700 W): 257 blocks, two to an SM; each thread one dependent FMA
// chain over all frames, with three shared-memory loads for two FMAs; the
// pair product x_p conj(x_q) formed again for every source; loads and
// compute never overlapping. Here:
// - a work item is a 2 x 2 tile of channel pairs, p in {2a, 2a + 1} and
//   q in {2b, 2b + 1} (a <= b; an odd M is padded by one channel), and a
//   group of up to kSources sources. Each pair product x_p conj(x_q) is
//   formed once a frame and weighted into the group's 64 accumulators in
//   registers (the same rounding as before: fmaf(w, fmaf(a.x, b.x,
//   a.y * b.y), acc)). A frame costs four 16-byte shared-memory loads (two
//   channels a side, the group's weights) for 80 FP32 operations;
// - one warp per item, its 32 lanes on frames f, f + 32, ...; the lanes'
//   sums meet by a reduce-scatter of shuffles (62 a lane, a fixed order),
//   after which lane k holds entry k of the item and writes it, scaled by
//   1/T, to both triangles. No shared-memory sums, no atomics, no second
//   launch: two launches give the same bits;
// - one block per bin, a warp per item (10 at the paths' M = N = 8, two
//   blocks an SM), so that X and phi are read from device memory once and
//   U written once. Past kMaxWarps items (only at sizes the paths do not
//   launch) the warps take the items in passes over the bin's frames, and
//   read them again, from L2 where they are still there;
// - X and phi reach shared memory by cp.async in tiles of kTileFrames
//   frames, kStages - 1 tiles ahead of the one being summed; each staged
//   frame is padded to an odd count of 16-byte words, so that the eight
//   lanes of a quarter-warp, on eight frames, load from distinct banks;
// - the kernel is a template: an instance for M = N = 8 (registers capped
//   for two blocks an SM) and a generic one for every other (M, N) that
//   the size contract takes.
// A first redesign split each bin's frames over a cluster of up to eight
// blocks, with the frame lanes' sums added in shared memory and the
// chunks' through distributed shared memory; its epilogue, not its
// arithmetic, set its time (PERF.md).
// All arithmetic is full f32 on the CUDA cores: no TF32, no bf16.
// Measured (scripts/torch_kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W):
// 0.0185 ms at the main path with either weight shape, from 0.0445 ms
// (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kSources = 8;        // sources per work item
constexpr int kPairs = 4;          // channel pairs per work item: {2a, 2a+1} x {2b, 2b+1}
constexpr int kSums = 2 * kPairs * kSources;  // a lane's accumulators: entry k at 2k (re), 2k + 1 (im)
constexpr int kWarpSize = 32;      // lanes of an item; the reduce-scatter leaves entry k on lane k
constexpr int kTileFrames = 128;   // frames of X and phi per cp.async buffer
constexpr int kStages = 3;         // buffers: kStages - 1 tiles in flight while one is summed
constexpr int kMaxWarps = 16;      // items of a block at once
constexpr int kMainWarps = 10;     // the items at M = N = 8
constexpr int kSmemMax = 232448;   // dynamic shared memory of one block on sm_90
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSums == 2 * kWarpSize, "the reduce-scatter leaves one entry (re, im) per lane");

struct Geometry {
  int half, tiles, groups, items, warps, passes, x_row, w_row, smem;
};

// ops/kernels.py:weighted_covariance_geometry computes the same numbers
__host__ __device__ inline Geometry geometry(int M, int N) {
  Geometry g;
  g.half = (M + 1) / 2;  // channel pairs; an odd M is padded by one channel
  g.tiles = g.half * (g.half + 1) / 2;
  g.groups = (N + kSources - 1) / kSources;
  g.items = g.tiles * g.groups;
  g.warps = g.items < kMaxWarps ? g.items : kMaxWarps;
  g.passes = (g.items + g.warps - 1) / g.warps;
  // a staged frame: 2 (half | 1) complex64 (an odd count of 16-byte words)
  // and groups x kSources + 4 float32 (likewise)
  g.x_row = 2 * (g.half | 1);
  g.w_row = g.groups * kSources + 4;
  g.smem = kStages * kTileFrames * (g.x_row * 8 + g.w_row * 4);
  return g;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// index -> (a, b), a <= b, row by row of the upper triangle of n x n
__device__ __forceinline__ void decode_pair(int index, int n, int& a, int& b) {
  int r = index;
  a = 0;
  while (r >= n - a) {
    r -= n - a;
    ++a;
  }
  b = a + r;
}

// One level of the reduce-scatter over a warp: of its first 2 H sums a lane
// keeps the half that its lane bit `bit` selects, adds the partner lane's
// same half, and leaves the result in its first H (a template, so that
// every index is fixed and the sums stay in registers)
template <int H>
__device__ __forceinline__ void reduce_level(float* v, int lane, int bit) {
  const bool upper = (lane & bit) != 0;
#pragma unroll
  for (int c = 0; c < H; ++c) {
    const float lo = v[c], hi = v[H + c];
    const float sent = __shfl_xor_sync(kFull, upper ? lo : hi, bit);
    v[c] = __fadd_rn(upper ? hi : lo, sent);
  }
}

// MT, NT: M and N at compile time (8, 8), or 0 for any (M, N) at run time
template <int MT, int NT>
__global__ void __launch_bounds__((MT ? kMainWarps : kMaxWarps) * kWarpSize, MT ? 2 : 1)
    weighted_covariance_kernel(const float2* __restrict__ X,   // (M, I, T)
                               const float* __restrict__ phi,  // (N, T) or (N, I, T)
                               float2* __restrict__ U,         // (I, N, M, M)
                               int M_run, int N_run, int I, int T, long long phi_src_stride,
                               long long phi_bin_stride) {
  const int M = MT ? MT : M_run, N = NT ? NT : N_run;
  const Geometry geo = geometry(M, N);
  const int G = geo.groups, x_row = geo.x_row, w_row = geo.w_row;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                                         // kStages x kTileFrames x w_row
  float2* xs = reinterpret_cast<float2*>(ws + kStages * kTileFrames * w_row);  // kStages x kTileFrames x x_row

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / kWarpSize, lane = tid - warp * kWarpSize;
  const int i = blockIdx.x;
  const int n_tiles = (T + kTileFrames - 1) / kTileFrames;
  const int n_steps = geo.passes * n_tiles;  // (pass, tile) in order
  const long long channel_stride = (long long)I * T;
  const float2* x_bin = X + (long long)i * T;
  const float* w_bin = phi + (long long)i * phi_bin_stride;

  // the loads of step g (tile g mod n_tiles) into buffer g % kStages,
  // asynchronous, frame-major in shared memory; one commit group per call,
  // empty past the last step, so that step g has landed once at most
  // kStages - 1 groups are pending
  auto issue = [&](int g) {
    const int k = g % n_tiles, t0 = k * kTileFrames;
    const int cnt = g < n_steps ? min(kTileFrames, T - t0) : 0;
    float2* xt = xs + (g % kStages) * kTileFrames * x_row;
    float* wt = ws + (g % kStages) * kTileFrames * w_row;
    // channel (source) fastest: at M = 8 a warp's reads take 4 frames, one
    // 32-byte sector, of 8 channels
    for (int e = tid; e < M * cnt; e += nthreads) {
      const int tt = e / M, m = e - tt * M;
      cp_async8(xt + tt * x_row + m, x_bin + m * channel_stride + t0 + tt);
    }
    for (int e = tid; e < N * cnt; e += nthreads) {
      const int tt = e / N, n = e - tt * N;
      cp_async4(wt + tt * w_row + n, w_bin + n * phi_src_stride + t0 + tt);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) issue(g);

  float v[kSums];
#pragma unroll
  for (int c = 0; c < kSums; ++c) v[c] = 0.f;
  int item = warp, ta = 0, tb = 0, wg = 0;
  if (item < geo.items) {
    decode_pair(item / G, geo.half, ta, tb);
    wg = (item % G) * kSources;
  }
  const float inv_frames = 1.f / (float)T;

  for (int g = 0; g < n_steps; ++g) {
    issue(g + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();  // step g staged for every thread
    const int k = g % n_tiles;
    const int cnt = min(kTileFrames, T - k * kTileFrames);
    const float2* xt = xs + (g % kStages) * kTileFrames * x_row;
    const float* w = ws + (g % kStages) * kTileFrames * w_row + wg;
    if (item < geo.items) {  // the same for the whole warp
#pragma unroll 1
      for (int tt = lane; tt < cnt; tt += kWarpSize) {
        // two channels of each side in one 16-byte load, the group's weights in two
        const float4 xa = *reinterpret_cast<const float4*>(xt + tt * x_row + 2 * ta);
        const float4 xb = *reinterpret_cast<const float4*>(xt + tt * x_row + 2 * tb);
        const float4 w0 = *reinterpret_cast<const float4*>(w + tt * w_row);
        const float4 w1 = *reinterpret_cast<const float4*>(w + tt * w_row + 4);
        const float wv[kSources] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float2 xp[2] = {make_float2(xa.x, xa.y), make_float2(xa.z, xa.w)};
        const float2 xq[2] = {make_float2(xb.x, xb.y), make_float2(xb.z, xb.w)};
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const float2 a = xp[j / 2], bq = xq[j % 2];
          // a conj(b), once for every source of the group
          const float pr = fmaf(a.x, bq.x, a.y * bq.y);
          const float pi = fmaf(a.y, bq.x, -a.x * bq.y);
#pragma unroll
          for (int c = 0; c < kSources; ++c) {
            v[2 * (j * kSources + c)] = fmaf(wv[c], pr, v[2 * (j * kSources + c)]);
            v[2 * (j * kSources + c) + 1] = fmaf(wv[c], pi, v[2 * (j * kSources + c) + 1]);
          }
        }
      }
      if (k == n_tiles - 1) {
        // the item's frames are summed: reduce-scatter over the lanes. At
        // each level a lane keeps the half of its values that its lane bit
        // selects and adds its partner's; lane k ends with sums 2k and 2k + 1
        reduce_level<32>(v, lane, 16);
        reduce_level<16>(v, lane, 8);
        reduce_level<8>(v, lane, 4);
        reduce_level<4>(v, lane, 2);
        reduce_level<2>(v, lane, 1);
        const int j = lane / kSources, n = wg + lane % kSources;
        const int p = 2 * ta + j / 2, q = 2 * tb + j % 2;
        if (n < N && q < M && p <= q) {  // not a padded channel or source, nor the mirror in a diagonal tile
          float2* u = U + ((long long)i * N + n) * M * M;
          const float re = v[0] * inv_frames, im = p == q ? 0.f : v[1] * inv_frames;
          u[p * M + q] = make_float2(re, im);
          u[q * M + p] = make_float2(re, -im);
        }
#pragma unroll
        for (int c = 0; c < kSums; ++c) v[c] = 0.f;
        item += geo.warps;  // the next pass
        if (item < geo.items) {
          decode_pair(item / G, geo.half, ta, tb);
          wg = (item % G) * kSources;
        }
      }
    }
    __syncthreads();  // buffer g % kStages is read before step g + kStages is issued into it
  }
  cp_async_wait<0>();  // no copy (the empty groups' included) outlives the kernel
}

template <int MT, int NT>
cudaError_t launch(const float2* X, const float* phi, float2* U, int M, int N, int I, int T,
                   long long phi_src_stride, long long phi_bin_stride, const Geometry& geo, cudaStream_t stream) {
  auto kernel = weighted_covariance_kernel<MT, NT>;
  if (geo.smem > 48 * 1024) {
    const cudaError_t status =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    if (status != cudaSuccess) return status;
  }
  kernel<<<I, geo.warps * kWarpSize, geo.smem, stream>>>(X, phi, U, M, N, I, T, phi_src_stride, phi_bin_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// X: complex64 (M, I, T); phi: float32 (N, T), or (N, I, T) when per_bin;
// U: complex64 (I, N, M, M). All contiguous on `device`. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError(). The
// Python wrapper checks the same limits before it calls.
int weighted_covariance_launch(const void* X, const void* phi, void* U, int M, int N, int I, int T,
                               int per_bin, int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (M < 1 || N < 1 || I < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(M, N);
  if (geo.smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const long long phi_src_stride = per_bin ? (long long)I * T : (long long)T;
  const long long phi_bin_stride = per_bin ? (long long)T : 0;
  const float2* x = (const float2*)X;
  const float* w = (const float*)phi;
  float2* u = (float2*)U;
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 8 && N == 8)
    status = launch<8, 8>(x, w, u, M, N, I, T, phi_src_stride, phi_bin_stride, geo, s);
  else
    status = launch<0, 0>(x, w, u, M, N, I, T, phi_src_stride, phi_bin_stride, geo, s);
  return (int)status;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

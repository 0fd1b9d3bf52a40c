// ISS1 source-steering sweep over all N sources, one bin per thread block.
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:iss1_sweep_pallas (the Pallas
// kernel _iss1_kernel), and the XLA form ssspy_tpu/ops/splitc.py:iss1_sweep_sc
// that the JAX package actually runs (its impl="auto" picks XLA).
//
// For each source n in order, with phi the weights of row m:
//   num[m]   = mean_t phi[m,t] y_m(t) conj(y_n(t))
//   denom[m] = max(mean_t phi[m,t] |y_n(t)|^2, eps)
//   v[m]     = num[m] / denom[m]  (m != n),   v[n] = 1 - 1 / sqrt(denom[n])
//   y_m(t)  -= v[m] y_n(t) for every row m, with the y_n(t) of before the
//              update (row n included); later sources see the updated Y.
//
// Bound on the H100: at the main-path shape (N = 8 sources, I = 257 bins,
// T = 626 frames) a call must read Y (10.30 MB) and write it (10.30 MB), plus
// the weights: 0.02 MB for IVA's (N, T), 5.15 MB for ILRMA's (N, I, T). At
// 3.35 TB/s that is 6.2 us (IVA) and 7.7 us (ILRMA). The arithmetic, about
// 18 flops per (source n, row m, bin, frame), is 0.19 GFLOP: 2.8 us at
// 67 TFLOP/s in f32. So bytes bound it.
//
// Design: in plain PyTorch each source costs about six launches that each
// read and write the whole Y, about 6N round trips of Y in all. Here one
// block per bin keeps the bin's Y (N x T complex, 40 KB at the main shape)
// and, for per-bin weights, its weights (20 KB) in dynamic shared memory for
// the whole sweep, so Y is read from device memory once and written once;
// the (N, T) weights are read from device memory, where every block finds
// them in L2. Every pass gives each thread the same frames (t = tid,
// tid + blockDim, ...), so no thread reads a value that another thread wrote,
// except through the block reduction. Pass 0 loads Y and accumulates the
// 3N sums of source 0 (Re num, Im num, denom, in f32 registers). Then, for
// each source n: warp shuffles and a table in shared memory reduce the sums;
// thread m forms v[m]; after a barrier every thread updates all N rows at its
// frames with the y_n(t) it read before the update, and, in the same pass,
// accumulates the sums of source n + 1 from the updated rows.
//
// A bin whose Y (and per-bin weights) do not fit in the 227 KB of shared
// memory a block may hold (T > ~2,400 at N = 8 with per-bin weights, T >
// ~3,600 with (N, T) weights) runs the streamed variant of the same code: the
// bin's Y lives in the output buffer in device memory, pass 0 copies it
// there, and each source costs one fused "update source n, accumulate for
// source n + 1" pass over it (mostly L2 hits). The wrapper picks the variant
// (ops/kernels.py:iss1_sweep_resident). Arithmetic is plain FP32.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSources = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
// shared-memory header: v (kMaxSources float2) and the reduction table
// (kMaxWarps x 3 kMaxSources floats); Y and the staged weights follow it
constexpr int kVBytes = kMaxSources * 8;
constexpr int kHeaderBytes = kVBytes + kMaxWarps * 3 * kMaxSources * 4;
constexpr long long kSmemLimit = 232448;  // 227 KB, the most one block may use on sm_90

template <int kN>
__device__ __forceinline__ float2 pick(const float2 (&y)[kN], int k) {
  float2 r = make_float2(0.f, 0.f);
#pragma unroll
  for (int m = 0; m < kN; ++m)
    if (m == k) r = y[m];
  return r;
}

// acc[3m..3m+2] += phi_m * (Re y_m conj(y_s), Im y_m conj(y_s), |y_s|^2)
template <int kN>
__device__ __forceinline__ void accumulate(float (&acc)[3 * kN], const float2 (&y)[kN], float2 ys,
                                           const float* w, long long w_stride, int t, int N) {
  const float ys2 = fmaf(ys.x, ys.x, ys.y * ys.y);
#pragma unroll
  for (int m = 0; m < kN; ++m) {
    if (m < N) {
      const float wm = w[m * w_stride + t];
      acc[3 * m] = fmaf(wm, fmaf(y[m].x, ys.x, y[m].y * ys.y), acc[3 * m]);
      acc[3 * m + 1] = fmaf(wm, fmaf(y[m].y, ys.x, -y[m].x * ys.y), acc[3 * m + 1]);
      acc[3 * m + 2] = fmaf(wm, ys2, acc[3 * m + 2]);
    }
  }
}

// Block-reduce the 3N sums of source n and write v into shared memory.
template <int kN>
__device__ __forceinline__ void solve_v(const float (&acc)[3 * kN], int n, int N, int T, float eps,
                                        float* red, float2* v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < 3 * kN; ++k) {
    float s = acc[k];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) s += __shfl_xor_sync(0xffffffffu, s, offset);
    if (lane == 0 && k < 3 * N) red[warp * 3 * kN + k] = s;
  }
  __syncthreads();
  const int m = threadIdx.x;
  if (m < N) {
    float num_re = 0.f, num_im = 0.f, den = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      num_re += red[w * 3 * kN + 3 * m];
      num_im += red[w * 3 * kN + 3 * m + 1];
      den += red[w * 3 * kN + 3 * m + 2];
    }
    const float inv_frames = 1.f / (float)T;
    float denom = den * inv_frames;
    denom = denom < eps ? eps : denom;  // a NaN stays NaN, as with max()
    v[m] = m == n ? make_float2(1.f - 1.f / sqrtf(denom), 0.f)
                  : make_float2(num_re * inv_frames / denom, num_im * inv_frames / denom);
  }
  __syncthreads();
}

template <int kN>
__global__ void __launch_bounds__(kMaxThreads)
    iss1_sweep_kernel(const float2* __restrict__ Y_in,  // (N, I, T)
                      const float* __restrict__ phi,    // (N, T) or (N, I, T)
                      float2* __restrict__ Y_out,       // (N, I, T)
                      int N, int I, int T, long long phi_src_stride, long long phi_bin_stride,
                      int resident, int stage_phi, float eps) {
  extern __shared__ float4 smem_raw[];  // 16-byte aligned
  char* smem = reinterpret_cast<char*>(smem_raw);
  float2* v = reinterpret_cast<float2*>(smem);
  float* red = reinterpret_cast<float*>(smem + kVBytes);

  const int i = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long src_stride = (long long)I * T;  // Y[m, i, t] = Y[m * I * T + i * T + t]
  const float2* y_in = Y_in + (long long)i * T;
  const float* phi_bin = phi + (long long)i * phi_bin_stride;

  // the bin's working copy of Y: shared memory, or the output itself
  float2* work;
  long long work_stride;
  if (resident) {
    work = reinterpret_cast<float2*>(smem + kHeaderBytes);
    work_stride = T;
  } else {
    work = Y_out + (long long)i * T;
    work_stride = src_stride;
  }
  const float* w = phi_bin;
  long long w_stride = phi_src_stride;
  float* staged = nullptr;
  if (stage_phi) {
    staged = reinterpret_cast<float*>(smem + kHeaderBytes + (long long)N * T * 8);
    w = staged;
    w_stride = T;
  }

  float acc[3 * kN];
  float2 y[kN];

  // pass 0: load Y (and the per-bin weights), accumulate the sums of source 0
#pragma unroll
  for (int k = 0; k < 3 * kN; ++k) acc[k] = 0.f;
  for (int t = tid; t < T; t += nt) {
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      if (m < N) {
        y[m] = y_in[m * src_stride + t];
        work[m * work_stride + t] = y[m];
        if (stage_phi) staged[m * T + t] = phi_bin[m * phi_src_stride + t];
      }
    }
    accumulate<kN>(acc, y, y[0], w, w_stride, t, N);
  }

  for (int n = 0; n < N; ++n) {
    solve_v<kN>(acc, n, N, T, eps, red, v);
    float2 vn[kN];
#pragma unroll
    for (int m = 0; m < kN; ++m) vn[m] = m < N ? v[m] : make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 3 * kN; ++k) acc[k] = 0.f;

    // update source n at this thread's frames; accumulate for source n + 1
    for (int t = tid; t < T; t += nt) {
#pragma unroll
      for (int m = 0; m < kN; ++m)
        if (m < N) y[m] = work[m * work_stride + t];
      const float2 yn = pick<kN>(y, n);  // before the update, for every row
#pragma unroll
      for (int m = 0; m < kN; ++m) {
        if (m < N) {
          y[m].x -= vn[m].x * yn.x - vn[m].y * yn.y;
          y[m].y -= vn[m].x * yn.y + vn[m].y * yn.x;
          work[m * work_stride + t] = y[m];
        }
      }
      if (n + 1 < N) accumulate<kN>(acc, y, pick<kN>(y, n + 1), w, w_stride, t, N);
    }
  }

  if (resident) {
    float2* y_out = Y_out + (long long)i * T;
    for (int t = tid; t < T; t += nt) {
#pragma unroll
      for (int m = 0; m < kN; ++m)
        if (m < N) y_out[m * src_stride + t] = work[m * T + t];
    }
  }
}

template <int kN>
cudaError_t launch(const void* Y, const void* phi, void* Y_out, int N, int I, int T,
                   long long phi_src_stride, long long phi_bin_stride, int resident, int stage_phi,
                   float eps, int threads, long long smem, cudaStream_t stream) {
  auto kernel = iss1_sweep_kernel<kN>;
  if (smem > 48 * 1024) {
    cudaError_t status =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (status != cudaSuccess) return status;
  }
  kernel<<<I, threads, (size_t)smem, stream>>>((const float2*)Y, (const float*)phi,
                                               (float2*)Y_out, N, I, T, phi_src_stride,
                                               phi_bin_stride, resident, stage_phi, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Y, Y_out: complex64 (N, I, T); phi: float32 (N, T), or (N, I, T) when
// per_bin. All contiguous on `device`, Y_out not aliasing Y. `resident`
// selects the shared-memory variant (1) or the streamed one (0); the
// resident variant needs its bin in shared memory, which the wrapper checks
// first (ops/kernels.py:iss1_sweep_resident). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
int iss1_sweep_launch(const void* Y, const void* phi, void* Y_out, int N, int I, int T,
                      int per_bin, int resident, float eps, int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (N < 1 || N > kMaxSources || I < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int stage_phi = resident && per_bin;
  const long long smem = kHeaderBytes + (resident ? (long long)N * T * 8 : 0) +
                         (stage_phi ? (long long)N * T * 4 : 0);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int warps_of_frames = ((T + 31) / 32) * 32;
  const int threads = warps_of_frames < kMaxThreads ? warps_of_frames : kMaxThreads;
  const long long phi_src_stride = per_bin ? (long long)I * T : (long long)T;
  const long long phi_bin_stride = per_bin ? (long long)T : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 2)
    status = launch<2>(Y, phi, Y_out, N, I, T, phi_src_stride, phi_bin_stride, resident, stage_phi,
                       eps, threads, smem, s);
  else if (N <= 4)
    status = launch<4>(Y, phi, Y_out, N, I, T, phi_src_stride, phi_bin_stride, resident, stage_phi,
                       eps, threads, smem, s);
  else if (N <= 8)
    status = launch<8>(Y, phi, Y_out, N, I, T, phi_src_stride, phi_bin_stride, resident, stage_phi,
                       eps, threads, smem, s);
  else
    status = launch<16>(Y, phi, Y_out, N, I, T, phi_src_stride, phi_bin_stride, resident,
                        stage_phi, eps, threads, smem, s);
  return (int)status;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

// Weighted covariance U[i,n] = (1/T) sum_t phi[n,(i),t] x_it x_it^H.
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:weighted_covariance_sc (the
// Pallas kernel _wcov_kernel), which reads each bin block of X into VMEM
// once and issues every source's contraction from that one read.
//
// Bound on the H100: at the main-path shape (M = N = 8 channels/sources,
// I = 257 bins, T = 626 frames) one call reads 10.3 MB of X, writes 1 MB of
// U and does about 0.66 GFLOP. That is ~3.4 us of HBM traffic at 3.35 TB/s
// and ~10 us of FP32 FMA at 67 TFLOP/s, with only 257 independent bins, so
// the kernel is bound by latency and by how few blocks there are, not by
// peak bandwidth or arithmetic. Measured on an H100 80GB HBM3 (700 W):
// ~44 us per call; each SM holds ~2 blocks of 9 warps, and each thread runs
// one dependent FMA chain over the frames.
//
// Design: one thread block per bin. The block walks the frames in chunks
// of kChunk; each chunk of X[:, i, t0:t0+kChunk] (M complex values per
// frame) and the matching weights are staged in shared memory by coalesced
// loads, so X is read from device memory exactly once for all N sources,
// as _wcov_kernel does. Each thread owns up to kMaxEntriesPerThread of the
// N * M(M+1)/2 upper-triangle entries and accumulates them in FP32
// registers with plain FMA (no TF32, no bf16). The epilogue scales by 1/T
// and writes both triangles (Hermitian symmetry, real diagonal). Both
// weight shapes, (N, T) and per-bin (N, I, T), are one code path that
// differs only in the weights' bin stride.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;               // frames staged in shared memory per pass
// Row stride of the staged chunks: one word of padding per row puts the
// rows of different channels/sources in different banks, so a warp whose
// threads read rows p, q, n at the same frame does not serialise on a bank.
constexpr int kStride = kChunk + 1;
constexpr int kMaxEntriesPerThread = 8;   // upper-triangle entries one thread accumulates
constexpr int kMaxThreads = 1024;

__global__ void weighted_covariance_kernel(const float2* __restrict__ X,    // (M, I, T)
                                           const float* __restrict__ phi,   // (N, T) or (N, I, T)
                                           float2* __restrict__ U,          // (I, N, M, M)
                                           int M, int N, int I, int T,
                                           long long phi_src_stride,
                                           long long phi_bin_stride,
                                           int entries_per_thread) {
  extern __shared__ float smem[];
  float2* xs = reinterpret_cast<float2*>(smem);  // (M, kStride)
  float* ws = smem + 2 * M * kStride;            // (N, kStride)

  const int i = blockIdx.x;
  const int n_pairs = M * (M + 1) / 2;
  const int n_entries = N * n_pairs;

  // decode this thread's entries e -> (source n, row p <= column q)
  int ent_n[kMaxEntriesPerThread];
  int ent_p[kMaxEntriesPerThread];
  int ent_q[kMaxEntriesPerThread];
  float acc_re[kMaxEntriesPerThread];
  float acc_im[kMaxEntriesPerThread];
#pragma unroll
  for (int k = 0; k < kMaxEntriesPerThread; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    ent_n[k] = -1;
    ent_p[k] = 0;
    ent_q[k] = 0;
    acc_re[k] = 0.f;
    acc_im[k] = 0.f;
    if (k < entries_per_thread && e < n_entries) {
      int r = e % n_pairs;
      int p = 0;
      while (r >= M - p) {
        r -= M - p;
        ++p;
      }
      ent_n[k] = e / n_pairs;
      ent_p[k] = p;
      ent_q[k] = p + r;
    }
  }

  const long long bin_stride = (long long)I * T;  // X[m, i, t] = X[m * I * T + i * T + t]
  const float2* x_bin = X + (long long)i * T;
  const float* w_bin = phi + (long long)i * phi_bin_stride;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tc = min(kChunk, T - t0);
    __syncthreads();  // the previous chunk has been consumed
    for (int idx = threadIdx.x; idx < M * kChunk; idx += blockDim.x) {
      const int m = idx / kChunk, tt = idx % kChunk;
      if (tt < tc) xs[m * kStride + tt] = x_bin[m * bin_stride + t0 + tt];
    }
    for (int idx = threadIdx.x; idx < N * kChunk; idx += blockDim.x) {
      const int n = idx / kChunk, tt = idx % kChunk;
      if (tt < tc) ws[n * kStride + tt] = w_bin[n * phi_src_stride + t0 + tt];
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kMaxEntriesPerThread; ++k) {
      if (ent_n[k] < 0) continue;
      const float2* xp = xs + ent_p[k] * kStride;
      const float2* xq = xs + ent_q[k] * kStride;
      const float* wn = ws + ent_n[k] * kStride;
      float re = acc_re[k], im = acc_im[k];
#pragma unroll 4
      for (int tt = 0; tt < tc; ++tt) {
        const float2 a = xp[tt], b = xq[tt];
        const float w = wn[tt];
        // w * a * conj(b)
        re = fmaf(w, fmaf(a.x, b.x, a.y * b.y), re);
        im = fmaf(w, fmaf(a.y, b.x, -a.x * b.y), im);
      }
      acc_re[k] = re;
      acc_im[k] = im;
    }
  }

  const float inv_frames = 1.f / (float)T;
#pragma unroll
  for (int k = 0; k < kMaxEntriesPerThread; ++k) {
    if (ent_n[k] < 0) continue;
    const int p = ent_p[k], q = ent_q[k];
    float2* u = U + ((long long)i * N + ent_n[k]) * M * M;
    const float re = acc_re[k] * inv_frames;
    const float im = p == q ? 0.f : acc_im[k] * inv_frames;
    u[p * M + q] = make_float2(re, im);
    u[q * M + p] = make_float2(re, -im);
  }
}

}  // namespace

extern "C" {

// X: complex64 (M, I, T); phi: float32 (N, T), or (N, I, T) when per_bin;
// U: complex64 (I, N, M, M). All contiguous on `device`. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError(). The
// Python wrapper checks the same limits before it calls.
int weighted_covariance_launch(const void* X, const void* phi, void* U, int M, int N, int I,
                               int T, int per_bin, int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  const int n_entries = N * (M * (M + 1) / 2);
  const int warps_of_entries = ((n_entries + 31) / 32) * 32;
  const int threads = warps_of_entries < kMaxThreads ? warps_of_entries : kMaxThreads;
  const int entries_per_thread = (n_entries + threads - 1) / threads;
  const int smem = (2 * M + N) * kStride * (int)sizeof(float);
  if (M < 1 || N < 1 || I < 1 || T < 1 || entries_per_thread > kMaxEntriesPerThread ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const long long phi_src_stride = per_bin ? (long long)I * T : (long long)T;
  const long long phi_bin_stride = per_bin ? (long long)T : 0;
  weighted_covariance_kernel<<<I, threads, smem, (cudaStream_t)stream>>>(
      (const float2*)X, (const float*)phi, (float2*)U, M, N, I, T, phi_src_stride,
      phi_bin_stride, entries_per_thread);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

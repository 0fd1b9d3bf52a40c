// One round of the IPA congruence sweep, one thread block per frequency bin:
// U'[i,s] = T[i] U[i,s] T[i]^H for every source s, and G'[i] = T[i] G[i].
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:ipa_congruence_lanes (the Pallas
// kernel _ipa_congruence_kernel with _lane_cmatmul, pallas_kernels.py:315-331,
// :430-496), which the IPA sweep launches once per source
// (ssspy_tpu/ops/splitc.py:2221-2223). Same function: a general complex T per
// bin (the sweep's T is the identity plus one row and one column, but the
// kernel does not rely on it), no hermitization of the result (the caller
// does that, splitc.py:2224-2226).
//
// Bound on the H100: T, U and G are read once and U' and G' written once,
// I N^2 8 (2S + 3) bytes: 2,500,096 B at (I, S, N) = (257, 8, 8), 0.75 us at
// 3.35 TB/s. The 2S + 1 complex N x N products are 8 N^3 (2S + 1) I flops:
// 17.9 MFLOP, 0.27 us at 67 TFLOP/s in f32. So bytes bound it.
//
// Design: the TPU kernel is one program with the bins in the 128 lanes, planar
// real and imaginary operands, and T^H made outside to avoid sublane
// shuffles. None of that carries over. Here a block owns one bin, on native
// interleaved complex (float2), with no padding of the bin axis. It stages T,
// T^H (conjugated on the way in, so both products read shared memory along
// rows) and G, then walks the S sources in groups of blockDim / N^2: each
// group of N^2 threads stages its U[s], forms A = T U[s] into a second
// buffer, then C = A T^H, one thread per output entry, N complex
// multiply-adds each in a fixed order (k ascending, fmaf). At N = S = 8 all
// eight sources run at once on 512 threads, so a block passes two barriers.
// The first N^2 threads also form G' = T G. The plain PyTorch version makes
// three batched einsums of 8 x 8 matrices (about ten launches with the
// conjugate and the copies); the work per bin is 70 KFLOP, so the kernel is
// bound by latency (one wave of 257 small blocks), far above its bound.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 16;                    // sources and channels per bin
constexpr int kMaxThreads = 1024;            // a group of N^2 threads per source in flight
constexpr int kMatrix = kMaxN * kMaxN;

__device__ __forceinline__ float2 cmadd(float2 acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
  return acc;
}

__global__ void __launch_bounds__(kMaxThreads)
    ipa_congruence_kernel(const float2* __restrict__ T_in,   // (I, N, N)
                          const float2* __restrict__ U_in,   // (I, S, N, N)
                          const float2* __restrict__ G_in,   // (I, N, N)
                          float2* __restrict__ U_out,        // (I, S, N, N)
                          float2* __restrict__ G_out,        // (I, N, N)
                          int S, int N) {
  __shared__ float2 t[kMatrix];             // T
  __shared__ float2 th[kMatrix];            // T^H: th[k, j] = conj(T[j, k])
  __shared__ float2 g[kMatrix];             // G
  __shared__ float2 u[kMaxThreads];         // one U[s] per group
  __shared__ float2 a[kMaxThreads];         // one T U[s] per group

  const int nn = N * N;
  const int tid = threadIdx.x;
  const int groups = blockDim.x / nn;
  const int group = tid / nn;
  const int e = tid - group * nn;           // entry of the group's matrix
  const int i = e / N, j = e - i * N;
  const long long bin = blockIdx.x;
  const float2* T_bin = T_in + bin * nn;
  const float2* G_bin = G_in + bin * nn;
  const float2* U_bin = U_in + bin * S * nn;
  float2* U_bin_out = U_out + bin * S * nn;

  for (int k = tid; k < nn; k += blockDim.x) {
    const float2 x = T_bin[k];
    const int r = k / N, c = k - r * N;
    t[k] = x;
    th[c * N + r] = make_float2(x.x, -x.y);
    g[k] = G_bin[k];
  }

  for (int s0 = 0; s0 < S; s0 += groups) {
    const int s = s0 + group;
    const bool live = s < S;
    float2* us = u + group * nn;
    float2* prod = a + group * nn;
    if (live) us[e] = U_bin[s * nn + e];
    __syncthreads();  // T, T^H, G (first pass) and this pass's U are staged
    if (live) {
      float2 acc = make_float2(0.f, 0.f);
      for (int k = 0; k < N; ++k) acc = cmadd(acc, t[i * N + k], us[k * N + j]);
      prod[e] = acc;
    }
    __syncthreads();
    if (live) {
      float2 acc = make_float2(0.f, 0.f);
      for (int k = 0; k < N; ++k) acc = cmadd(acc, prod[i * N + k], th[k * N + j]);
      U_bin_out[s * nn + e] = acc;
    }
    // no barrier here: the next pass restages `us`, whose reads all lie
    // before the second barrier, and rewrites `prod` only after its own first
    // barrier, which every thread reaches after the reads above
  }

  if (tid < nn) {
    float2 acc = make_float2(0.f, 0.f);
    for (int k = 0; k < N; ++k) acc = cmadd(acc, t[i * N + k], g[k * N + j]);
    G_out[bin * nn + tid] = acc;
  }
}

}  // namespace

extern "C" {

// T, G, G_out: complex64 (I, N, N); U, U_out: complex64 (I, S, N, N); all
// contiguous on `device`, the outputs aliasing no input. 1 <= N, S <= 16.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError().
int ipa_congruence_launch(const void* T, const void* U, const void* G, void* U_out, void* G_out,
                          int I, int S, int N, int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (I < 1 || S < 1 || N < 1 || S > kMaxN || N > kMaxN) return (int)cudaErrorInvalidValue;
  const int nn = N * N;
  int groups = kMaxThreads / nn;
  if (groups > S) groups = S;
  ipa_congruence_kernel<<<I, groups * nn, 0, (cudaStream_t)stream>>>(
      (const float2*)T, (const float2*)U, (const float2*)G, (float2*)U_out, (float2*)G_out, S, N);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

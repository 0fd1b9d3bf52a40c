// Sequential IP1 sweep over the sources, one bin per thread block.
//
// Replaces: ssspy_tpu/ops/splitc.py:ip1_sweep_sc, with its solve
// csolve/gauss_jordan_solve_nopivot (XLA ops in the JAX package, not a
// Pallas kernel).
//
// Bound on the H100: at the main-path shape (N = M = 8, I = 257 bins) a
// call reads 1 MB of U and 16 KB of W and does about 0.4 MFLOP per bin.
// Neither bytes nor flops bound it. In plain PyTorch the same sweep is a
// batched LU solve plus about eight small launches for each of the N
// sources, each of them a few microseconds of launch latency around
// almost no work, and the sources are sequential. So launch latency and
// the serial dependency from one source to the next bound it. Measured on
// an H100 80GB HBM3 (700 W): ~64 us per call here, against ~0.63 ms of
// device time (and ~2.8 ms per call) for the plain LU version.
//
// Design: one block per bin keeps W_i (N x M) and U_i (N x M x M) in
// shared memory for the whole sweep, so the N dependent source updates
// cost one launch instead of ~8N. For each source n in order the block
// forms A = W_i U_in, solves A w = e_n by pivot-free complex Gauss-Jordan
// with the augmented matrix in shared memory (a pivot with |p| < 1e-20 is
// floored to magnitude 1e-20 keeping its phase, and 0 becomes 1e-20, as
// in gauss_jordan_solve_nopivot), forms w^H U_in w, and writes
// conj(w) / max(sqrt(max(w^H U w, 0)), eps) into row n. Where w^H U w <= 0
// or is NaN (a singular U_in: a silent or zero-padded bin) row n is kept
// as it was, the freeze of splitc.py:309-317. Later sources see the
// updated rows. Arithmetic is plain FP32.

#include <cuda_runtime.h>

namespace {

constexpr float kTiny = 1e-20f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 c) {  // a * b + c
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)), fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}

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
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError(). The Python wrapper checks the same limits first.
int ip1_sweep_launch(const void* W, const void* U, void* W_out, int I, int N, int M, float eps,
                     int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  const int L = M + 1;
  const int smem = (N * M * M + N * M + M * L + L + 2 * M) * (int)sizeof(float2);
  const int work = M * L;
  const int warps_of_work = ((work + 31) / 32) * 32;
  const int threads = warps_of_work < kMaxThreads ? warps_of_work : kMaxThreads;
  if (I < 1 || N < 1 || M < 1 || N != M || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  ip1_sweep_kernel<<<I, threads, smem, (cudaStream_t)stream>>>(
      (const float2*)W, (const float2*)U, (float2*)W_out, N, M, eps);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

// Batched real symmetric eigendecomposition by fixed-sweep round-robin
// Jacobi, one matrix per thread block.
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:jacobi_eigh_lanes (the Pallas
// kernel _jacobi_lanes_kernel, pallas_kernels.py:826-943) and the XLA form
// ssspy_tpu/ops/jacobi.py:jacobi_eigh. Same iteration: `sweeps` passes over
// the rounds of the round-robin schedule (ops/kernels.py:round_pairs; the
// bye of odd n keeps c = 1, s = 0); per pair (p, q) the symmetrised
// a_pq = (A[p,q] + A[q,p]) / 2, tau = (a_qq - a_pp) / (2 a_pq),
// t = sgn(tau) / (|tau| + sqrt(1 + tau^2)) with sgn(0) = +1, t = 0 where
// |a_pq| < tiny, c = 1 / sqrt(1 + t^2), s = t c; then the row pass
// (row p <- c row p - s row q, row q <- c row q + s row p), the column pass
// with the same coefficients, and V on its columns. lambda is the final
// diagonal, sorted ascending (stable, NaN last) with V's columns.
//
// Bound on the H100: per matrix A is read once and lambda and V written
// once, B (2 n^2 + n) 4 bytes: 542,784 B at (257, 16, 16), 0.16 us at
// 3.35 TB/s. Each round's three passes (rows of A, columns of A, columns
// of V) cost 3 n^2 flops each; 6 sweeps x (n - 1) rounds at n = 16 make
// 207,360 flops per matrix, 53.3 MFLOP at B = 257: 0.80 us at 67 TFLOP/s
// in f32. So operations bound it (1.59 us at B = 514).
//
// Design: the plain PyTorch version spends about 15 launches per round, 90
// rounds per eigh, each over the whole batch. Here one block holds its
// matrix A, a second buffer for the row pass, V, the round's (c, s) and the
// whole partner table in shared memory for all sweeps, one thread per entry
// (n^2 threads, n <= 32). Per round: threads 0..n-1 form (c, s) of their
// index; barrier; every thread writes its row-pass entry into the second
// buffer and reads the V entries its column update needs; barrier; every
// thread writes its column-pass entry of A and of V; barrier. About 270
// block barriers in a chain, so the kernel is latency-bound, far above its
// bound; a warp per matrix with shuffles is the next step. The rotation and
// the passes round every product and sum on its own (__fmul_rn,
// __fadd_rn, no FMA contraction), as the plain version's separate tensor
// operations do.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__global__ void __launch_bounds__(kMaxN * kMaxN)
    jacobi_eigh_kernel(const float* __restrict__ A_in,      // (B, n, n)
                       const int* __restrict__ partners,    // (n_rounds, n)
                       float* __restrict__ lamb_out,        // (B, n)
                       float* __restrict__ V_out,           // (B, n, n)
                       int n, int n_rounds, int sweeps, float tiny) {
  __shared__ float a[kMaxN * kMaxN];
  __shared__ float b[kMaxN * kMaxN];
  __shared__ float v[kMaxN * kMaxN];
  __shared__ float rot_c[kMaxN];
  __shared__ float rot_s[kMaxN];
  __shared__ int part[kMaxN * kMaxN];
  __shared__ int rank[kMaxN];

  const int nn = n * n;
  const int tid = threadIdx.x;
  const int i = tid / n, j = tid - i * n;
  const long long base = (long long)blockIdx.x * nn;

  a[tid] = A_in[base + tid];
  v[tid] = i == j ? 1.f : 0.f;
  for (int k = tid; k < n_rounds * n; k += nn) part[k] = partners[k];
  __syncthreads();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < n_rounds; ++r) {
      const int* pr = part + r * n;
      if (tid < n) {
        const int k = tid, pk = pr[k];
        const int p = min(k, pk), q = max(k, pk);
        const float app = a[p * n + p], aqq = a[q * n + q];
        const float apq = mul(add(a[p * n + q], a[q * n + p]), 0.5f);
        const bool small = fabsf(apq) < tiny || p == q;
        const float tau = __fdiv_rn(add(aqq, -app), mul(2.f, small ? tiny : apq));
        const float sgn = tau >= 0.f ? 1.f : -1.f;
        float t = __fdiv_rn(sgn, add(fabsf(tau), __fsqrt_rn(add(1.f, mul(tau, tau)))));
        if (small) t = 0.f;
        const float c = __fdiv_rn(1.f, __fsqrt_rn(add(1.f, mul(t, t))));
        const float s = mul(t, c);
        rot_c[k] = c;
        rot_s[k] = k == p ? -s : s;
      }
      __syncthreads();
      const int pi = pr[i], pj = pr[j];
      b[tid] = add(mul(rot_c[i], a[tid]), mul(rot_s[i], a[pi * n + j]));
      const float v_new = add(mul(rot_c[j], v[tid]), mul(rot_s[j], v[i * n + pj]));
      __syncthreads();
      a[tid] = add(mul(rot_c[j], b[tid]), mul(rot_s[j], b[i * n + pj]));
      v[tid] = v_new;
      __syncthreads();
    }
  }

  // rank sort of the diagonal: ascending, ties by index, NaN last
  if (tid < n) {
    const float lk = a[tid * n + tid];
    const bool nan_k = isnan(lk);
    int r = 0;
    for (int m = 0; m < n; ++m) {
      const float lm = a[m * n + m];
      const bool nan_m = isnan(lm);
      const bool before = (nan_k || nan_m) ? (nan_k && (!nan_m || m < tid))
                                           : (lm < lk || (lm == lk && m < tid));
      r += before ? 1 : 0;
    }
    rank[tid] = r;
    lamb_out[(long long)blockIdx.x * n + r] = lk;
  }
  __syncthreads();
  V_out[base + i * n + rank[j]] = v[tid];
}

}  // namespace

extern "C" {

// A, V: float32 (B, n, n); lamb: float32 (B, n); partners: int32
// (n_rounds, n), the partner of each index per round (itself for the bye).
// All contiguous on `device`, outputs not aliasing A. 2 <= n <= 32.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int jacobi_eigh_launch(const void* A, const void* partners, void* lamb, void* V, int B, int n,
                       int n_rounds, int sweeps, float tiny, int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (B < 1 || n < 2 || n > kMaxN || n_rounds < 1 || n_rounds > kMaxN || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  jacobi_eigh_kernel<<<B, n * n, 0, (cudaStream_t)stream>>>(
      (const float*)A, (const int*)partners, (float*)lamb, (float*)V, n, n_rounds, sweeps, tiny);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

// The fused model pass of dense GaussMNMF, one thread block per frequency
// bin. For each (bin i, frame t), with R = herm(sum_n Lamb[n,i,t] H[n,i]) +
// eps I and M = R^-1 XX[i,t] R^-1:
//   t1[n,i,t] = Re tr(M H[n,i]),   t2[n,i,t] = Re tr(R^-1 H[n,i]),
//   P[n,i] = sum_t Lamb[n,i,t] R^-1,   Q[n,i] = sum_t Lamb[n,i,t] M.
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:planar_model_traces_sc (the
// Pallas kernel _model_traces_kernel, :516-584), which the fused route of
// ssspy_tpu/ops/splitc.py:gauss_mnmf_step_sc calls three times per iteration
// (:3024 twice, :3078; a fourth time with the latent Z). Same function as its
// "gj" branch (:651-672), with H hermitized on the way in as the TPU kernel
// does (:676-678); R built from the hermitized H is Hermitian to the bit, so
// its own hermitization is the identity and is skipped.
//
// Bound on the H100: XX (I T m^2 8 bytes), Lamb and H are read once, t1, t2,
// P and Q written once: about 101 MB at (N, I, T, m) = (8, 257, 626, 8),
// 0.030 ms at 3.35 TB/s. Per (bin, frame): building R 4 N m^2 flops, the
// elimination 16 m^3 (every entry of [R | I] at each of m steps), the two
// products 16 m^3, the two traces 8 N m^2 and the P/Q accumulation 8 N m^2:
// 26,624 flops at N = m = 8, 4.28 GFLOP in all, 0.064 ms at 67 TFLOP/s in
// f32. So operations bound it.
//
// Design: the TPU kernel is one program per bin with the frames in the 128
// lanes (XX relaid out to (I, m^2, T) and padded to a lane multiple), and
// the real 2m x 3m embedding of [R | I] because Mosaic has no complex type;
// its contractions are MXU matmuls over the flattened m^2 axis. None of that
// carries over: here XX is read as it lies, (I, T, m, m) native complex, no
// frame is padded, and the elimination is the complex one of gj_inverse.cuh.
// A block of eight warps owns one bin: it keeps the bin's hermitized H and
// its P and Q accumulators in shared memory and walks the frames in tiles of
// F = 8 floor(32 / m) (32 at m = 8). For each tile it stages Lamb and XX with
// coalesced loads; a group of m threads per frame, one row each, builds its
// row of R (sources summed in order), inverts with one __syncwarp() per step,
// forms its row of R^-1 XX in registers and its row of M into the XX buffer;
// then each thread of the group takes the sources n = row, row + m, ... and
// writes t1 and t2 (sums over (a, b) in order). After a block barrier each
// P and Q entry, owned by one thread for the whole bin, adds the tile's
// frames in frame order: deterministic, no atomics. No (I, T, m, m)
// intermediate reaches device memory. All arithmetic is full f32.

#include <cuda_runtime.h>

#include "gj_inverse.cuh"

namespace {

// largest system: each thread keeps its row of the products in registers
constexpr int kMaxM = 16;

constexpr int kWarpSize = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarpSize;

__global__ void __launch_bounds__(kThreads)
    model_traces_kernel(const float* __restrict__ Lamb,   // (N, I, T)
                        const float2* __restrict__ H,     // (N, I, m, m)
                        const float2* __restrict__ XX,    // (I, T, m, m)
                        float* __restrict__ t1_out,       // (N, I, T)
                        float* __restrict__ t2_out,       // (N, I, T)
                        float2* __restrict__ P_out,       // (N, I, m, m)
                        float2* __restrict__ Q_out,       // (N, I, m, m)
                        int N, int I, int T, int m, float eps, float tiny) {
  extern __shared__ float2 smem[];
  const int mm = m * m, w = gj::stride(m);
  const int hs = mm + 1;            // padded per-source stride of hh: sources in other banks
  const int per_warp = kWarpSize / m;
  const int F = kWarps * per_warp;  // frames per tile
  float2* hh = smem;                // N x hs: hermitized H of this bin
  float2* p_acc = hh + N * hs;      // N x m x m
  float2* q_acc = p_acc + N * mm;   // N x m x m
  float2* aug = q_acc + N * mm;     // F x m x w: [R | I], then [. | R^-1]
  float2* xm = aug + F * m * w;     // F x m x m: XX, then M
  float* lamb = (float*)(xm + F * mm);  // N x F

  const int tid = threadIdx.x;
  const int i = blockIdx.x;

  for (int e = tid; e < N * mm; e += kThreads) {
    const int n = e / mm, rc = e - n * mm, r = rc / m, c = rc - r * m;
    const float2* Hn = H + ((long long)n * I + i) * mm;
    const float2 a = Hn[r * m + c], b = Hn[c * m + r];
    hh[n * hs + rc] = make_float2((a.x + b.x) / 2, (a.y - b.y) / 2);
    p_acc[e] = make_float2(0.f, 0.f);
    q_acc[e] = make_float2(0.f, 0.f);
  }

  const int warp = tid / kWarpSize, lane = tid - warp * kWarpSize;
  const int gw = lane / m, row = lane - gw * m;
  const int f = warp * per_warp + gw;  // this group's frame within the tile
  const float2* XX_bin = XX + (long long)i * T * mm;

  for (int t0 = 0; t0 < T; t0 += F) {
    const int cnt = min(F, T - t0);
    __syncthreads();  // H staged (first tile); the previous tile's reads are done
    for (int e = tid; e < N * F; e += kThreads) {
      const int n = e / F, ff = e - n * F;
      lamb[e] = ff < cnt ? Lamb[((long long)n * I + i) * T + t0 + ff] : 0.f;
    }
    for (int e = tid; e < cnt * mm; e += kThreads) xm[e] = XX_bin[(long long)t0 * mm + e];
    __syncthreads();

    const bool live = gw < per_warp && f < cnt;
    float2* sys = aug + (live ? f : 0) * m * w;
    float2* xf = xm + (live ? f : 0) * mm;
    if (live) {
      float2* own = sys + row * w;
      for (int c = 0; c < m; ++c) {
        float2 acc = make_float2(0.f, 0.f);
        for (int n = 0; n < N; ++n) {
          const float l = lamb[n * F + f];
          const float2 h = hh[n * hs + row * m + c];
          acc.x = fmaf(l, h.x, acc.x);
          acc.y = fmaf(l, h.y, acc.y);
        }
        if (c == row) acc.x += eps;
        own[c] = acc;
        own[m + c] = make_float2(c == row ? 1.f : 0.f, 0.f);
      }
    }
    gj::invert(sys, m, row, live, tiny);

    float2 mrow[kMaxM];
    if (live) {
      const float2* rinv_row = sys + row * w + m;
      float2 m1[kMaxM];
#pragma unroll
      for (int j = 0; j < kMaxM; ++j) {
        if (j < m) {
          float2 acc = make_float2(0.f, 0.f);
          for (int k = 0; k < m; ++k) acc = gj::cmadd(acc, rinv_row[k], xf[k * m + j]);
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
          mrow[j] = acc;
        }
      }
    }
    __syncwarp();  // every row of R^-1 XX is formed before XX is overwritten by M
    if (live) {
#pragma unroll
      for (int j = 0; j < kMaxM; ++j)
        if (j < m) xf[row * m + j] = mrow[j];
    }
    __syncwarp();

    if (live) {
      for (int n = row; n < N; n += m) {
        const float2* hn = hh + n * hs;
        float s1 = 0.f, s2 = 0.f;
        for (int a = 0; a < m; ++a) {
          for (int b = 0; b < m; ++b) {
            const float2 h = hn[b * m + a];
            const float2 mv = xf[a * m + b], rv = sys[a * w + m + b];
            s1 = fmaf(mv.x, h.x, s1);
            s1 = fmaf(-mv.y, h.y, s1);
            s2 = fmaf(rv.x, h.x, s2);
            s2 = fmaf(-rv.y, h.y, s2);
          }
        }
        const long long at = ((long long)n * I + i) * T + t0 + f;
        t1_out[at] = s1;
        t2_out[at] = s2;
      }
    }
    __syncthreads();  // every frame's R^-1 and M are in shared memory

    for (int e = tid; e < N * mm; e += kThreads) {
      const int n = e / mm, rc = e - n * mm, r = rc / m, c = rc - r * m;
      float2 p = p_acc[e], q = q_acc[e];
      for (int ff = 0; ff < cnt; ++ff) {
        const float l = lamb[n * F + ff];
        const float2 rv = aug[ff * m * w + r * w + m + c], mv = xm[ff * mm + rc];
        p.x = fmaf(l, rv.x, p.x);
        p.y = fmaf(l, rv.y, p.y);
        q.x = fmaf(l, mv.x, q.x);
        q.y = fmaf(l, mv.y, q.y);
      }
      p_acc[e] = p;
      q_acc[e] = q;
    }
  }
  __syncthreads();

  for (int e = tid; e < N * mm; e += kThreads) {
    const int n = e / mm, rc = e - n * mm;
    const long long at = ((long long)n * I + i) * mm + rc;
    P_out[at] = p_acc[e];
    Q_out[at] = q_acc[e];
  }
}

}  // namespace

extern "C" {

// Shared memory one block takes: H (padded), P and Q of its bin, and per
// frame of a tile the padded [R | I] and XX (complex64), plus the tile's
// Lamb (float32). The wrapper (ops/kernels.py:model_traces_smem_bytes)
// computes the same number and checks it against the 227 KB a block can have.
int model_traces_smem_bytes(int N, int m) {
  const int F = kWarps * (kWarpSize / m);
  return (N * (3 * m * m + 1) + F * m * (gj::stride(m) + m)) * (int)sizeof(float2) +
         N * F * (int)sizeof(float);
}

// Lamb, t1, t2: float32 (N, I, T); H, P, Q: complex64 (N, I, m, m); XX:
// complex64 (I, T, m, m). All contiguous on `device`, the outputs aliasing no
// input. 1 <= m <= 16. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
int model_traces_launch(const void* Lamb, const void* H, const void* XX, void* t1, void* t2, void* P,
                        void* Q, int N, int I, int T, int m, float eps, float tiny, int device,
                        void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (N < 1 || I < 1 || T < 1 || m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const int smem = model_traces_smem_bytes(N, m);
  status = cudaFuncSetAttribute(model_traces_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != cudaSuccess) return (int)status;
  model_traces_kernel<<<I, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)Lamb, (const float2*)H, (const float2*)XX, (float*)t1, (float*)t2, (float2*)P,
      (float2*)Q, N, I, T, m, eps, tiny);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

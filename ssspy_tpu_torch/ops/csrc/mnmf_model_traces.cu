// The fused model pass of dense GaussMNMF. For each (bin i, frame t), with
// R = herm(sum_n Lamb[n,i,t] H[n,i]) + eps I and M = R^-1 XX[i,t] R^-1:
//   t1[n,i,t] = Re tr(M H[n,i]),   t2[n,i,t] = Re tr(R^-1 H[n,i]),
//   P[n,i] = sum_t Lamb[n,i,t] R^-1,   Q[n,i] = sum_t Lamb[n,i,t] M.
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:planar_model_traces_sc (:607;
// its pl.pallas_call :713, the Pallas kernel _model_traces_kernel), which
// the fused route of ssspy_tpu/ops/splitc.py:gauss_mnmf_step_sc calls three
// times per iteration (:3024 twice, :3078; a fourth time with the latent Z).
// Same function as its "gj" branch (:651-672), with H hermitized on the way
// in as the TPU kernel does (:676-678); R built from the hermitized H is
// Hermitian to the bit, so its own hermitization is the identity and is
// skipped.
//
// Bound on the H100: XX (I T m^2 8 bytes), Lamb and H are read once, t1,
// t2, P and Q written once: about 101 MB at (N, I, T, m) = (8, 257, 626, 8),
// 0.030 ms at 3.35 TB/s. Per (bin, frame): building R 4 N m^2 flops, the
// elimination 16 m^3, the two products 16 m^3, the two traces 8 N m^2 and
// the P/Q sums 8 N m^2: 26,624 flops at N = m = 8, 4.28 GFLOP in all,
// 0.064 ms at 67 TFLOP/s in f32. So operations bound it.
//
// Design. A group of m threads owns one frame, one row of [R | I] each, in
// registers; floor(32 / m) groups share a warp, eight warps a block, so a
// tile holds F = 8 floor(32 / m) frames (32 at m = 8). Per tile: each
// thread builds its row of R (sources summed in order) and inverts with the
// complex Gauss-Jordan of gj_inverse.cuh, forms its rows of R^-1 XX and M
// and its share of t1 and t2; then each P and Q entry, owned by one thread,
// adds the tile's frames in frame order. The first design was one block per
// bin walking all 626 frames: 257 blocks of 8 warps on 132 SMs, one thread
// of each group dividing the whole pivot row while the other m - 1 waited,
// every row of [R | I] read and written in shared memory at each step, row
// arrays sized for m = 16, and tiles loaded while nothing computed. Here:
// - the frames of a bin are split into S chunks of whole tiles, grid
//   (I, S) (the wrapper picks S for about 2,048 blocks: 257 x 7 at the main
//   path), and each block writes its chunk's partial P and Q to a workspace
//   (2, N, I, S, m, m); a second kernel adds the S partials in chunk order.
//   No atomics: two launches give the same bits; P and Q are summed in
//   another order than the plain version's, within 2e-4 of it;
// - each thread keeps its row of [R | I] in registers. At step k the owner
//   of row k publishes the entries still alive (the left half after k, the
//   right half up to k: the others are 0 or never read again) in a pivot
//   buffer and broadcasts its pivot by shuffle, each thread divides one
//   entry, and every row takes the buffer back: per entry the operations of
//   gj::invert, so R^-1 keeps its bits;
// - the kernel is a template on m, with an m = 8 instance (8-entry rows,
//   loops unrolled, the traces summed over each thread's own row and added
//   across the group by butterfly) and a generic m <= 16 one;
// - rows of H and R^-1 and each frame's XX are padded by one entry, so that
//   the rows a group reads and the frames a warp reads fall in other banks;
// - XX and Lamb of the next tile arrive by cp.async into a second buffer
//   while the current tile computes (one buffer where two would not fit a
//   block's 227 KB; the sizes the kernel takes are those the first design's
//   layout fits, which is never smaller than this one's single buffer);
// - the caller may ask for the traces alone (the basis and activation
//   updates) or the sums alone (the spatial update), and the kernel skips
//   the other half's work and writes.
// No (I, T, m, m) intermediate reaches device memory. All arithmetic is
// full f32 on the CUDA cores: no TF32, and 8 x 8 products are far below a
// tensor-core tile.

#include <cuda_runtime.h>

#include "gj_inverse.cuh"

namespace {

constexpr int kMaxM = 16;  // each thread keeps its row of the products in registers
constexpr int kWarpSize = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarpSize;
constexpr int kSmemMax = 232448;  // dynamic shared memory of one block on sm_90
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int frames_per_tile(int m) { return kWarps * (kWarpSize / m); }

// Shared-memory layout. Row stride of H and of R^-1: m, padded by one
// entry from m = 8 on, where rows m complex64 apart would share banks.
__host__ __device__ inline int row_stride(int m) { return m + (m >= 8 ? 1 : 0); }
// per source: H; per frame: the pivot row, then R^-1; per frame: XX, then
// M. Each padded by one entry, so that the frames (and sources) that the
// groups of a warp read at once fall in other banks.
__host__ __device__ inline int source_stride(int m) { return m * row_stride(m) + 1; }
__host__ __device__ inline int frame_stride(int m) { return m * row_stride(m) + 1; }
__host__ __device__ inline int xx_stride(int m) { return m * m + 1; }

// H, P and Q of the bin, per frame of a tile the pivot row / R^-1, and per
// buffer a tile's XX (complex64) and Lamb (float32)
__host__ __device__ inline int smem_bytes(int N, int m, int stages) {
  const int F = frames_per_tile(m);
  return (N * (source_stride(m) + 2 * m * m) + F * frame_stride(m) + stages * F * xx_stride(m)) * 8 +
         stages * N * F * 4;
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

// MT: m at compile time (8), or 0 for any 1 <= m <= 16 at run time
template <int MT>
__global__ void __launch_bounds__(kThreads, MT ? 2 : 1)
    model_traces_kernel(const float* __restrict__ Lamb,   // (N, I, T)
                        const float2* __restrict__ H,     // (N, I, m, m)
                        const float2* __restrict__ XX,    // (I, T, m, m)
                        float* __restrict__ t1_out,       // (N, I, T), or null
                        float* __restrict__ t2_out,       // (N, I, T), or null
                        float2* __restrict__ partial,     // (2, N, I, S, m, m), or null
                        int N, int I, int T, int m_run, int chunk, int stages, float eps, float tiny) {
  constexpr int kRow = MT ? MT : kMaxM;  // register row length
  const int m = MT ? MT : m_run;
  extern __shared__ float2 smem[];
  const int mm = m * m, ld = row_stride(m), hs = source_stride(m), fs = frame_stride(m), xs = xx_stride(m);
  const int per_warp = kWarpSize / m;
  const int F = kWarps * per_warp;
  float2* hh = smem;                            // N x hs: hermitized H of this bin, rows ld apart
  float2* p_acc = hh + N * hs;                  // N x m x m
  float2* q_acc = p_acc + N * mm;               // N x m x m
  float2* inv = q_acc + N * mm;                 // F x fs: the pivot row, then R^-1 (rows ld apart)
  float2* xm_buf = inv + F * fs;                // stages x F x xs: XX, then M
  float* lamb_buf = (float*)(xm_buf + stages * F * xs);  // stages x N x F
  const bool want_traces = t1_out != nullptr, want_sums = partial != nullptr;

  const int tid = threadIdx.x;
  const int i = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int first = s * chunk, n_frames = min(chunk, T - first);
  const int n_tiles = (n_frames + F - 1) / F;
  const float2* XX_bin = XX + ((long long)i * T + first) * mm;

  // the loads of tile k (frames first + k F ...) into buffer b, asynchronous
  auto issue = [&](int k, int b) {
    const int t0 = k * F, cnt = min(F, n_frames - t0);
    float2* xm = xm_buf + b * F * xs;
    float* lamb = lamb_buf + b * N * F;
    for (int e = tid; e < cnt * mm; e += kThreads) {
      const int ff = e / mm;
      cp_async8(xm + ff * xs + (e - ff * mm), XX_bin + (long long)t0 * mm + e);
    }
    for (int e = tid; e < N * F; e += kThreads) {
      const int n = e / F, ff = e - n * F;
      if (ff < cnt)
        cp_async4(lamb + e, Lamb + ((long long)n * I + i) * T + first + t0 + ff);
      else
        lamb[e] = 0.f;
    }
    cp_async_commit();
  };

  issue(0, 0);
  for (int e = tid; e < N * mm; e += kThreads) {
    const int n = e / mm, rc = e - n * mm, r = rc / m, c = rc - r * m;
    const float2* Hn = H + ((long long)n * I + i) * mm;
    const float2 a = Hn[r * m + c], b = Hn[c * m + r];
    hh[n * hs + r * ld + c] = make_float2((a.x + b.x) / 2, (a.y - b.y) / 2);
    p_acc[e] = make_float2(0.f, 0.f);
    q_acc[e] = make_float2(0.f, 0.f);
  }

  const int warp = tid / kWarpSize, lane = tid - warp * kWarpSize;
  const int gw = lane / m, row = lane - gw * m, leader = gw * m;
  const int f = warp * per_warp + gw;  // this group's frame within the tile

  for (int k = 0; k < n_tiles; ++k) {
    const int b = stages == 2 ? k & 1 : 0;
    if (stages == 2 && k + 1 < n_tiles) {
      issue(k + 1, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile k (and, at k = 0, H) staged for every thread
    const int t0 = k * F, cnt = min(F, n_frames - t0);
    float2* xm = xm_buf + b * F * xs;
    const float* lamb = lamb_buf + b * N * F;

    const bool live = gw < per_warp && f < cnt;
    float2* sys = inv + (live ? f : 0) * fs;
    float2* xf = xm + (live ? f : 0) * xs;
    // this thread's row of [R | I] in registers: R in [0, m), I and then
    // R^-1 in [kRow, kRow + m)
    float2 rowv[2 * kRow];
#pragma unroll
    for (int c = 0; c < kRow; ++c) rowv[c] = make_float2(0.f, 0.f);
    if (live) {
      for (int n = 0; n < N; ++n) {  // sources in order, each entry on its own
        const float l = lamb[n * F + f];
        const float2* h = hh + n * hs + row * ld;
#pragma unroll
        for (int c = 0; c < kRow; ++c) {
          if (c < m) {
            rowv[c].x = fmaf(l, h[c].x, rowv[c].x);
            rowv[c].y = fmaf(l, h[c].y, rowv[c].y);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kRow; ++c) {
      if (c < m) {
        if (c == row) rowv[c].x += eps;
        rowv[kRow + c] = make_float2(c == row ? 1.f : 0.f, 0.f);
      }
    }
    // Gauss-Jordan, step by step as gj::invert, on the entries still alive:
    // at step k the left half's columns after k and the right half's
    // columns up to k (the others are 0 or are not read again, and
    // subtracting f x 0 leaves an entry as it is). The owner of row k
    // publishes them in the frame's pivot buffer (left column c at c, right
    // column c at m + c: the live ones are k + 1 .. k + m) and broadcasts its
    // pivot by shuffle; thread `row` divides entry k + 1 + row; every row
    // takes the divided row back.
    float2* piv = sys;
#pragma unroll
    for (int step = 0; step < kRow; ++step) {
      if (step < m) {
        if (live && row == step) {
#pragma unroll
          for (int c = 0; c < kRow; ++c) {
            if (c < m) {
              if (c > step) piv[c] = rowv[c];
              if (c <= step) piv[m + c] = rowv[kRow + c];
            }
          }
        }
        const float2 raw = make_float2(__shfl_sync(kFull, rowv[step].x, leader + step),
                                       __shfl_sync(kFull, rowv[step].y, leader + step));
        // |p| >= max(|p.x|, |p.y|): a component at or above the floor keeps p
        // as gj::floored_pivot would, without its hypotf
        const float2 p = fabsf(raw.x) >= tiny || fabsf(raw.y) >= tiny ? raw : gj::floored_pivot(raw, tiny);
        __syncwarp();
        if (live) piv[step + 1 + row] = gj::cdiv(piv[step + 1 + row], p);
        __syncwarp();
        if (live) {
          const float2 f_k = rowv[step];
          const bool pivot = row == step;
#pragma unroll
          for (int c = 0; c < kRow; ++c) {
            if (c < m && c > step) {
              const float2 q = piv[c], t = gj::cmul(f_k, q);
              rowv[c] = pivot ? q : make_float2(rowv[c].x - t.x, rowv[c].y - t.y);
            }
            if (c < m && c <= step) {
              const float2 q = piv[m + c], t = gj::cmul(f_k, q);
              rowv[kRow + c] = pivot ? q : make_float2(rowv[kRow + c].x - t.x, rowv[kRow + c].y - t.y);
            }
          }
        }
        __syncwarp();  // the buffer is read before the next owner writes it
      }
    }
    // R^-1 rows where the products, the traces and the sums read them
    if (live) {
#pragma unroll
      for (int c = 0; c < kRow; ++c)
        if (c < m) sys[row * ld + c] = rowv[kRow + c];
    }
    __syncwarp();

    float2 mrow[kRow];
#pragma unroll
    for (int j = 0; j < kRow; ++j) mrow[j] = make_float2(0.f, 0.f);
    if (live) {
      float2 m1[kRow];
#pragma unroll
      for (int j = 0; j < kRow; ++j) {
        if (j < m) {
          float2 acc = make_float2(0.f, 0.f);
#pragma unroll
          for (int q = 0; q < kRow; ++q)
            if (q < m) acc = gj::cmadd(acc, rowv[kRow + q], xf[q * m + j]);
          m1[j] = acc;
        }
      }
#pragma unroll
      for (int j = 0; j < kRow; ++j) {
        if (j < m) {
          float2 acc = make_float2(0.f, 0.f);
#pragma unroll
          for (int q = 0; q < kRow; ++q)
            if (q < m) acc = gj::cmadd(acc, m1[q], sys[q * ld + j]);
          mrow[j] = acc;
        }
      }
    }
    __syncwarp();  // every row of R^-1 XX is formed before XX is overwritten by M
    if (live) {
#pragma unroll
      for (int j = 0; j < kRow; ++j)
        if (j < m) xf[row * m + j] = mrow[j];
    }
    __syncwarp();

    if constexpr (MT != 0) {
      // m a power of two: each thread sums the traces over its own row
      // (M's and R^-1's rows are in its registers), the group adds the m
      // partial sums by butterfly, and the thread of row n mod m writes
      if (want_traces) {
        for (int n = 0; n < N; ++n) {
          const float2* hn = hh + n * hs + row;  // column `row` of H_n: entry (c, row) at c * ld
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int c = 0; c < MT; ++c) {
            const float2 h = hn[c * ld], mv = mrow[c], rv = rowv[kRow + c];
            s1 = fmaf(mv.x, h.x, s1);
            s1 = fmaf(-mv.y, h.y, s1);
            s2 = fmaf(rv.x, h.x, s2);
            s2 = fmaf(-rv.y, h.y, s2);
          }
#pragma unroll
          for (int off = MT / 2; off > 0; off /= 2) {
            s1 += __shfl_xor_sync(kFull, s1, off);
            s2 += __shfl_xor_sync(kFull, s2, off);
          }
          if (live && row == n % MT) {
            const long long at = ((long long)n * I + i) * T + first + t0 + f;
            t1_out[at] = s1;
            t2_out[at] = s2;
          }
        }
      }
    } else if (live && want_traces) {
      for (int n = row; n < N; n += m) {
        const float2* hn = hh + n * hs;
        float s1 = 0.f, s2 = 0.f;
        for (int a = 0; a < m; ++a) {
          for (int c = 0; c < m; ++c) {
            const float2 h = hn[c * ld + a];
            const float2 mv = xf[a * m + c], rv = sys[a * ld + c];
            s1 = fmaf(mv.x, h.x, s1);
            s1 = fmaf(-mv.y, h.y, s1);
            s2 = fmaf(rv.x, h.x, s2);
            s2 = fmaf(-rv.y, h.y, s2);
          }
        }
        const long long at = ((long long)n * I + i) * T + first + t0 + f;
        t1_out[at] = s1;
        t2_out[at] = s2;
      }
    }
    __syncthreads();  // every frame's R^-1 and M are in shared memory

    if (want_sums) {
      for (int e = tid; e < N * mm; e += kThreads) {
        const int n = e / mm, rc = e - n * mm, r = rc / m, c = rc - r * m;
        float2 p = p_acc[e], q = q_acc[e];
        for (int ff = 0; ff < cnt; ++ff) {
          const float l = lamb[n * F + ff];
          const float2 rv = inv[ff * fs + r * ld + c], mv = xm[ff * xs + rc];
          p.x = fmaf(l, rv.x, p.x);
          p.y = fmaf(l, rv.y, p.y);
          q.x = fmaf(l, mv.x, q.x);
          q.y = fmaf(l, mv.y, q.y);
        }
        p_acc[e] = p;
        q_acc[e] = q;
      }
    }
    __syncthreads();  // the tile's buffers and R^-1 are free for the next loads
    if (stages == 1 && k + 1 < n_tiles) issue(k + 1, 0);
  }

  if (want_sums) {
    const long long plane = (long long)N * I * S * mm;
    for (int e = tid; e < N * mm; e += kThreads) {
      const int n = e / mm, rc = e - n * mm;
      const long long at = (((long long)n * I + i) * S + s) * mm + rc;
      partial[at] = p_acc[e];
      partial[plane + at] = q_acc[e];
    }
  }
}

// P[n,i] and Q[n,i] entry by entry: the S partials of the bin in chunk order
__global__ void model_traces_kernel_sums(const float2* __restrict__ partial,  // (2, N, I, S, m, m)
                                    float2* __restrict__ P, float2* __restrict__ Q, long long NI, int S,
                                    int mm) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * NI * mm) return;
  const long long which = idx / (NI * mm), rest = idx - which * NI * mm;
  const long long ni = rest / mm, rc = rest - ni * mm;
  const float2* src = partial + which * NI * S * mm + ni * S * mm + rc;
  float2 acc = src[0];
  for (int s = 1; s < S; ++s) {
    const float2 v = src[(long long)s * mm];
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
  }
  (which == 0 ? P : Q)[rest] = acc;
}

}  // namespace

extern "C" {

// Shared memory one block takes with `stages` buffers of a tile's XX and
// Lamb (ops/kernels.py:model_traces_geometry computes the same number).
int model_traces_smem_bytes(int N, int m, int stages) { return smem_bytes(N, m, stages); }

// Lamb, t1, t2: float32 (N, I, T); H, P, Q: complex64 (N, I, m, m); XX:
// complex64 (I, T, m, m); partial: complex64 (2, N, I, S, m, m) with
// S = ceil(T / chunk), chunk a multiple of 8 floor(32 / m). t1 and t2 null:
// no traces; partial, P and Q null: no sums. All contiguous on `device`,
// the outputs aliasing no input. 1 <= m <= 16. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
int model_traces_launch(const void* Lamb, const void* H, const void* XX, void* t1, void* t2, void* partial,
                        void* P, void* Q, int N, int I, int T, int m, int chunk, float eps, float tiny, int device,
                        void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  const bool traces = t1 != nullptr && t2 != nullptr, sums = partial != nullptr && P != nullptr && Q != nullptr;
  if (N < 1 || I < 1 || T < 1 || m < 1 || m > kMaxM || !(traces || sums)) return (int)cudaErrorInvalidValue;
  if ((t1 == nullptr) != (t2 == nullptr) || chunk < 1 || chunk % frames_per_tile(m) != 0)
    return (int)cudaErrorInvalidValue;
  const int S = (T + chunk - 1) / chunk;
  const int stages = smem_bytes(N, m, 2) <= kSmemMax ? 2 : 1;
  const int smem = smem_bytes(N, m, stages);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = m == 8 ? model_traces_kernel<8> : model_traces_kernel<0>;
  status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != cudaSuccess) return (int)status;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<dim3(I, S), kThreads, smem, s>>>((const float*)Lamb, (const float2*)H, (const float2*)XX,
                                             traces ? (float*)t1 : nullptr, traces ? (float*)t2 : nullptr,
                                             sums ? (float2*)partial : nullptr, N, I, T, m, chunk, stages, eps,
                                             tiny);
  status = cudaGetLastError();
  if (status != cudaSuccess || !sums) return (int)status;
  const long long entries = 2LL * N * I * m * m;
  const int block = 256;
  model_traces_kernel_sums<<<(unsigned)((entries + block - 1) / block), block, 0, s>>>(
      (const float2*)partial, (float2*)P, (float2*)Q, (long long)N * I, S, m * m);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

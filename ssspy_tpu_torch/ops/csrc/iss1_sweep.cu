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
// What held the first design back (a block of 512 threads per bin, Y in
// shared memory; 0.055-0.058 ms between CUDA events and 52-61 us a launch
// by the profiler on an NVIDIA H100 80GB HBM3 at 700 W): at T = 626, 114
// threads owned two frames and the rest one, so every pass cost two frames;
// each source reduced its 3N sums with 3N separate butterflies, then waited
// on a barrier for thread m to add the warps' partials and on a second one
// before any thread could update; the bin's Y went through shared memory
// and the (N, T) weights through L2 once a source.
//
// Three variants, chosen by shape before the launch
// (ops/kernels.py:iss1_sweep_variant):
// - registers (the paths' shapes: T up to 32 kRegWarps kRegFrames frames):
//   ceil(T / (32 F)) warps a bin, F = kRegFrames frames a thread
//   (t = tid, tid + blockDim, ...; 5 warps of 4 frames at N = 8, T = 626:
//   640 slots for 626 frames, two blocks an SM, 257 bins in one wave). Each
//   thread keeps its frames of Y and of the weights, in either layout, in
//   registers for the whole sweep: Y is read from device memory once and
//   written once. For each source a thread adds its frames into 4 kN sums
//   (Re num, Im num, denom, and a zero group that makes a power of two);
//   the warp meets them in one fixed reduce-scatter of shuffles (31 at
//   kN = 8, as K1's), writes its partials into a double-buffered table in
//   shared memory and takes the source's one __syncthreads; then lane m of
//   every warp adds the warps' partials of row m in warp order, forms v[m],
//   and the warp shares v through its own slot in shared memory. No second
//   barrier: the next source writes the other table, which no warp can
//   still be reading. Every product, quotient and square root rounds as
//   iss1_sweep_plain's operators round it, so at T = 1 (where each sum is
//   one term and the update cancels to rounding noise that the next source
//   scales by up to 1 / sqrt(eps)) the variant is the plain version bit for
//   bit; at longer T only the order of the frame sums differs.
// - resident (longer bins that fit one block's 227 KB): one block of up to
//   512 threads keeps the bin's Y, and per-bin weights, in dynamic shared
//   memory; one pass per source updates source n and accumulates the sums
//   of source n + 1 (the first design).
// - streamed (T > ~2,400 at N = 8 with per-bin weights, T > ~3,600 with
//   (N, T) weights): the same code with the bin's Y in the output buffer in
//   device memory (mostly L2 hits).
// Every variant sums in a fixed order, without atomics: two launches give
// the same bits. Arithmetic is plain FP32.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSources = 16;
constexpr int kWarpSize = 32;
constexpr unsigned kFull = 0xffffffffu;

// ---- registers: the bin's frames in registers, one barrier a source ---------------------

// frames a thread and most warps a bin, by the template's sources kN (the
// register budget: about 3 kN F floats of Y and weights, 4 kN sums and 2 kN
// of v a thread)
constexpr int kRegFrames2 = 4;
constexpr int kRegWarps2 = 16;
constexpr int kRegFrames4 = 4;
constexpr int kRegWarps4 = 16;
constexpr int kRegFrames8 = 4;
constexpr int kRegWarps8 = 10;
constexpr int kRegFrames16 = 1;
constexpr int kRegWarps16 = 12;

__host__ __device__ constexpr int reg_frames(int kN) {
  return kN <= 2 ? kRegFrames2 : kN <= 4 ? kRegFrames4 : kN <= 8 ? kRegFrames8 : kRegFrames16;
}

__host__ __device__ constexpr int reg_warps(int kN) {
  return kN <= 2 ? kRegWarps2 : kN <= 4 ? kRegWarps4 : kN <= 8 ? kRegWarps8 : kRegWarps16;
}

// One level of the reduce-scatter over a warp: of its first 2 H sums a lane
// keeps the half that its lane bit `bit` selects, adds the partner lane's
// same half, and leaves the result in its first H
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

// The reduce-scatter of S sums from lane bit Bit down to bit 1. From
// Bit = min(S / 2, 16) it leaves lane l with max(S / 32, 1) sums, summed over
// the lanes that differ from l in the bits it took: sums S / 32 l + c at
// S >= 32, sum l mod S below
template <int S, int Bit>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  reduce_level<S / 2>(v, lane, Bit);
  if constexpr (Bit > 1) reduce_scatter<S / 2, Bit / 2>(v, lane);
}

template <int kN>
__global__ void __launch_bounds__(kWarpSize * reg_warps(kN))
    iss1_sweep_kernel_regs(const float2* __restrict__ Y_in,  // (N, I, T)
                           const float* __restrict__ phi,    // (N, T) or (N, I, T)
                           float2* __restrict__ Y_out,       // (N, I, T)
                           int N, int I, int T, long long phi_src_stride, long long phi_bin_stride,
                           float eps) {
  constexpr int kF = reg_frames(kN), kS = 4 * kN;  // sums: Re num, Im num, denom, zero
  constexpr int kKeep = kS >= kWarpSize ? kS / kWarpSize : 1;
  constexpr int kBit = kS / 2 < 16 ? kS / 2 : 16;
  __shared__ float table[2][reg_warps(kN)][kS];  // the warps' partial sums, double-buffered
  __shared__ float2 v_slot[reg_warps(kN)][kN];    // each warp's copy of v

  const int i = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & (kWarpSize - 1), warp = tid / kWarpSize, n_warps = nt / kWarpSize;
  const long long src_stride = (long long)I * T;  // Y[m, i, t] = Y[m * I * T + i * T + t]
  const float2* y_in = Y_in + (long long)i * T;
  const float* w_in = phi + (long long)i * phi_bin_stride;

  // this thread's frames; rows past N and frames past T hold zeros
  float2 y[kF][kN];
  float w[kF][kN];
#pragma unroll
  for (int j = 0; j < kF; ++j) {
    const int t = tid + j * nt;
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      const bool ok = t < T && m < N;
      y[j][m] = ok ? y_in[m * src_stride + t] : make_float2(0.f, 0.f);
      w[j][m] = ok ? w_in[m * phi_src_stride + t] : 0.f;
    }
  }

  const float inv_frames = 1.f / (float)T;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    if (n >= N) break;
    // this thread's frames into the 4 kN sums of source n: each term rounds
    // as iss1_sweep_plain's operators round it (the complex product with
    // conj(y_n), then the weight; |y_n|^2 as two squares and a sum)
    float acc[kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) acc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      const float2 ys = y[j][n];
      const float ys2 = __fadd_rn(__fmul_rn(ys.x, ys.x), __fmul_rn(ys.y, ys.y));
#pragma unroll
      for (int m = 0; m < kN; ++m) {
        const float wm = w[j][m];
        acc[m] = fmaf(wm, __fmaf_rn(y[j][m].x, ys.x, __fmul_rn(y[j][m].y, ys.y)), acc[m]);
        acc[kN + m] = fmaf(wm, __fmaf_rn(-y[j][m].x, ys.y, __fmul_rn(y[j][m].y, ys.x)), acc[kN + m]);
        acc[2 * kN + m] = fmaf(wm, ys2, acc[2 * kN + m]);
      }
    }
    reduce_scatter<kS, kBit>(acc, lane);
    if constexpr (kS < kWarpSize) {  // the lane bits the reduce-scatter left: a butterfly
#pragma unroll
      for (int bit = kS; bit < kWarpSize; bit <<= 1) acc[0] = __fadd_rn(acc[0], __shfl_xor_sync(kFull, acc[0], bit));
    }
    float* part = &table[n & 1][0][0];
    if constexpr (kS >= kWarpSize) {
#pragma unroll
      for (int c = 0; c < kKeep; ++c) part[warp * kS + lane * kKeep + c] = acc[c];
    } else {
      if (lane < kS) part[warp * kS + lane] = acc[0];
    }
    __syncthreads();

    // lane m < N: v[m] from the warps' partials of row m, added in warp
    // order, then rounded as the plain version's mean, division and
    // reciprocal square root round it; the warp reads v back from its slot
    {
      const int l = lane < kN ? lane : 0;
      float num_re = 0.f, num_im = 0.f, den = 0.f;
      for (int q = 0; q < n_warps; ++q) {
        num_re += part[q * kS + l];
        num_im += part[q * kS + kN + l];
        den += part[q * kS + 2 * kN + l];
      }
      float denom = __fmul_rn(den, inv_frames);
      denom = denom < eps ? eps : denom;  // a NaN stays NaN, as with max()
      const float rd = __frcp_rn(denom);
      const float2 off = make_float2(__fmul_rn(__fmul_rn(num_re, inv_frames), rd),
                                     __fmul_rn(__fmul_rn(num_im, inv_frames), rd));
      const float2 own = make_float2(__fsub_rn(1.f, __frcp_rn(__fsqrt_rn(denom))), 0.f);
      if (lane < kN) v_slot[warp][lane] = lane < N ? (lane == n ? own : off) : make_float2(0.f, 0.f);
    }
    __syncwarp();
    float2 vm[kN];
#pragma unroll
    for (int m = 0; m < kN; ++m) vm[m] = v_slot[warp][m];
    __syncwarp();  // every lane has read the slot before the next source writes it

    // Y -= v y_n at this thread's frames, with the y_n of before the update
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      const float2 yn = y[j][n];
#pragma unroll
      for (int m = 0; m < kN; ++m) {
        const float2 t = make_float2(__fmaf_rn(vm[m].x, yn.x, -__fmul_rn(vm[m].y, yn.y)),
                                     __fmaf_rn(vm[m].x, yn.y, __fmul_rn(vm[m].y, yn.x)));
        y[j][m] = make_float2(__fsub_rn(y[j][m].x, t.x), __fsub_rn(y[j][m].y, t.y));
      }
    }
  }

  float2* y_out = Y_out + (long long)i * T;
#pragma unroll
  for (int j = 0; j < kF; ++j) {
    const int t = tid + j * nt;
#pragma unroll
    for (int m = 0; m < kN; ++m)
      if (t < T && m < N) y_out[m * src_stride + t] = y[j][m];
  }
}

// ---- resident and streamed: one block per bin, Y in shared or device memory -------------

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

// Every pass gives each thread the same frames (t = tid, tid + blockDim,
// ...), so no thread reads a value that another thread wrote, except through
// the block reduction. Pass 0 loads Y and accumulates the 3N sums of source
// 0; then, for each source n, the block reduces the sums, thread m forms
// v[m], and after a barrier every thread updates all N rows at its frames
// and, in the same pass, accumulates the sums of source n + 1.
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

enum Variant { kStreamed = 0, kResident = 1, kRegisters = 2 };

template <int kN>
cudaError_t launch(const void* Y, const void* phi, void* Y_out, int N, int I, int T, int per_bin,
                   int variant, float eps, cudaStream_t stream) {
  const long long phi_src_stride = per_bin ? (long long)I * T : (long long)T;
  const long long phi_bin_stride = per_bin ? (long long)T : 0;
  if (variant == kRegisters) {
    const int warps = (T + kWarpSize * reg_frames(kN) - 1) / (kWarpSize * reg_frames(kN));
    if (warps > reg_warps(kN)) return cudaErrorInvalidValue;
    iss1_sweep_kernel_regs<kN><<<I, warps * kWarpSize, 0, stream>>>(
        (const float2*)Y, (const float*)phi, (float2*)Y_out, N, I, T, phi_src_stride, phi_bin_stride, eps);
    return cudaGetLastError();
  }
  const int resident = variant == kResident;
  const int stage_phi = resident && per_bin;
  const long long smem = kHeaderBytes + (resident ? (long long)N * T * 8 : 0) +
                         (stage_phi ? (long long)N * T * 4 : 0);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const int warps_of_frames = ((T + 31) / 32) * 32;
  const int threads = warps_of_frames < kMaxThreads ? warps_of_frames : kMaxThreads;
  auto kernel = iss1_sweep_kernel<kN>;
  if (smem > 48 * 1024) {
    cudaError_t status =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (status != cudaSuccess) return status;
  }
  kernel<<<I, threads, (size_t)smem, stream>>>((const float2*)Y, (const float*)phi, (float2*)Y_out, N, I, T,
                                               phi_src_stride, phi_bin_stride, resident, stage_phi, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Y, Y_out: complex64 (N, I, T); phi: float32 (N, T), or (N, I, T) when
// per_bin. All contiguous on `device`, Y_out not aliasing Y. `variant`
// selects the register variant (2), the resident one (1) or the streamed
// one (0); the first two need the bin in registers or in shared memory,
// which the wrapper checks first (ops/kernels.py:iss1_sweep_variant), and a
// variant that cannot take the shape returns cudaErrorInvalidValue.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int iss1_sweep_launch(const void* Y, const void* phi, void* Y_out, int N, int I, int T,
                      int per_bin, int variant, float eps, int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (N < 1 || N > kMaxSources || I < 1 || T < 1 || variant < kStreamed || variant > kRegisters)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 2)
    status = launch<2>(Y, phi, Y_out, N, I, T, per_bin, variant, eps, s);
  else if (N <= 4)
    status = launch<4>(Y, phi, Y_out, N, I, T, per_bin, variant, eps, s);
  else if (N <= 8)
    status = launch<8>(Y, phi, Y_out, N, I, T, per_bin, variant, eps, s);
  else
    status = launch<16>(Y, phi, Y_out, N, I, T, per_bin, variant, eps, s);
  return (int)status;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

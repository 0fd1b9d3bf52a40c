// One round of the IPA congruence sweep, per frequency bin:
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
// Design. The TPU kernel is one program with the bins in the 128 lanes,
// planar real and imaginary operands, and T^H made outside to avoid sublane
// shuffles; none of that carries over. Here the work is I (S + 1) items, a
// bin's S congruences and its T G, on native interleaved complex (float2),
// so that G' is one more independent item and not a serial tail. A template
// on N, every loop unrolled, instanced at each N up to kMaxN: a group of
// lanes of one warp owns an item, row_lanes(N) lanes a row, each lane
// owning lane_columns(N) consecutive columns of its row (at N = 8: four
// lanes a row, two columns a lane, one item a warp; at N = 2: two lanes a
// row, one column a lane, eight items a warp). kBlockWarps warps a block,
// which share nothing: no block barrier. A lane loads its entries of T and
// of its U[s] (or G), 16 bytes at a time where its columns pair up, and
// copies them into its group's region of shared memory (rows row_stride(N)
// complex64 apart, so that the row reads below spread over the banks); one
// __syncwarp() of the group; it forms A[r, j] = sum_k T[r,k] U[k,j] for its
// columns j from row r of T and the rows of U, puts them beside the other
// lanes' in shared memory, and after another __syncwarp() forms
// C[r, j] = sum_k A[r,k] conj(T[j,k]) from row r of A and rows j of T, and
// stores them. Each sum runs in k order with fused multiply-adds,
// gj::cmadd's form. A fixed order and no atomics: two launches give the
// same bits.
// Why so many lanes an item: a first form of this redesign gave a group of
// N lanes an item (lane r owning row r). Unrolled at N = 8 it ran only about
// a fifth faster than the first design (one block of S N^2 threads per bin,
// two block barriers, G' on N^2 threads after them): each lane's chain of
// 2 N^2 multiply-adds, with one warp a scheduler, was not hidden; its
// instance for a runtime N ran 1.9x as slow as the first design at N = 8
// and 1.8x at N = 16. Spreading a row over
// 32 / N lanes shortens the chain by as much and multiplies the warps; as
// one-warp blocks the 2,313 items at N = 8 ran no faster, because the
// launch of 2,313 blocks alone (an empty kernel) took most of the time;
// four warps a block cut the blocks to 579. Measured: PERF.md, section 6.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 16;  // sources and channels per bin
constexpr int kWarpSize = 32;
constexpr int kBlockWarps = 4;  // warps a block, which share nothing

__device__ __forceinline__ float2 cmadd(float2 acc, float2 a, float2 b) {  // gj::cmadd
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
  return acc;
}

__device__ __forceinline__ float2 conjugate(float2 a) { return make_float2(a.x, -a.y); }

// ---- the layout at N ----------------------------------------------------------------
// Chosen so that the most lanes share an item's rows while its group stays
// inside one warp: a row is kept by row_lanes(N) lanes, each owning
// lane_columns(N) consecutive columns, and 32 / (N row_lanes(N)) groups share
// a warp. At N = 8: four lanes a row, two columns a lane, one item a warp.

// lanes a row at most: N of them, and N of those rows in one warp
__host__ __device__ constexpr int row_lanes_most(int n) { return n < kWarpSize / n ? n : kWarpSize / n; }
// the columns those lanes leave each, made even at even N (so that a lane's
// columns go 16 bytes at a time) unless it is one
__host__ __device__ constexpr int lane_columns(int n) {
  const int columns = (n + row_lanes_most(n) - 1) / row_lanes_most(n);
  return n % 2 == 0 && columns % 2 == 1 && columns > 1 ? columns + 1 : columns;
}
__host__ __device__ constexpr int row_lanes(int n) { return (n + lane_columns(n) - 1) / lane_columns(n); }
__host__ __device__ constexpr bool paired(int n) { return n % 2 == 0 && lane_columns(n) % 2 == 0; }
// complex64 between staged rows: where a lane reads in pairs, the least
// >= N + 2 that is 2 modulo 4 (each row then starts 16 bytes aligned and an
// odd count of 16-byte bank quads past the row before it, so that eight
// consecutive rows start on eight distinct quads); else N or N + 1,
// whichever is odd (consecutive rows on distinct 8-byte bank pairs)
__host__ __device__ constexpr int row_stride(int n) { return paired(n) ? (n % 4 == 0 ? n + 2 : n + 4) : (n | 1); }
__host__ __device__ constexpr int group_lanes(int n) { return n * row_lanes(n); }
__host__ __device__ constexpr int warp_groups(int n) { return kWarpSize / group_lanes(n); }

// two consecutive complex64, 16 bytes at a time when `vec`
__device__ __forceinline__ void load2(float2& a, float2& b, const float2* src, bool vec) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    a = make_float2(v.x, v.y);
    b = make_float2(v.z, v.w);
  } else {
    a = src[0];
    b = src[1];
  }
}

__device__ __forceinline__ void store2(float2* dst, float2 a, float2 b, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  } else {
    dst[0] = a;
    dst[1] = b;
  }
}

// row `src` of N staged complex64 into registers, 16 bytes at a time where the layout pairs them
template <int N>
__device__ __forceinline__ void load_row(float2 (&row)[N], const float2* src) {
  if constexpr (paired(N)) {
#pragma unroll
    for (int c = 0; c < N; c += 2) load2(row[c], row[c + 1], src + c, true);
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) row[c] = src[c];
  }
}

template <int N>
__global__ void __launch_bounds__(kBlockWarps * kWarpSize)
    ipa_congruence_kernel(const float2* __restrict__ T_in,   // (I, N, N)
                          const float2* __restrict__ U_in,   // (I, S, N, N)
                          const float2* __restrict__ G_in,   // (I, N, N)
                          float2* __restrict__ U_out,        // (I, S, N, N)
                          float2* __restrict__ G_out,        // (I, N, N)
                          int items, int S, bool vec) {
  constexpr int NN = N * N, CL = lane_columns(N), RL = row_lanes(N), GL = group_lanes(N);
  constexpr int GW = warp_groups(N), LD = row_stride(N), kRegion = 3 * N * LD, kStep = paired(N) ? 2 : 1;
  __shared__ __align__(16) float2 stage[kBlockWarps][GW * kRegion];  // per group: T, U and A
  const int warp = threadIdx.x / kWarpSize, lane = threadIdx.x % kWarpSize, g = lane / GL;
  const int item = (blockIdx.x * kBlockWarps + warp) * GW + g;
  if (g >= GW || item >= items) return;  // whole groups: lanes past the last group, groups past the last item
  const unsigned group = GL == kWarpSize ? 0xffffffffu : ((1u << GL) - 1) << (g * GL);
  float2 *Ts = stage[warp] + g * kRegion, *Us = Ts + N * LD, *As = Us + N * LD;
  const int e = lane - g * GL, r = e / RL, c0 = CL * (e - r * RL);  // row r, columns c0 .. c0 + CL - 1
  const int bin = item / (S + 1), s = item - bin * (S + 1);
  const bool is_g = s == S;  // the T G item of its bin
  const float2* src = is_g ? G_in + (long long)bin * NN : U_in + ((long long)bin * S + s) * NN;
  float2* dst = (is_g ? G_out + (long long)bin * NN : U_out + ((long long)bin * S + s) * NN) + r * N;
  const float2* t_src = T_in + (long long)bin * NN + r * N;

#pragma unroll
  for (int c = 0; c < CL; c += kStep) {
    const int j = c0 + c;
    if (j < N) {
      if constexpr (paired(N)) {
        float2 t0, t1, u0, u1;
        load2(t0, t1, t_src + j, vec);
        load2(u0, u1, src + r * N + j, vec);
        store2(Ts + r * LD + j, t0, t1, true);
        store2(Us + r * LD + j, u0, u1, true);
      } else {
        Ts[r * LD + j] = t_src[j];
        Us[r * LD + j] = src[r * N + j];
      }
    }
  }
  __syncwarp(group);

  // A[r, j] = sum_k T[r,k] U[k,j] for the lane's columns j, k ascending
  float2 row[N], a[CL];
  load_row<N>(row, Ts + r * LD);
#pragma unroll
  for (int c = 0; c < CL; ++c) a[c] = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int c = 0; c < CL; c += kStep) {
      if (c0 + c < N) {
        if constexpr (paired(N)) {
          float2 x0, x1;
          load2(x0, x1, Us + k * LD + c0 + c, true);
          a[c] = cmadd(a[c], row[k], x0);
          a[c + 1] = cmadd(a[c + 1], row[k], x1);
        } else {
          a[c] = cmadd(a[c], row[k], Us[k * LD + c0 + c]);
        }
      }
    }
  }
  if (!is_g) {
#pragma unroll
    for (int c = 0; c < CL; c += kStep) {
      if (c0 + c < N) {
        if constexpr (paired(N)) {
          store2(As + r * LD + c0 + c, a[c], a[c + 1], true);
        } else {
          As[r * LD + c0 + c] = a[c];
        }
      }
    }
    __syncwarp(group);
    // C[r, j] = sum_k A[r,k] conj(T[j,k]) for the lane's columns j, k ascending
    load_row<N>(row, As + r * LD);
#pragma unroll
    for (int c = 0; c < CL; ++c) {
      if (c0 + c < N) {
        float2 trow[N];
        load_row<N>(trow, Ts + (c0 + c) * LD);
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < N; ++k) acc = cmadd(acc, row[k], conjugate(trow[k]));
        a[c] = acc;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CL; c += kStep) {
    if (c0 + c < N) {
      if constexpr (paired(N)) {
        store2(dst + c0 + c, a[c], a[c + 1], vec);
      } else {
        dst[c0 + c] = a[c];
      }
    }
  }
}

template <int N>
int launch(const float2* t, const float2* u, const float2* g, float2* uo, float2* go, long long items, int S,
           bool aligned, cudaStream_t stream) {
  constexpr int per_block = kBlockWarps * warp_groups(N);
  ipa_congruence_kernel<N><<<(unsigned)((items + per_block - 1) / per_block), kBlockWarps * kWarpSize, 0, stream>>>(
      t, u, g, uo, go, (int)items, S, paired(N) && aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// T, G, G_out: complex64 (I, N, N); U, U_out: complex64 (I, S, N, N); all
// contiguous on `device`, the outputs aliasing no input. 1 <= N, S <= 16 and
// I (S + 1) < 2^31. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int ipa_congruence_launch(const void* T, const void* U, const void* G, void* U_out, void* G_out,
                          int I, int S, int N, int device, void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (I < 1 || S < 1 || N < 1 || S > kMaxN || N > kMaxN) return (int)cudaErrorInvalidValue;
  const long long items = (long long)I * (S + 1);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float2 *t = (const float2*)T, *u = (const float2*)U, *g = (const float2*)G;
  float2 *uo = (float2*)U_out, *go = (float2*)G_out;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte accesses to device memory: every pair of columns is aligned when the tensors are
  const bool aligned = ((reinterpret_cast<unsigned long long>(T) | reinterpret_cast<unsigned long long>(U) |
                         reinterpret_cast<unsigned long long>(G) | reinterpret_cast<unsigned long long>(U_out) |
                         reinterpret_cast<unsigned long long>(G_out)) & 15) == 0;
  static_assert(kMaxN == 16, "the cases below launch every N up to kMaxN");
  switch (N) {
    case 1: return launch<1>(t, u, g, uo, go, items, S, aligned, s);
    case 2: return launch<2>(t, u, g, uo, go, items, S, aligned, s);
    case 3: return launch<3>(t, u, g, uo, go, items, S, aligned, s);
    case 4: return launch<4>(t, u, g, uo, go, items, S, aligned, s);
    case 5: return launch<5>(t, u, g, uo, go, items, S, aligned, s);
    case 6: return launch<6>(t, u, g, uo, go, items, S, aligned, s);
    case 7: return launch<7>(t, u, g, uo, go, items, S, aligned, s);
    case 8: return launch<8>(t, u, g, uo, go, items, S, aligned, s);
    case 9: return launch<9>(t, u, g, uo, go, items, S, aligned, s);
    case 10: return launch<10>(t, u, g, uo, go, items, S, aligned, s);
    case 11: return launch<11>(t, u, g, uo, go, items, S, aligned, s);
    case 12: return launch<12>(t, u, g, uo, go, items, S, aligned, s);
    case 13: return launch<13>(t, u, g, uo, go, items, S, aligned, s);
    case 14: return launch<14>(t, u, g, uo, go, items, S, aligned, s);
    case 15: return launch<15>(t, u, g, uo, go, items, S, aligned, s);
    case 16: return launch<16>(t, u, g, uo, go, items, S, aligned, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

// Batched real symmetric eigendecomposition by fixed-sweep round-robin
// Jacobi, one matrix per warp (or per n lanes of one).
//
// Replaces: ssspy_tpu/ops/pallas_kernels.py:jacobi_eigh_lanes (:894; its
// pl.pallas_call :926, the Pallas kernel _jacobi_lanes_kernel) and the XLA
// form ssspy_tpu/ops/jacobi.py:jacobi_eigh. Same iteration: `sweeps` passes
// over the rounds of the round-robin schedule (ops/kernels.py:round_pairs;
// the bye of odd n keeps c = 1, s = 0); per pair (p, q) the symmetrised
// a_pq = (A[p,q] + A[q,p]) / 2, tau = (a_qq - a_pp) / (2 a_pq),
// t = sgn(tau) / (|tau| + sqrt(1 + tau^2)) with sgn(0) = +1, t = 0 where
// |a_pq| < tiny, c = 1 / sqrt(1 + t^2), s = t c; then the row pass
// (row p <- c row p - s row q, row q <- c row q + s row p), the column pass
// with the same coefficients, and V on its columns. lambda is the final
// diagonal, sorted ascending (stable, NaN last) with V's columns. Every
// product and sum is rounded on its own (__fmul_rn, __fadd_rn, no FMA
// contraction), as the plain version's separate tensor operations are, so
// the kernel is bit-identical to ops/kernels.py:jacobi_eigh_plain.
//
// Bound on the H100: per matrix A is read once and lambda and V written
// once, B (2 n^2 + n) 4 bytes; each round's three passes (rows of A,
// columns of A, columns of V) cost 3 n^2 flops each, 9 n^2 (n - 1) per
// sweep at even n: 207,360 flops per matrix at n = 16. At 67 TFLOP/s in
// f32, operations bound it: 0.80 us at B = 257, 0.50 ms at B = 160,882.
//
// What held the first design back: one block of n^2 threads per matrix,
// with three block barriers per round, 270 in a chain at n = 16, about
// 690 ns a round whatever the batch (152 waves of ~62 us at B = 160,882).
// Here n lanes of one warp own a matrix (floor(32 / n) matrices to a warp,
// four warps to a block) and lane j owns column j of A and row j of V, so
// no block barrier is left:
// - the rotation: lane j takes A[pj, j] out of its column and carries
//   A[j, j] from the previous round, trades both with its partner lane pj
//   by __shfl_sync and forms the pair's (c, s) itself (both lanes of a
//   pair compute the same numbers), then publishes its (c, s') in a
//   warp-private slot of shared memory; a small pair skips its divisions;
// - after one __syncwarp, the row pass of A (rows p and q of column j) and
//   the column pass of V (entries p and q of row j) are lane-local;
// - the column pass of A trades column j for column pj by n shuffles.
// For the even sizes the paths launch (n = 8, 10: IPSDTA; 14: IPA; 16:
// prox, MNMF, the eigh model; 32: the hard tier) the kernel is a template
// on n that keeps A's column and V's row in registers, in the order of the
// round's positions (see the kernel), so that each round pairs fixed
// registers and the round loop stays rolled: unrolled, it outgrew the
// instruction cache. Every other 2 <= n <= 32 takes one generic instance
// that keeps them in the warp's shared memory, entry (i, lane) at
// i * 32 + lane (no bank conflict). At small batch a call is the chain of
// 6 (n - 1) rounds, each bound by the rotation's five correctly rounded
// divisions and square roots in a row; at large batch the f32 pipe and
// the shuffles bound it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kWarps = 4;  // warps per block, each on its own matrices
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// The round-robin schedule of ops/kernels.py:round_pairs(n), the circle
// method on m = n + (n odd) players: player 0 stays at position 0, the
// others move one place per round (position k to k + 1, the last to 1), and
// position k meets position m - 1 - k. `span` = m - 1, the rounds of a sweep.
__host__ __device__ constexpr int rr_position(int span, int r, int x) { return x == 0 ? 0 : 1 + (x - 1 + r) % span; }

__host__ __device__ constexpr int rr_player(int span, int r, int k) {
  return k == 0 ? 0 : 1 + ((k - 1 - r) % span + span) % span;
}

// Partner of index x in round r; a partner n (the virtual player of odd n)
// is the bye: x is its own partner.
__host__ __device__ constexpr int rr_partner(int n, int r, int x) {
  const int span = n + (n & 1) - 1;
  const int y = rr_player(span, r, span - rr_position(span, r, x));
  return y >= n ? x : y;
}

// x[idx] for a run-time idx, by a tree of selects over idx's bits (no
// dynamic register index, which would put x in local memory)
template <int N>
__device__ __forceinline__ float pick(const float (&x)[N], int idx) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    float half[(N + 1) / 2];
    const bool odd = idx & 1;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) half[k] = odd ? x[2 * k + 1] : x[2 * k];
    if constexpr (N % 2 == 1) half[N / 2] = x[N - 1];
    return pick<(N + 1) / 2>(half, idx >> 1);
  }
}

// (c, s') of index j in a round: s' = -s at p = min(j, pj), +s at q.
// app, aqq and the pair's off-diagonal sum are the same on both lanes. The
// plain version's t = sgn(tau) / d and c = 1 / sqrt(.) are the correctly
// rounded reciprocals __frcp_rn, with the sign applied after, and a small
// pair (t = 0, c = 1, s = 0 whatever tau is) skips tau: the same bits, and
// no division of a pair the sweeps have already zeroed (whose quotients
// take the division's slow path).
__device__ __forceinline__ float2 rotation(float d, float e, float d_partner, float e_partner, bool first,
                                           bool bye, float tiny) {
  const float app = first ? d : d_partner, aqq = first ? d_partner : d;
  // a_pq + a_qp: lane p holds a_qp (e) and receives a_pq; float addition commutes
  const float apq = mul(add(e_partner, e), 0.5f);
  const bool small = fabsf(apq) < tiny || bye;
  float t = 0.f;
  if (!small) {
    const float tau = __fdiv_rn(add(aqq, -app), mul(2.f, apq));
    const float r = __frcp_rn(add(fabsf(tau), __fsqrt_rn(add(1.f, mul(tau, tau)))));
    t = tau >= 0.f ? r : -r;
  }
  const float c = __frcp_rn(__fsqrt_rn(add(1.f, mul(t, t))));
  const float s = mul(t, c);
  return make_float2(c, first ? -s : s);
}

__device__ __forceinline__ float mix(float2 cs, float own, float other) {
  return add(mul(cs.x, own), mul(cs.y, other));
}

// Rank of lane j's eigenvalue d among the n of its matrix: ascending, ties
// by index, NaN last (the plain version's stable sort).
__device__ __forceinline__ int rank_of(float d, int j, int n, int base) {
  const bool nan_k = isnan(d);
  int r = 0;
  for (int m = 0; m < n; ++m) {
    const float lm = __shfl_sync(kFull, d, base + m);
    const bool nan_m = isnan(lm);
    const bool before = (nan_k || nan_m) ? (nan_k && (!nan_m || m < j)) : (lm < d || (lm == d && m < j));
    r += before ? 1 : 0;
  }
  return r;
}

// One warp slot of (c, s') per lane, with room for the idle lanes past the
// last matrix of a warp to read (base + n <= 64).
struct Coef {
  float2 slot[kWarps][2 * 32];
};

// ---- templated on even n: A's column and V's row in registers ----------------------
//
// Lane j keeps column j of A and row j of V in the order of the round's
// positions, a[k] = A[player(k), j] and v[k] = V[j, player(k)], so that the
// pairs of every round are the fixed (k, N - 1 - k) and the round loop need
// not be unrolled (unrolled, 90 rounds of n = 16 overflow the instruction
// cache); after each round the registers move one position, as the players
// do, and after a sweep they are back in index order.

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
    jacobi_eigh_kernel(const float* __restrict__ A_in,  // (B, N, N)
                       float* __restrict__ lamb_out,    // (B, N)
                       float* __restrict__ V_out,       // (B, N, N)
                       int B, int sweeps, float tiny) {
  static_assert(N % 2 == 0, "odd n has a bye; it takes the generic instance");
  constexpr int G = 32 / N;   // matrices per warp
  constexpr int span = N - 1;  // rounds per sweep
  __shared__ Coef coef_s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / N, j = lane - g * N, base = g * N;
  const long long b = ((long long)blockIdx.x * kWarps + warp) * G + g;
  const bool live = g < G && b < B;
  float2* coef = coef_s.slot[warp];

  float a[N], v[N];
  const float* Ab = A_in + (live ? b : 0) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = live ? Ab[i * N + j] : 0.f;
    v[i] = i == j ? 1.f : 0.f;
  }

  // d: this lane's diagonal entry A[j, j], carried from round to round (the
  // passes' own arithmetic on the four entries of the pair, so the same
  // bits as the entry in a); the round's positions, carried as well
  float d = pick(a, j);
  int pos = rr_position(span, 0, j), partner_pos = span - pos, pj = rr_player(span, 0, partner_pos);
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll 1
    for (int r = 0; r < span; ++r) {
      const float e = pick(a, partner_pos);  // A[pj, j]
      const float d_partner = __shfl_sync(kFull, d, base + pj);
      const float e_partner = __shfl_sync(kFull, e, base + pj);
      const float2 cs = rotation(d, e, d_partner, e_partner, j < pj, false, tiny);
      coef[base + pos] = cs;
      __syncwarp();
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const int q = N - 1 - k;
        const float2 ck = coef[base + k], cq = coef[base + q];
        const float ak = a[k], aq = a[q], vk = v[k], vq = v[q];
        a[k] = mix(ck, ak, aq);
        a[q] = mix(cq, aq, ak);
        v[k] = mix(ck, vk, vq);
        v[q] = mix(cq, vq, vk);
      }
      __syncwarp();  // every slot read before the next round writes it
      // A[j, j] after the round: the row pass gave B[j, j] here and
      // B[j, pj] in the partner's column, the column pass mixes the two
      d = mix(cs, mix(cs, d, e), mix(cs, e_partner, d_partner));
      const int next = r + 1 == span ? 0 : r + 1;
      pos = rr_position(span, next, j);
      partner_pos = span - pos;
      const int pj_next = rr_player(span, next, partner_pos);
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] = mix(cs, a[i], __shfl_sync(kFull, a[i], base + pj));
      pj = pj_next;
      const float a_last = a[N - 1], v_last = v[N - 1];
#pragma unroll
      for (int k = N - 1; k > 1; --k) {
        a[k] = a[k - 1];
        v[k] = v[k - 1];
      }
      a[1] = a_last;
      v[1] = v_last;
    }
  }

  const int rank = rank_of(d, j, N, base);
  if (live) lamb_out[b * N + rank] = d;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int rk = __shfl_sync(kFull, rank, base + k);
    if (live) V_out[b * N * N + j * N + rk] = v[k];
  }
}

// ---- generic: any 2 <= n <= 32, A's column and V's row in shared memory ----------

__global__ void __launch_bounds__(kWarps * 32)
    jacobi_eigh_kernel_smem(const float* __restrict__ A_in, float* __restrict__ lamb_out,
                            float* __restrict__ V_out, int B, int n, int sweeps, float tiny) {
  __shared__ Coef coef_s;
  __shared__ float a_s[kWarps][kMaxN * 32];
  __shared__ float v_s[kWarps][kMaxN * 32];
  const int G = 32 / n, R = n + (n & 1) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / n, j = lane - g * n, base = g * n;
  const long long b = ((long long)blockIdx.x * kWarps + warp) * G + g;
  const bool live = g < G && b < B;
  float2* coef = coef_s.slot[warp];
  float* a = a_s[warp] + lane;  // a[i * 32]: entry (i, j) of this lane's matrix
  float* v = v_s[warp] + lane;  // v[k * 32]: entry (j, k) of V

  const float* Ab = A_in + (live ? b : 0) * n * n;
  for (int i = 0; i < n; ++i) {
    a[i * 32] = live ? Ab[i * n + j] : 0.f;
    v[i * 32] = i == j ? 1.f : 0.f;
  }

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < R; ++r) {
      const int pj = rr_partner(n, r, j);
      const float d = a[j * 32], e = a[pj * 32];
      const float d_partner = __shfl_sync(kFull, d, base + pj);
      const float e_partner = __shfl_sync(kFull, e, base + pj);
      const float2 cs = rotation(d, e, d_partner, e_partner, j <= pj, j == pj, tiny);
      coef[lane] = cs;
      __syncwarp();
      for (int x = 0; x < n; ++x) {
        const int y = rr_partner(n, r, x);
        if (x < y) {
          const float2 cx = coef[base + x], cy = coef[base + y];
          const float ax = a[x * 32], ay = a[y * 32], vx = v[x * 32], vy = v[y * 32];
          a[x * 32] = mix(cx, ax, ay);
          a[y * 32] = mix(cy, ay, ax);
          v[x * 32] = mix(cx, vx, vy);
          v[y * 32] = mix(cy, vy, vx);
        } else if (x == y) {
          const float2 cx = coef[base + x];
          a[x * 32] = mix(cx, a[x * 32], a[x * 32]);
          v[x * 32] = mix(cx, v[x * 32], v[x * 32]);
        }
      }
      __syncwarp();
      for (int i = 0; i < n; ++i) a[i * 32] = mix(cs, a[i * 32], __shfl_sync(kFull, a[i * 32], base + pj));
    }
  }

  const float d = a[j * 32];
  const int rank = rank_of(d, j, n, base);
  if (live) lamb_out[b * n + rank] = d;
  for (int k = 0; k < n; ++k) {
    const int rk = __shfl_sync(kFull, rank, base + k);
    if (live) V_out[b * n * n + j * n + rk] = v[k * 32];
  }
}

template <int N>
void launch_reg(const float* A, float* lamb, float* V, int B, int sweeps, float tiny, cudaStream_t stream) {
  const int per_block = kWarps * (32 / N);
  jacobi_eigh_kernel<N><<<(B + per_block - 1) / per_block, kWarps * 32, 0, stream>>>(A, lamb, V, B, sweeps, tiny);
}

}  // namespace

extern "C" {

// A, V: float32 (B, n, n); lamb: float32 (B, n). All contiguous on
// `device`, outputs not aliasing A. 2 <= n <= 32. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
int jacobi_eigh_launch(const void* A, void* lamb, void* V, int B, int n, int sweeps, float tiny, int device,
                       void* stream) {
  cudaError_t status = cudaSetDevice(device);
  if (status != cudaSuccess) return (int)status;
  if (B < 1 || n < 2 || n > kMaxN || sweeps < 0) return (int)cudaErrorInvalidValue;
  const float* a = (const float*)A;
  float* l = (float*)lamb;
  float* v = (float*)V;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 8: launch_reg<8>(a, l, v, B, sweeps, tiny, s); break;
    case 10: launch_reg<10>(a, l, v, B, sweeps, tiny, s); break;
    case 14: launch_reg<14>(a, l, v, B, sweeps, tiny, s); break;
    case 16: launch_reg<16>(a, l, v, B, sweeps, tiny, s); break;
    case 32: launch_reg<32>(a, l, v, B, sweeps, tiny, s); break;
    default: {
      const int per_block = kWarps * (32 / n);
      jacobi_eigh_kernel_smem<<<(B + per_block - 1) / per_block, kWarps * 32, 0, s>>>(a, l, v, B, n, sweeps,
                                                                                        tiny);
    }
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

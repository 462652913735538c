// Shared device code of the exact-mode round kernels (sv_rounds.cuh, for
// sv_round3_first.cu, sv_round3.cu and sv_round2.cu) and the point block
// (sv_point.cu): the exact-mode kNN selection kernel over a channel-major
// (B, C, N) or a row-major (B, N, C) source, a shared-memory block GEMM,
// and small helpers.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SV_EPS 1e-6f
// dynamic shared memory a block may ask for (H100: 227 KB of 256 KB per SM)
#define SV_SMEM_LIMIT (220 * 1024)

typedef unsigned long long sv_u64;

// jnp.sign: 0 at 0, so a binarized product term vanishes there.
static __device__ __forceinline__ float sv_sign(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

// (a*b + c*d) + e*f, each operation rounded on its own (no FMA). The
// Vector2Scalar invariants that feed a sign() are computed this way, and
// their frames z as sequential channel sums of rounded products, so that
// they are bitwise those of the plain versions and binarize alike.
static __device__ __forceinline__ float sv_dot3_rn(float a, float b, float c,
                                                   float d, float e, float f) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d)), __fmul_rn(e, f));
}

static __device__ __forceinline__ float sv_leaky(float y) {
  return y >= 0.f ? y : 0.2f * y;
}

// Negative squared distance 2*inner - |ctr|^2 - |cand|^2, in that order and
// rounded op by op with no FMA contraction, like the plain version
// (svnet_tpu_torch/ops/knn.py::pairwise_neg_sqdist); a row's distance to
// itself is exactly 0 because inner and the norms are summed in the same
// channel order (sv_sqnorm_kernel below).
static __device__ __forceinline__ float sv_neg_dist(float inner, float ctr_sq,
                                                    float cand_sq) {
  return __fsub_rn(__fsub_rn(__fmul_rn(2.f, inner), ctr_sq), cand_sq);
}

// Exact-mode neighbour key (svnet_tpu/ops/pallas/sv_round3.py:194-196): the
// sortable-int bits of the f32 distance with the sign bit flipped, so the
// unsigned order is the float order (-0.0 below +0.0). 0 is never the key
// of a non-NaN distance and marks a removed candidate.
static __device__ __forceinline__ unsigned sv_ukey(float neg) {
  const int bits = __float_as_int(neg);
  const int key = bits < 0 ? (bits ^ 0x7FFFFFFF) : bits;
  return ((unsigned)key) ^ 0x80000000u;
}

// (key, row) packed into one unique value: the low word is N-1-row, so
// among equal keys the smallest row is the largest value -- the min-row
// tie-break of sv_round3.py:441-451.
static __device__ __forceinline__ sv_u64 sv_pack(unsigned ukey, int row, int N) {
  return ukey == 0u ? 0ull
                    : (((sv_u64)ukey << 32) | (sv_u64)(unsigned)(N - 1 - row));
}

static __device__ __forceinline__ sv_u64 sv_warp_max_u64(sv_u64 v) {
  for (int off = 16; off > 0; off >>= 1) {
    const sv_u64 o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

static __host__ __device__ inline size_t sv_align16(size_t n) { return (n + 15) & ~(size_t)15; }

// aa[b*N + m] = sum_c x[b, c, m]^2 over a channel-major (B, C, N) source,
// or sum_c x[b, m, c]^2 over a row-major (B, N, C) one, summed in channel
// order with the rounding of the selection's inner products, so that every
// self-distance is exactly 0.
template <bool ROW>
static __global__ void sv_sqnorm_kernel(const float* __restrict__ x,
                                        float* __restrict__ aa, int B, int N,
                                        int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * N) return;
  const long long b = i / N, m = i % N;
  const float* p = ROW ? x + i * C : x + b * C * (long long)N + m;
  const long long stride = ROW ? 1 : N;
  float acc = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = p[(long long)c * stride];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  aa[i] = acc;
}

// ---------------------------------------------------------------------------
// exact-mode kNN selection
// ---------------------------------------------------------------------------
// One warp owns SEL_TPW centre points. It computes their keys against all N
// candidates (each candidate's features loaded once for the SEL_TPW
// centres) into shared memory, then extracts the k largest (key, row) pairs
// rank by rank: each lane keeps the best of its own candidates
// (m = lane mod 32), a warp max picks the winner, and only the winner's
// lane rescans. Winners go to wins (B, k, N), rank-major like the JAX
// kernel's emit_wins output, or (B, N, k) point-major.
//
// Channel-major source: lane m reads candidate m's channel c at x[c*N + m],
// consecutive lanes on consecutive addresses. Row-major source
// (ROW, the legacy round2 trunk): a candidate is one contiguous row, so
// the block stages 32 candidate rows at a time in shared memory with
// coalesced loads (row stride C | 1, odd, so that the 32 lanes reading
// channel c of their own rows hit 32 banks) and lane m reads its row
// there. The arithmetic is the same in both layouts: equal keys, equal ids.
#define SEL_WARPS 4
#define SEL_TPW 4
#define SEL_TP (SEL_WARPS * SEL_TPW)

static size_t sv_select_smem(int N, int C, bool row_major = false) {
  return sv_align16((size_t)SEL_TP * C * sizeof(float)) +
         sv_align16((size_t)SEL_TP * N * sizeof(unsigned)) +
         (row_major ? (size_t)32 * (C | 1) * sizeof(float) : 0);
}

template <bool ROW>
static __global__ void __launch_bounds__(SEL_WARPS * 32)
sv_knn_select_kernel(const float* __restrict__ src,
                     const float* __restrict__ aa, int* __restrict__ wins,
                     int N, int C, int k, int rs, int ps) {
  extern __shared__ __align__(16) unsigned char sv_smem[];
  float* ctr = (float*)sv_smem;  // (SEL_TP, C)
  const size_t ctr_bytes = sv_align16((size_t)SEL_TP * C * sizeof(float));
  unsigned* keys = (unsigned*)(sv_smem + ctr_bytes);
  // ROW: 32 candidate rows at stride CP
  float* tile = (float*)(sv_smem + ctr_bytes +
                         sv_align16((size_t)SEL_TP * N * sizeof(unsigned)));
  const int CP = C | 1;
  const int b = blockIdx.y, n0 = blockIdx.x * SEL_TP;
  const float* x = src + (size_t)b * C * N;
  const float* a = aa + (size_t)b * N;
  for (int i = threadIdx.x; i < SEL_TP * C; i += blockDim.x) {
    const int t = i / C, c = i % C, n = n0 + t;
    ctr[i] = n < N ? (ROW ? x[(size_t)n * C + c] : x[(size_t)c * N + n]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = warp * SEL_TPW;
  unsigned* wk = keys + (size_t)t0 * N;
  float tt[SEL_TPW];
#pragma unroll
  for (int t = 0; t < SEL_TPW; ++t) {
    const int n = n0 + t0 + t;
    tt[t] = n < N ? a[n] : 0.f;
  }
  // block-uniform trip count: ROW synchronises the block around each tile
  for (int m0 = 0; m0 < N; m0 += 32) {
    const int m = m0 + lane;
    if constexpr (ROW) {
      __syncthreads();  // the previous tile is consumed
      const int rows = min(32, N - m0);
      for (int i = threadIdx.x; i < rows * C; i += blockDim.x)
        tile[(i / C) * CP + i % C] = x[(size_t)m0 * C + i];
      __syncthreads();
    }
    if (m < N) {
      float acc[SEL_TPW];
#pragma unroll
      for (int t = 0; t < SEL_TPW; ++t) acc[t] = 0.f;
      for (int c = 0; c < C; ++c) {
        const float xv = ROW ? tile[lane * CP + c] : x[(size_t)c * N + m];
#pragma unroll
        for (int t = 0; t < SEL_TPW; ++t)
          acc[t] = __fadd_rn(acc[t], __fmul_rn(xv, ctr[(t0 + t) * C + c]));
      }
      const float am = a[m];
#pragma unroll
      for (int t = 0; t < SEL_TPW; ++t)
        wk[(size_t)t * N + m] = sv_ukey(sv_neg_dist(acc[t], tt[t], am));
    }
  }
  __syncwarp();

  for (int t = 0; t < SEL_TPW; ++t) {
    const int n = n0 + t0 + t;
    if (n >= N) break;  // warp-uniform
    unsigned* kt = wk + (size_t)t * N;
    sv_u64 best = 0ull;
    for (int m = lane; m < N; m += 32) {
      const sv_u64 v = sv_pack(kt[m], m, N);
      best = v > best ? v : best;
    }
    for (int r = 0; r < k; ++r) {
      const sv_u64 w = sv_warp_max_u64(best);
      const int row = N - 1 - (int)(unsigned)(w & 0xffffffffull);
      if (lane == 0) wins[(size_t)b * k * N + (size_t)r * rs + (size_t)n * ps] = row;
      if ((row & 31) == lane) {  // the winner's owner drops it and rescans
        kt[row] = 0u;
        best = 0ull;
        for (int m = lane; m < N; m += 32) {
          const sv_u64 v = sv_pack(kt[m], m, N);
          best = v > best ? v : best;
        }
      }
    }
  }
}

template <bool ROW>
static cudaError_t sv_knn_select_t(const float* src, float* aa, int* wins,
                                   int B, int N, int C, int k,
                                   cudaStream_t stream, bool point_major) {
  const size_t smem = sv_select_smem(N, C, ROW);
  if (smem > SV_SMEM_LIMIT || k > N || k < 1) return cudaErrorInvalidValue;
  const long long BN = (long long)B * N;
  sv_sqnorm_kernel<ROW><<<(unsigned)((BN + 255) / 256), 256, 0, stream>>>(
      src, aa, B, N, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sv_knn_select_kernel<ROW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + SEL_TP - 1) / SEL_TP, B);
  sv_knn_select_kernel<ROW><<<grid, SEL_WARPS * 32, smem, stream>>>(
      src, aa, wins, N, C, k, point_major ? 1 : N, point_major ? k : 1);
  return cudaGetLastError();
}

// Squared norms + selection for a channel-major (B, C, N) source, or a
// row-major (B, N, C) one when row_major. aa is a (B, N) scratch buffer the
// wrapper allocated. wins is (B, k, N), or (B, N, k) when point_major.
static cudaError_t sv_knn_select(const float* src, float* aa, int* wins,
                                 int B, int N, int C, int k,
                                 cudaStream_t stream, bool point_major = false,
                                 bool row_major = false) {
  return row_major
             ? sv_knn_select_t<true>(src, aa, wins, B, N, C, k, stream, point_major)
             : sv_knn_select_t<false>(src, aa, wins, B, N, C, k, stream, point_major);
}

// ---------------------------------------------------------------------------
// block GEMM over shared memory
// ---------------------------------------------------------------------------
// acc(e, o) = sum_r X[e*ldx + r] * W[r*O + o] for e < E, o < O, with X in
// shared memory and W (K, O) row-major in global memory (small, reused by
// every block, so it stays in L1/L2). Each thread owns a TE x TO register
// tile; epi(e, o, acc) receives every in-range result.
template <int TE, int TO, class Epi>
static __device__ __forceinline__ void sv_block_gemm(
    const float* X, int ldx, int E, const float* __restrict__ W, int K,
    int O, Epi epi) {
  const int og = (O + TO - 1) / TO, eg = (E + TE - 1) / TE;
  for (int item = threadIdx.x; item < og * eg; item += blockDim.x) {
    const int o0 = (item % og) * TO, e0 = (item / og) * TE;
    float acc[TE][TO];
#pragma unroll
    for (int i = 0; i < TE; ++i)
#pragma unroll
      for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < K; ++r) {
      float w[TO], xv[TE];
#pragma unroll
      for (int j = 0; j < TO; ++j)
        w[j] = o0 + j < O ? W[(size_t)r * O + o0 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < TE; ++i)
        xv[i] = e0 + i < E ? X[(size_t)(e0 + i) * ldx + r] : 0.f;
#pragma unroll
      for (int i = 0; i < TE; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[i][j] += xv[i] * w[j];
    }
#pragma unroll
    for (int i = 0; i < TE; ++i)
#pragma unroll
      for (int j = 0; j < TO; ++j)
        if (e0 + i < E && o0 + j < O) epi(e0 + i, o0 + j, acc[i][j]);
  }
}

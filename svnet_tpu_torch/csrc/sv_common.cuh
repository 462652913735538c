// Shared device code of the exact-mode round kernels (sv_round3_first.cu,
// sv_round3.cu) and the point block (sv_point.cu): the exact-mode kNN
// selection kernel, a shared-memory block GEMM, and small helpers.
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
// summed in channel order with the rounding of the selection's inner
// products, so that every self-distance is exactly 0.
static __global__ void sv_sqnorm_kernel(const float* __restrict__ x,
                                        float* __restrict__ aa, int B, int N,
                                        int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * N) return;
  const long long b = i / N, m = i % N;
  const float* p = x + b * C * (long long)N + m;
  float acc = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = p[(long long)c * N];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  aa[i] = acc;
}

// ---------------------------------------------------------------------------
// exact-mode kNN selection
// ---------------------------------------------------------------------------
// One warp owns SEL_TPW centre points. It computes their keys against all N
// candidates (each candidate's channel column loaded once for the SEL_TPW
// centres) into shared memory, then extracts the k largest (key, row) pairs
// rank by rank: each lane keeps the best of its own candidates
// (m = lane mod 32), a warp max picks the winner, and only the winner's
// lane rescans. Winners go to wins (B, k, N), rank-major like the JAX
// kernel's emit_wins output.
#define SEL_WARPS 4
#define SEL_TPW 4
#define SEL_TP (SEL_WARPS * SEL_TPW)

static size_t sv_select_smem(int N, int C) {
  return sv_align16((size_t)SEL_TP * C * sizeof(float)) +
         (size_t)SEL_TP * N * sizeof(unsigned);
}

static __global__ void __launch_bounds__(SEL_WARPS * 32)
sv_knn_select_kernel(const float* __restrict__ src,
                     const float* __restrict__ aa, int* __restrict__ wins,
                     int N, int C, int k, int rs, int ps) {
  extern __shared__ __align__(16) unsigned char sv_smem[];
  float* ctr = (float*)sv_smem;  // (SEL_TP, C)
  unsigned* keys =
      (unsigned*)(sv_smem + sv_align16((size_t)SEL_TP * C * sizeof(float)));
  const int b = blockIdx.y, n0 = blockIdx.x * SEL_TP;
  const float* x = src + (size_t)b * C * N;
  const float* a = aa + (size_t)b * N;
  for (int i = threadIdx.x; i < SEL_TP * C; i += blockDim.x) {
    const int t = i / C, c = i % C, n = n0 + t;
    ctr[i] = n < N ? x[(size_t)c * N + n] : 0.f;
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
  for (int m = lane; m < N; m += 32) {
    float acc[SEL_TPW];
#pragma unroll
    for (int t = 0; t < SEL_TPW; ++t) acc[t] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float xv = x[(size_t)c * N + m];
#pragma unroll
      for (int t = 0; t < SEL_TPW; ++t)
        acc[t] = __fadd_rn(acc[t], __fmul_rn(xv, ctr[(t0 + t) * C + c]));
    }
    const float am = a[m];
#pragma unroll
    for (int t = 0; t < SEL_TPW; ++t)
      wk[(size_t)t * N + m] = sv_ukey(sv_neg_dist(acc[t], tt[t], am));
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

// Squared norms + selection for a channel-major (B, C, N) source. aa is a
// (B, N) scratch buffer the wrapper allocated. wins is (B, k, N), or
// (B, N, k) when point_major.
static cudaError_t sv_knn_select(const float* src, float* aa, int* wins,
                                 int B, int N, int C, int k,
                                 cudaStream_t stream, bool point_major = false) {
  const size_t smem = sv_select_smem(N, C);
  if (smem > SV_SMEM_LIMIT || k > N || k < 1) return cudaErrorInvalidValue;
  const long long BN = (long long)B * N;
  sv_sqnorm_kernel<<<(unsigned)((BN + 255) / 256), 256, 0, stream>>>(
      src, aa, B, N, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sv_knn_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + SEL_TP - 1) / SEL_TP, B);
  sv_knn_select_kernel<<<grid, SEL_WARPS * 32, smem, stream>>>(
      src, aa, wins, N, C, k, point_major ? 1 : N, point_major ? k : 1);
  return cudaGetLastError();
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

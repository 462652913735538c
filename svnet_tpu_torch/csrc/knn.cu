// Standalone kNN on Hopper, exact, fast and approx mode: neighbour ids
// (B, N, k), self included.
//
// Replaces svnet_tpu/ops/pallas/knn.py::knn_pallas: per centre, the k
// largest negative squared distances over all N candidates, without an
// (N, N) array in device memory. Exact mode ranks by the sortable-int key
// of the f32 distance with ties to the minimum row id. Fast mode
// (knn.py:38-96, sv_round2.py:197-210) ranks by the packed key q * 2^ib +
// (2^ib - 1 - row), q the distance quantized on the scale of each key tile
// of T centres (the tile of the TPU kernel's (T, N) block), whose worst
// distance the pre-pass (sv_neg_min_launch) finds; approx mode folds those
// keys to L lanes by key max first (a fixed 256-lane fold,
// sv_round2.py:58). These are the selection's fast and approx
// instantiations of the serving rounds (sv_common.cuh), told the scales,
// T and L.
//
// What bounds it on the H100: B*N*N*C multiply-adds of the distances
// (C = 3, 62, 62, 127 on the training path), rounded op by op in f32 on
// the CUDA cores (no FMA, so that self-distances are exactly 0 and the
// ranking is bitwise the plain version's): twice the instructions of the
// FMA bound. The design is the serving rounds' selection (sv_common.cuh):
// register tiles of 8 centres x 4 candidates per lane over channel chunks
// staged in shared memory, then a per-centre top-k list in registers that
// drops every key below its k-th entry at once and folds the rest in by
// warp insertion or a bitonic merge, so no rank rescans the N keys and
// the shared memory per centre scales with k. The ids are written
// point-major, as knn_pallas returns them.
#include "sv_common.cuh"

// ---------------------------------------------------------------------------
// fast mode's pre-pass: each centre's farthest candidate
// ---------------------------------------------------------------------------
// neg_min[b*N + n] = min over the N candidates m of neg(n, m) =
// sv_neg_dist(<x_n, x_m>, |x_n|^2, |x_m|^2), the very values the selection
// quantizes, whence the key tiles' scales (quant.py::tile_scales takes the
// min over each tile of T centres outside). The TPU kernel holds its
// (N, T) block of distances and takes that min in passing
// (sv_round3.py:199-206); here it is a pass of its own over the pairs.
//
// What bounds it on the H100: the pairs' inner products, C multiplies and
// C adds each, rounded one by one on the CUDA cores (-fmad=false; no
// tensor cores: TF32 or bf16 would move a tile's worst distance, and with
// it every key of the tile). Over all N^2 pairs that is 2 B N^2 C
// instructions at 33.5 T a second, twice the FMA-counted bound: 1.02 ms at
// cls (128, 1024, 127). The design halves the work: the inner product is
// bitwise symmetric (sv_pair_inner), so a block takes one 128 x 128 tile
// (I, J) of the cloud with I <= J, nt (nt + 1) / 2 tiles of nt^2 (36 of 64
// at N = 1024), and its epilogue reads each inner product both ways:
// neg(n, m) = sv_neg_dist(inner, |x_n|^2, |x_m|^2) for the rows n of I and
// neg(m, n) = sv_neg_dist(inner, |x_m|^2, |x_n|^2) for the rows m of J,
// each the plain version's pairwise_neg_sqdist entry bitwise (a diagonal
// tile once). 256 threads hold 8 x 8 inner products each, the chunks
// streamed by cp.async (sv_pair_inner): 4 float4 of shared memory a
// channel for 128 operations. A row's min over the tile reaches device
// memory by an integer atomic min on the float's bits (sv_atomic_fmin)
// over the +inf that sv_neg_min_init wrote on the same stream before: a
// min has no order, so the result is exact and deterministic. At cls
// (128, 1024, 127) it takes 0.92 ms, 62% of the halved floor's 0.57
// (utils/bench_prepass.py, NVIDIA H100 80GB HBM3, 700 W).
//
// With WIN (SvWindow) centre n's min runs over the rows of the blocks its
// key tile keeps, and takes in 0.0 where that tile's window has padding
// (the JAX kernel zeroes neg on padding before its min,
// sv_round3.py:586-591, so the tile's scale sees the kept rows and 0):
// that 0.0 is the row's initial value. T, N and W are multiples of 128, so
// a 128-row tile lies in one key tile: tile (I, J) feeds the rows of I
// where I's key tile keeps block J and the rows of J where J's keeps block
// I, and is skipped where neither does (every tile counts where ok is 0).
#define NM_T 128  // rows of a pre-pass tile

// *p = min(*p, v) for a v that is not NaN: a float with the sign bit clear
// orders as a signed int, one with it set inversely as an unsigned int.
static __device__ __forceinline__ void sv_atomic_fmin(float* p, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin((int*)p, __float_as_int(v));
  else
    atomicMax((unsigned*)p, __float_as_uint(v));
}

// aa = the rows' squared norms (sv_row_sqnorm); neg_min = +inf,
// or (WIN) 0.0 on the rows of a key tile whose window has padding (ok set,
// fewer than W / 128 blocks kept). A block per 128 rows.
template <bool WIN>
static __global__ void __launch_bounds__(NM_T)
sv_neg_min_init(const float* __restrict__ x, float* __restrict__ aa,
                float* __restrict__ neg_min, int N, int C, SvWindow win) {
  const int b = blockIdx.y, n = blockIdx.x * NM_T + threadIdx.x;
  float init = INFINITY;
  if constexpr (WIN) {
    const int nb = N / NM_T;
    const int* kf = win.keep + ((size_t)b * (N / win.T) + blockIdx.x * NM_T / win.T) * nb;
    int kept = 0;
    for (int j0 = 0; j0 < nb; j0 += NM_T)
      kept += __syncthreads_count(j0 + (int)threadIdx.x < nb && kf[j0 + threadIdx.x] != 0);
    if (*win.ok && kept * NM_T < win.W) init = 0.f;
  }
  if (n >= N) return;
  aa[(size_t)b * N + n] = sv_row_sqnorm(x + ((size_t)b * N + n) * C, 1, C);
  neg_min[(size_t)b * N + n] = init;
}

template <bool WIN>
static __global__ void __launch_bounds__(256, 2)
sv_neg_min_kernel(const float* __restrict__ src, const float* __restrict__ aa,
                  float* __restrict__ neg_min, int N, int C, SvWindow win) {
  __shared__ __align__(16) float sm[SV_PI_FLOATS(NM_T, NM_T)];
  __shared__ float cmin[8][NM_T];  // each warp's column mins
  const int b = blockIdx.y, nt = (N + NM_T - 1) / NM_T;
  int I = 0, p = blockIdx.x;  // tile (I, J), I <= J, row by row
  for (; p >= nt - I; ++I) p -= nt - I;
  const int J = I + p;
  bool rows_i = true, rows_j = I != J;  // a diagonal tile counts once
  if constexpr (WIN) {
    if (*win.ok) {
      const int* kf = win.keep + (size_t)b * (N / win.T) * nt;
      rows_i = kf[(size_t)(I * NM_T / win.T) * nt + J] != 0;
      rows_j = rows_j && kf[(size_t)(J * NM_T / win.T) * nt + I] != 0;
      if (!rows_i && !rows_j) return;
    }
  }
  float acc[8][8];
  sv_pair_inner<NM_T, NM_T, 8, 8>(acc, sm, src + (size_t)b * N * C,
                                  SvRun{I * NM_T, N}, SvRun{J * NM_T, N}, C);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* a = aa + (size_t)b * N;
  float* out = neg_min + (size_t)b * N;
  float ai[8], aj[8];  // squared norms; NaN past N, which fminf drops
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = I * NM_T + sv_tile_row<NM_T, 8>(ty, i);
    const int m = J * NM_T + sv_tile_row<NM_T, 8>(tx, i);
    ai[i] = n < N ? a[n] : NAN;
    aj[i] = m < N ? a[m] : NAN;
  }
  if (rows_i) {  // neg(n, m), min over the tile's columns m
    float mn[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mn[i] = INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mn[i] = fminf(mn[i], sv_neg_dist(acc[i][j], ai[i], aj[j]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // over the 16 lanes of this ty
        mn[i] = fminf(mn[i], __shfl_xor_sync(0xffffffffu, mn[i], off));
      const int n = I * NM_T + sv_tile_row<NM_T, 8>(ty, i);
      if (tx == 0 && n < N) sv_atomic_fmin(out + n, mn[i]);
    }
  }
  if (rows_j) {  // neg(m, n), min over the tile's rows n
    float mn[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mn[j] = INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) mn[j] = fminf(mn[j], sv_neg_dist(acc[i][j], aj[j], ai[i]));
      mn[j] = fminf(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], 16));  // the warp's two ty
      if (lane < 16) cmin[warp][sv_tile_row<NM_T, 8>(tx, j)] = mn[j];
    }
    __syncthreads();
    if (threadIdx.x < NM_T) {
      const int m = J * NM_T + threadIdx.x;
      float v = cmin[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < 8; ++w) v = fminf(v, cmin[w][threadIdx.x]);
      if (m < N) sv_atomic_fmin(out + m, v);
    }
  }
}

// Squared norms + the pre-pass over a row-major (B, N, C) source; aa is
// (B, N) scratch. win: the candidate window (SvWindow), W = 0 for none.
static cudaError_t sv_neg_min(const float* src, float* aa, float* neg_min,
                              int B, int N, int C, cudaStream_t stream,
                              SvWindow win = SvWindow{}) {
  if (N < 1 || C < 1 || !sv_window_ok(win, N, 1, 0)) return cudaErrorInvalidValue;
  const int nt = (N + NM_T - 1) / NM_T;
  const dim3 rows(nt, B), tiles(nt * (nt + 1) / 2, B);
  if (win.W) {
    sv_neg_min_init<true><<<rows, NM_T, 0, stream>>>(src, aa, neg_min, N, C, win);
    sv_neg_min_kernel<true><<<tiles, 256, 0, stream>>>(src, aa, neg_min, N, C, win);
  } else {
    sv_neg_min_init<false><<<rows, NM_T, 0, stream>>>(src, aa, neg_min, N, C, win);
    sv_neg_min_kernel<false><<<tiles, 256, 0, stream>>>(src, aa, neg_min, N, C, win);
  }
  return cudaGetLastError();
}

// x (B, C, N) channel-major; aa (B, N) scratch; ids (B, N, k) int32.
// Fast mode: tile_scale (B, N / T), the key tiles' scales
// (quant.py::tile_scales); approx mode also L > 0, the fold width. Exact
// mode passes a null tile_scale and T = L = 0.
extern "C" int sv_knn_launch(const float* x, float* aa, int* ids,
                             const float* tile_scale, int B, int N, int C,
                             int k, int T, int L, void* stream) {
  return (int)sv_knn_select(x, aa, ids, B, N, C, k, (cudaStream_t)stream,
                            /*point_major=*/true, /*row_major=*/false,
                            tile_scale, T, L);
}

// Fast mode's pre-pass (sv_neg_min above): x (B, N, C) row-major;
// aa (B, N) scratch; neg_min (B, N), each centre's least negative squared
// distance over all N candidates, which quant.py::tile_scales turns into
// the key tiles' scales.
extern "C" int sv_neg_min_launch(const float* x, float* aa, float* neg_min,
                                 int B, int N, int C, void* stream) {
  return (int)sv_neg_min(x, aa, neg_min, B, N, C, (cudaStream_t)stream);
}

// The pre-pass over a candidate window (SvWindow): x, aa and neg_min as
// sv_neg_min_launch's; keep (B, N / T, N / 128) and ok (one int) from
// ops/window.py on the device; each centre's least negative squared
// distance over its key tile's kept rows, and 0.0 where the tile's W-row
// window has padding (all N rows where ok is 0).
extern "C" int sv_neg_min_window_launch(const float* x, float* aa,
                                        float* neg_min, const int* keep,
                                        const int* ok, int B, int N, int C,
                                        int T, int W, void* stream) {
  return (int)sv_neg_min(x, aa, neg_min, B, N, C, (cudaStream_t)stream,
                         SvWindow{keep, ok, T, W, 0});
}

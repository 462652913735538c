// The candidate window's pre-pass on Hopper (svnet_tpu_torch/ops/window.py;
// svnet_tpu/ops/pallas/sv_round3.py::_prune_prepass, :916-988, XLA in JAX,
// not a Pallas kernel): two kernels for its two scans of the cloud, the
// rest (the blocks' boxes, the margin, ok) in PyTorch.
//
// sv_window_tau_kernel: tau[b, n], the k-th smallest squared distance
// (|x_n|^2 + |x_m|^2) - 2<x_n, x_m> from n to the 384 rows m of its own
// 128-row block and the two beside it (the ends wrap; at N = 256 the other
// block counts twice, as JAX's rolled copies do), counted with
// multiplicity (:946-955). In PyTorch (the plain version) it is a
// (B, N, 384) slab of distances and a kthvalue over it. What bounds it on
// the H100: B N 384 C multiplies and as many adds, rounded one by one on
// the CUDA cores (-fmad=false, so tau is bitwise the plain version's):
// 0.38 ms at (16, 8192) and C = 127, twice the FMA-counted bound; at C = 3
// the distances cost nothing and the selection of 131,072 k-th values is
// the work. A block of 16 warps owns 64 centres of one Morton block and
// runs sv_pair_inner (sv_common.cuh: the band's rows and the centres'
// streamed through two cp.async stages of 16 channels) with a thread tile
// of 4 centres x 12 band rows: warp w ends up holding the distances of its
// 4 centres to all 384 rows, 12 a lane, in registers, so no slab of
// distances is kept anywhere. Per centre each lane sorts its 12
// order-preserving keys (a 42-comparator network), and the warp takes the
// least head key (one __reduce_min_sync) and pops it from every lane that
// holds it, until k keys are taken: at most k rounds, or 385 - k from the
// top for k above 192. The band's 384 rows are staged once for 64
// centres: at 32 centres (8 warps, 3 blocks an SM at 80 registers) the
// staging cost 12% more at C = 127 (utils/bench_prepass.py, NVIDIA H100
// 80GB HBM3, 700 W). 57 KB of shared memory and 96 registers a thread:
// one block (16 warps) an SM. It takes 0.25 / 0.54 / 0.89 ms at C = 3 /
// 62 / 127 and k = 20 (same script and card): at C = 127, 43% of the
// no-FMA floor.
//
// sv_window_keep_kernel: keep[b, t, bk] is 1 unless every centre n of key
// tile t has lb2(n, bk) > tau[b, n], lb2 the squared distance from x_n to
// block bk's bounding box [lo, hi] in the direct form, sum_c max(lo_c -
// x_c, x_c - hi_c, 0)^2 (:961-985); in PyTorch (the plain version) the
// test runs channel by channel over (B, N, blocks) temporaries, 23.2 ms at
// (16, 8192) and C = 127. What bounds it on the H100: B N (N / 128) C
// channel terms, 1.07 G there, each 5 f32 instructions rounded one by one
// (-fmad=false): x - clamp(x, lo, hi) is, up to its sign, the one of lo -
// x and x - hi that is positive (or 0), rounded alike, so its square is
// the plain version's term bit for bit, in 2 FMNMX, a subtraction, a
// product and a sum. That is 0.16 ms at the card's issue rate (1.98 GHz),
// against 0.079 ms for those 5 operations over the f32 peak, which counts
// an FMA as 2. A
// block of 256 threads owns one Morton block's 128 centres and 64 blocks
// of the cloud and runs sv_pair_tile (sv_common.cuh): the centres' rows
// and the blocks' lo and hi stream through two cp.async stages of 16
// channels, and a thread folds 4 blocks x 8 centres, reading 4 float4 of
// shared memory a channel for 32 terms: each row is read from device
// memory once. A warp's 8 blocks x 128 centres meet in a warp OR; a key tile of 128 centres is the block's
// own, stored as is, and a larger one is an integer atomicOr over zeros
// (order-free). 0.015 / 0.13 / 0.27 ms device time at C = 3 / 62 / 127
// and (16, 8192) (utils/bench_prepass.py, NVIDIA H100 80GB HBM3, 700 W):
// at C = 127, 60% of the 5-instruction floor. A warp that stopped once
// all its sums passed their tau (a sum only grows) saved nothing on the
// windowed rounds' inputs, so no warp stops early.
//
// Both sum channel by channel, each product and sum rounded on its own
// (built with -fmad=false), as their plain versions do: tau and the flags
// are bitwise theirs.
#include "sv_common.cuh"

// float -> unsigned with the float order (-0.0 below +0.0), and back
static __device__ __forceinline__ unsigned wt_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
static __device__ __forceinline__ float wt_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

#define WT_C 64               // centres a block, 4 a warp
#define WT_THREADS (WT_C / 4 * 32)
#define WT_BAND (3 * SEL_TM)  // a centre's band rows
#define WT_Q (WT_BAND / 32)   // band rows a lane
#define WT_SMEM (SV_PI_FLOATS(WT_C, WT_BAND) * 4)

// Row t < 384 of the band of Morton block bk: blocks bk - 1, bk, bk + 1 of
// nb, the ends wrapping.
struct WtBand {
  int bk, nb;
  __device__ __forceinline__ int operator()(int t) const {
    int blk = bk + t / SEL_TM - 1;
    blk = blk < 0 ? blk + nb : (blk >= nb ? blk - nb : blk);
    return blk * SEL_TM + t % SEL_TM;
  }
};

#define WT_CAS(a, b)                                 \
  {                                                  \
    const unsigned lo_ = min(v[a], v[b]);            \
    v[b] = max(v[a], v[b]);                          \
    v[a] = lo_;                                      \
  }

// Sorts a lane's 12 keys ascending: Batcher's odd-even merge sort on 16
// slots without the comparators of the 4 slots past 12 (42 in 10 layers).
static __device__ __forceinline__ void wt_sort(unsigned (&v)[WT_Q]) {
  static_assert(WT_Q == 12, "the network sorts 12 keys");
  WT_CAS(0, 1) WT_CAS(2, 3) WT_CAS(4, 5) WT_CAS(6, 7) WT_CAS(8, 9) WT_CAS(10, 11)
  WT_CAS(0, 2) WT_CAS(1, 3) WT_CAS(4, 6) WT_CAS(5, 7) WT_CAS(8, 10) WT_CAS(9, 11)
  WT_CAS(1, 2) WT_CAS(5, 6) WT_CAS(9, 10)
  WT_CAS(0, 4) WT_CAS(1, 5) WT_CAS(2, 6) WT_CAS(3, 7)
  WT_CAS(2, 4) WT_CAS(3, 5)
  WT_CAS(1, 2) WT_CAS(3, 4) WT_CAS(5, 6) WT_CAS(9, 10)
  WT_CAS(0, 8) WT_CAS(1, 9) WT_CAS(2, 10) WT_CAS(3, 11)
  WT_CAS(4, 8) WT_CAS(5, 9) WT_CAS(6, 10) WT_CAS(7, 11)
  WT_CAS(2, 4) WT_CAS(3, 5) WT_CAS(6, 8) WT_CAS(7, 9)
  WT_CAS(1, 2) WT_CAS(3, 4) WT_CAS(5, 6) WT_CAS(7, 8) WT_CAS(9, 10)
}

// The rank-th smallest (1-based) of the warp's 32 x WT_Q keys, each lane's
// sorted ascending, with multiplicity: the warp takes the least head key,
// which every lane holding it there pops, until rank keys are taken.
static __device__ __forceinline__ unsigned wt_select(unsigned (&key)[WT_Q], int rank) {
  for (;;) {
    const unsigned m = __reduce_min_sync(0xffffffffu, key[0]);
    const bool hit = key[0] == m;
    rank -= __popc(__ballot_sync(0xffffffffu, hit));
    if (rank <= 0) return m;
    if (hit) {
#pragma unroll
      for (int q = 0; q + 1 < WT_Q; ++q) key[q] = key[q + 1];
      key[WT_Q - 1] = 0xffffffffu;
    }
  }
}

__global__ void __launch_bounds__(WT_THREADS, 1)
sv_window_tau_kernel(const float* __restrict__ x, const float* __restrict__ aa,
                     float* __restrict__ tau, int N, int C, int k) {
  extern __shared__ __align__(16) float wt_sm[];
  const int b = blockIdx.y, n0 = blockIdx.x * WT_C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WtBand band{n0 / SEL_TM, N / SEL_TM};
  float acc[4][WT_Q];  // centre n0 + 4 warp + i, band row sv_tile_row<WT_BAND, WT_Q>(lane, q)
  sv_pair_inner<WT_C, WT_BAND, 4, WT_Q>(acc, wt_sm, x + (size_t)b * N * C,
                                        SvRun{n0, N}, band, C);
  const float* a = aa + (size_t)b * N;
  // above 192, the k-th smallest is the (385 - k)-th largest: the
  // (385 - k)-th smallest of the complemented keys
  const bool top = k > WT_BAND / 2;
  const int rank = top ? WT_BAND + 1 - k : k;
  float ctr_sq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ctr_sq[i] = a[n0 + 4 * warp + i];
  unsigned key[4][WT_Q];  // the distances' keys, in place of acc
#pragma unroll
  for (int q = 0; q < WT_Q; ++q) {
    const float cand_sq = a[band(sv_tile_row<WT_BAND, WT_Q>(lane, q))];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = wt_key(
          __fsub_rn(__fadd_rn(ctr_sq[i], cand_sq), __fmul_rn(2.f, acc[i][q])));
      key[i][q] = top ? ~u : u;
    }
  }
  auto finish = [&](unsigned (&kc)[WT_Q], int i) {
    wt_sort(kc);
    const unsigned kth = wt_select(kc, rank);
    if (lane == 0) tau[(size_t)b * N + n0 + 4 * warp + i] = wt_value(top ? ~kth : kth);
  };
  finish(key[0], 0);  // one call a centre: key's indices stay constants
  finish(key[1], 1);
  finish(key[2], 2);
  finish(key[3], 3);
}

// x (B, N, C) row-major, N a multiple of 128; aa (B, N) scratch (the
// squared norms, sv_common.cuh's sv_sqnorm, summed like the distances);
// tau (B, N) out: each centre's k-th band distance, 1 <= k <= 384.
extern "C" int sv_window_tau_launch(const float* x, float* aa, float* tau,
                                    int B, int N, int C, int k, void* stream) {
  if (B < 1 || C < 1 || N < 128 || N % 128 != 0 || k < 1 || k > WT_BAND)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = sv_sqnorm<true>(x, aa, B, N, C, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sv_window_tau_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WT_SMEM);
  if (err != cudaSuccess) return (int)err;
  sv_window_tau_kernel<<<dim3(N / WT_C, B), WT_THREADS, WT_SMEM,
                         (cudaStream_t)stream>>>(x, aa, tau, N, C, k);
  return (int)cudaGetLastError();
}

#define WK_B 64   // blocks a block of threads, 8 a warp
#define WK_C 128  // centres a block of threads: one Morton block
#define WK_THREADS ((WK_B / 4) * (WK_C / 8))
#define WK_SMEM (SV_PT_FLOATS(2, WK_B, WK_C) * 4)

__global__ void __launch_bounds__(WK_THREADS, 2)
sv_window_keep_kernel(const float* __restrict__ x, const float* __restrict__ lo,
                      const float* __restrict__ hi, const float* __restrict__ tau,
                      int* __restrict__ keep, int N, int C, int T, int nb) {
  extern __shared__ __align__(16) float wk_sm[];
  const int b = blockIdx.z, n0 = blockIdx.x * WK_C, bk0 = blockIdx.y * WK_B;
  const int tx = threadIdx.x % (WK_C / 8), ty = threadIdx.x / (WK_C / 8);
  float tn[8];  // centre n0 + sv_tile_row<WK_C, 8>(tx, j)
#pragma unroll
  for (int j = 0; j < 8; ++j) tn[j] = tau[(size_t)b * N + n0 + sv_tile_row<WK_C, 8>(tx, j)];
  // acc[i][j]: lb2 of block bk0 + 4 ty + i to centre j. x - clamp(x, lo,
  // hi) is, up to its sign, the one of lo - x and x - hi that is positive
  // (or 0), rounded alike: its square is the plain version's term bit for
  // bit, in 5 operations for 6
  float acc[4][8];
  const size_t boxes = (size_t)b * nb * C;
  sv_pair_tile<WK_B, WK_C, 4, 8, 2>(
      acc, wk_sm, lo + boxes, hi + boxes, x + (size_t)b * N * C, SvRun{bk0, nb},
      SvRun{n0, N}, C,
      [](float& s, float l, float h, float v) {
        const float d = __fsub_rn(v, fminf(fmaxf(v, l), h));
        s = __fadd_rn(s, __fmul_rn(d, d));
      });
  unsigned hit = 0u;  // bit 4 (ty & 1) + i: the warp's block 8 (ty / 2) + 4 (ty & 1) + i
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (!(acc[i][j] > tn[j])) hit |= 1u << (4 * (ty & 1) + i);
  hit = __reduce_or_sync(0xffffffffu, hit);
  const int lane = threadIdx.x & 31, bk = bk0 + 8 * (threadIdx.x >> 5) + lane;
  if (lane < 8 && bk < nb) {
    int* flag = &keep[((size_t)b * (N / T) + n0 / T) * nb + bk];
    if (T == WK_C) *flag = (hit >> lane) & 1u;  // the key tile is this block's
    else if ((hit >> lane) & 1u) atomicOr(flag, 1);  // the tile's blocks meet, over 0
  }
}

// x (B, N, C) row-major; lo, hi (B, N / 128, C) the blocks' boxes (lo <=
// hi); tau (B, N) each centre's inflated k-th band distance; keep (B, N /
// T, N / 128) int32 out. N a multiple of 128, T a multiple of 128 dividing
// N.
extern "C" int sv_window_keep_launch(const float* x, const float* lo,
                                     const float* hi, const float* tau,
                                     int* keep, int B, int N, int C, int T,
                                     void* stream) {
  if (B < 1 || B > 65535 || C < 1 || N < 128 || N % 128 != 0 || T < 128 ||
      T % 128 != 0 || N % T != 0)
    return (int)cudaErrorInvalidValue;
  const int nb = N / 128;
  if (T != WK_C) {
    const cudaError_t err = cudaMemsetAsync(
        keep, 0, sizeof(int) * (size_t)B * (N / T) * nb, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  sv_window_keep_kernel<<<dim3(N / WK_C, (nb + WK_B - 1) / WK_B, B), WK_THREADS,
                          WK_SMEM, (cudaStream_t)stream>>>(x, lo, hi, tau, keep, N,
                                                           C, T, nb);
  return (int)cudaGetLastError();
}

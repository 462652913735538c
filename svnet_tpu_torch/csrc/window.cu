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
// x_c, x_c - hi_c, 0)^2 (:961-985). Bound: B*N*(N/128)*C channel terms,
// 1.1 G at a long cloud's conv4 (B = 16, N = 8192, C = 127), six f32
// operations each, about 0.1 ms; in PyTorch the test runs channel by
// channel over (B, N, blocks) temporaries (the plain version: 23.2 ms
// there, NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 2). A thread
// owns a centre and a chunk of WK_BLK blocks: it reads its row once per
// chunk, the chunk's boxes come from shared memory (a broadcast) and the
// chunk's sums stay in registers; a warp OR and a shared-memory atomicOr
// (integer, so order-free) fold the tile's centres.
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

#define WK_BLK 16       // blocks a chunk
#define WK_THREADS 128  // centres a pass of the block

__global__ void __launch_bounds__(WK_THREADS)
sv_window_keep_kernel(const float* __restrict__ x, const float* __restrict__ lo,
                      const float* __restrict__ hi,
                      const float* __restrict__ tau, int* __restrict__ keep,
                      int N, int C, int T, int nb) {
  extern __shared__ float box[];  // (2, WK_BLK, C): the chunk's lo, then hi
  __shared__ unsigned kept;        // bit j: the chunk's block j is kept
  const int b = blockIdx.y, t = blockIdx.x;
  const float* xb = x + (size_t)b * N * C;
  const float* bhi = box + WK_BLK * C;
  for (int bk0 = 0; bk0 < nb; bk0 += WK_BLK) {
    const int nblk = min(WK_BLK, nb - bk0);
    __syncthreads();  // the previous chunk's boxes and flags are consumed
    for (int e = threadIdx.x; e < WK_BLK * C; e += blockDim.x) {
      const bool in = e < nblk * C;
      const size_t g = ((size_t)b * nb + bk0) * C + e;
      box[e] = in ? lo[g] : 0.f;
      box[WK_BLK * C + e] = in ? hi[g] : 0.f;
    }
    if (threadIdx.x == 0) kept = 0u;
    __syncthreads();
    unsigned hit = 0u;
    for (int n = t * T + threadIdx.x; n < (t + 1) * T; n += blockDim.x) {
      float acc[WK_BLK];
#pragma unroll
      for (int j = 0; j < WK_BLK; ++j) acc[j] = 0.f;
      const float* xn = xb + (size_t)n * C;
      for (int c = 0; c < C; ++c) {
        const float v = xn[c];
#pragma unroll
        for (int j = 0; j < WK_BLK; ++j) {
          const float d = fmaxf(fmaxf(__fsub_rn(box[j * C + c], v),
                                      __fsub_rn(v, bhi[j * C + c])), 0.f);
          acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
        }
      }
      const float tn = tau[(size_t)b * N + n];
#pragma unroll
      for (int j = 0; j < WK_BLK; ++j)
        if (j < nblk && !(acc[j] > tn)) hit |= 1u << j;
    }
    hit = __reduce_or_sync(0xffffffffu, hit);
    if ((threadIdx.x & 31) == 0 && hit) atomicOr(&kept, hit);
    __syncthreads();
    if (threadIdx.x < nblk)
      keep[((size_t)b * (N / T) + t) * nb + bk0 + threadIdx.x] =
          (int)((kept >> threadIdx.x) & 1u);
  }
}

// x (B, N, C) row-major; lo, hi (B, N / 128, C) the blocks' boxes; tau
// (B, N) each centre's inflated k-th band distance; keep (B, N / T,
// N / 128) int32 out. N a multiple of 128, T a multiple of 128 dividing N.
extern "C" int sv_window_keep_launch(const float* x, const float* lo,
                                     const float* hi, const float* tau,
                                     int* keep, int B, int N, int C, int T,
                                     void* stream) {
  if (B < 1 || C < 1 || N % 128 != 0 || T < 128 || T % 128 != 0 || N % T != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)WK_BLK * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sv_window_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sv_window_keep_kernel<<<dim3(N / T, B), WK_THREADS, smem,
                          (cudaStream_t)stream>>>(x, lo, hi, tau, keep, N, C,
                                                  T, N / 128);
  return (int)cudaGetLastError();
}

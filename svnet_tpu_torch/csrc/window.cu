// The candidate window's pre-pass on Hopper (svnet_tpu_torch/ops/window.py;
// svnet_tpu/ops/pallas/sv_round3.py::_prune_prepass, :916-988, XLA in JAX,
// not a Pallas kernel): two kernels for its two scans of the cloud, the
// rest (the blocks' boxes, the margin, ok) in PyTorch.
//
// sv_window_tau_kernel: tau[b, n], the k-th smallest squared distance
// (|x_n|^2 + |x_m|^2) - 2<x_n, x_m> from n to the 384 rows m of its own
// 128-row block and the two beside it (the ends wrap; at N = 256 the other
// block counts twice, as JAX's rolled copies do). In PyTorch (the plain
// version) it is a (B, N, 384) slab of distances and a kthvalue over it:
// 3.5 / 27.8 / 54.1 ms at B = 16, N = 8192, C = 3 / 62 / 127 on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py, phase 2). Bound: B*N*384*(2C +
// 3) operations, 0.007 ms at C = 3. Here a block of 8 warps owns 64
// centres and runs the selection's distance stage (sv_common.cuh,
// sv_tile_inner: chunks of 32 channels in shared memory, 8 centres x 4
// candidates a lane) over the three band blocks into a (64, 384) slab in
// shared memory; each warp then finds its centres' k-th value by a radix
// select over the slab's order-preserving integer keys (32 rounds of a
// warp sum), with multiplicity.
//
// sv_window_keep_kernel: keep[b, t, bk] is 1 unless every centre n of key
// tile t has lb2(n, bk) > tau[b, n], lb2 the squared distance from x_n to
// block bk's bounding box [lo, hi] in the direct form, sum_c max(lo_c -
// x_c, x_c - hi_c, 0)^2 (:961-985). Bound: B*N*(N/128)*C channel terms,
// 1.1 G at a long cloud's conv4 (B = 16, N = 8192, C = 127), six f32
// operations each, about 0.1 ms; in PyTorch the test runs channel by
// channel over (B, N, blocks) temporaries (the plain version: 23.2 ms
// there, same card and script). A thread owns a centre and a chunk of
// WK_BLK blocks: it reads its row once per chunk, the chunk's boxes come
// from shared memory (a broadcast) and the chunk's sums stay in
// registers; a warp OR and a shared-memory atomicOr (integer, so
// order-free) fold the tile's centres.
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

#define WT_BAND (3 * SEL_TM)  // a centre's band rows
#define WT_SMEM (SEL_KC * (SEL_CS + SEL_MS) * 4 + SEL_TC * WT_BAND * 4)

__global__ void __launch_bounds__(SEL_WARPS * 32, 1)
sv_window_tau_kernel(const float* __restrict__ x, const float* __restrict__ aa,
                     float* __restrict__ tau, int N, int C, int k) {
  extern __shared__ __align__(16) unsigned char wt_smem[];
  float* ctr_s = (float*)wt_smem;           // (SEL_KC, SEL_CS) centres
  float* cand_s = ctr_s + SEL_KC * SEL_CS;  // (SEL_KC, SEL_MS) band rows
  float* d2s = cand_s + SEL_KC * SEL_MS;    // (SEL_TC, WT_BAND) distances
  const int b = blockIdx.y, n0 = blockIdx.x * SEL_TC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t0 = warp * 8;
  const int nb = N / SEL_TM, bk = n0 / SEL_TM;
  const float* xb = x + (size_t)b * C * N;
  const float* a = aa + (size_t)b * N;
  float ctr_sq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ctr_sq[i] = a[n0 + t0 + i];
  for (int s = 0; s < 3; ++s) {  // the blocks before, at and after n's
    const int r0 = ((bk + s - 1 + nb) % nb) * SEL_TM;
    float acc[8][4];
    sv_tile_inner<true>(acc, ctr_s, cand_s, xb, n0, SvRun{r0, N}, t0, lane, N,
                        C);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float cand_sq = a[r0 + 4 * lane + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d2s[(t0 + i) * WT_BAND + s * SEL_TM + 4 * lane + j] = __fsub_rn(
            __fadd_rn(ctr_sq[i], cand_sq), __fmul_rn(2.f, acc[i][j]));
    }
  }
  __syncwarp();  // a warp reads back only its own centres' rows
  for (int i = 0; i < 8; ++i) {
    unsigned key[WT_BAND / 32];
#pragma unroll
    for (int q = 0; q < WT_BAND / 32; ++q)
      key[q] = wt_key(d2s[(t0 + i) * WT_BAND + 32 * q + lane]);
    // the k-th smallest key, bit by bit from the top: keep the bit 0 while
    // at least `need` keys under the prefix have it 0
    unsigned prefix = 0u;
    int need = k;
    for (int bit = 31; bit >= 0; --bit) {
      const unsigned hi = bit == 31 ? 0u : ~0u << (bit + 1);
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < WT_BAND / 32; ++q)
        cnt += (key[q] & hi) == prefix && !((key[q] >> bit) & 1u);
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (cnt < need) {
        need -= cnt;
        prefix |= 1u << bit;
      }
    }
    if (lane == 0) tau[(size_t)b * N + n0 + t0 + i] = wt_value(prefix);
  }
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
  sv_window_tau_kernel<<<dim3(N / SEL_TC, B), SEL_WARPS * 32, WT_SMEM,
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

// Shared device code of the round kernels (sv_rounds.cuh, for
// sv_round3_first.cu, sv_round3.cu and sv_round2.cu) and the point block
// (sv_point.cu): the kNN selection kernel over a channel-major (B, C, N)
// or a row-major (B, N, C) source, by exact mode's key, fast mode's or
// approx mode's folded one, over all N rows or a certified candidate
// window; a staged tile of pairs folded channel by channel (sv_pair_tile:
// inner products, sv_pair_inner, for the fast key's pre-pass in knn.cu and
// the window's tau in window.cu; box distances for the window's block test
// in window.cu); a shared-memory block GEMM, and small helpers.
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
// channel order (sv_row_sqnorm below).
static __device__ __forceinline__ float sv_neg_dist(float inner, float ctr_sq,
                                                    float cand_sq) {
  return __fsub_rn(__fsub_rn(__fmul_rn(2.f, inner), ctr_sq), cand_sq);
}

// Exact-mode neighbour key (svnet_tpu/ops/pallas/sv_round3.py:194-196): the
// sortable-int bits of the f32 distance with the sign bit flipped, so the
// unsigned order is the float order (-0.0 below +0.0).
static __device__ __forceinline__ unsigned sv_ukey(float neg) {
  const int bits = __float_as_int(neg);
  const int key = bits < 0 ? (bits ^ 0x7FFFFFFF) : bits;
  return ((unsigned)key) ^ 0x80000000u;
}

// Fast mode's key tiles (svnet_tpu/ops/pallas/sv_round3.py:199-206): the
// distance of centre n quantized on the scale of its tile of T centres,
// q = floor(neg * scale[b][n / T]) clamped to [qlo, qhi]
// (ops/kernels/quant.py::packed_keys), with the sign bit flipped so the
// unsigned order is q's. The JAX package packs q with the row into one
// int32 (q * 2^ib + 2^ib - 1 - row); sv_pack below gives the same order.
// A null scale selects exact mode's key. Approx mode folds the candidates
// to L lanes (sv_approx_key below); L = 0: no fold.
struct SvKeyTiles {
  const float* scale;  // (B, N / T)
  int T;
  float qlo, qhi;
  int L, ib;  // approx mode's fold width; the packed key's row bits
};

static __device__ __forceinline__ unsigned sv_fast_ukey(float neg, float scale,
                                                        float qlo, float qhi) {
  const float q = fminf(fmaxf(floorf(__fmul_rn(neg, scale)), qlo), qhi);
  return ((unsigned)(int)q) ^ 0x80000000u;
}

// Approx mode's key (sv_round3.py:199-234): the JAX package's packed int32
// q * 2^ib + (2^ib - 1 - row), its sign bit flipped so that the unsigned
// order is the int32 order. It holds the row, so the largest of a residue
// class mod L also says which row won. No key is 0: q >= qlo > -2^(31-ib).
static __device__ __forceinline__ unsigned sv_approx_key(float neg, float scale,
                                                         float qlo, float qhi,
                                                         int row, int ib) {
  const int q = (int)fminf(fmaxf(floorf(__fmul_rn(neg, scale)), qlo), qhi);
  return (((unsigned)q << ib) + (unsigned)(((1 << ib) - 1) - row)) ^ 0x80000000u;
}

// The row of an approx key (its low ib bits).
static __device__ __forceinline__ int sv_approx_row(unsigned key, int ib) {
  return ((1 << ib) - 1) - (int)(key & ((1u << ib) - 1u));
}

// (key, row) packed into one unique value: the low word is N-1-row, so
// among equal keys the smallest row is the largest value -- the min-row
// tie-break of sv_round3.py:441-451. The order of packed values is that of
// the plain version's packed int64 (ops/knn.py::topk_rows), NaN keys
// included. 0 is the packed value of (the lowest key, row N-1), the last
// of every order, and also marks an empty slot of a selection list: a list
// slot that keeps 0 decodes to row N-1, which is what it then stands for.
static __device__ __forceinline__ sv_u64 sv_pack(unsigned ukey, int row, int N) {
  return ((sv_u64)ukey << 32) | (sv_u64)(unsigned)(N - 1 - row);
}

static __host__ __device__ inline size_t sv_align16(size_t n) { return (n + 15) & ~(size_t)15; }

// sum_c p[c * stride]^2, summed from 0.f in channel order with the
// rounding of every inner product of the selection and the pre-passes, so
// that every self-distance is exactly 0. Every squared norm of a row goes
// through here.
static __device__ __forceinline__ float sv_row_sqnorm(const float* __restrict__ p,
                                                      long long stride, int C) {
  float acc = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = p[(long long)c * stride];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  return acc;
}

// aa[b*N + m] = sum_c x[b, c, m]^2 over a channel-major (B, C, N) source,
// or sum_c x[b, m, c]^2 over a row-major (B, N, C) one (sv_row_sqnorm).
template <bool ROW>
static __global__ void sv_sqnorm_kernel(const float* __restrict__ x,
                                        float* __restrict__ aa, int B, int N,
                                        int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * N) return;
  const long long b = i / N, m = i % N;
  aa[i] = ROW ? sv_row_sqnorm(x + i * C, 1, C)
              : sv_row_sqnorm(x + b * C * (long long)N + m, N, C);
}

// ---------------------------------------------------------------------------
// kNN selection
// ---------------------------------------------------------------------------
// A block of SEL_WARPS warps owns SEL_TC centre points of one cloud, 8 per
// warp, and streams all N candidates past them in tiles of SEL_TM.
//
// Distance pass. For each tile, chunks of SEL_KC channels of the centres
// and of the tile's candidates are staged in shared memory channel-major
// (both layouts: a row-major source is transposed on the way in). A lane
// owns 8 centres x 4 adjacent candidates: per channel it reads two float4
// of centres (a broadcast) and one float4 of candidates for 32 products
// and 32 sums, and every pair's inner product is summed from 0.f channel
// by channel with __fmul_rn / __fadd_rn, as in the plain version. The
// cloud's features are read once per SEL_TC centres.
//
// Selection. Each centre keeps a list of its best 32 * KW packed keys
// (KW = 1 for k <= 32, else 2), sorted descending, in shared memory
// between tiles and in its warp's registers while the warp folds a tile
// in (lane l holds entries l and 32 + l), beside a threshold T, the
// list's kc-th entry. The tile's keys overwrite the staged chunks once
// every warp is done with them. After a tile, the warp goes over each of its
// centres' 128 keys in 4 batches of 32 (one per lane): a key at or below T
// is dropped at once; a batch with at most SEL_SERIAL keys above T inserts
// them one by one (a ballot finds the position, a shuffle shifts the
// tail), a batch with more (the first tiles) is sorted by a warp bitonic
// sort and merged into the list by a bitonic merge (an insertion is a few
// dependent shuffles, a merge about twenty). The threshold is refreshed
// once per batch, and the kernel is built for 3 blocks an SM (at most 85
// registers a thread): the selection is a chain of shuffles, and more
// warps hide its latency. Nothing holds a centre's N keys, no
// rank rescans them, and the shared memory of a centre is 32 * KW * 8
// bytes plus the tile's keys. The packed keys are unique, so the list
// does not depend on the order in which candidates arrive: the ids are
// the plain version's. A k above 64 is selected in rounds of 64 ranks,
// each pass keeping only keys below the last one the previous round took.
// Winners go to wins (B, k, N), rank-major like the JAX kernel's emit_wins
// output, or (B, N, k) point-major. Fast mode only changes the key a
// distance becomes (sv_fast_ukey): its packed keys are unique too.
//
// Approx mode (FOLD) ranks L folded lanes, not N rows: lane i holds the
// largest approx key (sv_approx_key) of the rows i + t*L, t < N / L
// (_build_key_t's repeated halving max). The candidates stream in tiles
// of 128 lanes: for each tile the distance stage runs once per row set
// t on rows t*L + m0 .. t*L + m0 + 127, and each thread folds its keys
// into the tile's running maxima in shared memory (its own 4 lanes of
// each of its warp's 8 centres, so no barrier; lanes at or past L stay
// 0, below every key), kept beside the staged chunks (SEL_FOLD_BYTES);
// the maxima then go into the lists as above, packed with the row they
// carry. Folded keys never reach device memory; the distance work is
// that of fast mode (L rounded up to 128, N / L times), the list work L
// keys a centre instead of N.
#define SEL_WARPS 8
#define SEL_TC (8 * SEL_WARPS)  // centres per block
#define SEL_TM 128              // candidates per tile, 4 per lane
#define SEL_KC 32               // channels per staged chunk
#define SEL_CS (SEL_TC + 4)     // row strides of the staged chunks: 16-byte
#define SEL_MS (SEL_TM + 4)     // rows; a row-major transpose hits 32 banks
#define SEL_SERIAL 4            // a batch with more keys above T is merged
#define SEL_STAGE_BYTES                                                 \
  (SEL_KC * (SEL_CS + SEL_MS) * 4 > SEL_TC * SEL_TM * 4                 \
       ? SEL_KC * (SEL_CS + SEL_MS) * 4                                  \
       : SEL_TC * SEL_TM * 4)

// approx mode (FOLD) keeps the tile's keys beside the staged chunks, not
// over them: its running maxima outlive the row sets' staging
#define SEL_FOLD_BYTES (SEL_KC * (SEL_CS + SEL_MS) * 4 + SEL_TC * SEL_TM * 4)

static size_t sv_select_smem(int kw, bool fold) {
  return (fold ? SEL_FOLD_BYTES : SEL_STAGE_BYTES) +
         (size_t)SEL_TC * (32 * kw + 1) * sizeof(sv_u64);
}

// dst[cc * (ROWS + 4) + t] = channel c0 + cc of row row_of(t) (0 where it
// is -1), for t < ROWS, cc < nc. Channel-major: consecutive threads read
// consecutive rows. Row-major: a warp reads 8 consecutive channels of 4
// rows, and its 32 stores fall in 32 banks (row stride = 4 mod 32).
template <bool ROW, int ROWS, class RowOf>
static __device__ __forceinline__ void sv_stage(float* dst,
                                                const float* __restrict__ x,
                                                RowOf row_of, int c0, int nc,
                                                int N, int C) {
  constexpr int ld = ROWS + 4;
  if constexpr (ROW) {
    const int ncp = (nc + 7) & ~7;
    for (int e = threadIdx.x; e < ROWS * ncp; e += blockDim.x) {
      const int cc = (e / (8 * ROWS)) * 8 + (e & 7), t = (e >> 3) % ROWS;
      const int r = row_of(t);
      if (cc < nc) dst[cc * ld + t] = r >= 0 ? x[(size_t)r * C + c0 + cc] : 0.f;
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * nc; e += blockDim.x) {
      const int cc = e / ROWS, t = e % ROWS, r = row_of(t);
      dst[cc * ld + t] = r >= 0 ? x[(size_t)(c0 + cc) * N + r] : 0.f;
    }
  }
}

// Rows r0 .. r0 + ROWS - 1 of the cloud, -1 past its N rows.
struct SvRun {
  int r0, N;
  __device__ __forceinline__ int operator()(int t) const {
    return r0 + t < N ? r0 + t : -1;
  }
};

static __device__ __forceinline__ sv_u64 sv_max64(sv_u64 a, sv_u64 b) { return a > b ? a : b; }
static __device__ __forceinline__ sv_u64 sv_min64(sv_u64 a, sv_u64 b) { return a < b ? a : b; }

// Sorts a bitonic sequence of 32 values over the warp, descending.
static __device__ __forceinline__ sv_u64 sv_bitonic_desc(sv_u64 v, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const sv_u64 o = __shfl_xor_sync(0xffffffffu, v, stride);
    v = (lane & stride) ? sv_min64(v, o) : sv_max64(v, o);
  }
  return v;
}

// Sorts 32 values over the warp, descending (lane 0 the largest).
static __device__ __forceinline__ sv_u64 sv_warp_sort_desc(sv_u64 v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const sv_u64 o = __shfl_xor_sync(0xffffffffu, v, stride);
      const bool desc = (lane & size) == 0, low = (lane & stride) == 0;
      v = low == desc ? sv_max64(v, o) : sv_min64(v, o);
    }
  return v;
}

// The list's entry r (0-based), on every lane.
template <int KW>
static __device__ __forceinline__ sv_u64 sv_entry(const sv_u64 (&L)[KW], int r) {
  sv_u64 v = L[0];
  if (KW > 1 && r >= 32) v = L[KW - 1];
  return __shfl_sync(0xffffffffu, v, r & 31);
}

// Inserts x (the same on every lane) into the descending list; the last
// entry falls off.
template <int KW>
static __device__ __forceinline__ void sv_insert(sv_u64 (&L)[KW], sv_u64 x, int lane) {
  int pos = 0;
#pragma unroll
  for (int w = 0; w < KW; ++w) pos += __popc(__ballot_sync(0xffffffffu, L[w] > x));
  sv_u64 carry = 0ull;  // entry 32w - 1 before the shift
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    sv_u64 up = __shfl_up_sync(0xffffffffu, L[w], 1);
    const sv_u64 last = __shfl_sync(0xffffffffu, L[w], 31);
    if (lane == 0) up = carry;
    const int r = 32 * w + lane;
    L[w] = r < pos ? L[w] : (r == pos ? x : up);
    carry = last;
  }
}

// Merges one value per lane (any order) into the descending list, keeping
// the 32 * KW largest of both.
template <int KW>
static __device__ __forceinline__ void sv_merge(sv_u64 (&L)[KW], sv_u64 x, int lane) {
  // y ascending over the lanes: max(L, y) is the top 32 of both, bitonic
  sv_u64 y = __shfl_sync(0xffffffffu, sv_warp_sort_desc(x, lane), 31 - lane);
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    const sv_u64 hi = sv_max64(L[w], y), lo = sv_min64(L[w], y);
    L[w] = sv_bitonic_desc(hi, lane);
    if (w + 1 < KW)  // the rest compete for the next 32 entries
      y = __shfl_sync(0xffffffffu, sv_bitonic_desc(lo, lane), 31 - lane);
  }
}

// The distance stage of a tile: acc[i][j] = <centre n0 + t0 + i,
// candidate cand(4 * lane + j)>, summed from 0.f channel by channel with
// __fmul_rn / __fadd_rn (see the selection below); cand(t) is the row of
// the tile's t-th candidate (SvRun: 128 consecutive rows), or -1. Every
// thread of the block calls it: it stages the chunks between
// __syncthreads.
template <bool ROW, class Cand>
static __device__ __forceinline__ void sv_tile_inner(
    float (&acc)[8][4], float* ctr_s, float* cand_s,
    const float* __restrict__ x, int n0, Cand cand, int t0, int lane, int N,
    int C) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < C; c0 += SEL_KC) {
    const int nc = min(SEL_KC, C - c0);
    __syncthreads();  // the previous chunk, or tile's keys, is consumed
    sv_stage<ROW, SEL_TC>(ctr_s, x, SvRun{n0, N}, c0, nc, N, C);
    sv_stage<ROW, SEL_TM>(cand_s, x, cand, c0, nc, N, C);
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < nc; ++cc) {
      const float4 qa = *(const float4*)(ctr_s + cc * SEL_CS + t0);
      const float4 qb = *(const float4*)(ctr_s + cc * SEL_CS + t0 + 4);
      const float4 p = *(const float4*)(cand_s + cc * SEL_MS + 4 * lane);
      const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(pv[j], q[i]));
    }
  }
}

// The certified candidate window (svnet_tpu_torch/ops/window.py;
// sv_round3.py:548-591, :1274-1313): keep (B, N / T, N / 128) int32, not 0
// where the key tile of T centres keeps the 128-row block; ok, one int32
// on the device, 0 where some tile keeps more than W rows, and then every
// block counts as kept, the capacity is N and the fold width kt.L, the
// round as without a window; W the compacted capacity and LW approx mode's
// fold width at W. W = 0: no window. T, N and W are multiples of 128, so a
// block of SEL_TC centres lies in one key tile and a run of 128 compacted
// positions is one kept block.
struct SvWindow {
  const int* keep = nullptr;
  const int* ok = nullptr;
  int T = 0, W = 0, LW = 0;
};

// Thread 0 lists the kept blocks of this block's key tile in ascending
// order into kb (shared, N / 128 + 2 ints): kb[0 .. n) the blocks (all of
// them where ok is 0), kb[N / 128] = n, kb[N / 128 + 1] = ok. Every thread
// of the block calls it (one barrier).
static __device__ __forceinline__ void sv_window_blocks(int* kb,
                                                        const SvWindow& win,
                                                        int b, int n0, int N,
                                                        int& nkept, bool& ok) {
  const int nb = N / SEL_TM;
  if (threadIdx.x == 0) {
    const int okv = *win.ok;
    const int* kf = win.keep + ((size_t)b * (N / win.T) + n0 / win.T) * nb;
    int c = 0;
    for (int bk = 0; bk < nb; ++bk)
      if (!okv || kf[bk] != 0) kb[c++] = bk;
    kb[nb] = c;
    kb[nb + 1] = okv;
  }
  __syncthreads();
  nkept = kb[nb];
  ok = kb[nb + 1] != 0;
}

// Candidate positions base + t -> rows, -1 (padding) from cnt on. In a
// key tile's window (kb, sv_window_blocks) position p is row
// kb[p / 128] * 128 + p % 128 (cnt = 128 per kept block); without one
// (kb null, cnt = N) it is row p.
struct SvWinRows {
  const int* kb;
  int cnt, base;
  __device__ __forceinline__ int operator()(int t) const {
    const int p = base + t;
    if (p >= cnt) return -1;
    return kb ? kb[p / SEL_TM] * SEL_TM + p % SEL_TM : p;
  }
};

// FAST: fast mode's key on the tiles' scales (SvKeyTiles), else exact's;
// FOLD (with FAST): approx mode's folded lanes; WIN: the candidate window
// (SvWindow). With WIN a block ranks its key tile's compacted window:
// exact and fast mode stream the kept blocks (128 compacted positions are
// one block, so a tile is still a run of rows), the keys packed with the
// absolute row; FOLD streams the W positions in row sets of L = LW, each
// position's row from the kept-block list (a row set may span two blocks,
// so its rows are staged one by one), padding contributing no key (the
// JAX kernel's _INT_MIN, sv_round3.py:586-591, below every key).
template <bool ROW, int KW, bool FAST, bool FOLD, bool WIN>
static __global__ void __launch_bounds__(SEL_WARPS * 32, 3)
sv_knn_select_kernel(const float* __restrict__ src,
                     const float* __restrict__ aa, int* __restrict__ wins,
                     int N, int C, int k, int rs, int ps, SvKeyTiles kt,
                     SvWindow win) {
  extern __shared__ __align__(16) unsigned char sv_smem[];
  float* ctr_s = (float*)sv_smem;           // (SEL_KC, SEL_CS) centres
  float* cand_s = ctr_s + SEL_KC * SEL_CS;  // (SEL_KC, SEL_MS) candidates
  // (SEL_TC, SEL_TM) a tile's keys: over the staged chunks, or (FOLD)
  // beside them
  unsigned* keys_s =
      (unsigned*)(sv_smem + (FOLD ? SEL_KC * (SEL_CS + SEL_MS) * 4 : 0));
  sv_u64* lists =  // (SEL_TC, 32 KW)
      (sv_u64*)(sv_smem + (FOLD ? SEL_FOLD_BYTES : SEL_STAGE_BYTES));
  sv_u64* upper = lists + SEL_TC * 32 * KW;              // (SEL_TC)
  int* kb = (int*)(upper + SEL_TC);  // (WIN) the kept blocks, N / 128 + 2
  const int b = blockIdx.y, n0 = blockIdx.x * SEL_TC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = warp * 8;  // this warp's first centre in the block
  const float* x = src + (size_t)b * C * N;
  const float* a = aa + (size_t)b * N;
  unsigned* wkeys = keys_s + t0 * SEL_TM;
  sv_u64* wlist = lists + t0 * 32 * KW;
  float ctr_sq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + t0 + i;
    ctr_sq[i] = n < N ? a[n] : 0.f;
  }
  // fast mode: this warp's centres' key-tile scales, read where the keys
  // are made (from L1), not held in registers across the distance stage
  const float* wscale = nullptr;
  if constexpr (FAST) wscale = kt.scale + (size_t)b * (N / kt.T);
  if (lane < 8) upper[t0 + lane] = ~0ull;
  // what the block ranks: Wc candidate positions (rows without a window),
  // folded to L lanes (FOLD)
  int nkept = N / SEL_TM, Wc = N, L = kt.L;
  if constexpr (WIN) {
    bool ok;
    sv_window_blocks(kb, win, b, n0, N, nkept, ok);
    if (ok) Wc = win.W, L = win.LW;
  }
  const int cnt = WIN ? nkept * SEL_TM : N;  // the candidate positions
  const int M = FOLD ? L : cnt;  // what a centre ranks

  for (int r0 = 0; r0 < k; r0 += 32 * KW) {
    const int kc = min(32 * KW, k - r0);
    for (int i = lane; i < 8 * 32 * KW; i += 32) wlist[i] = 0ull;
    // block-uniform trip counts: every warp reaches every __syncthreads
    for (int m0 = 0; m0 < M; m0 += SEL_TM) {
      // exact and fast mode: the tile's first row
      int rb = m0;
      if constexpr (WIN && !FOLD) rb = kb[m0 / SEL_TM] * SEL_TM;
      if constexpr (FOLD) {
        // lane m0 + 4 * lane + j of each centre: the largest key over its
        // positions base + 4 * lane + j, base = m0 + t * L
        for (int base = m0; base < Wc; base += L) {
          float acc[8][4];
          const SvWinRows rows{WIN ? kb : nullptr, cnt, base};
          sv_tile_inner<ROW>(acc, ctr_s, cand_s, x, n0, rows, t0, lane, N, C);
          int crow[4];  // the row of each of this thread's 4 lanes, or -1
#pragma unroll
          for (int j = 0; j < 4; ++j)
            crow[j] = m0 + 4 * lane + j < L ? rows(4 * lane + j) : -1;
          float cand_sq[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) cand_sq[j] = crow[j] >= 0 ? a[crow[j]] : 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int n = n0 + t0 + i;
            const float scale = n < N ? wscale[n / kt.T] : 0.f;
            uint4* slot = (uint4*)(wkeys + i * SEL_TM + 4 * lane);
            unsigned kv[4] = {0u, 0u, 0u, 0u};
            if (base != m0) {
              const uint4 was = *slot;
              kv[0] = was.x, kv[1] = was.y, kv[2] = was.z, kv[3] = was.w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (crow[j] < 0) continue;
              const unsigned key = sv_approx_key(
                  sv_neg_dist(acc[i][j], ctr_sq[i], cand_sq[j]), scale, kt.qlo,
                  kt.qhi, crow[j], kt.ib);
              kv[j] = key > kv[j] ? key : kv[j];
            }
            *slot = make_uint4(kv[0], kv[1], kv[2], kv[3]);
          }
        }
      } else {
        float acc[8][4];
        sv_tile_inner<ROW>(acc, ctr_s, cand_s, x, n0, SvRun{rb, N}, t0, lane,
                           N, C);
        float cand_sq[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + 4 * lane + j;
          cand_sq[j] = m < M ? a[rb + 4 * lane + j] : 0.f;
        }
        __syncthreads();  // every warp is done with the staged chunk
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          unsigned kv[4];
          float scale = 0.f;
          if constexpr (FAST) {
            const int n = n0 + t0 + i;
            scale = n < N ? wscale[n / kt.T] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float neg = sv_neg_dist(acc[i][j], ctr_sq[i], cand_sq[j]);
            if constexpr (FAST)
              kv[j] = sv_fast_ukey(neg, scale, kt.qlo, kt.qhi);
            else
              kv[j] = sv_ukey(neg);
          }
          *(uint4*)(wkeys + i * SEL_TM + 4 * lane) =
              make_uint4(kv[0], kv[1], kv[2], kv[3]);
        }
      }
      __syncwarp();
#pragma unroll 1
      for (int i = 0; i < 8; ++i) {
        if (n0 + t0 + i >= N) break;  // warp-uniform
        sv_u64* li = wlist + i * 32 * KW;
        const sv_u64 up = upper[t0 + i];
        sv_u64 L_[KW];
#pragma unroll
        for (int w = 0; w < KW; ++w) L_[w] = li[32 * w + lane];
        sv_u64 T = sv_entry<KW>(L_, kc - 1);
#pragma unroll 1
        for (int j = 0; j < SEL_TM; j += 32) {
          const int m = m0 + j + lane;
          sv_u64 v = 0ull;
          if (m < M) {
            const unsigned key = wkeys[i * SEL_TM + j + lane];
            v = sv_pack(key, FOLD ? sv_approx_row(key, kt.ib) : rb + j + lane, N);
          }
          const bool pass = v > T && v < up;
          unsigned mask = __ballot_sync(0xffffffffu, pass);
          if (__popc(mask) > SEL_SERIAL) {
            sv_merge<KW>(L_, pass ? v : 0ull, lane);
            T = sv_entry<KW>(L_, kc - 1);
          } else {  // T is refreshed after the batch: a key that falls
                    // below it meanwhile lands past entry kc - 1
            while (mask) {
              const int s = __ffs(mask) - 1;
              mask &= mask - 1;
              sv_insert<KW>(L_, __shfl_sync(0xffffffffu, v, s), lane);
            }
            T = sv_entry<KW>(L_, kc - 1);
          }
        }
#pragma unroll
        for (int w = 0; w < KW; ++w) li[32 * w + lane] = L_[w];
      }
    }
    __syncwarp();
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + t0 + i;
      if (n >= N) break;
      const sv_u64* li = wlist + i * 32 * KW;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const int r = 32 * w + lane;
        if (r < kc)
          wins[(size_t)blockIdx.y * k * N + (size_t)(r0 + r) * rs + (size_t)n * ps] =
              N - 1 - (int)(unsigned)(li[r] & 0xffffffffull);
      }
      if (lane == 0) upper[t0 + i] = li[kc - 1];
    }
    __syncwarp();
  }
}

// Shared memory of the window's kept-block list (sv_window_blocks).
static size_t sv_window_smem(int N) { return (size_t)(N / SEL_TM + 2) * sizeof(int); }

template <bool ROW, int KW, bool FAST, bool FOLD, bool WIN>
static cudaError_t sv_knn_select_launch(const float* src, const float* aa,
                                        int* wins, int B, int N, int C, int k,
                                        cudaStream_t stream, bool point_major,
                                        SvKeyTiles kt, SvWindow win) {
  const size_t smem = sv_select_smem(KW, FOLD) + (WIN ? sv_window_smem(N) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      sv_knn_select_kernel<ROW, KW, FAST, FOLD, WIN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + SEL_TC - 1) / SEL_TC, B);
  sv_knn_select_kernel<ROW, KW, FAST, FOLD, WIN><<<grid, SEL_WARPS * 32, smem, stream>>>(
      src, aa, wins, N, C, k, point_major ? 1 : N, point_major ? k : 1, kt, win);
  return cudaGetLastError();
}

// aa[b*N + m] = |x_m|^2 for the selection and its pre-pass.
template <bool ROW>
static cudaError_t sv_sqnorm(const float* src, float* aa, int B, int N, int C,
                             cudaStream_t stream) {
  const long long BN = (long long)B * N;
  sv_sqnorm_kernel<ROW><<<(unsigned)((BN + 255) / 256), 256, 0, stream>>>(
      src, aa, B, N, C);
  return cudaGetLastError();
}

template <bool ROW, bool FAST, bool FOLD, bool WIN>
static cudaError_t sv_knn_select_k(const float* src, const float* aa, int* wins,
                                   int B, int N, int C, int k,
                                   cudaStream_t stream, bool point_major,
                                   SvKeyTiles kt, SvWindow win) {
  return k <= 32 ? sv_knn_select_launch<ROW, 1, FAST, FOLD, WIN>(
                       src, aa, wins, B, N, C, k, stream, point_major, kt, win)
                 : sv_knn_select_launch<ROW, 2, FAST, FOLD, WIN>(
                       src, aa, wins, B, N, C, k, stream, point_major, kt, win);
}

template <bool ROW, bool FAST, bool FOLD = false>
static cudaError_t sv_knn_select_t(const float* src, float* aa, int* wins,
                                   int B, int N, int C, int k,
                                   cudaStream_t stream, bool point_major,
                                   SvKeyTiles kt, SvWindow win) {
  cudaError_t err = sv_sqnorm<ROW>(src, aa, B, N, C, stream);
  if (err != cudaSuccess) return err;
  return win.W ? sv_knn_select_k<ROW, FAST, FOLD, true>(
                     src, aa, wins, B, N, C, k, stream, point_major, kt, win)
               : sv_knn_select_k<ROW, FAST, FOLD, false>(
                     src, aa, wins, B, N, C, k, stream, point_major, kt, win);
}

// Row bits of fast mode's packed key at N rows (quant.py::idx_bits).
static int sv_idx_bits(int N) {
  int b = 13;
  while ((1 << b) < N) ++b;
  return b;
}

// (N / d) a power of two, d dividing N.
static bool sv_halves(int N, int d) {
  return d >= 1 && N % d == 0 && ((N / d) & (N / d - 1)) == 0;
}

// A window the kernels take (SvWindow): T, N and W multiples of 128, T
// dividing N, T <= W < N, and with a fold (L > 0) W halving evenly to LW
// >= k.
static bool sv_window_ok(const SvWindow& win, int N, int k, int L) {
  if (win.W == 0) return true;
  if (win.keep == nullptr || win.ok == nullptr || win.T < SEL_TM ||
      win.T % SEL_TM != 0 || N % win.T != 0 || N % SEL_TM != 0 ||
      win.W % SEL_TM != 0 || win.W < win.T || win.W >= N)
    return false;
  return L == 0 || (win.LW >= k && sv_halves(win.W, win.LW));
}

// Squared norms + selection for a channel-major (B, C, N) source, or a
// row-major (B, N, C) one when row_major. aa is a (B, N) scratch buffer the
// wrapper allocated. wins is (B, k, N), or (B, N, k) when point_major.
// With tile_scale (B, N / T), fast mode's key on tiles of T centres
// (SvKeyTiles), else exact mode's; with a fold width L > 0 too, approx
// mode's: N / L a power of two (N halves evenly down to L) and k <= L.
// win: the candidate window (SvWindow), W = 0 for none.
static cudaError_t sv_knn_select(const float* src, float* aa, int* wins,
                                 int B, int N, int C, int k,
                                 cudaStream_t stream, bool point_major = false,
                                 bool row_major = false,
                                 const float* tile_scale = nullptr, int T = 0,
                                 int L = 0, SvWindow win = SvWindow{}) {
  if (k > N || k < 1 || C < 1 || !sv_window_ok(win, N, k, L))
    return cudaErrorInvalidValue;
  const int ib = sv_idx_bits(N);
  SvKeyTiles kt{tile_scale, T, (float)(-(1 << (18 < 31 - ib ? 18 : 31 - ib)) + 1),
                (float)((1 << (31 - ib)) - 1), L, ib};
  if (tile_scale != nullptr && (T < 1 || N % T != 0 || ib > 30))
    return cudaErrorInvalidValue;
  if (L != 0) {
    if (tile_scale == nullptr || k > L || !sv_halves(N, L))
      return cudaErrorInvalidValue;
    return row_major ? sv_knn_select_t<true, true, true>(src, aa, wins, B, N, C, k,
                                                         stream, point_major, kt, win)
                     : sv_knn_select_t<false, true, true>(src, aa, wins, B, N, C, k,
                                                          stream, point_major, kt, win);
  }
  if (tile_scale != nullptr)
    return row_major ? sv_knn_select_t<true, true>(src, aa, wins, B, N, C, k,
                                                   stream, point_major, kt, win)
                     : sv_knn_select_t<false, true>(src, aa, wins, B, N, C, k,
                                                    stream, point_major, kt, win);
  return row_major ? sv_knn_select_t<true, false>(src, aa, wins, B, N, C, k,
                                                  stream, point_major, kt, win)
                   : sv_knn_select_t<false, false>(src, aa, wins, B, N, C, k,
                                                   stream, point_major, kt, win);
}

// ---------------------------------------------------------------------------
// a staged tile of inner products over a row-major source
// ---------------------------------------------------------------------------
#define SV_PI_KC 16  // channels a stage

static __device__ __forceinline__ unsigned sv_smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of one f32 into shared memory, 0 there where !valid (src must
// still be a mapped address).
static __device__ __forceinline__ void sv_cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sv_smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

static __device__ __forceinline__ void sv_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
static __device__ __forceinline__ void sv_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[cc * (ROWS + 4) + t] = channel c0 + cc of row row_of(t) of a
// row-major (N, C) source (0 where it is -1), t < ROWS, cc < nc <=
// SV_PI_KC, by cp.async: thread i copies channels i % 8 + 8 v of rows
// i / 8 + blockDim / 8 u, so a warp copies 8 consecutive channels of 4
// rows, its 32 stores fall in 32 banks (row stride = 4 mod 32), and each
// row's address is taken once.
template <int ROWS, class RowOf>
static __device__ __forceinline__ void sv_stage_async(float* dst,
                                                      const float* __restrict__ x,
                                                      RowOf row_of, int c0, int nc,
                                                      int C) {
  constexpr int ld = ROWS + 4;
  const int c = threadIdx.x & 7;
  for (int t = threadIdx.x >> 3; t < ROWS; t += blockDim.x >> 3) {
    const int r = row_of(t);
    const float* src = x + (r >= 0 ? (size_t)r * C + c0 : 0);
#pragma unroll
    for (int v = 0; v < SV_PI_KC / 8; ++v)
      if (c + 8 * v < nc) sv_cp4(dst + (c + 8 * v) * ld + t, src + c + 8 * v, r >= 0);
  }
}

// The row of value i of thread t in a tile of R rows whose threads hold TI
// values each: TI / 4 float4 groups, group g at g * R / (TI / 4) + 4 t, so
// a warp's float4 reads of a staged channel are contiguous.
template <int R, int TI>
static __device__ __forceinline__ int sv_tile_row(int t, int i) {
  return (i >> 2) * (R / (TI / 4)) + 4 * t + (i & 3);
}

// Floats of sv_pair_tile's two stages: NA sources of RA rows, one of RB.
#define SV_PT_FLOATS(NA, RA, RB) (2 * SV_PI_KC * ((NA) * ((RA) + 4) + (RB) + 4))
#define SV_PI_FLOATS(RA, RB) SV_PT_FLOATS(1, RA, RB)

// acc[i][j] = 0.f folded over the channels c = 0, 1, ..., C - 1 in order
// by op(acc[i][j], a_c, a2_c, b_c), a (a2) channel c of row
// rowa(sv_tile_row<RA, TA>(ty, i)) of the row-major (N, C) source xa
// (xa2, read where NA = 2), b that of row rowb(sv_tile_row<RB, TB>(tx,
// j)) of xb, ty = thread / (RB / TB), tx = thread % (RB / TB), over a
// block of (RA / TA) (RB / TB) threads; a row -1 reads as 0. Chunks of
// SV_PI_KC channels of every operand stream through two stages of sm
// (SV_PT_FLOATS, 16-byte aligned) by cp.async: chunk c + 1 loads while
// chunk c's operations run, one barrier a chunk. A thread reads NA TA / 4
// + TB / 4 float4 of shared memory a channel for TA TB calls of op. Every
// thread of the block calls it, once.
template <int RA, int RB, int TA, int TB, int NA, class RowA, class RowB, class Op>
static __device__ __forceinline__ void sv_pair_tile(float (&acc)[TA][TB], float* sm,
                                                    const float* __restrict__ xa,
                                                    const float* __restrict__ xa2,
                                                    const float* __restrict__ xb, RowA rowa,
                                                    RowB rowb, int C, Op op) {
  static_assert(NA == 1 || NA == 2, "one or two A sources");
  constexpr int LA = RA + 4, LB = RB + 4, STAGE = SV_PI_KC * (NA * LA + LB);
  const int tx = threadIdx.x % (RB / TB), ty = threadIdx.x / (RB / TB);
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j) acc[i][j] = 0.f;
  auto stage = [&](int ch) {
    float* s = sm + (ch & 1) * STAGE;
    const int c0 = ch * SV_PI_KC, nc = min(SV_PI_KC, C - c0);
    sv_stage_async<RA>(s, xa, rowa, c0, nc, C);
    if constexpr (NA == 2) sv_stage_async<RA>(s + SV_PI_KC * LA, xa2, rowa, c0, nc, C);
    sv_stage_async<RB>(s + SV_PI_KC * NA * LA, xb, rowb, c0, nc, C);
    sv_cp_commit();
  };
  auto step = [&](const float* as, const float* bs) {
    float a[TA], a2[TA], b[TB];
#pragma unroll
    for (int g = 0; g < TA / 4; ++g) {
      const int r = sv_tile_row<RA, TA>(ty, 4 * g);
      const float4 v = *(const float4*)(as + r);
      a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z, a[4 * g + 3] = v.w;
      if constexpr (NA == 2) {
        const float4 w = *(const float4*)(as + SV_PI_KC * LA + r);
        a2[4 * g] = w.x, a2[4 * g + 1] = w.y, a2[4 * g + 2] = w.z, a2[4 * g + 3] = w.w;
      }
    }
#pragma unroll
    for (int g = 0; g < TB / 4; ++g) {
      const float4 v = *(const float4*)(bs + sv_tile_row<RB, TB>(tx, 4 * g));
      b[4 * g] = v.x, b[4 * g + 1] = v.y, b[4 * g + 2] = v.z, b[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) op(acc[i][j], a[i], NA == 2 ? a2[i] : a[i], b[j]);
  };
  const int nch = (C + SV_PI_KC - 1) / SV_PI_KC;
  stage(0);
  for (int ch = 0; ch < nch; ++ch) {
    sv_cp_wait<0>();
    __syncthreads();  // chunk ch is in; chunk ch - 1's stage is consumed
    if (ch + 1 < nch) stage(ch + 1);
    const float* as = sm + (ch & 1) * STAGE;
    const float* bs = as + SV_PI_KC * NA * LA;
    const int nc = min(SV_PI_KC, C - ch * SV_PI_KC);
    if (nc == SV_PI_KC) {
#pragma unroll
      for (int cc = 0; cc < SV_PI_KC; ++cc) step(as + cc * LA, bs + cc * LB);
    } else {
      for (int cc = 0; cc < nc; ++cc) step(as + cc * LA, bs + cc * LB);
    }
  }
}

// acc[i][j] = <row rowa(sv_tile_row<RA, TA>(ty, i)), row rowb(sv_tile_row<RB,
// TB>(tx, j))> of a row-major (N, C) source by sv_pair_tile. Every inner
// product is summed from 0.f channel by channel with __fmul_rn /
// __fadd_rn, as the plain versions and the selection (sv_tile_inner) sum
// it, so it is bitwise the same whichever of the two rows is the centre
// (an IEEE product commutes). A thread reads TA / 4 + TB / 4 float4 of
// shared memory a channel for 2 TA TB operations.
template <int RA, int RB, int TA, int TB, class RowA, class RowB>
static __device__ __forceinline__ void sv_pair_inner(float (&acc)[TA][TB], float* sm,
                                                     const float* __restrict__ x,
                                                     RowA rowa, RowB rowb, int C) {
  sv_pair_tile<RA, RB, TA, TB, 1>(
      acc, sm, x, x, x, rowa, rowb, C,
      [](float& s, float a, float, float b) { s = __fadd_rn(s, __fmul_rn(a, b)); });
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

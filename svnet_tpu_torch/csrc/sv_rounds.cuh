// The block kernels of the fused rounds (exact mode; fast mode through B1
// and B2), shared by the channel-major round3 launchers
// (sv_round3_first.cu, sv_round3.cu), the row-major round2 and round
// launchers (sv_round2.cu, sv_round.cu) and the row-major launchers that
// take the caller's neighbour ids (sv_edge.cu, through sv_first_block and
// sv_conv_block). Each kernel is a template
// on the layout: with ROW the outputs and the neighbour ids are row-major
// -- (B, N, C) and (B, N, k) -- else channel-major (B, C, N) with ids
// (B, k, N). The first round reads its points in the same layout; the conv
// round reads a row-major source in both (a neighbour is one contiguous
// row; the channel-major launcher is handed a row-major copy). Only the
// addressing differs; the arithmetic, and so every output bit, is the
// same in both layouts. The per-point gate sums always leave channel-major
// (B, channels, N): the wrappers reduce them over N in one layout.
#pragma once

#include "sv_common.cuh"
#include "sv_mma.cuh"

// ---------------------------------------------------------------------------
// first round (xyz edges, FP block)
// ---------------------------------------------------------------------------
// Edges [nbr - ctr, ctr] (NCH = 2, DGCNN) or [nbr - ctr, ctr, nbr x ctr]
// (NCH = 3, SV-PointNet), init Vector2Scalar (wz0) and the block's
// Vector2Scalar (wz1), FP linear1 + folded BN + leaky 0.2 -> max over k,
// linear2 + VectorBN -> mean over k, and the init-scalar sums the gate
// reads. S_out is 32; VO, the vector width, is 10 (SV_DGCNN_CLS,
// SV-PointNet) or 16 (SV_DGCNN_PSEG's make_divisible widths).
//
// A block of FB_THREADS threads owns FB_TP centres and walks their ranks
// in chunks of FB_G; per chunk, two barriers and three phases:
//   edges       a thread per edge (rank slot, centre): the edge, both
//               frames and the invariants xc (6*NCH floats, j-major) into
//               XC, the edge's vectors into VE. The neighbour's
//               coordinates were loaded during the previous chunk and its
//               id the chunk before that, so no id -> coordinate chain
//               waits on device memory.
//   linear1     lane = output o (S_out = 32 = a warp), w1's column o in
//               registers for the whole kernel; a warp owns FB_CW centres,
//               reads each edge's xc as broadcast float4s and sums
//               xc . w1[:, o] over q in order, then BN, leaky and the
//               running max (registers).
//   linear2     thread = (centre, half of the VO outputs): linear2 over
//               the channels in order, VectorBN, the vector sums over the
//               ranks in rank order (registers); the first half also sums
//               the init scalars (the gate's statistics) in rank order.
// The outputs leave through shared memory, coalesced in both layouts.
// Every product and sum is the plain version's (first_block_rows), in
// its order, f32 with no FMA: bitwise equal outputs.
#define F_S_OUT 32
#define FB_TP 128                       // centres per block
#define FB_G 2                          // ranks per chunk
#define FB_THREADS (FB_TP * FB_G)       // one edge a thread in the edge phase
#define FB_CW (FB_TP / (FB_THREADS / 32))  // centres per warp in linear1

template <int NCH, int VO, bool ROW>
static __global__ void __launch_bounds__(FB_THREADS, 2)
sv_first_block_kernel(
    const float* __restrict__ pts, const int* __restrict__ wins,
    const float* __restrict__ wz0, const float* __restrict__ wz1,
    const float* __restrict__ w1, const float* __restrict__ a1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ a2, const float* __restrict__ b2,
    float* __restrict__ s_out, float* __restrict__ v_out,
    float* __restrict__ ssum, int N, int k) {
  constexpr int NSS = 3 * NCH, NX = 6 * NCH, NXP = (NX + 3) & ~3;
  constexpr int VG = VO / 2;                // linear2 outputs a thread
  constexpr int NO = F_S_OUT + 3 * VO + 1;  // a centre's row of OUT (odd)
  constexpr int XCW = FB_G * FB_TP * NXP, VEW = FB_G * 3 * NCH * FB_TP;
  constexpr int SMW = XCW + VEW > FB_TP * NO ? XCW + VEW : FB_TP * NO;
  __shared__ __align__(16) float sm[SMW];
  __shared__ float wzs[6 * NCH], w2s[NCH * VO], a2s[VO], b2s[VO];
  float* XC = sm;        // (G, TP, NXP) invariants [init | block]
  float* VE = sm + XCW;  // (G, 3, NCH, TP) the edges' vectors
  float* OUT = sm;       // after the ranks: (TP, NO) [s | v i-major]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, n0 = blockIdx.x * FB_TP;
  // this thread's centre and rank slot (edge phase) or output half (linear2)
  const int t = tid % FB_TP, g1 = tid / FB_TP, n = n0 + t;
  const bool valid = n < N;
  const float* x = pts + (size_t)b * 3 * N;
  auto coord = [&](int m, int i) {
    return ROW ? x[(size_t)m * 3 + i] : x[(size_t)i * N + m];
  };
  auto id_at = [&](int r) {
    return valid && r < k ? (ROW ? wins[((size_t)b * N + n) * k + r]
                                 : wins[((size_t)b * k + r) * N + n])
                          : -1;
  };

  for (int i = tid; i < 6 * NCH; i += FB_THREADS)
    wzs[i] = i < 3 * NCH ? wz0[i] : wz1[i - 3 * NCH];
  for (int i = tid; i < NCH * VO; i += FB_THREADS) w2s[i] = w2[i];
  for (int i = tid; i < VO; i += FB_THREADS) a2s[i] = a2[i], b2s[i] = b2[i];
  float ctr[3], nb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ctr[i] = valid ? coord(n, i) : 0.f;
  int row = id_at(g1);
#pragma unroll
  for (int i = 0; i < 3; ++i) nb[i] = row >= 0 ? coord(row, i) : 0.f;
  int nrow = id_at(FB_G + g1);

  float w1r[NX];  // linear1: column o = lane of w1
#pragma unroll
  for (int q = 0; q < NX; ++q) w1r[q] = w1[q * F_S_OUT + lane];
  const float a1r = a1[lane], b1r = b1[lane];
  float sacc[FB_CW];
#pragma unroll
  for (int c = 0; c < FB_CW; ++c) sacc[c] = -INFINITY;
  float vacc[VG][3], ss[NSS];
#pragma unroll
  for (int o = 0; o < VG; ++o)
#pragma unroll
    for (int i = 0; i < 3; ++i) vacc[o][i] = 0.f;
#pragma unroll
  for (int j = 0; j < NSS; ++j) ss[j] = 0.f;
  __syncthreads();  // the staged weights

  for (int r0 = 0; r0 < k; r0 += FB_G) {
    const int g = min(FB_G, k - r0);
    {  // edges: this thread's edge (rank r0 + g1 of centre t)
      float ve[3][NCH];  // per component i: [nbr - ctr, ctr(, cross)]
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ve[i][0] = nb[i] - ctr[i];
        ve[i][1] = ctr[i];
      }
      if constexpr (NCH == 3) {
        ve[0][2] = nb[1] * ctr[2] - nb[2] * ctr[1];
        ve[1][2] = nb[2] * ctr[0] - nb[0] * ctr[2];
        ve[2][2] = nb[0] * ctr[1] - nb[1] * ctr[0];
      }
      {  // the edge's vectors, for linear2
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            VE[((g1 * 3 + i) * NCH + c) * FB_TP + t] = ve[i][c];
      }
      {  // frames and invariants, rows j*NCH + c: init_scalar (wz0) then
         // the block's v2s (wz1); frames summed over c in order
        float xc[NXP];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* wz = wzs + h * 3 * NCH;
          float z[3][3];
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              float acc = ve[i][0] * wz[j];
#pragma unroll
              for (int c = 1; c < NCH; ++c) acc += ve[i][c] * wz[c * 3 + j];
              z[i][j] = acc;
            }
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int c = 0; c < NCH; ++c)
              xc[h * NSS + j * NCH + c] =
                  ve[0][c] * z[0][j] + ve[1][c] * z[1][j] + ve[2][c] * z[2][j];
        }
#pragma unroll
        for (int q = NX; q < NXP; ++q) xc[q] = 0.f;
        float4* dst = (float4*)(XC + (size_t)(g1 * FB_TP + t) * NXP);
#pragma unroll
        for (int q = 0; q < NXP / 4; ++q)
          dst[q] = make_float4(xc[4 * q], xc[4 * q + 1], xc[4 * q + 2], xc[4 * q + 3]);
      }
    }
    {  // gather: the next chunk's neighbour, and the id of the one after
      row = nrow;
#pragma unroll
      for (int i = 0; i < 3; ++i) nb[i] = row >= 0 ? coord(row, i) : 0.f;
      nrow = id_at(r0 + 2 * FB_G + g1);
    }
    __syncthreads();
    for (int gg = 0; gg < g; ++gg) {  // linear1, BN, leaky, running max
#pragma unroll
      for (int c = 0; c < FB_CW; ++c) {
        const float4* xr =
            (const float4*)(XC + (size_t)(gg * FB_TP + warp * FB_CW + c) * NXP);
        float h = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < NXP / 4; ++q4) {
          const float4 v = xr[q4];
          const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (4 * q4 + u < NX) h += xv[u] * w1r[4 * q4 + u];
        }
        sacc[c] = fmaxf(sacc[c], sv_leaky(h * a1r + b1r));
      }
    }
    for (int gg = 0; gg < g; ++gg) {  // linear2, VectorBN, vector sums
      float ve[3][NCH];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          ve[i][c] = VE[((gg * 3 + i) * NCH + c) * FB_TP + t];
#pragma unroll
      for (int oo = 0; oo < VG; ++oo) {
        const int o = g1 * VG + oo;
        float wl[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float acc = ve[i][0] * w2s[o];
#pragma unroll
          for (int c = 1; c < NCH; ++c) acc += ve[i][c] * w2s[c * VO + o];
          wl[i] = acc;
        }
        const float nrm = sqrtf(wl[0] * wl[0] + wl[1] * wl[1] + wl[2] * wl[2]) + SV_EPS;
        const float f = a2s[o] + b2s[o] / nrm;
#pragma unroll
        for (int i = 0; i < 3; ++i) vacc[oo][i] += wl[i] * f;
      }
    }
    if (g1 == 0)  // ss sums: the init scalars over the ranks, in order
      for (int gg = 0; gg < g; ++gg)
#pragma unroll
        for (int j = 0; j < NSS; ++j) ss[j] += XC[(size_t)(gg * FB_TP + t) * NXP + j];
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < FB_CW; ++c) OUT[(warp * FB_CW + c) * NO + lane] = sacc[c];
  const float inv_k = (float)(1.0 / k);
#pragma unroll
  for (int oo = 0; oo < VG; ++oo)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      OUT[t * NO + F_S_OUT + i * VO + g1 * VG + oo] = vacc[oo][i] * inv_k;
  __syncthreads();
  {  // writes, coalesced: the block's rows (ROW), else its columns
    const int nt = min(FB_TP, N - n0);
    if (valid && g1 == 0)
#pragma unroll
      for (int j = 0; j < NSS; ++j) ssum[((size_t)b * NSS + j) * N + n] = ss[j];
    if constexpr (ROW) {
      for (int i = tid; i < nt * F_S_OUT; i += FB_THREADS)
        s_out[((size_t)b * N + n0) * F_S_OUT + i] = OUT[(i / F_S_OUT) * NO + i % F_S_OUT];
      for (int i = tid; i < nt * 3 * VO; i += FB_THREADS)
        v_out[((size_t)b * N + n0) * 3 * VO + i] =
            OUT[(i / (3 * VO)) * NO + F_S_OUT + i % (3 * VO)];
    } else {
      for (int i = tid; i < FB_TP * F_S_OUT; i += FB_THREADS)
        if (i % FB_TP < nt)
          s_out[((size_t)b * F_S_OUT + i / FB_TP) * N + n0 + i % FB_TP] =
              OUT[(i % FB_TP) * NO + i / FB_TP];
      for (int i = tid; i < FB_TP * 3 * VO; i += FB_THREADS)
        if (i % FB_TP < nt)
          v_out[((size_t)b * 3 * VO + i / FB_TP) * N + n0 + i % FB_TP] =
              OUT[(i % FB_TP) * NO + F_S_OUT + i / FB_TP];
    }
  }
}

// The block kernel on the caller's neighbour ids, for the edge channel
// count (2, or 3 with cross) and the vector width (10 or 16).
template <bool ROW>
static int sv_first_block(const float* pts, const int* wins, const float* wz0,
                          const float* wz1, const float* w1, const float* a1,
                          const float* b1, const float* w2, const float* a2,
                          const float* b2, float* s_out, float* v_out,
                          float* ssum, int B, int N, int k, int S_out,
                          int V_out, int cross, cudaStream_t st) {
  if (S_out != F_S_OUT || (V_out != 10 && V_out != 16))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + FB_TP - 1) / FB_TP, B);
#define SV_FIRST(NCH, VO)                                                   \
  sv_first_block_kernel<NCH, VO, ROW><<<grid, FB_THREADS, 0, st>>>(         \
      pts, wins, wz0, wz1, w1, a1, b1, w2, a2, b2, s_out, v_out, ssum, N, k)
  if (cross) {
    if (V_out == 10) SV_FIRST(3, 10); else SV_FIRST(3, 16);
  } else {
    if (V_out == 10) SV_FIRST(2, 10); else SV_FIRST(2, 16);
  }
#undef SV_FIRST
  return (int)cudaGetLastError();
}

// Selection over the xyz points (C = 3), then the block kernel. Fast mode
// (tile_scale (B, N / T), sv_knn_select) selects on the raw points and
// runs the block on pts_q, the points through the gather grid (neighbours
// and centres alike, so a self-edge is 0); exact mode leaves pts_q null.
// Approx mode is fast mode with the fold width L > 0. win: the selection's
// candidate window (sv_common.cuh, SvWindow), W = 0 for none; the block
// kernel takes the absolute ids either way.
template <bool ROW>
static int sv_first_round(const float* pts, float* aa, const float* wz0,
                          const float* wz1, const float* w1, const float* a1,
                          const float* b1, const float* w2, const float* a2,
                          const float* b2, float* s_out, float* v_out,
                          float* ssum, int* wins, int B, int N, int k,
                          int S_out, int V_out, int cross, cudaStream_t st,
                          const float* pts_q = nullptr,
                          const float* tile_scale = nullptr, int T = 0,
                          int L = 0, SvWindow win = SvWindow{}) {
  if (S_out != F_S_OUT || (V_out != 10 && V_out != 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = sv_knn_select(pts, aa, wins, B, N, 3, k, st,
                                  /*point_major=*/ROW, /*row_major=*/ROW,
                                  tile_scale, T, L, win);
  if (err != cudaSuccess) return (int)err;
  return sv_first_block<ROW>(pts_q ? pts_q : pts, wins, wz0, wz1, w1, a1, b1,
                             w2, a2, b2, s_out, v_out, ssum, B, N, k, S_out,
                             V_out, cross, st);
}

// ---------------------------------------------------------------------------
// conv round (joint-feature edges, binary or FP block)
// ---------------------------------------------------------------------------
// A persistent block of RB_THREADS threads walks tiles of RB_TP centres
// and, per tile, chunks of RB_G ranks (RB_E edges, rank-major: edge
// e = g * RB_TP + t). Per chunk, four barriers:
//   gather      a warp per (32-channel chunk, centre), lanes over the
//               channels of a neighbour's row, RB_GP pairs at once, each
//               lane over the chunk's ranks in rank order (the source is
//               row-major in both layouts; the channel-major wrapper
//               passes a row-major copy; the ids were staged during the
//               previous chunk). The edge scalars go straight to linear1's
//               operand (signed when binary), the vectors' difference half
//               to VE, and the gate statistics are summed here
//   frames      z_i[j] = sum_c v_e[i][c] wz[c][j], channel by channel
//   invariants  sv[j][c] (sv_dot3_rn), a warp per edge, signed when binary
//   linear1 and the vector path, side by side. Binary: sign(x + beta) by
//               the sign weights on the tensor cores (sv_mma.cuh; exact),
//               the weights staged once per block; a warp owns 16 centres
//               x 16 outputs over every rank, applies BN and leaky to its
//               accumulators and folds them into the running max over the
//               ranks (shared memory, one owner per entry). FP: each thread
//               owns 2 centres x 4 outputs and sums x . w1 over the rows
//               in order, as the plain version. The vector path: a thread
//               owns (centre, 3 outputs), runs linear2 over the channels
//               in order from w2 staged in shared memory, and adds the
//               ranks in rank order.
// The pooled maxima, vector sums and gate sums stay in shared memory
// across the chunks; nothing of shape (B, N, k, C) reaches device memory.
#define RB_TP 32  // centre points per tile
#define RB_G 2    // neighbour ranks per chunk
#define RB_E (RB_TP * RB_G)
#define RB_THREADS 512
#define RB_GP 8   // (channel chunk, centre) pairs a warp gathers at once

struct RbSmem {
  size_t wx, ve, z, ctr, w2, par, rows, sacc, vacc, sesum, total;
};

// ``stats``: room for the per-point sums of the edge scalars (the gate
// statistics); the gated variant emits none. Binary: the sign weights
// (sv_pad16(S_out) rows) and the signed operand (RB_E rows), bf16 with
// row stride sv_mma_ld(IN1); FP: the operand in f32.
static RbSmem rb_layout(int S, int V, int S_out, int V_out, int binary,
                        bool stats = true) {
  const int C = S + 3 * V, IN1 = 2 * S + 6 * V;
  RbSmem L;
  size_t o = 0;
  auto take = [&o](size_t bytes) { size_t at = o; o += (bytes + 127) & ~(size_t)127; return at; };
  L.wx = take(binary ? (size_t)(sv_pad16(S_out) + RB_E) * sv_mma_ld(IN1) * 2
                     : (size_t)RB_E * IN1 * 4);
  L.ve = take((size_t)RB_E * 3 * V * 4);
  L.z = take((size_t)RB_E * 9 * 4);
  L.ctr = take((size_t)RB_TP * C * 4);
  L.w2 = take((size_t)2 * V * V_out * 4);
  L.par = take((size_t)(IN1 + 6 * V + 2 * S_out + 3 * V_out) * 4);
  L.rows = take((size_t)2 * RB_E * 4);
  L.sacc = take((size_t)RB_TP * S_out * 4);
  L.vacc = take((size_t)RB_TP * 3 * V_out * 4);
  L.sesum = take(stats ? (size_t)RB_TP * 2 * S * 4 : 0);
  L.total = o;
  return L;
}

// src is row-major (B, N, S + 3V) in both layouts; ROW picks the layout
// of the ids ((B, N, k), else (B, k, N); one cloud's ids start ids_bs
// elements after the previous cloud's, N * k when packed, more for the
// first ranks of a wider tensor) and of the outputs. GATED: v
// leaves gated, (sum * (1/k)) * gate[b, o] with gate (B, V_out), and no
// gate statistics are summed (ssum unused); else v leaves ungated and ssum
// takes the per-point sums of the edge scalars. V2BF16 (B10c's exact=False):
// linear2 reads each edge vector [nbr - ctr | ctr] rounded to bf16 (the
// caller passes w2 rounded to bf16); the frames and invariants read VE as
// it is, and the invariants stage, VE's last other reader, rounds it in
// place, once a value.
template <bool ROW, bool GATED = false, bool V2BF16 = false>
static __global__ void __launch_bounds__(RB_THREADS, 1)
sv_round_block_kernel(
    const float* __restrict__ src, const int* __restrict__ wins,
    const float* __restrict__ gate,
    const float* __restrict__ wz, const float* __restrict__ w1,
    const float* __restrict__ beta, const float* __restrict__ a1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ scale2, const float* __restrict__ a2,
    const float* __restrict__ b2, float* __restrict__ s_out,
    float* __restrict__ v_out, float* __restrict__ ssum, RbSmem L, int B,
    int N, int S, int V, int S_out, int V_out, int k, int binary,
    long long ids_bs) {
  extern __shared__ __align__(16) unsigned char sv_smem[];
  const int C = S + 3 * V, twoV = 2 * V, IN1 = 2 * S + 6 * V;
  const int ldk = sv_mma_ld(IN1), K16 = sv_pad16(IN1), So16 = sv_pad16(S_out);
  sv_bf16* Wt = (sv_bf16*)(sv_smem + L.wx);   // (So16, ldk) sign weights, o-major
  sv_bf16* Xb = Wt + (size_t)So16 * ldk;       // (E, ldk) sign(x + beta)
  float* Xf = (float*)(sv_smem + L.wx);        // FP: (E, IN1) x
  float* VE = (float*)(sv_smem + L.ve);        // (E, 3, V) nbr - ctr of the vectors
  float* Z = (float*)(sv_smem + L.z);          // (E, 3, 3) z_i[j]
  float* ctr = (float*)(sv_smem + L.ctr);      // (TP, C)
  float* w2s = (float*)(sv_smem + L.w2);       // (2V, V_out)
  float* betas = (float*)(sv_smem + L.par);    // (IN1) beta
  float* wzs = betas + IN1;                    // (2V, 3) wz
  float* a1s = wzs + 6 * V;                    // (S_out) a1, then b1
  float* b1s = a1s + S_out;
  float* sc2 = b1s + S_out;                    // (V_out) scale2, then a2, b2
  float* a2s = sc2 + V_out;
  float* b2s = a2s + V_out;
  int* rows = (int*)(sv_smem + L.rows);        // (2, E) a chunk's ids, -1 = no edge
  float* sacc = (float*)(sv_smem + L.sacc);    // (TP, S_out)
  float* vacc = (float*)(sv_smem + L.vacc);    // (TP, 3, V_out)
  float* sesum = (float*)(sv_smem + L.sesum);  // (TP, 2S)

  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nwarp = nth >> 5;
  const int tpb = (N + RB_TP - 1) / RB_TP, ntiles = B * tpb;

  // once per block: the sign weights, zero padding columns, linear2's
  // weights and the per-channel vectors
  if (binary) {
    sv_stage_signs_t(Wt, w1, IN1, S_out);
    for (int i = tid; i < RB_E * (K16 - IN1); i += nth)
      Xb[(size_t)(i / (K16 - IN1)) * ldk + IN1 + i % (K16 - IN1)] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < twoV * V_out; i += nth) w2s[i] = w2[i];
  for (int i = tid; i < IN1; i += nth) betas[i] = binary ? beta[i] : 0.f;
  for (int i = tid; i < twoV * 3; i += nth) wzs[i] = wz[i];
  for (int i = tid; i < S_out; i += nth) a1s[i] = a1[i], b1s[i] = b1[i];
  for (int i = tid; i < V_out; i += nth) sc2[i] = scale2[i], a2s[i] = a2[i], b2s[i] = b2[i];
  // the ids of the chunk at rank r0 into buffer (r0 / RB_G) & 1
  auto load_ids = [&](int b, int n0, int r0) {
    int* buf = rows + ((r0 / RB_G) & 1) * RB_E;
    for (int e = tid; e < RB_E; e += nth) {
      const int t = e % RB_TP, n = n0 + t, r = r0 + e / RB_TP;
      const int* w = wins + b * ids_bs;
      buf[e] = n < N && r < k ? (ROW ? w[(size_t)n * k + r] : w[(size_t)r * N + n])
                              : -1;
    }
  };

  // linear2's operand: an edge vector's value, through bf16 with V2BF16
  auto sv_v2 = [](float v) {
    if constexpr (V2BF16) return __bfloat162float(__float2bfloat16_rn(v));
    return v;
  };
  // channel c < 2V of component i3 of edge e's vector [nbr - ctr | ctr]
  auto ve_at = [&](int e, int i3, int c) {
    return c < V ? VE[((size_t)e * 3 + i3) * V + c]
                 : ctr[(size_t)(e % RB_TP) * C + S + i3 * V + c - V];
  };

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tpb, n0 = (tile % tpb) * RB_TP;
    const float* x = src + (size_t)b * N * C;
    __syncthreads();  // the previous tile's pooled values are written out
    for (int i = tid; i < RB_TP * C; i += nth)
      ctr[i] = n0 + i / C < N ? x[(size_t)n0 * C + i] : 0.f;
    for (int i = tid; i < RB_TP * S_out; i += nth) sacc[i] = -INFINITY;
    for (int i = tid; i < RB_TP * 3 * V_out; i += nth) vacc[i] = 0.f;
    if constexpr (!GATED)
      for (int i = tid; i < RB_TP * 2 * S; i += nth) sesum[i] = 0.f;
    load_ids(b, n0, 0);
    __syncthreads();

    for (int r0 = 0; r0 < k; r0 += RB_G) {
      // gather: edge scalars into linear1's operand, vectors into VE. A
      // warp takes (32-channel chunk, centre) pairs, lanes over channels of
      // one neighbour row, RB_GP pairs at a time: RB_GP * RB_G reads in
      // flight
      const int* ids = rows + ((r0 / RB_G) & 1) * RB_E;
      const int npair = ((C + 31) / 32) * RB_TP;
      for (int p0 = warp; p0 < npair; p0 += RB_GP * nwarp) {
        float xv[RB_GP][RB_G];
#pragma unroll
        for (int u = 0; u < RB_GP; ++u) {
          const int p = min(p0 + u * nwarp, npair - 1), t = p % RB_TP;
          const int c = min((p / RB_TP) * 32 + lane, C - 1);
#pragma unroll
          for (int g = 0; g < RB_G; ++g) {
            const int row = ids[g * RB_TP + t];
            xv[u][g] = row >= 0 ? x[(size_t)row * C + c] : ctr[t * C + c];
          }
        }
#pragma unroll
        for (int u = 0; u < RB_GP; ++u) {
          const int p = p0 + u * nwarp, t = p % RB_TP, c = (p / RB_TP) * 32 + lane;
          if (p >= npair) break;
          if (c >= C) continue;
          const float cv = ctr[t * C + c];
#pragma unroll
          for (int g = 0; g < RB_G; ++g) {
            const int e = g * RB_TP + t;
            const float d = xv[u][g] - cv;
            if (c < S) {
              if (binary) {
                Xb[(size_t)e * ldk + c] = __float2bfloat16_rn(sv_sign(d + betas[c]));
                Xb[(size_t)e * ldk + S + c] = __float2bfloat16_rn(sv_sign(cv + betas[S + c]));
              } else {
                Xf[(size_t)e * IN1 + c] = d;
                Xf[(size_t)e * IN1 + S + c] = cv;
              }
              if constexpr (!GATED)
                if (ids[e] >= 0) {  // gate statistics, rank by rank
                  sesum[t * 2 * S + c] += d;
                  sesum[t * 2 * S + S + c] += cv;
                }
            } else {
              VE[(size_t)e * 3 * V + c - S] = d;  // (i3, cc) = divmod(c - S, V)
            }
          }
        }
      }
      __syncthreads();
      // Vector2Scalar frame z_i[j] = sum_c v_e[i][c] * wz[c][j]
      for (int i = tid; i < RB_E * 9; i += nth) {
        const int e = i / 9, i3 = (i % 9) / 3, j = i % 3;
        float z = 0.f;
        for (int c = 0; c < twoV; ++c) z = __fadd_rn(z, __fmul_rn(ve_at(e, i3, c), wzs[c * 3 + j]));
        Z[i] = z;
      }
      __syncthreads();
      // invariants sv[j][c] = sum_i v_e[i][c] * z_i[j], rows 2S + j*2V + c;
      // a warp per edge, lanes over channels
      for (int e = warp; e < RB_E; e += nwarp) {
        const float* z = Z + e * 9;
        for (int c = lane; c < twoV; c += 32) {
          const float v0 = ve_at(e, 0, c), v1 = ve_at(e, 1, c), v2 = ve_at(e, 2, c);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float s = sv_dot3_rn(v0, z[j], v1, z[3 + j], v2, z[6 + j]);
            const int q = 2 * S + j * twoV + c;
            if (binary)
              Xb[(size_t)e * ldk + q] = __float2bfloat16_rn(sv_sign(s + betas[q]));
            else
              Xf[(size_t)e * IN1 + q] = s;
          }
          if constexpr (V2BF16)
            if (c < V) {  // linear2's operand from here on
              float* ve = VE + (size_t)e * 3 * V + c;
              ve[0] = sv_v2(v0), ve[V] = sv_v2(v1), ve[2 * V] = sv_v2(v2);
            }
        }
      }
      __syncthreads();
      // the next chunk's ids, read after this chunk's closing barrier
      if (r0 + RB_G < k) load_ids(b, n0, r0 + RB_G);
      // scalar path: linear1 + BN + leaky, max over the valid ranks
      if (binary) {
        // job = (half of the tile's centres, 16 outputs); +-1 products
        // summed on the tensor cores: exact
        const int njobs = 2 * (So16 / 16);
        for (int job = tid >> 5; job < njobs; job += nth >> 5) {
          const int h = job & 1, c0 = (job >> 1) * 16;
          // two accumulator sets, even and odd depth steps, to halve the
          // chains of dependent MMAs; their integer sums add exactly
          float acc[RB_G][2][4] = {}, acc2[RB_G][2][4] = {};
          const sv_bf16* pa = sv_frag_a(Xb, ldk, h * 16);
          const sv_bf16* pb = sv_frag_b(Wt, ldk, c0);
#pragma unroll 2
          for (int k0 = 0; k0 < K16; k0 += 32) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int kk = k0 + 16 * half;
              if (kk >= K16) break;
              unsigned bw[4];
              sv_ldsm4(bw, pb + kk);
#pragma unroll
              for (int g = 0; g < RB_G; ++g) {
                unsigned a[4];
                sv_ldsm4(a, pa + (size_t)g * RB_TP * ldk + kk);
                float(&d)[2][4] = half ? acc2[g] : acc[g];
                sv_mma(d[0], a, bw[0], bw[1]);
                sv_mma(d[1], a, bw[2], bw[3]);
              }
            }
          }
#pragma unroll
          for (int g = 0; g < RB_G; ++g)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[g][j][q] += acc2[g][j][q];
#pragma unroll
          for (int g = 0; g < RB_G; ++g)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int t = h * 16 + sv_acc_row(lane, q), o = c0 + sv_acc_col(lane, j, q);
                if (o < S_out && n0 + t < N && r0 + g < k) {
                  float* m = sacc + (size_t)t * S_out + o;
                  *m = fmaxf(*m, sv_leaky(acc[g][j][q] * a1s[o] + b1s[o]));
                }
              }
        }
      } else {
        // a thread owns 2 centres x 4 outputs over the chunk's ranks
        const int og = (S_out + 3) / 4;
        const bool vec = (S_out & 3) == 0 && ((size_t)w1 & 15) == 0;
        for (int item = tid; item < (RB_TP / 2) * og; item += nth) {
          const int t0 = (item / og) * 2, o0 = (item % og) * 4;
          float acc[2][RB_G][4] = {};
          for (int r = 0; r < IN1; ++r) {
            float w[4];
            if (vec) {
              const float4 w4 = *(const float4*)(w1 + (size_t)r * S_out + o0);
              w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) w[j] = o0 + j < S_out ? w1[(size_t)r * S_out + o0 + j] : 0.f;
            }
#pragma unroll
            for (int tt = 0; tt < 2; ++tt)
#pragma unroll
              for (int g = 0; g < RB_G; ++g) {
                const float xv = Xf[(size_t)(g * RB_TP + t0 + tt) * IN1 + r];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[tt][g][j] += xv * w[j];
              }
          }
#pragma unroll
          for (int tt = 0; tt < 2; ++tt)
#pragma unroll
            for (int g = 0; g < RB_G; ++g)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int t = t0 + tt, o = o0 + j;
                if (o < S_out && n0 + t < N && r0 + g < k) {
                  float* m = sacc + (size_t)t * S_out + o;
                  *m = fmaxf(*m, sv_leaky(acc[tt][g][j] * a1s[o] + b1s[o]));
                }
              }
        }
      }
      // vector path: linear2 * scale2 + VectorBN, summed over the ranks in
      // rank order; a thread owns (centre, 3 outputs) over the chunk's ranks
      // (items counted from the last thread, so that the warps without a
      // linear1 job at narrow widths take them first)
      const int vg = (V_out + 2) / 3;
      for (int item = nth - 1 - tid; item < RB_TP * vg; item += nth) {
        const int t = item / vg, o0 = (item % vg) * 3, nv = min(3, V_out - o0);
        int os[3];
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) os[jj] = min(o0 + jj, V_out - 1);
        float acc[RB_G][3][3] = {};
        // channels c < V: each rank's nbr - ctr; c >= V: the centre's
        // vectors, one load for every rank
        for (int c = 0; c < V; ++c) {
          float w[3];
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) w[jj] = w2s[c * V_out + os[jj]];
#pragma unroll
          for (int g = 0; g < RB_G; ++g)
#pragma unroll
            for (int i3 = 0; i3 < 3; ++i3) {
              const float v = VE[((size_t)(g * RB_TP + t) * 3 + i3) * V + c];
#pragma unroll
              for (int jj = 0; jj < 3; ++jj) acc[g][i3][jj] += v * w[jj];
            }
        }
        const float* cvec = ctr + (size_t)t * C + S;
        for (int c = 0; c < V; ++c) {
          float w[3];
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) w[jj] = w2s[(V + c) * V_out + os[jj]];
#pragma unroll
          for (int i3 = 0; i3 < 3; ++i3) {
            const float v = sv_v2(cvec[i3 * V + c]);
#pragma unroll
            for (int g = 0; g < RB_G; ++g)
#pragma unroll
              for (int jj = 0; jj < 3; ++jj) acc[g][i3][jj] += v * w[jj];
          }
        }
#pragma unroll
        for (int g = 0; g < RB_G; ++g) {
          if (n0 + t >= N || r0 + g >= k) continue;
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            if (jj >= nv) break;
            const int o = os[jj];
            float wl[3];
#pragma unroll
            for (int i3 = 0; i3 < 3; ++i3) wl[i3] = acc[g][i3][jj] * sc2[o];
            const float nrm = sqrtf(wl[0] * wl[0] + wl[1] * wl[1] + wl[2] * wl[2]) + SV_EPS;
            const float f = a2s[o] + b2s[o] / nrm;
#pragma unroll
            for (int i3 = 0; i3 < 3; ++i3)
              vacc[((size_t)t * 3 + i3) * V_out + o] += wl[i3] * f;
          }
        }
      }
      __syncthreads();
    }

    const float inv_k = (float)(1.0 / k);
    // the pooled vector of output channel q = i3*V_out + o
    auto vmean = [&](int t, int q) {
      const float m = vacc[(size_t)t * 3 * V_out + q] * inv_k;
      if constexpr (GATED) return m * gate[(size_t)b * V_out + q % V_out];
      return m;
    };
    if constexpr (ROW) {  // a point's outputs are one contiguous row
      for (int i = tid; i < RB_TP * S_out; i += nth) {
        const int t = i / S_out, o = i % S_out, n = n0 + t;
        if (n < N) s_out[((size_t)b * N + n) * S_out + o] = sacc[i];
      }
      for (int i = tid; i < RB_TP * 3 * V_out; i += nth) {
        const int t = i / (3 * V_out), q = i % (3 * V_out), n = n0 + t;
        if (n < N) v_out[((size_t)b * N + n) * 3 * V_out + q] = vmean(t, q);
      }
    } else {
      for (int i = tid; i < RB_TP * S_out; i += nth) {
        const int o = i / RB_TP, t = i % RB_TP, n = n0 + t;
        if (n < N) s_out[((size_t)b * S_out + o) * N + n] = sacc[t * S_out + o];
      }
      for (int i = tid; i < RB_TP * 3 * V_out; i += nth) {
        const int q = i / RB_TP, t = i % RB_TP, n = n0 + t;  // q = i3*V_out + o
        if (n < N) v_out[((size_t)b * 3 * V_out + q) * N + n] = vmean(t, q);
      }
    }
    if constexpr (!GATED)
      for (int i = tid; i < RB_TP * 2 * S; i += nth) {
        const int ch = i / RB_TP, t = i % RB_TP, n = n0 + t;
        if (n < N) ssum[((size_t)b * 2 * S + ch) * N + n] = sesum[t * 2 * S + ch];
      }
  }
}

// The block kernel on the caller's neighbour ids over a row-major source
// (GATED: v gated, no statistics), on a persistent grid of as many blocks
// as the card holds at once. ids_bs: the ids' batch stride in elements (0:
// packed, N * k).
template <bool ROW, bool GATED, bool V2BF16 = false>
static int sv_conv_block(const float* src, const int* wins, const float* gate,
                         const float* wz, const float* w1, const float* beta,
                         const float* a1, const float* b1, const float* w2,
                         const float* scale2, const float* a2, const float* b2,
                         float* s_out, float* v_out, float* ssum, int B, int N,
                         int S, int V, int S_out, int V_out, int k, int binary,
                         cudaStream_t st, long long ids_bs = 0) {
  const RbSmem L = rb_layout(S, V, S_out, V_out, binary, /*stats=*/!GATED);
  if (L.total > SV_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = sv_round_block_kernel<ROW, GATED, V2BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, RB_THREADS,
                                                           L.total)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)B * ((N + RB_TP - 1) / RB_TP);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kern<<<grid, RB_THREADS, L.total, st>>>(
      src, wins, gate, wz, w1, beta, a1, b1, w2, scale2, a2, b2, s_out, v_out,
      ssum, L, B, N, S, V, S_out, V_out, k, binary,
      ids_bs ? ids_bs : (long long)N * k);
  return (int)cudaGetLastError();
}

// Selection over the joint features of a row-major source, then the block
// kernel; ROW picks the ids' and outputs' layout (else (B, k, N) ids and
// channel-major outputs). Fast mode (tile_scale (B, N / T)) selects on the
// raw source and runs the block on src_q, the source through the gather
// grid (row-major too); exact mode leaves src_q null. Approx mode is fast
// mode with the fold width L > 0; win as sv_first_round's.
template <bool ROW>
static int sv_conv_round(const float* src, float* aa, const float* wz,
                         const float* w1, const float* beta, const float* a1,
                         const float* b1, const float* w2, const float* scale2,
                         const float* a2, const float* b2, float* s_out,
                         float* v_out, float* ssum, int* wins, int B, int N,
                         int S, int V, int S_out, int V_out, int k, int binary,
                         cudaStream_t st, const float* src_q = nullptr,
                         const float* tile_scale = nullptr, int T = 0,
                         int L = 0, SvWindow win = SvWindow{}) {
  if (rb_layout(S, V, S_out, V_out, binary).total > SV_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = sv_knn_select(src, aa, wins, B, N, S + 3 * V, k, st,
                                  /*point_major=*/ROW, /*row_major=*/true,
                                  tile_scale, T, L, win);
  if (err != cudaSuccess) return (int)err;
  return sv_conv_block<ROW, false>(src_q ? src_q : src, wins, nullptr, wz, w1,
                                   beta, a1, b1, w2, scale2, a2, b2, s_out,
                                   v_out, ssum, B, N, S, V, S_out, V_out, k,
                                   binary, st);
}

// Device code of the differentiable fused SV-DGCNN rounds (training):
// sv_first_train.cu (the FP first round, B5) and sv_round3_train.cu (a conv
// round, B6) are two instantiations of the kernels below.
//
// A round maps points or joint features src (B, N, C) and neighbour ids
// idx (B, N, k) to an SVBlock over the k edges of every point, pooled over
// the ranks. Per edge e = (b, n, rank):
//   v_e[i] = [nbr_v[i] - ctr_v[i], ctr_v[i]]        (3, 2V)
//   z[i][j] = (sum_c v_e[i][c] wz[c][j]) * scalez[j]  Vector2Scalar frame
//   sv[j][c] = sum_i v_e[i][c] z[i][j]                 invariants, j-major
//   conv:  x = [s_nbr - s_ctr, s_ctr | sv]            (2S + 6V)
//   first: x = [sv(wz0) | sv(wz)]                      (6 + 6; S = 0, V = 1)
//   h = (sign(x + beta) or x) @ w1 * scale1,  y = leaky(BN(h))
//   v2[i] = v_e[i] @ w2 * scale2,  n = sqrt(max(|v2|^2, 1e-12)) + EPS,
//   v = v2 / n * BN(n)
//   s_out = max over ranks of y (first argmax rank kept), v_out = mean of v.
// BN statistics run over all B*N*k edges, so each direction takes two
// passes, as in the TPU kernels (svnet_tpu/ops/pallas/sv_round3_train.py):
//   F1  sums of h, h^2, n, n^2 and per-point sums of the gate scalars
//   F2  outputs and the argmax rank per (point, channel)
//   B1  BN-backward sums of dy, dy*xhat, dnbn, dnbn*nhat
//   B2  d(src) and every parameter gradient
// Batch statistics and the divisions by M = B*N*k happen in torch between
// passes. Every pass recomputes the edges, h and the norms from src + idx.
//
// Blocks run in no order, so nothing is accumulated across blocks in the
// kernel: a persistent grid walks tiles of points, and each block
// keeps its own row of partial sums in `part` (BN sums and parameter
// gradients), reduced over blocks by torch. Within a block every sum runs
// in a fixed order (chunk by chunk, rank by rank), so the result does not
// depend on scheduling. The BN sums (F1, B1) accumulate in double: the
// batch statistics then round to the same f32 values as the plain
// version's double sums, whatever the order, which keeps the forward
// passes of kernel and plain version equal -- an f32 sum over B*N*k edges
// in another order moves the statistics by ulps, and the binary rounds
// downstream turn that into sign and kNN flips. Per-point gate sums and
// vector means run over the ranks in rank order, as the plain version's.
// The neighbour half of d(src) is the one sum in no fixed order: it is
// scattered with float atomicAdd into dnbr (the order of the ~k
// contributions per point varies from run to run at the ulp level); the
// centre half is summed per point in rank order.
//
// The products on the tensor cores (sv_mma.cuh; binary rounds only). The
// block stages the sign weights w1 once as bf16 and signs x where it is
// written (sign(x + beta), bf16). h = xq @ w1 is +-1 by +-1, exact in
// any order, so h, the batch statistics and the forward outputs stay
// those of the plain version. In B2, dh * scale1 is split into three
// bf16 pieces (sv_split3) that carry it exactly; d(x) = dh_raw @ w1^T and
// dW1 = xq^T dh_raw multiply each piece by signs, exactly, and sum in the
// MMA's order. dW1 is summed over the edges of two chunks (two buffers of
// xq and the pieces) and added to the block's row of `part` with float2
// atomics by one thread per entry, in chunk order: a fixed order, with
// the adds done in L2. FP rounds and B5 keep their ordered f32 products on
// the CUDA cores (tr_gemm), bitwise the plain versions' forward. A block
// is 512 threads, one per SM at conv4's widths; the loops over (edge,
// channel) pairs look a channel's place up in small tables (vmap, jcmap)
// instead of dividing by runtime widths.
#pragma once

#include "sv_common.cuh"
#include "sv_mma.cuh"

#define TR_G 2         // neighbour ranks per chunk
#define TR_THREADS 512
#define TR_CLIP 1.2f   // STE: the sign's gradient passes where |x| <= 1.2
#define TR_NSQ_FLOOR 1e-12f

enum { TR_F1 = 0, TR_F2 = 1, TR_B1 = 2, TR_B2 = 3 };

// Centre points per tile: 16 (32 edges a chunk); B2 takes 8 where its
// cotangent buffers would not fit beside the sign weights with 16 (conv4's
// widths; tr_launch_phase). Edges per chunk are a multiple of 16, the
// MMA's rows.
#define TR_TP 16

// Pointer slots of the launch functions (ops/kernels/sv_round3_train.py
// builds the same list, in this order).
enum {
  P_SRC, P_IDX, P_WZ0, P_WZ, P_SCALEZ, P_W1, P_W1T, P_BETA, P_SCALE1,
  P_G1, P_BB1, P_MU1, P_INV1, P_W2, P_W2T, P_SCALE2, P_G2, P_BB2, P_MUN,
  P_INVN, P_DSO, P_DVO, P_KMAX, P_DSSUM, P_RED, P_PART, P_SSUM, P_SOUT,
  P_VOUT, P_DCTR, P_DNBR, P_COUNT
};
// Integer slots: B N k S V S_out V_out binary nblocks
enum { D_B, D_N, D_K, D_S, D_V, D_SOUT, D_VOUT, D_BINARY, D_NBLOCKS, D_COUNT };

struct TrDims {
  int B, N, k, S, V, S_out, V_out, binary, first, nrows;
  int C, twoV, SX, IN1;
};

struct TrArgs {
  const float *src;
  const int *idx;
  const float *wz0, *wz, *scalez, *w1, *w1t, *beta, *scale1, *g1, *bb1,
      *mu1, *inv1, *w2, *w2t, *scale2, *g2, *bb2, *mun, *invn, *dso, *dvo;
  int *kmax;
  const float *dssum, *red;
  void* part;  // double rows in F1/B1, float rows in B2
  float *ssum, *s_out, *v_out, *dctr, *dnbr;
};

struct TrSmem {
  size_t ctr, rows, X, XQ, VE, ZR, Z0R, H, V2R, ss, sacc, karg, vacc, DH, DX,
      DV2, DVE, DZ, DZ0, dctr, Wt, DHb, kst, dsos, dvos, vmap, total;
};

static TrSmem tr_layout(const TrDims& D, int phase, int TP) {
  TrSmem L;
  size_t o = 0;
  auto take = [&o](size_t n) { size_t at = o; o += sv_align16(n * 4); return at; };
  const size_t E = (size_t)TP * TR_G;
  L.ctr = take((size_t)TP * D.C);
  L.rows = take(E);
  L.vmap = take(3 * (size_t)D.V + 3 * (size_t)D.twoV);
  L.X = take(E * D.IN1);
  // binary: linear1's operand sign(x + beta) and the sign weights as bf16
  // for the tensor cores (sv_mma.cuh layouts)
  // (B2: two buffers, so that dW1 sums the edges of two chunks at once)
  const size_t nbuf = phase == TR_B2 ? 2 : 1;
  L.XQ = D.binary ? take(nbuf * E * sv_mma_ld(D.IN1) / 2) : L.X;
  L.VE = take(E * 3 * D.twoV);
  L.ZR = take(E * 9);
  L.Z0R = D.first ? take(E * 9) : L.ZR;
  L.H = take(E * D.S_out);
  L.V2R = take(E * 3 * D.V_out);
  L.ss = L.sacc = L.karg = L.vacc = 0;
  L.DH = L.DX = L.DV2 = L.DVE = L.DZ = L.DZ0 = L.dctr = L.Wt = L.DHb = 0;
  L.kst = L.dsos = L.dvos = 0;
  if (phase == TR_B1 || phase == TR_B2) {  // the tile's cotangents and argmax ranks
    L.kst = take((size_t)TP * D.S_out);
    L.dsos = take((size_t)TP * D.S_out);
    L.dvos = take((size_t)TP * 3 * D.V_out);
  }
  if (D.binary) L.Wt = take((size_t)sv_pad16(D.S_out) * sv_mma_ld(D.IN1) / 2);
  if (phase == TR_F1) L.ss = take((size_t)TP * D.SX);
  if (phase == TR_F2) {
    L.sacc = take((size_t)TP * D.S_out);
    L.karg = take((size_t)TP * D.S_out);
    L.vacc = take((size_t)TP * 3 * D.V_out);
  }
  if (phase == TR_B2) {
    L.DH = take(E * D.S_out);
    L.DX = take(E * D.IN1);
    L.DV2 = take(E * 3 * D.V_out);
    L.DVE = take(E * 3 * D.twoV);
    L.DZ = take(E * 9);
    L.DZ0 = D.first ? take(E * 9) : L.DZ;
    L.dctr = take((size_t)TP * D.C);
    // binary: dh * scale1 split into three bf16 pieces (sv_split3)
    if (D.binary) L.DHb = take(nbuf * 3 * E * sv_mma_ld(D.S_out) / 2);
  }
  L.total = o;
  return L;
}

// Width of a block's row of partial sums in `part`.
static __host__ __device__ inline size_t tr_part_width(const TrDims& D, int phase) {
  if (phase == TR_F1 || phase == TR_B1) return 2 * (size_t)D.S_out + 2 * D.V_out;
  if (phase == TR_B2)
    return (size_t)D.IN1 * D.S_out + (size_t)D.twoV * D.V_out +
           (size_t)D.twoV * 3 * (D.first ? 2 : 1) + D.IN1 + D.S_out + D.V_out + 3;
  return 0;
}

// acc(e, o) = sum_r x(e, r) * w(r, o) for e < E, o < O, accumulated over r
// in order, each product and sum rounded on its own (built with
// -fmad=false): bitwise what the plain versions' ordered_matmul gives.
// Each thread owns a TE x TO register tile; epi(e, o, acc) takes every
// in-range result.
template <int TE, int TO, class XF, class WF, class Epi>
static __device__ __forceinline__ void tr_gemm(int E, int K, int O, XF xf,
                                               WF wf, Epi epi) {
  const int og = (O + TO - 1) / TO, eg = (E + TE - 1) / TE;
  for (int item = threadIdx.x; item < og * eg; item += blockDim.x) {
    const int o0 = (item % og) * TO, e0 = (item / og) * TE;
    float acc[TE][TO];
#pragma unroll
    for (int i = 0; i < TE; ++i)
#pragma unroll
      for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int r = 0; r < K; ++r) {
      float w[TO], xv[TE];
#pragma unroll
      for (int j = 0; j < TO; ++j) w[j] = o0 + j < O ? wf(r, o0 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < TE; ++i) xv[i] = e0 + i < E ? xf(e0 + i, r) : 0.f;
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

// Vector-path quantities of one (edge, channel): v2 (scaled), |v2|^2, the
// floored root sq and the norm n = sq + EPS.
struct TrVec {
  float v2[3], nsq, sq, n;
};

static __device__ __forceinline__ TrVec tr_vec(const float* V2R, int e, int o,
                                               int V_out, float scale2) {
  TrVec r;
#pragma unroll
  for (int i = 0; i < 3; ++i) r.v2[i] = V2R[((size_t)e * 3 + i) * V_out + o] * scale2;
  r.nsq = r.v2[0] * r.v2[0] + r.v2[1] * r.v2[1] + r.v2[2] * r.v2[2];
  r.sq = sqrtf(fmaxf(r.nsq, TR_NSQ_FLOOR));
  r.n = r.sq + SV_EPS;
  return r;
}

// dy of one (edge, channel): the pooled cotangent if this rank is the
// recorded argmax, times the leaky slope at ybn; kmax and dso of the
// edge's centre and channel.
static __device__ __forceinline__ float tr_dy(const TrArgs& A, int kmax, float dso,
                                              int r, float xhat, int o) {
  const float ybn = A.g1[o] * xhat + A.bb1[o];
  const float lm = ybn >= 0.f ? 1.f : 0.2f;
  return (kmax == r ? dso : 0.f) * lm;
}

// Per channel o < nout, the double sums over the chunk's valid edges of
// the two terms f(e, o, a, b) gives: SP adjacent lanes per channel take
// every SP-th edge, and a fixed shuffle tree adds their partials, so the
// order is fixed. acc(o, sum_a, sum_b) runs on the channel's first lane.
template <int SP, class F, class Acc>
static __device__ __forceinline__ void tr_edge_sums(int nout, int ne, const int* rows,
                                                    F f, Acc acc) {
  for (int base = 0; base < nout * SP; base += blockDim.x) {  // block-uniform
    const int i = base + threadIdx.x, o = i / SP, p = i % SP;
    double sa = 0.0, sb = 0.0;
    if (o < nout)
      for (int e = p; e < ne; e += SP) {
        if (rows[e] < 0) continue;
        float a, b;
        f(e, o, a, b);
        sa += (double)a;
        sb += (double)b;
      }
#pragma unroll
    for (int off = SP / 2; off > 0; off >>= 1) {
      sa += __shfl_down_sync(0xffffffffu, sa, off, SP);
      sb += __shfl_down_sync(0xffffffffu, sb, off, SP);
    }
    if (o < nout && p == 0) acc(o, sa, sb);
  }
}

template <int PH, int TP>
static __global__ void __launch_bounds__(TR_THREADS)
sv_train_kernel(TrArgs A, TrDims D, TrSmem L) {
  extern __shared__ __align__(16) unsigned char sv_smem[];
  constexpr int EC = TP * TR_G, NBUF = PH == TR_B2 ? 2 : 1;
  float* CTR = (float*)(sv_smem + L.ctr);  // (TP, C)
  int* rows = (int*)(sv_smem + L.rows);    // (E,) -1 = no edge
  float* X = (float*)(sv_smem + L.X);      // (E, IN1) x before the sign
  float* XQ = (float*)(sv_smem + L.XQ);    // FP: (E, IN1) linear1's operand (= X)
  sv_bf16* XQb = (sv_bf16*)(sv_smem + L.XQ);  // binary: (NBUF, E, ldk) sign(x + beta)
  sv_bf16* Wt = (sv_bf16*)(sv_smem + L.Wt);   // binary: (So16, ldk) sign weights
  float* VE = (float*)(sv_smem + L.VE);    // (E, 3, 2V)
  float* ZR = (float*)(sv_smem + L.ZR);    // (E, 3, 3) unscaled frames
  float* Z0R = (float*)(sv_smem + L.Z0R);  // (E, 3, 3) first: init_scalar's
  float* H = (float*)(sv_smem + L.H);      // (E, S_out) h before scale1
  float* V2R = (float*)(sv_smem + L.V2R);  // (E, 3, V_out) v2 before scale2

  const int N = D.N, k = D.k, S = D.S, V = D.V, C = D.C, twoV = D.twoV;
  const int SX = D.SX, IN1 = D.IN1, S_out = D.S_out, V_out = D.V_out;
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nwarp = nth >> 5;
  const int tpb = (N + TP - 1) / TP, ntiles = D.B * tpb;
  // vector channel q = i*V + c of src -> its place i*2V + c in a (3, 2V) v_e
  int* vmap = (int*)(sv_smem + L.vmap);
  for (int q = tid; q < 3 * V; q += nth) vmap[q] = (q / V) * twoV + q % V;
  // (j, c) of q = j*2V + c < 3 * 2V, packed j << 16 | c
  int* jcmap = vmap + 3 * V;
  for (int q = tid; q < 3 * twoV; q += nth) jcmap[q] = (q / twoV) << 16 | q % twoV;
  const int ldk = sv_mma_ld(IN1), K16 = sv_pad16(IN1), So16 = sv_pad16(S_out);
  const int lds = sv_mma_ld(S_out);
  const float inv_k = (float)(1.0 / k);
  const size_t pw = tr_part_width(D, PH);
  double* partd = (double*)A.part + (size_t)blockIdx.x * pw;  // F1, B1
  float* part = (float*)A.part + (size_t)blockIdx.x * pw;     // B2
  // this block's row of partial sums, and the rows of the blocks the
  // card could not hold at once (D.nrows >= gridDim.x; see tr_launch_phase)
  for (int row = blockIdx.x; row < D.nrows; row += gridDim.x) {
    if (PH == TR_F1 || PH == TR_B1)
      for (size_t i = tid; i < pw; i += nth) ((double*)A.part)[row * pw + i] = 0.0;
    if (PH == TR_B2)
      for (size_t i = tid; i < pw; i += nth) ((float*)A.part)[row * pw + i] = 0.f;
  }
  if (D.binary) {  // once per block: the sign weights, zero padding columns
    sv_stage_signs_t(Wt, A.w1, IN1, S_out);
    for (int i = tid; i < NBUF * EC * (K16 - IN1); i += nth)
      XQb[(size_t)(i / (K16 - IN1)) * ldk + IN1 + i % (K16 - IN1)] = __float2bfloat16_rn(0.f);
    if (PH == TR_B2) {
      sv_bf16* DHb = (sv_bf16*)(sv_smem + L.DHb);
      for (int i = tid; i < NBUF * 3 * EC * (So16 - S_out); i += nth)
        DHb[(size_t)(i / (So16 - S_out)) * lds + S_out + i % (So16 - S_out)] =
            __float2bfloat16_rn(0.f);
    }
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tpb, n0 = (tile % tpb) * TP;
    const float* x = A.src + (size_t)b * N * C;
    for (int i = tid; i < TP * C; i += nth) {
      const int t = i / C, n = n0 + t;
      CTR[i] = n < N ? x[(size_t)n * C + i % C] : 0.f;
    }
    if (PH == TR_F1) {
      float* ss = (float*)(sv_smem + L.ss);
      for (int i = tid; i < TP * SX; i += nth) ss[i] = 0.f;
    }
    if (PH == TR_F2) {
      float* vacc = (float*)(sv_smem + L.vacc);
      for (int i = tid; i < TP * 3 * V_out; i += nth) vacc[i] = 0.f;
    }
    if (PH == TR_B2) {
      float* dc = (float*)(sv_smem + L.dctr);
      for (int i = tid; i < TP * C; i += nth) dc[i] = 0.f;
    }
    if (PH == TR_B1 || PH == TR_B2) {
      int* kst = (int*)(sv_smem + L.kst);
      float* dsos = (float*)(sv_smem + L.dsos);
      float* dvos = (float*)(sv_smem + L.dvos);
      const size_t at = ((size_t)b * N + n0) * S_out;
      for (int i = tid; i < TP * S_out; i += nth) {
        const bool in = n0 + i / S_out < N;
        kst[i] = in ? A.kmax[at + i] : -1;
        dsos[i] = in ? A.dso[at + i] : 0.f;
      }
      const size_t av = ((size_t)b * N + n0) * 3 * V_out;
      for (int i = tid; i < TP * 3 * V_out; i += nth)
        dvos[i] = n0 + i / (3 * V_out) < N ? A.dvo[av + i] : 0.f;
    }

    for (int r0 = 0; r0 < k; r0 += TR_G) {
      const int buf = (r0 / TR_G) % NBUF;  // B2: chunks alternate buffers
      sv_bf16* XQc = XQb + (size_t)buf * EC * ldk;
      // ---- recompute the chunk's edges: rows, x, v_e, frames, h, v2 ----
      for (int e = tid; e < EC; e += nth) {
        const int n = n0 + e / TR_G, r = r0 + e % TR_G;
        rows[e] = (n < N && r < k) ? A.idx[((size_t)b * N + n) * k + r] : -1;
      }
      __syncthreads();
      // consecutive threads on consecutive channels of a neighbour's row,
      // four rows in flight per thread
      for (int i0 = tid; i0 < EC * C; i0 += 4 * nth) {
        float nv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = min(i0 + u * nth, EC * C - 1), e = i / C, row = rows[e];
          nv[u] = row >= 0 ? x[(size_t)row * C + i - e * C] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * nth;
          if (i >= EC * C) break;
          const int e = i / C, c = i - e * C;
          const float cv = CTR[(e / TR_G) * C + c];
          const float d = (rows[e] >= 0 ? nv[u] : cv) - cv;
          if (c < S) {
            X[(size_t)e * IN1 + c] = d;
            X[(size_t)e * IN1 + S + c] = cv;
            if (D.binary) {  // linear1's operand sign(x + beta)
              XQc[(size_t)e * ldk + c] = __float2bfloat16_rn(sv_sign(d + A.beta[c]));
              XQc[(size_t)e * ldk + S + c] = __float2bfloat16_rn(sv_sign(cv + A.beta[S + c]));
            }
          } else {
            float* ve = VE + (size_t)e * 3 * twoV + vmap[c - S];
            ve[0] = d;
            ve[V] = cv;
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < EC * 9; i += nth) {
        const int e = i / 9, i3 = (i % 9) / 3, j = i % 3;
        const float* ve = VE + ((size_t)e * 3 + i3) * twoV;
        float z = 0.f;
        for (int c = 0; c < twoV; ++c) z = __fadd_rn(z, __fmul_rn(ve[c], A.wz[c * 3 + j]));
        ZR[i] = z;
        if (D.first) {
          float z0 = 0.f;
          for (int c = 0; c < twoV; ++c)
            z0 = __fadd_rn(z0, __fmul_rn(ve[c], A.wz0[c * 3 + j]));
          Z0R[i] = z0;
        }
      }
      __syncthreads();
      for (int i = tid; i < EC * 3 * twoV; i += nth) {
        const int e = i / (3 * twoV), jc = jcmap[i - e * 3 * twoV];
        const int j = jc >> 16, c = jc & 0xffff;
        const float* ve = VE + (size_t)e * 3 * twoV;
        const float* z = ZR + e * 9;
        const float sz = A.scalez[j];
        const int q = SX + j * twoV + c;
        const float sv = sv_dot3_rn(
            ve[c], __fmul_rn(z[j], sz), ve[twoV + c], __fmul_rn(z[3 + j], sz),
            ve[2 * twoV + c], __fmul_rn(z[6 + j], sz));
        X[(size_t)e * IN1 + q] = sv;
        if (D.binary) XQc[(size_t)e * ldk + q] = __float2bfloat16_rn(sv_sign(sv + A.beta[q]));
        if (D.first) {
          const float* z0 = Z0R + e * 9;
          X[(size_t)e * IN1 + j * twoV + c] = sv_dot3_rn(
              ve[c], z0[j], ve[twoV + c], z0[3 + j], ve[2 * twoV + c], z0[6 + j]);
        }
      }
      __syncthreads();
      if (D.binary) {
        // +-1 by +-1 on the tensor cores, exact: a warp per 16 edges x 16
        // outputs
        for (int job = tid >> 5; job < (EC / 16) * (So16 / 16); job += nth >> 5) {
          const int m0 = (job % (EC / 16)) * 16, c0 = (job / (EC / 16)) * 16;
          float acc[2][4] = {};
          const sv_bf16* pa = sv_frag_a(XQc, ldk, m0);
          const sv_bf16* pb = sv_frag_b(Wt, ldk, c0);
          for (int k0 = 0; k0 < K16; k0 += 16) {
            unsigned a[4], bw[4];
            sv_ldsm4(a, pa + k0);
            sv_ldsm4(bw, pb + k0);
            sv_mma(acc[0], a, bw[0], bw[1]);
            sv_mma(acc[1], a, bw[2], bw[3]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int o = c0 + sv_acc_col(lane, j, q);
              if (o < S_out) H[(size_t)(m0 + sv_acc_row(lane, q)) * S_out + o] = acc[j][q];
            }
        }
      } else {
        tr_gemm<2, 4>(EC, IN1, S_out,
                      [&](int e, int r) { return XQ[(size_t)e * IN1 + r]; },
                      [&](int r, int o) { return A.w1[(size_t)r * S_out + o]; },
                      [&](int e, int o, float h) { H[(size_t)e * S_out + o] = h; });
      }
      tr_gemm<4, 2>(EC * 3, twoV, V_out,
                    [&](int q, int c) { return VE[(size_t)q * twoV + c]; },
                    [&](int c, int o) { return A.w2[(size_t)c * V_out + o]; },
                    [&](int q, int o, float v) { V2R[(size_t)q * V_out + o] = v; });
      __syncthreads();

      if (PH == TR_F1) {
        // BN sums over the chunk's edges; per-point gate sums rank by rank
        tr_edge_sums<4>(S_out, EC, rows,
            [&](int e, int o, float& a, float& q) {
              a = H[(size_t)e * S_out + o] * A.scale1[o];
              q = a * a;
            },
            [&](int o, double sa, double sq) {
              partd[o] += sa;
              partd[S_out + o] += sq;
            });
        tr_edge_sums<8>(V_out, EC, rows,
            [&](int e, int o, float& a, float& q) {
              a = tr_vec(V2R, e, o, V_out, A.scale2[o]).n;
              q = a * a;
            },
            [&](int o, double sa, double sq) {
              partd[2 * S_out + o] += sa;
              partd[2 * S_out + V_out + o] += sq;
            });
        float* ss = (float*)(sv_smem + L.ss);
        for (int t = warp; t < TP; t += nwarp)
          for (int ch = lane; ch < SX; ch += 32) {
          const int i = t * SX + ch;
          for (int g = 0; g < TR_G; ++g) {
            const int e = t * TR_G + g;
            if (rows[e] >= 0) ss[i] += X[(size_t)e * IN1 + ch];
          }
        }
      } else if (PH == TR_F2) {
        float* sacc = (float*)(sv_smem + L.sacc);
        int* karg = (int*)(sv_smem + L.karg);
        float* vacc = (float*)(sv_smem + L.vacc);
        for (int t = warp; t < TP; t += nwarp)
          for (int o = lane; o < S_out; o += 32) {
          const int i = t * S_out + o;
          float m = sacc[i];
          int am = karg[i];
          for (int g = 0; g < TR_G; ++g) {
            const int e = t * TR_G + g, r = r0 + g;
            if (rows[e] < 0) continue;
            const float h = H[(size_t)e * S_out + o] * A.scale1[o];
            const float xhat = (h - A.mu1[o]) * A.inv1[o];
            const float y = sv_leaky(A.g1[o] * xhat + A.bb1[o]);
            if (r == 0 || y > m) {  // the first rank among equal maxima
              m = y;
              am = r;
            }
          }
          sacc[i] = m;
          karg[i] = am;
        }
        for (int i = tid; i < TP * V_out; i += nth) {
          const int t = i / V_out, o = i % V_out;
          for (int g = 0; g < TR_G; ++g) {
            const int e = t * TR_G + g;
            if (rows[e] < 0) continue;
            const TrVec tv = tr_vec(V2R, e, o, V_out, A.scale2[o]);
            const float nbn = A.g2[o] * ((tv.n - A.mun[o]) * A.invn[o]) + A.bb2[o];
            const float w = nbn / tv.n;
#pragma unroll
            for (int i3 = 0; i3 < 3; ++i3)
              vacc[((size_t)t * 3 + i3) * V_out + o] += tv.v2[i3] * w;
          }
        }
      } else if (PH == TR_B1) {
        const int* kst = (const int*)(sv_smem + L.kst);
        const float* dsos = (const float*)(sv_smem + L.dsos);
        const float* dvos = (const float*)(sv_smem + L.dvos);
        tr_edge_sums<4>(S_out, EC, rows,
            [&](int e, int o, float& dy, float& dyx) {
              const int t = e / TR_G, r = r0 + e % TR_G;
              const float h = H[(size_t)e * S_out + o] * A.scale1[o];
              const float xhat = (h - A.mu1[o]) * A.inv1[o];
              dy = tr_dy(A, kst[t * S_out + o], dsos[t * S_out + o], r, xhat, o);
              dyx = dy * xhat;
            },
            [&](int o, double ds, double dx) {
              partd[o] += ds;
              partd[S_out + o] += dx;
            });
        tr_edge_sums<8>(V_out, EC, rows,
            [&](int e, int o, float& dnbn, float& dnx) {
              const TrVec tv = tr_vec(V2R, e, o, V_out, A.scale2[o]);
              const float nhat = (tv.n - A.mun[o]) * A.invn[o];
              const float* dv = dvos + (e / TR_G) * 3 * V_out + o;
              const float G = (dv[0] * inv_k) * tv.v2[0] + (dv[V_out] * inv_k) * tv.v2[1] +
                              (dv[2 * V_out] * inv_k) * tv.v2[2];
              dnbn = G / tv.n;
              dnx = dnbn * nhat;
            },
            [&](int o, double ds, double dx) {
              partd[2 * S_out + o] += ds;
              partd[2 * S_out + V_out + o] += dx;
            });
      } else {  // TR_B2
        float* DH = (float*)(sv_smem + L.DH);    // (E, S_out) dh before scale1
        float* DX = (float*)(sv_smem + L.DX);    // (E, IN1) d(x)
        float* DV2 = (float*)(sv_smem + L.DV2);  // (E, 3, V_out) dv2 before scale2
        float* DVE = (float*)(sv_smem + L.DVE);  // (E, 3, 2V) d(v_e)
        float* DZ = (float*)(sv_smem + L.DZ);    // (E, 3, 3) d(z) [i][j]
        float* DZ0 = (float*)(sv_smem + L.DZ0);  // (E, 3, 3) first: init's
        float* dc = (float*)(sv_smem + L.dctr);  // (TP, C)
        const float* red = A.red;  // E[dy], E[dy xhat], E[dnbn], E[dnbn nhat]
        float* pW1 = part;
        float* pW2 = pW1 + (size_t)IN1 * S_out;
        float* pWZ = pW2 + (size_t)twoV * V_out;
        float* pWZ0 = pWZ + (size_t)twoV * 3;
        float* pbeta = pWZ0 + (D.first ? (size_t)twoV * 3 : 0);
        float* psc1 = pbeta + IN1;
        float* psc2 = psc1 + S_out;
        float* pscz = psc2 + V_out;

        // BN1 and VectorBN backward per (edge, channel)
        for (int i = tid; i < EC * S_out; i += nth) {
          const int e = i / S_out, o = i % S_out;
          float dh = 0.f;
          if (rows[e] >= 0) {
            const int t = e / TR_G, r = r0 + e % TR_G;
            const float h = H[i] * A.scale1[o];
            const float xhat = (h - A.mu1[o]) * A.inv1[o];
            const float dy = tr_dy(A, ((const int*)(sv_smem + L.kst))[t * S_out + o],
                                   ((const float*)(sv_smem + L.dsos))[t * S_out + o], r,
                                   xhat, o);
            dh = (A.g1[o] * A.inv1[o]) * ((dy - red[o]) - xhat * red[S_out + o]);
          }
          DH[i] = dh;
          if (D.binary) {  // dh_raw in three bf16 pieces for the tensor cores
            sv_bf16* DHb = (sv_bf16*)(sv_smem + L.DHb) + (size_t)(buf * 3 * EC + e) * lds + o;
            sv_split3(dh * A.scale1[o], DHb[0], DHb[(size_t)EC * lds],
                      DHb[(size_t)2 * EC * lds]);
          }
        }
        for (int i = tid; i < EC * V_out; i += nth) {
          const int e = i / V_out, o = i % V_out;
          float dv2[3] = {0.f, 0.f, 0.f};
          if (rows[e] >= 0) {
            const TrVec tv = tr_vec(V2R, e, o, V_out, A.scale2[o]);
            const float nhat = (tv.n - A.mun[o]) * A.invn[o];
            const float nbn = A.g2[o] * nhat + A.bb2[o];
            const float w = nbn / tv.n;
            const float* dv = (const float*)(sv_smem + L.dvos) + (e / TR_G) * 3 * V_out + o;
            const float dout[3] = {dv[0] * inv_k, dv[V_out] * inv_k, dv[2 * V_out] * inv_k};
            const float G = dout[0] * tv.v2[0] + dout[1] * tv.v2[1] + dout[2] * tv.v2[2];
            const float dnbn = G / tv.n;
            float dn = (A.g2[o] * A.invn[o]) *
                       ((dnbn - red[2 * S_out + o]) - nhat * red[2 * S_out + V_out + o]);
            dn = dn - (G * nbn) / (tv.n * tv.n);
            const float fac = (dn / tv.sq) * (tv.nsq > TR_NSQ_FLOOR ? 1.f : 0.f);
#pragma unroll
            for (int i3 = 0; i3 < 3; ++i3) dv2[i3] = dout[i3] * w + fac * tv.v2[i3];
          }
#pragma unroll
          for (int i3 = 0; i3 < 3; ++i3) DV2[((size_t)e * 3 + i3) * V_out + o] = dv2[i3];
        }
        __syncthreads();
        // d(x) = dh_raw @ w1^T, d(v_e) = dv2_raw @ w2^T; dW1 += xq^T dh_raw,
        // dW2 += v_e^T dv2_raw (invalid edges carry zero cotangents)
        if (D.binary) {
          // d(x) = dh_raw @ w1^T and dW1 += xq^T dh_raw on the tensor cores:
          // each piece of dh_raw times a sign is exact, the f32 sums are
          // taken in the MMA's order
          const sv_bf16* DHb = (const sv_bf16*)(sv_smem + L.DHb);
          const size_t piece = (size_t)EC * lds;
          const sv_bf16* DHc = DHb + buf * 3 * piece;
          for (int job = tid >> 5; job < (EC / 16) * (K16 / 16); job += nth >> 5) {
            const int m0 = (job % (EC / 16)) * 16, q0 = (job / (EC / 16)) * 16;
            float acc[2][4] = {};
            const sv_bf16* pa = sv_frag_a(DHc, lds, m0);
            const sv_bf16* pb = sv_frag_bt(Wt, ldk, q0);
            for (int k0 = 0; k0 < So16; k0 += 16) {
              unsigned bw[4];
              sv_ldsm4_t(bw, pb + (size_t)k0 * ldk);
#pragma unroll
              for (int p3 = 0; p3 < 3; ++p3) {
                unsigned a[4];
                sv_ldsm4(a, pa + p3 * piece + k0);
                sv_mma(acc[0], a, bw[0], bw[1]);
                sv_mma(acc[1], a, bw[2], bw[3]);
              }
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int r = q0 + sv_acc_col(lane, j, q);
                if (r < IN1) DX[(size_t)(m0 + sv_acc_row(lane, q)) * IN1 + r] = acc[j][q];
              }
          }
          // dW1 every second chunk and at the tile's last, over the edges
          // of both buffers; float2 adds where the row allows them
          const bool two = (S_out & 1) == 0 && ((size_t)pW1 & 7) == 0;
          const int npair = So16 / 16;
          for (int job = tid >> 5; (buf == NBUF - 1 || r0 + TR_G >= k) &&
                                   job < (K16 / 16) * npair; job += nth >> 5) {
            const int m0 = (job / npair) * 16, c0 = (job % npair) * 16;
            float acc[2][4] = {};
            for (int bi = 0; bi <= buf; ++bi) {  // the sum runs over the edges
              const sv_bf16* pa = sv_frag_at(XQb + (size_t)bi * EC * ldk, ldk, m0);
              const sv_bf16* pb = sv_frag_bt(DHb + bi * 3 * piece, lds, c0);
              for (int e0 = 0; e0 < EC; e0 += 16) {
                unsigned a[4];
                sv_ldsm4_t(a, pa + (size_t)e0 * ldk);
#pragma unroll
                for (int p3 = 0; p3 < 3; ++p3) {
                  unsigned bw[4];
                  sv_ldsm4_t(bw, pb + p3 * piece + (size_t)e0 * lds);
                  sv_mma(acc[0], a, bw[0], bw[1]);
                  sv_mma(acc[1], a, bw[2], bw[3]);
                }
              }
            }
            // one thread adds to each entry of the block's row, flush by
            // flush: a fixed order; the adds happen in L2 (no round trip)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int q = 0; q < 4; q += 2) {
                const int r = m0 + sv_acc_row(lane, q), o = c0 + sv_acc_col(lane, j, q);
                if (r >= IN1 || o >= S_out) continue;
                float* w = pW1 + (size_t)r * S_out + o;
                if (two) {  // o is even, so is o + 1 < S_out
                  atomicAdd((float2*)w, make_float2(acc[j][q], acc[j][q + 1]));
                } else {
                  atomicAdd(w, acc[j][q]);
                  if (o + 1 < S_out) atomicAdd(w + 1, acc[j][q + 1]);
                }
              }
          }
        } else {
          tr_gemm<2, 4>(EC, S_out, IN1,
                        [&](int e, int o) { return DH[(size_t)e * S_out + o] * A.scale1[o]; },
                        [&](int o, int r) { return A.w1t[(size_t)o * IN1 + r]; },
                        [&](int e, int r, float v) { DX[(size_t)e * IN1 + r] = v; });
          tr_gemm<4, 4>(IN1, EC, S_out,
                        [&](int r, int e) { return XQ[(size_t)e * IN1 + r]; },
                        [&](int e, int o) { return DH[(size_t)e * S_out + o] * A.scale1[o]; },
                        [&](int r, int o, float v) { pW1[(size_t)r * S_out + o] += v; });
        }
        tr_gemm<2, 2>(EC * 3, V_out, twoV,
                      [&](int q, int o) { return DV2[(size_t)q * V_out + o] * A.scale2[o]; },
                      [&](int o, int c) { return A.w2t[(size_t)o * twoV + c]; },
                      [&](int q, int c, float v) { DVE[(size_t)q * twoV + c] = v; });
        tr_gemm<2, 2>(twoV, EC * 3, V_out,
                      [&](int c, int q) { return VE[(size_t)q * twoV + c]; },
                      [&](int q, int o) { return DV2[(size_t)q * V_out + o] * A.scale2[o]; },
                      [&](int c, int o, float v) { pW2[(size_t)c * V_out + o] += v; });
        for (int o = tid; o < S_out; o += nth) {
          float acc = 0.f;
          for (int e = 0; e < EC; ++e)
            acc += DH[(size_t)e * S_out + o] * H[(size_t)e * S_out + o];
          psc1[o] += acc;
        }
        for (int o = tid; o < V_out; o += nth) {
          float acc = 0.f;
          for (int q = 0; q < EC * 3; ++q)
            acc += DV2[(size_t)q * V_out + o] * V2R[(size_t)q * V_out + o];
          psc2[o] += acc;
        }
        __syncthreads();
        if (D.binary) {  // STE of sign(x + beta); dbeta is the masked d(x)
          for (int r = tid; r < IN1; r += nth) {
            float acc = 0.f;
            for (int e = 0; e < EC; ++e) {
              const size_t q = (size_t)e * IN1 + r;
              const float dx = fabsf(X[q] + A.beta[r]) <= TR_CLIP ? DX[q] : 0.f;
              DX[q] = dx;
              acc += dx;
            }
            pbeta[r] += acc;
          }
          __syncthreads();
        }
        // Vector2Scalar backward: d(z)[i][j] = sum_c d(sv)[j][c] v_e[i][c]
        for (int i = tid; i < EC * 9; i += nth) {
          const int e = i / 9, i3 = (i % 9) / 3, j = i % 3;
          const float* ve = VE + ((size_t)e * 3 + i3) * twoV;
          const float* dsv = DX + (size_t)e * IN1 + SX + j * twoV;
          float dz = 0.f;
          for (int c = 0; c < twoV; ++c) dz += dsv[c] * ve[c];
          DZ[i] = dz;
          if (D.first) {
            const float* dsa = DX + (size_t)e * IN1 + j * twoV;
            const float* gs = A.dssum + (size_t)b * SX + j * twoV;
            float dz0 = 0.f;
            if (rows[e] >= 0)
              for (int c = 0; c < twoV; ++c) dz0 += (dsa[c] + gs[c]) * ve[c];
            DZ0[i] = dz0;
          }
        }
        __syncthreads();
        for (int i = tid; i < twoV * 3; i += nth) {
          const int c = i / 3, j = i % 3;
          float acc = 0.f, acc0 = 0.f;
          for (int q = 0; q < EC * 3; ++q) {  // q = e*3 + i3
            const float ve = VE[(size_t)q * twoV + c];
            acc += ve * (DZ[q * 3 + j] * A.scalez[j]);
            if (D.first) acc0 += ve * DZ0[q * 3 + j];
          }
          pWZ[i] += acc;
          if (D.first) pWZ0[i] += acc0;
        }
        if (tid < 3) {
          const int j = tid;
          float acc = 0.f;
          for (int q = 0; q < EC * 3; ++q) acc += DZ[q * 3 + j] * ZR[q * 3 + j];
          pscz[j] += acc;
        }
        for (int i = tid; i < EC * 3 * twoV; i += nth) {
          const int e = i / (3 * twoV), ic = i - e * 3 * twoV;
          const int i3 = jcmap[ic] >> 16, c = jcmap[ic] & 0xffff;
          float dv = DVE[i];
          for (int j = 0; j < 3; ++j) {
            const float dsv = DX[(size_t)e * IN1 + SX + j * twoV + c];
            const float z = ZR[e * 9 + i3 * 3 + j] * A.scalez[j];
            const float dzr = DZ[e * 9 + i3 * 3 + j] * A.scalez[j];
            if (D.first) {
              const float dsa = rows[e] >= 0 ? DX[(size_t)e * IN1 + j * twoV + c] +
                                                   A.dssum[(size_t)b * SX + j * twoV + c]
                                             : 0.f;
              dv = dv + dsa * Z0R[e * 9 + i3 * 3 + j] +
                   A.wz0[c * 3 + j] * DZ0[e * 9 + i3 * 3 + j] + dsv * z + A.wz[c * 3 + j] * dzr;
            } else {
              dv = dv + dsv * z + A.wz[c * 3 + j] * dzr;
            }
          }
          DVE[i] = dv;
        }
        __syncthreads();
        // edge features back to src: neighbour half scattered, centre half
        // summed per point in rank order
        for (int i = tid; i < EC * C; i += nth) {
          const int e = i / C, c = i - e * C, row = rows[e];
          if (row < 0) continue;
          float dn;
          if (c < S) {
            dn = DX[(size_t)e * IN1 + c] + A.dssum[(size_t)b * SX + c];
          } else {
            dn = DVE[(size_t)e * 3 * twoV + vmap[c - S]];
          }
          atomicAdd(A.dnbr + ((size_t)b * N + row) * C + c, dn);
        }
        for (int i = tid; i < TP * C; i += nth) {
          const int t = i / C, c = i - t * C;
          float acc = dc[i];
          for (int g = 0; g < TR_G; ++g) {
            const int e = t * TR_G + g;
            if (rows[e] < 0) continue;
            if (c < S) {
              const float dn = DX[(size_t)e * IN1 + c] + A.dssum[(size_t)b * SX + c];
              const float dcs = DX[(size_t)e * IN1 + S + c] + A.dssum[(size_t)b * SX + S + c];
              acc += -dn + dcs;
            } else {
              const float* dve = DVE + (size_t)e * 3 * twoV + vmap[c - S];
              acc += -dve[0] + dve[V];
            }
          }
          dc[i] = acc;
        }
      }
      __syncthreads();
    }

    // ---- tile outputs ----
    if (PH == TR_F1) {
      float* ss = (float*)(sv_smem + L.ss);
      for (int i = tid; i < TP * SX; i += nth) {
        const int t = i / SX, n = n0 + t;
        if (n < N) A.ssum[((size_t)b * N + n) * SX + i % SX] = ss[i];
      }
    } else if (PH == TR_F2) {
      const float* sacc = (const float*)(sv_smem + L.sacc);
      const int* karg = (const int*)(sv_smem + L.karg);
      const float* vacc = (const float*)(sv_smem + L.vacc);
      for (int i = tid; i < TP * S_out; i += nth) {
        const int n = n0 + i / S_out;
        if (n < N) {
          A.s_out[((size_t)b * N + n) * S_out + i % S_out] = sacc[i];
          A.kmax[((size_t)b * N + n) * S_out + i % S_out] = karg[i];
        }
      }
      for (int i = tid; i < TP * 3 * V_out; i += nth) {
        const int n = n0 + i / (3 * V_out);
        if (n < N) A.v_out[((size_t)b * N + n) * 3 * V_out + i % (3 * V_out)] = vacc[i] * inv_k;
      }
    } else if (PH == TR_B2) {
      const float* dc = (const float*)(sv_smem + L.dctr);
      for (int i = tid; i < TP * C; i += nth) {
        const int n = n0 + i / C;
        if (n < N) A.dctr[((size_t)b * N + n) * C + i % C] = dc[i];
      }
    }
    __syncthreads();
  }
}

template <int PH, int TP>
static cudaError_t tr_launch_tile(const TrArgs& A, const TrDims& D, int nblocks,
                                  cudaStream_t st) {
  const TrSmem L = tr_layout(D, PH, TP);
  if (L.total > SV_SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sv_train_kernel<PH, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  // a persistent grid of the blocks the card holds at once, at most the
  // caller's rows of partial sums
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sv_train_kernel<PH, TP>,
                                                           TR_THREADS, L.total)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = nblocks < sms * per_sm ? nblocks : sms * per_sm;
  TrDims Dg = D;
  Dg.nrows = nblocks;
  sv_train_kernel<PH, TP><<<grid, TR_THREADS, L.total, st>>>(A, Dg, L);
  return cudaGetLastError();
}

template <int PH>
static cudaError_t tr_launch_phase(const TrArgs& A, const TrDims& D, int nblocks,
                                   cudaStream_t st) {
  if (PH == TR_B2 && tr_layout(D, PH, TR_TP).total > SV_SMEM_LIMIT)
    return tr_launch_tile<PH, TR_TP / 2>(A, D, nblocks, st);
  return tr_launch_tile<PH, TR_TP>(A, D, nblocks, st);
}

// dims: D_COUNT ints in the D_* order.
static TrDims tr_dims(const int* dims, int first) {
  TrDims D;
  D.B = dims[D_B];
  D.N = dims[D_N];
  D.k = dims[D_K];
  D.S = dims[D_S];
  D.V = dims[D_V];
  D.S_out = dims[D_SOUT];
  D.V_out = dims[D_VOUT];
  D.binary = dims[D_BINARY];
  D.first = first;
  D.C = D.S + 3 * D.V;
  D.twoV = 2 * D.V;
  D.SX = first ? 3 * D.twoV : 2 * D.S;
  D.IN1 = D.SX + 3 * D.twoV;
  D.nrows = dims[D_NBLOCKS];
  return D;
}

// Centre points per tile that a phase launches with at these dims (B2:
// TR_TP / 2 where TR_TP's layout exceeds the shared-memory limit), 0 where
// neither fits.
static int tr_tile(int phase, const int* dims, int first) {
  const TrDims D = tr_dims(dims, first);
  if (tr_layout(D, phase, TR_TP).total <= SV_SMEM_LIMIT) return TR_TP;
  if (phase == TR_B2 && tr_layout(D, phase, TR_TP / 2).total <= SV_SMEM_LIMIT)
    return TR_TP / 2;
  return 0;
}

// One phase of a training round. ptrs: P_COUNT pointers in the P_* order
// (unused slots may be null).
static int tr_run(int phase, void* const* ptrs, const int* dims, int first,
                  void* stream) {
  const TrDims D = tr_dims(dims, first);
  const int nblocks = D.nrows;
  if (D.k < 1 || D.k > D.N || nblocks < 1 || (first && (D.S != 0 || D.V != 1)))
    return (int)cudaErrorInvalidValue;
  TrArgs A;
  A.src = (const float*)ptrs[P_SRC];
  A.idx = (const int*)ptrs[P_IDX];
  A.wz0 = (const float*)ptrs[P_WZ0];
  A.wz = (const float*)ptrs[P_WZ];
  A.scalez = (const float*)ptrs[P_SCALEZ];
  A.w1 = (const float*)ptrs[P_W1];
  A.w1t = (const float*)ptrs[P_W1T];
  A.beta = (const float*)ptrs[P_BETA];
  A.scale1 = (const float*)ptrs[P_SCALE1];
  A.g1 = (const float*)ptrs[P_G1];
  A.bb1 = (const float*)ptrs[P_BB1];
  A.mu1 = (const float*)ptrs[P_MU1];
  A.inv1 = (const float*)ptrs[P_INV1];
  A.w2 = (const float*)ptrs[P_W2];
  A.w2t = (const float*)ptrs[P_W2T];
  A.scale2 = (const float*)ptrs[P_SCALE2];
  A.g2 = (const float*)ptrs[P_G2];
  A.bb2 = (const float*)ptrs[P_BB2];
  A.mun = (const float*)ptrs[P_MUN];
  A.invn = (const float*)ptrs[P_INVN];
  A.dso = (const float*)ptrs[P_DSO];
  A.dvo = (const float*)ptrs[P_DVO];
  A.kmax = (int*)ptrs[P_KMAX];
  A.dssum = (const float*)ptrs[P_DSSUM];
  A.red = (const float*)ptrs[P_RED];
  A.part = ptrs[P_PART];
  A.ssum = (float*)ptrs[P_SSUM];
  A.s_out = (float*)ptrs[P_SOUT];
  A.v_out = (float*)ptrs[P_VOUT];
  A.dctr = (float*)ptrs[P_DCTR];
  A.dnbr = (float*)ptrs[P_DNBR];
  cudaStream_t st = (cudaStream_t)stream;
  switch (phase) {
    case TR_F1: return (int)tr_launch_phase<TR_F1>(A, D, nblocks, st);
    case TR_F2: return (int)tr_launch_phase<TR_F2>(A, D, nblocks, st);
    case TR_B1: return (int)tr_launch_phase<TR_B1>(A, D, nblocks, st);
    case TR_B2: return (int)tr_launch_phase<TR_B2>(A, D, nblocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

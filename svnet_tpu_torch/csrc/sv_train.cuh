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
// kernel: a persistent grid walks tiles of TR_TP points, and each block
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
#pragma once

#include "sv_common.cuh"

#define TR_TP 8        // centre points per tile
#define TR_G 2         // neighbour ranks per chunk
#define TR_E (TR_TP * TR_G)
#define TR_THREADS 256
#define TR_CLIP 1.2f   // STE: the sign's gradient passes where |x| <= 1.2
#define TR_NSQ_FLOOR 1e-12f

enum { TR_F1 = 0, TR_F2 = 1, TR_B1 = 2, TR_B2 = 3 };

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
  int B, N, k, S, V, S_out, V_out, binary, first;
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
      DV2, DVE, DZ, DZ0, dctr, total;
};

static TrSmem tr_layout(const TrDims& D, int phase) {
  TrSmem L;
  size_t o = 0;
  auto take = [&o](size_t n) { size_t at = o; o += sv_align16(n * 4); return at; };
  const size_t E = TR_E;
  L.ctr = take((size_t)TR_TP * D.C);
  L.rows = take(E);
  L.X = take(E * D.IN1);
  L.XQ = D.binary ? take(E * D.IN1) : L.X;
  L.VE = take(E * 3 * D.twoV);
  L.ZR = take(E * 9);
  L.Z0R = D.first ? take(E * 9) : L.ZR;
  L.H = take(E * D.S_out);
  L.V2R = take(E * 3 * D.V_out);
  L.ss = L.sacc = L.karg = L.vacc = 0;
  L.DH = L.DX = L.DV2 = L.DVE = L.DZ = L.DZ0 = L.dctr = 0;
  if (phase == TR_F1) L.ss = take((size_t)TR_TP * D.SX);
  if (phase == TR_F2) {
    L.sacc = take((size_t)TR_TP * D.S_out);
    L.karg = take((size_t)TR_TP * D.S_out);
    L.vacc = take((size_t)TR_TP * 3 * D.V_out);
  }
  if (phase == TR_B2) {
    L.DH = take(E * D.S_out);
    L.DX = take(E * D.IN1);
    L.DV2 = take(E * 3 * D.V_out);
    L.DVE = take(E * 3 * D.twoV);
    L.DZ = take(E * 9);
    L.DZ0 = D.first ? take(E * 9) : L.DZ;
    L.dctr = take((size_t)TR_TP * D.C);
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
// recorded argmax, times the leaky slope at ybn.
static __device__ __forceinline__ float tr_dy(const TrArgs& A, size_t pt_o,
                                              int r, float xhat, int o) {
  const float ybn = A.g1[o] * xhat + A.bb1[o];
  const float lm = ybn >= 0.f ? 1.f : 0.2f;
  return (A.kmax[pt_o] == r ? A.dso[pt_o] : 0.f) * lm;
}

template <int PH>
static __global__ void __launch_bounds__(TR_THREADS)
sv_train_kernel(TrArgs A, TrDims D, TrSmem L) {
  extern __shared__ __align__(16) unsigned char sv_smem[];
  float* CTR = (float*)(sv_smem + L.ctr);  // (TP, C)
  int* rows = (int*)(sv_smem + L.rows);    // (E,) -1 = no edge
  float* X = (float*)(sv_smem + L.X);      // (E, IN1) x before the sign
  float* XQ = (float*)(sv_smem + L.XQ);    // (E, IN1) linear1's operand
  float* VE = (float*)(sv_smem + L.VE);    // (E, 3, 2V)
  float* ZR = (float*)(sv_smem + L.ZR);    // (E, 3, 3) unscaled frames
  float* Z0R = (float*)(sv_smem + L.Z0R);  // (E, 3, 3) first: init_scalar's
  float* H = (float*)(sv_smem + L.H);      // (E, S_out) h before scale1
  float* V2R = (float*)(sv_smem + L.V2R);  // (E, 3, V_out) v2 before scale2

  const int N = D.N, k = D.k, S = D.S, V = D.V, C = D.C, twoV = D.twoV;
  const int SX = D.SX, IN1 = D.IN1, S_out = D.S_out, V_out = D.V_out;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int tpb = (N + TR_TP - 1) / TR_TP, ntiles = D.B * tpb;
  const float inv_k = (float)(1.0 / k);
  const size_t pw = tr_part_width(D, PH);
  double* partd = (double*)A.part + (size_t)blockIdx.x * pw;  // F1, B1
  float* part = (float*)A.part + (size_t)blockIdx.x * pw;     // B2
  if (PH == TR_F1 || PH == TR_B1)
    for (size_t i = tid; i < pw; i += nth) partd[i] = 0.0;
  if (PH == TR_B2)
    for (size_t i = tid; i < pw; i += nth) part[i] = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tpb, n0 = (tile % tpb) * TR_TP;
    const float* x = A.src + (size_t)b * N * C;
    for (int i = tid; i < TR_TP * C; i += nth) {
      const int t = i / C, n = n0 + t;
      CTR[i] = n < N ? x[(size_t)n * C + i % C] : 0.f;
    }
    if (PH == TR_F1) {
      float* ss = (float*)(sv_smem + L.ss);
      for (int i = tid; i < TR_TP * SX; i += nth) ss[i] = 0.f;
    }
    if (PH == TR_F2) {
      float* vacc = (float*)(sv_smem + L.vacc);
      for (int i = tid; i < TR_TP * 3 * V_out; i += nth) vacc[i] = 0.f;
    }
    if (PH == TR_B2) {
      float* dc = (float*)(sv_smem + L.dctr);
      for (int i = tid; i < TR_TP * C; i += nth) dc[i] = 0.f;
    }

    for (int r0 = 0; r0 < k; r0 += TR_G) {
      // ---- recompute the chunk's edges: rows, x, v_e, frames, h, v2 ----
      for (int e = tid; e < TR_E; e += nth) {
        const int n = n0 + e / TR_G, r = r0 + e % TR_G;
        rows[e] = (n < N && r < k) ? A.idx[((size_t)b * N + n) * k + r] : -1;
      }
      __syncthreads();
      for (int i = tid; i < TR_E * C; i += nth) {
        const int e = i / C, c = i % C, row = rows[e];
        const float cv = CTR[(e / TR_G) * C + c];
        const float d = (row >= 0 ? x[(size_t)row * C + c] : cv) - cv;
        if (c < S) {
          X[(size_t)e * IN1 + c] = d;
          X[(size_t)e * IN1 + S + c] = cv;
        } else {
          const int i3 = (c - S) / V, cc = (c - S) % V;
          VE[((size_t)e * 3 + i3) * twoV + cc] = d;
          VE[((size_t)e * 3 + i3) * twoV + V + cc] = cv;
        }
      }
      __syncthreads();
      for (int i = tid; i < TR_E * 9; i += nth) {
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
      for (int i = tid; i < TR_E * 3 * twoV; i += nth) {
        const int e = i / (3 * twoV), j = (i % (3 * twoV)) / twoV, c = i % twoV;
        const float* ve = VE + (size_t)e * 3 * twoV;
        const float* z = ZR + e * 9;
        const float sz = A.scalez[j];
        X[(size_t)e * IN1 + SX + j * twoV + c] = sv_dot3_rn(
            ve[c], __fmul_rn(z[j], sz), ve[twoV + c], __fmul_rn(z[3 + j], sz),
            ve[2 * twoV + c], __fmul_rn(z[6 + j], sz));
        if (D.first) {
          const float* z0 = Z0R + e * 9;
          X[(size_t)e * IN1 + j * twoV + c] = sv_dot3_rn(
              ve[c], z0[j], ve[twoV + c], z0[3 + j], ve[2 * twoV + c], z0[6 + j]);
        }
      }
      __syncthreads();
      if (D.binary) {
        for (int i = tid; i < TR_E * IN1; i += nth)
          XQ[i] = sv_sign(X[i] + A.beta[i % IN1]);
        __syncthreads();
      }
      tr_gemm<2, 4>(TR_E, IN1, S_out,
                    [&](int e, int r) { return XQ[(size_t)e * IN1 + r]; },
                    [&](int r, int o) { return A.w1[(size_t)r * S_out + o]; },
                    [&](int e, int o, float h) { H[(size_t)e * S_out + o] = h; });
      tr_gemm<2, 2>(TR_E * 3, twoV, V_out,
                    [&](int q, int c) { return VE[(size_t)q * twoV + c]; },
                    [&](int c, int o) { return A.w2[(size_t)c * V_out + o]; },
                    [&](int q, int o, float v) { V2R[(size_t)q * V_out + o] = v; });
      __syncthreads();

      if (PH == TR_F1) {
        // BN sums over the chunk's edges; per-point gate sums rank by rank
        for (int o = tid; o < S_out; o += nth) {
          double hs = 0.0, hq = 0.0;
          for (int e = 0; e < TR_E; ++e) {
            if (rows[e] < 0) continue;
            const float h = H[(size_t)e * S_out + o] * A.scale1[o];
            hs += (double)h;
            hq += (double)(h * h);
          }
          partd[o] += hs;
          partd[S_out + o] += hq;
        }
        for (int o = tid; o < V_out; o += nth) {
          double ns = 0.0, nq = 0.0;
          for (int e = 0; e < TR_E; ++e) {
            if (rows[e] < 0) continue;
            const TrVec tv = tr_vec(V2R, e, o, V_out, A.scale2[o]);
            ns += (double)tv.n;
            nq += (double)(tv.n * tv.n);
          }
          partd[2 * S_out + o] += ns;
          partd[2 * S_out + V_out + o] += nq;
        }
        float* ss = (float*)(sv_smem + L.ss);
        for (int i = tid; i < TR_TP * SX; i += nth) {
          const int t = i / SX, ch = i % SX;
          for (int g = 0; g < TR_G; ++g) {
            const int e = t * TR_G + g;
            if (rows[e] >= 0) ss[i] += X[(size_t)e * IN1 + ch];
          }
        }
      } else if (PH == TR_F2) {
        float* sacc = (float*)(sv_smem + L.sacc);
        int* karg = (int*)(sv_smem + L.karg);
        float* vacc = (float*)(sv_smem + L.vacc);
        for (int i = tid; i < TR_TP * S_out; i += nth) {
          const int t = i / S_out, o = i % S_out;
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
        for (int i = tid; i < TR_TP * V_out; i += nth) {
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
        for (int o = tid; o < S_out; o += nth) {
          double ds = 0.0, dx = 0.0;
          for (int e = 0; e < TR_E; ++e) {
            if (rows[e] < 0) continue;
            const int n = n0 + e / TR_G, r = r0 + e % TR_G;
            const float h = H[(size_t)e * S_out + o] * A.scale1[o];
            const float xhat = (h - A.mu1[o]) * A.inv1[o];
            const float dy = tr_dy(A, ((size_t)b * N + n) * S_out + o, r, xhat, o);
            ds += (double)dy;
            dx += (double)(dy * xhat);
          }
          partd[o] += ds;
          partd[S_out + o] += dx;
        }
        for (int o = tid; o < V_out; o += nth) {
          double ds = 0.0, dx = 0.0;
          for (int e = 0; e < TR_E; ++e) {
            if (rows[e] < 0) continue;
            const int n = n0 + e / TR_G;
            const TrVec tv = tr_vec(V2R, e, o, V_out, A.scale2[o]);
            const float nhat = (tv.n - A.mun[o]) * A.invn[o];
            const float* dv = A.dvo + ((size_t)b * N + n) * 3 * V_out + o;
            const float G = (dv[0] * inv_k) * tv.v2[0] + (dv[V_out] * inv_k) * tv.v2[1] +
                            (dv[2 * V_out] * inv_k) * tv.v2[2];
            const float dnbn = G / tv.n;
            ds += (double)dnbn;
            dx += (double)(dnbn * nhat);
          }
          partd[2 * S_out + o] += ds;
          partd[2 * S_out + V_out + o] += dx;
        }
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
        for (int i = tid; i < TR_E * S_out; i += nth) {
          const int e = i / S_out, o = i % S_out;
          float dh = 0.f;
          if (rows[e] >= 0) {
            const int n = n0 + e / TR_G, r = r0 + e % TR_G;
            const float h = H[i] * A.scale1[o];
            const float xhat = (h - A.mu1[o]) * A.inv1[o];
            const float dy = tr_dy(A, ((size_t)b * N + n) * S_out + o, r, xhat, o);
            dh = (A.g1[o] * A.inv1[o]) * ((dy - red[o]) - xhat * red[S_out + o]);
          }
          DH[i] = dh;
        }
        for (int i = tid; i < TR_E * V_out; i += nth) {
          const int e = i / V_out, o = i % V_out;
          float dv2[3] = {0.f, 0.f, 0.f};
          if (rows[e] >= 0) {
            const int n = n0 + e / TR_G;
            const TrVec tv = tr_vec(V2R, e, o, V_out, A.scale2[o]);
            const float nhat = (tv.n - A.mun[o]) * A.invn[o];
            const float nbn = A.g2[o] * nhat + A.bb2[o];
            const float w = nbn / tv.n;
            const float* dv = A.dvo + ((size_t)b * N + n) * 3 * V_out + o;
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
        tr_gemm<2, 4>(TR_E, S_out, IN1,
                      [&](int e, int o) { return DH[(size_t)e * S_out + o] * A.scale1[o]; },
                      [&](int o, int r) { return A.w1t[(size_t)o * IN1 + r]; },
                      [&](int e, int r, float v) { DX[(size_t)e * IN1 + r] = v; });
        tr_gemm<2, 2>(TR_E * 3, V_out, twoV,
                      [&](int q, int o) { return DV2[(size_t)q * V_out + o] * A.scale2[o]; },
                      [&](int o, int c) { return A.w2t[(size_t)o * twoV + c]; },
                      [&](int q, int c, float v) { DVE[(size_t)q * twoV + c] = v; });
        tr_gemm<4, 4>(IN1, TR_E, S_out,
                      [&](int r, int e) { return XQ[(size_t)e * IN1 + r]; },
                      [&](int e, int o) { return DH[(size_t)e * S_out + o] * A.scale1[o]; },
                      [&](int r, int o, float v) { pW1[(size_t)r * S_out + o] += v; });
        tr_gemm<2, 2>(twoV, TR_E * 3, V_out,
                      [&](int c, int q) { return VE[(size_t)q * twoV + c]; },
                      [&](int q, int o) { return DV2[(size_t)q * V_out + o] * A.scale2[o]; },
                      [&](int c, int o, float v) { pW2[(size_t)c * V_out + o] += v; });
        for (int o = tid; o < S_out; o += nth) {
          float acc = 0.f;
          for (int e = 0; e < TR_E; ++e)
            acc += DH[(size_t)e * S_out + o] * H[(size_t)e * S_out + o];
          psc1[o] += acc;
        }
        for (int o = tid; o < V_out; o += nth) {
          float acc = 0.f;
          for (int q = 0; q < TR_E * 3; ++q)
            acc += DV2[(size_t)q * V_out + o] * V2R[(size_t)q * V_out + o];
          psc2[o] += acc;
        }
        __syncthreads();
        if (D.binary) {  // STE of sign(x + beta); dbeta is the masked d(x)
          for (int r = tid; r < IN1; r += nth) {
            float acc = 0.f;
            for (int e = 0; e < TR_E; ++e) {
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
        for (int i = tid; i < TR_E * 9; i += nth) {
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
          for (int q = 0; q < TR_E * 3; ++q) {  // q = e*3 + i3
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
          for (int q = 0; q < TR_E * 3; ++q) acc += DZ[q * 3 + j] * ZR[q * 3 + j];
          pscz[j] += acc;
        }
        for (int i = tid; i < TR_E * 3 * twoV; i += nth) {
          const int e = i / (3 * twoV), i3 = (i % (3 * twoV)) / twoV, c = i % twoV;
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
        for (int i = tid; i < TR_E * C; i += nth) {
          const int e = i / C, c = i % C, row = rows[e];
          if (row < 0) continue;
          float dn;
          if (c < S) {
            dn = DX[(size_t)e * IN1 + c] + A.dssum[(size_t)b * SX + c];
          } else {
            const int i3 = (c - S) / V, cc = (c - S) % V;
            dn = DVE[((size_t)e * 3 + i3) * twoV + cc];
          }
          atomicAdd(A.dnbr + ((size_t)b * N + row) * C + c, dn);
        }
        for (int i = tid; i < TR_TP * C; i += nth) {
          const int t = i / C, c = i % C;
          float acc = dc[i];
          for (int g = 0; g < TR_G; ++g) {
            const int e = t * TR_G + g;
            if (rows[e] < 0) continue;
            if (c < S) {
              const float dn = DX[(size_t)e * IN1 + c] + A.dssum[(size_t)b * SX + c];
              const float dcs = DX[(size_t)e * IN1 + S + c] + A.dssum[(size_t)b * SX + S + c];
              acc += -dn + dcs;
            } else {
              const int i3 = (c - S) / V, cc = (c - S) % V;
              const float* dve = DVE + ((size_t)e * 3 + i3) * twoV;
              acc += -dve[cc] + dve[V + cc];
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
      for (int i = tid; i < TR_TP * SX; i += nth) {
        const int t = i / SX, n = n0 + t;
        if (n < N) A.ssum[((size_t)b * N + n) * SX + i % SX] = ss[i];
      }
    } else if (PH == TR_F2) {
      const float* sacc = (const float*)(sv_smem + L.sacc);
      const int* karg = (const int*)(sv_smem + L.karg);
      const float* vacc = (const float*)(sv_smem + L.vacc);
      for (int i = tid; i < TR_TP * S_out; i += nth) {
        const int n = n0 + i / S_out;
        if (n < N) {
          A.s_out[((size_t)b * N + n) * S_out + i % S_out] = sacc[i];
          A.kmax[((size_t)b * N + n) * S_out + i % S_out] = karg[i];
        }
      }
      for (int i = tid; i < TR_TP * 3 * V_out; i += nth) {
        const int n = n0 + i / (3 * V_out);
        if (n < N) A.v_out[((size_t)b * N + n) * 3 * V_out + i % (3 * V_out)] = vacc[i] * inv_k;
      }
    } else if (PH == TR_B2) {
      const float* dc = (const float*)(sv_smem + L.dctr);
      for (int i = tid; i < TR_TP * C; i += nth) {
        const int n = n0 + i / C;
        if (n < N) A.dctr[((size_t)b * N + n) * C + i % C] = dc[i];
      }
    }
    __syncthreads();
  }
}

template <int PH>
static cudaError_t tr_launch_phase(const TrArgs& A, const TrDims& D, int nblocks,
                                   cudaStream_t st) {
  const TrSmem L = tr_layout(D, PH);
  if (L.total > SV_SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sv_train_kernel<PH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  sv_train_kernel<PH><<<nblocks, TR_THREADS, L.total, st>>>(A, D, L);
  return cudaGetLastError();
}

// One phase of a training round. ptrs: P_COUNT pointers in the P_* order
// (unused slots may be null); dims: D_COUNT ints in the D_* order.
static int tr_run(int phase, void* const* ptrs, const int* dims, int first,
                  void* stream) {
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
  const int nblocks = dims[D_NBLOCKS];
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

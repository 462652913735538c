// The block kernels of the exact-mode fused rounds, shared by the
// channel-major round3 launchers (sv_round3_first.cu, sv_round3.cu), the
// row-major round2 and round launchers (sv_round2.cu, sv_round.cu) and the
// row-major launchers that take the caller's neighbour ids (sv_edge.cu,
// through sv_first_block and sv_conv_block). Each kernel is a template
// on the layout: with ROW the source, the outputs and the neighbour ids
// are row-major -- a neighbour is one contiguous row (B, N, C), the ids
// (B, N, k) -- else channel-major (B, C, N) with ids (B, k, N). Only the
// addressing differs; the arithmetic, and so every output bit, is the
// same in both layouts. The per-point gate sums always leave channel-major
// (B, channels, N): the wrappers reduce them over N in one layout.
#pragma once

#include "sv_common.cuh"

// ---------------------------------------------------------------------------
// first round (xyz edges, FP block)
// ---------------------------------------------------------------------------
// One thread per centre point, all of its block math in registers: edges
// [nbr - ctr, ctr] (NCH = 2, DGCNN) or [nbr - ctr, ctr, nbr x ctr]
// (NCH = 3, SV-PointNet), init Vector2Scalar (wz0) and the block's
// Vector2Scalar (wz1), FP linear1 + folded BN + leaky 0.2 -> max over k,
// linear2 + VectorBN -> mean over k, and the init-scalar sums the gate
// reads. S_out is 32; VO, the vector width, is 10 (SV_DGCNN_CLS,
// SV-PointNet) or 16 (SV_DGCNN_PSEG's make_divisible widths).
#define F_S_OUT 32
#define F_THREADS 128

template <int NCH, int VO, bool ROW>
static __global__ void __launch_bounds__(F_THREADS)
sv_first_block_kernel(
    const float* __restrict__ pts, const int* __restrict__ wins,
    const float* __restrict__ wz0, const float* __restrict__ wz1,
    const float* __restrict__ w1, const float* __restrict__ a1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ a2, const float* __restrict__ b2,
    float* __restrict__ s_out, float* __restrict__ v_out,
    float* __restrict__ ssum, int N, int k) {
  constexpr int NSS = 3 * NCH, NX = 6 * NCH;
  const int b = blockIdx.y;
  const int n = blockIdx.x * F_THREADS + threadIdx.x;
  const bool valid = n < N;
  const float* x = pts + (size_t)b * 3 * N;
  // coordinate i of point m
  auto coord = [&](int m, int i) {
    return ROW ? x[(size_t)m * 3 + i] : x[(size_t)i * N + m];
  };

  float ctr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ctr[i] = valid ? coord(n, i) : 0.f;
  float sacc[F_S_OUT], vacc[3][VO], ss[NSS];
#pragma unroll
  for (int o = 0; o < F_S_OUT; ++o) sacc[o] = -INFINITY;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int o = 0; o < VO; ++o) vacc[i][o] = 0.f;
#pragma unroll
  for (int j = 0; j < NSS; ++j) ss[j] = 0.f;

  for (int r = 0; valid && r < k; ++r) {
    const int row = ROW ? wins[((size_t)b * N + n) * k + r]
                        : wins[((size_t)b * k + r) * N + n];
    float nb[3], ve[3][NCH];  // per component i: [nbr - ctr, ctr(, cross)]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nb[i] = coord(row, i);
      ve[i][0] = nb[i] - ctr[i];
      ve[i][1] = ctr[i];
    }
    if constexpr (NCH == 3) {
      ve[0][2] = nb[1] * ctr[2] - nb[2] * ctr[1];
      ve[1][2] = nb[2] * ctr[0] - nb[0] * ctr[2];
      ve[2][2] = nb[0] * ctr[1] - nb[1] * ctr[0];
    }
    // Vector2Scalar invariants, j-major rows j*NCH + c: init_scalar (wz0)
    // then the block's v2s (wz1); frames summed over c in order
    float xc[NX];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* wz = h == 0 ? wz0 : wz1;
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
    for (int j = 0; j < NSS; ++j) ss[j] += xc[j];
#pragma unroll
    for (int o = 0; o < F_S_OUT; ++o) {
      float h = 0.f;
#pragma unroll
      for (int q = 0; q < NX; ++q) h += xc[q] * w1[q * F_S_OUT + o];
      sacc[o] = fmaxf(sacc[o], sv_leaky(h * a1[o] + b1[o]));
    }
#pragma unroll
    for (int o = 0; o < VO; ++o) {
      float wl[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float acc = ve[i][0] * w2[o];
#pragma unroll
        for (int c = 1; c < NCH; ++c) acc += ve[i][c] * w2[c * VO + o];
        wl[i] = acc;
      }
      const float nrm = sqrtf(wl[0] * wl[0] + wl[1] * wl[1] + wl[2] * wl[2]) + SV_EPS;
      const float f = a2[o] + b2[o] / nrm;
#pragma unroll
      for (int i = 0; i < 3; ++i) vacc[i][o] += wl[i] * f;
    }
  }

  if (valid) {
    const float inv_k = (float)(1.0 / k);
#pragma unroll
    for (int o = 0; o < F_S_OUT; ++o)
      s_out[ROW ? ((size_t)b * N + n) * F_S_OUT + o
                : ((size_t)b * F_S_OUT + o) * N + n] = sacc[o];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int o = 0; o < VO; ++o)
        v_out[ROW ? ((size_t)b * N + n) * 3 * VO + i * VO + o
                  : ((size_t)b * 3 * VO + i * VO + o) * N + n] =
            vacc[i][o] * inv_k;
#pragma unroll
    for (int j = 0; j < NSS; ++j) ssum[((size_t)b * NSS + j) * N + n] = ss[j];
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
  dim3 grid((N + F_THREADS - 1) / F_THREADS, B);
#define SV_FIRST(NCH, VO)                                                   \
  sv_first_block_kernel<NCH, VO, ROW><<<grid, F_THREADS, 0, st>>>(          \
      pts, wins, wz0, wz1, w1, a1, b1, w2, a2, b2, s_out, v_out, ssum, N, k)
  if (cross) {
    if (V_out == 10) SV_FIRST(3, 10); else SV_FIRST(3, 16);
  } else {
    if (V_out == 10) SV_FIRST(2, 10); else SV_FIRST(2, 16);
  }
#undef SV_FIRST
  return (int)cudaGetLastError();
}

// Selection over the xyz points (C = 3), then the block kernel.
template <bool ROW>
static int sv_first_round(const float* pts, float* aa, const float* wz0,
                          const float* wz1, const float* w1, const float* a1,
                          const float* b1, const float* w2, const float* a2,
                          const float* b2, float* s_out, float* v_out,
                          float* ssum, int* wins, int B, int N, int k,
                          int S_out, int V_out, int cross, cudaStream_t st) {
  if (S_out != F_S_OUT || (V_out != 10 && V_out != 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = sv_knn_select(pts, aa, wins, B, N, 3, k, st,
                                  /*point_major=*/ROW, /*row_major=*/ROW);
  if (err != cudaSuccess) return (int)err;
  return sv_first_block<ROW>(pts, wins, wz0, wz1, w1, a1, b1, w2, a2, b2,
                             s_out, v_out, ssum, B, N, k, S_out, V_out, cross,
                             st);
}

// ---------------------------------------------------------------------------
// conv round (joint-feature edges, binary or FP block)
// ---------------------------------------------------------------------------
// A block stages R3_TP centres x R3_G ranks of edge features in shared
// memory -- the gather reads neighbour rows straight from device memory --
// and runs linear1 as a register-tiled block GEMM over them, so each weight
// load serves four edges. Pooled maxima and sums stay in shared memory
// across rank chunks; nothing of shape (B, N, k, C) reaches device memory.
#define R3_TP 16  // centre points per block
#define R3_G 2    // neighbour ranks per chunk
#define R3_E (R3_TP * R3_G)
#define R3_THREADS 256

struct R3Smem {
  size_t ctr, X, VE, Z, Y, sacc, vacc, sesum, rows, total;
};

// ``stats``: room for the per-point sums of the edge scalars (the gate
// statistics); the gated variant emits none.
static R3Smem r3_layout(int S, int V, int S_out, int V_out, bool stats = true) {
  const int C = S + 3 * V, twoV = 2 * V, IN1 = 2 * S + 6 * V;
  R3Smem L;
  size_t o = 0;
  auto take = [&o](size_t n) { size_t at = o; o += sv_align16(n * 4); return at; };
  L.ctr = take((size_t)R3_TP * C);
  L.X = take((size_t)R3_E * IN1);
  L.VE = take((size_t)R3_E * 3 * twoV);
  L.Z = take((size_t)R3_E * 9);
  L.Y = take((size_t)R3_E * S_out);
  L.sacc = take((size_t)R3_TP * S_out);
  L.vacc = take((size_t)R3_TP * 3 * V_out);
  L.sesum = stats ? take((size_t)R3_TP * (2 * S > 0 ? 2 * S : 1)) : take(0);
  L.rows = take(R3_E);
  L.total = o;
  return L;
}

// GATED: v leaves gated, (sum * (1/k)) * gate[b, o] with gate (B, V_out),
// and no gate statistics are summed (ssum unused); else v leaves ungated
// and ssum takes the per-point sums of the edge scalars.
template <bool ROW, bool GATED = false>
static __global__ void __launch_bounds__(R3_THREADS)
sv_round_block_kernel(
    const float* __restrict__ src, const int* __restrict__ wins,
    const float* __restrict__ gate,
    const float* __restrict__ wz, const float* __restrict__ w1,
    const float* __restrict__ beta, const float* __restrict__ a1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ scale2, const float* __restrict__ a2,
    const float* __restrict__ b2, float* __restrict__ s_out,
    float* __restrict__ v_out, float* __restrict__ ssum, R3Smem L, int N,
    int S, int V, int S_out, int V_out, int k, int binary) {
  extern __shared__ __align__(16) unsigned char sv_smem[];
  float* ctr = (float*)(sv_smem + L.ctr);    // (TP, C)
  float* X = (float*)(sv_smem + L.X);        // (E, IN1): [s_e | sv j-major]
  float* VE = (float*)(sv_smem + L.VE);      // (E, 3, 2V): [diff | ctr]
  float* Z = (float*)(sv_smem + L.Z);        // (E, 3, 3): z_i[j]
  float* Y = (float*)(sv_smem + L.Y);        // (E, S_out)
  float* sacc = (float*)(sv_smem + L.sacc);  // (TP, S_out)
  float* vacc = (float*)(sv_smem + L.vacc);  // (TP, 3, V_out)
  float* sesum = (float*)(sv_smem + L.sesum);  // (TP, 2S)
  int* rows = (int*)(sv_smem + L.rows);      // (E,) -1 = no edge

  const int C = S + 3 * V, twoV = 2 * V, IN1 = 2 * S + 6 * V;
  const int b = blockIdx.y, n0 = blockIdx.x * R3_TP;
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* x = src + (size_t)b * C * N;
  // channel c of point m: ROW reads a point's row contiguously
  auto at = [&](int m, int c) {
    return ROW ? x[(size_t)m * C + c] : x[(size_t)c * N + m];
  };

  for (int i = tid; i < R3_TP * C; i += nth) {
    const int t = i / C, c = i % C, n = n0 + t;
    ctr[i] = n < N ? at(n, c) : 0.f;
  }
  for (int i = tid; i < R3_TP * S_out; i += nth) sacc[i] = -INFINITY;
  for (int i = tid; i < R3_TP * 3 * V_out; i += nth) vacc[i] = 0.f;
  if constexpr (!GATED)
    for (int i = tid; i < R3_TP * 2 * S; i += nth) sesum[i] = 0.f;

  for (int r0 = 0; r0 < k; r0 += R3_G) {
    for (int e = tid; e < R3_E; e += nth) {
      const int n = n0 + e / R3_G, r = r0 + e % R3_G;
      rows[e] = (n < N && r < k)
                    ? (ROW ? wins[((size_t)b * N + n) * k + r]
                           : wins[((size_t)b * k + r) * N + n])
                    : -1;
    }
    __syncthreads();
    // gather: raw edge scalars into X[:, :2S], vectors into VE
    for (int i = tid; i < R3_E * C; i += nth) {
      const int e = i / C, c = i % C, row = rows[e];
      const float cv = ctr[(e / R3_G) * C + c];
      const float d = (row >= 0 ? at(row, c) : cv) - cv;
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
    // gate statistics: per-point sums of the raw edge scalars, rank by rank
    if constexpr (!GATED)
      for (int i = tid; i < R3_TP * 2 * S; i += nth) {
        const int t = i / (2 * S), ch = i % (2 * S);
        for (int g = 0; g < R3_G; ++g) {
          const int e = t * R3_G + g;
          if (rows[e] >= 0) sesum[i] += X[(size_t)e * IN1 + ch];
        }
      }
    // Vector2Scalar frame z_i[j] = sum_c v_e[i][c] * wz[c][j]
    for (int i = tid; i < R3_E * 9; i += nth) {
      const int e = i / 9, i3 = (i % 9) / 3, j = i % 3;
      const float* ve = VE + ((size_t)e * 3 + i3) * twoV;
      float z = 0.f;
      for (int c = 0; c < twoV; ++c) z = __fadd_rn(z, __fmul_rn(ve[c], wz[c * 3 + j]));
      Z[i] = z;
    }
    __syncthreads();
    // invariants sv[j][c] = sum_i v_e[i][c] * z_i[j], rows 2S + j*2V + c
    for (int i = tid; i < R3_E * 3 * twoV; i += nth) {
      const int e = i / (3 * twoV), j = (i % (3 * twoV)) / twoV, c = i % twoV;
      const float* ve = VE + (size_t)e * 3 * twoV;
      const float* z = Z + e * 9;
      X[(size_t)e * IN1 + 2 * S + j * twoV + c] = sv_dot3_rn(
          ve[c], z[j], ve[twoV + c], z[3 + j], ve[2 * twoV + c], z[6 + j]);
    }
    __syncthreads();
    if (binary) {
      for (int i = tid; i < R3_E * IN1; i += nth)
        X[i] = sv_sign(X[i] + beta[i % IN1]);
      __syncthreads();
    }
    // scalar path: linear1 (+-1 products are exact in f32) + BN + leaky
    sv_block_gemm<4, 4>(X, IN1, R3_E, w1, IN1, S_out,
                        [&](int e, int o, float h) {
                          Y[(size_t)e * S_out + o] = sv_leaky(h * a1[o] + b1[o]);
                        });
    // vector path: linear2 * scale2 + VectorBN, summed over the chunk
    for (int i = tid; i < R3_TP * V_out; i += nth) {
      const int t = i / V_out, o = i % V_out;
      for (int g = 0; g < R3_G; ++g) {
        const int e = t * R3_G + g;
        if (rows[e] < 0) continue;
        float wl[3];
        for (int i3 = 0; i3 < 3; ++i3) {
          const float* ve = VE + ((size_t)e * 3 + i3) * twoV;
          float acc = 0.f;
          for (int c = 0; c < twoV; ++c) acc += ve[c] * w2[c * V_out + o];
          wl[i3] = acc * scale2[o];
        }
        const float nrm = sqrtf(wl[0] * wl[0] + wl[1] * wl[1] + wl[2] * wl[2]) + SV_EPS;
        const float f = a2[o] + b2[o] / nrm;
        for (int i3 = 0; i3 < 3; ++i3)
          vacc[((size_t)t * 3 + i3) * V_out + o] += wl[i3] * f;
      }
    }
    __syncthreads();
    for (int i = tid; i < R3_TP * S_out; i += nth) {
      const int t = i / S_out, o = i % S_out;
      float m = sacc[i];
      for (int g = 0; g < R3_G; ++g) {
        const int e = t * R3_G + g;
        if (rows[e] >= 0) m = fmaxf(m, Y[(size_t)e * S_out + o]);
      }
      sacc[i] = m;
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
    for (int i = tid; i < R3_TP * S_out; i += nth) {
      const int t = i / S_out, o = i % S_out, n = n0 + t;
      if (n < N) s_out[((size_t)b * N + n) * S_out + o] = sacc[i];
    }
    for (int i = tid; i < R3_TP * 3 * V_out; i += nth) {
      const int t = i / (3 * V_out), q = i % (3 * V_out), n = n0 + t;
      if (n < N) v_out[((size_t)b * N + n) * 3 * V_out + q] = vmean(t, q);
    }
  } else {
    for (int i = tid; i < R3_TP * S_out; i += nth) {
      const int o = i / R3_TP, t = i % R3_TP, n = n0 + t;
      if (n < N) s_out[((size_t)b * S_out + o) * N + n] = sacc[t * S_out + o];
    }
    for (int i = tid; i < R3_TP * 3 * V_out; i += nth) {
      const int q = i / R3_TP, t = i % R3_TP, n = n0 + t;  // q = i3*V_out + o
      if (n < N) v_out[((size_t)b * 3 * V_out + q) * N + n] = vmean(t, q);
    }
  }
  if constexpr (!GATED)
    for (int i = tid; i < R3_TP * 2 * S; i += nth) {
      const int ch = i / R3_TP, t = i % R3_TP, n = n0 + t;
      if (n < N) ssum[((size_t)b * 2 * S + ch) * N + n] = sesum[t * 2 * S + ch];
    }
}

// The block kernel on the caller's neighbour ids (GATED: v gated, no
// statistics).
template <bool ROW, bool GATED>
static int sv_conv_block(const float* src, const int* wins, const float* gate,
                         const float* wz, const float* w1, const float* beta,
                         const float* a1, const float* b1, const float* w2,
                         const float* scale2, const float* a2, const float* b2,
                         float* s_out, float* v_out, float* ssum, int B, int N,
                         int S, int V, int S_out, int V_out, int k, int binary,
                         cudaStream_t st) {
  const R3Smem L = r3_layout(S, V, S_out, V_out, /*stats=*/!GATED);
  if (L.total > SV_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sv_round_block_kernel<ROW, GATED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + R3_TP - 1) / R3_TP, B);
  sv_round_block_kernel<ROW, GATED><<<grid, R3_THREADS, L.total, st>>>(
      src, wins, gate, wz, w1, beta, a1, b1, w2, scale2, a2, b2, s_out, v_out,
      ssum, L, N, S, V, S_out, V_out, k, binary);
  return (int)cudaGetLastError();
}

// Selection over the joint features, then the block kernel.
template <bool ROW>
static int sv_conv_round(const float* src, float* aa, const float* wz,
                         const float* w1, const float* beta, const float* a1,
                         const float* b1, const float* w2, const float* scale2,
                         const float* a2, const float* b2, float* s_out,
                         float* v_out, float* ssum, int* wins, int B, int N,
                         int S, int V, int S_out, int V_out, int k, int binary,
                         cudaStream_t st) {
  if (r3_layout(S, V, S_out, V_out).total > SV_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = sv_knn_select(src, aa, wins, B, N, S + 3 * V, k, st,
                                  /*point_major=*/ROW, /*row_major=*/ROW);
  if (err != cudaSuccess) return (int)err;
  return sv_conv_block<ROW, false>(src, wins, nullptr, wz, w1, beta, a1, b1,
                                   w2, scale2, a2, b2, s_out, v_out, ssum, B,
                                   N, S, V, S_out, V_out, k, binary, st);
}

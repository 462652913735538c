// One SV-DGCNN conv round, exact mode, on Hopper.
//
// Replaces svnet_tpu/ops/pallas/sv_round3.py::sv_round3 (kernel
// _round3_kernel, selection _select_rows / _build_key_t): kNN over the
// joint [s | v] features (sortable-int key, min-row tie-break), neighbour
// gather, the SVBlock (Vector2Scalar quadratic invariant, sign(x + beta)
// +-1 or FP linear1, h*a1 + b1, leaky; linear2*scale2 + VectorBN
// f = a2 + b2/(|.| + EPS)), svpool (max; sum * (1/k)) and the per-block
// sums of the edge scalars for the SE gate.
//
// What bounds it on the H100: at the cls shapes (C = 62..127, N = 1024,
// k = 20) the distance pass is B*N*N*C multiply-adds and linear1 is
// B*N*k*(2S+6V)*S_out, both in f32 on the CUDA cores (the distance is
// rounded op by op, no FMA, so that self-distances are exactly 0). The
// selection kernel (sv_common.cuh) reuses each candidate column for
// SEL_TPW centres and keeps its keys in shared memory. The block kernel
// stages R3_TP centres x R3_G ranks of edge features in shared memory --
// the gather reads neighbour rows straight from device memory, where the
// TPU needed one-hot int8 matmuls over byte planes -- and runs linear1 as
// a register-tiled block GEMM over them, so each weight load serves four
// edges. Pooled maxima and sums stay in shared memory across rank chunks;
// nothing of shape (B, N, k, C) reaches device memory. The gate
// statistics leave as per-point sums over the ranks, reduced over N
// outside (no float atomics: run-independent).
#include "sv_common.cuh"

#define R3_TP 16  // centre points per block
#define R3_G 2    // neighbour ranks per chunk
#define R3_E (R3_TP * R3_G)
#define R3_THREADS 256

struct R3Smem {
  size_t ctr, X, VE, Z, Y, sacc, vacc, sesum, rows, total;
};

static R3Smem r3_layout(int S, int V, int S_out, int V_out) {
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
  L.sesum = take((size_t)R3_TP * (2 * S > 0 ? 2 * S : 1));
  L.rows = take(R3_E);
  L.total = o;
  return L;
}

static __global__ void __launch_bounds__(R3_THREADS)
sv_round3_block_kernel(
    const float* __restrict__ src, const int* __restrict__ wins,
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

  for (int i = tid; i < R3_TP * C; i += nth) {
    const int t = i / C, c = i % C, n = n0 + t;
    ctr[i] = n < N ? x[(size_t)c * N + n] : 0.f;
  }
  for (int i = tid; i < R3_TP * S_out; i += nth) sacc[i] = -INFINITY;
  for (int i = tid; i < R3_TP * 3 * V_out; i += nth) vacc[i] = 0.f;
  for (int i = tid; i < R3_TP * 2 * S; i += nth) sesum[i] = 0.f;

  for (int r0 = 0; r0 < k; r0 += R3_G) {
    for (int e = tid; e < R3_E; e += nth) {
      const int n = n0 + e / R3_G, r = r0 + e % R3_G;
      rows[e] = (n < N && r < k) ? wins[((size_t)b * k + r) * N + n] : -1;
    }
    __syncthreads();
    // gather: raw edge scalars into X[:, :2S], vectors into VE
    for (int i = tid; i < R3_E * C; i += nth) {
      const int e = i / C, c = i % C, row = rows[e];
      const float cv = ctr[(e / R3_G) * C + c];
      const float d = (row >= 0 ? x[(size_t)c * N + row] : cv) - cv;
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
  for (int i = tid; i < R3_TP * S_out; i += nth) {
    const int o = i / R3_TP, t = i % R3_TP, n = n0 + t;
    if (n < N) s_out[((size_t)b * S_out + o) * N + n] = sacc[t * S_out + o];
  }
  for (int i = tid; i < R3_TP * 3 * V_out; i += nth) {
    const int q = i / R3_TP, t = i % R3_TP, n = n0 + t;  // q = i3*V_out + o
    if (n < N)
      v_out[((size_t)b * 3 * V_out + q) * N + n] =
          vacc[(size_t)t * 3 * V_out + q] * inv_k;
  }
  for (int i = tid; i < R3_TP * 2 * S; i += nth) {
    const int ch = i / R3_TP, t = i % R3_TP, n = n0 + t;
    if (n < N) ssum[((size_t)b * 2 * S + ch) * N + n] = sesum[t * 2 * S + ch];
  }
}

// src (B, S+3V, N) channel-major [s | v i-major]; aa (B, N) scratch;
// folded weights in the JAX fold's orientation (wz (2V, 3), w1 (2S+6V,
// S_out), w2 (2V, V_out), per-channel vectors); outputs s_out (B, S_out,
// N), v_out (B, 3V_out, N) ungated, ssum (B, 2S, N) per-point sums of
// the edge scalars over the ranks, wins (B, k, N).
extern "C" int sv_round3_launch(
    const float* src, float* aa, const float* wz, const float* w1,
    const float* beta, const float* a1, const float* b1, const float* w2,
    const float* scale2, const float* a2, const float* b2, float* s_out,
    float* v_out, float* ssum, int* wins, int B, int N, int S, int V,
    int S_out, int V_out, int k, int binary, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const R3Smem L = r3_layout(S, V, S_out, V_out);
  if (L.total > SV_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = sv_knn_select(src, aa, wins, B, N, S + 3 * V, k, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sv_round3_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + R3_TP - 1) / R3_TP, B);
  sv_round3_block_kernel<<<grid, R3_THREADS, L.total, st>>>(
      src, wins, wz, w1, beta, a1, b1, w2, scale2, a2, b2, s_out, v_out,
      ssum, L, N, S, V, S_out, V_out, k, binary);
  return (int)cudaGetLastError();
}

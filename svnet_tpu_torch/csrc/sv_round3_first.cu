// First SV-DGCNN / SV-PointNet round, exact mode, on Hopper.
//
// Replaces svnet_tpu/ops/pallas/sv_round3.py::sv_round3_first (kernel
// _round3_first_kernel): xyz kNN (sortable-int key, min-row tie-break),
// edges [nbr - ctr, ctr] (DGCNN) or, with cross, [nbr - ctr, ctr,
// nbr x ctr] (SV-PointNet), init Vector2Scalar (wz0) and conv1's /
// conv_pos's Vector2Scalar (wz1), FP linear1 + folded BN + leaky 0.2 -> max
// over k, linear2 + VectorBN -> mean over k, and the init-scalar sums the
// gate reads. The block kernel is a template on the edge channel count
// (2 or 3); the cross product is two rounded products and one subtraction
// per component, like the plain version.
//
// What bounds it on the H100: the selection. With C = 3 every edge costs a
// few hundred FLOPs, while each centre scans all N candidates k times on
// the TPU. Here one warp selects for several centres from keys held in
// shared memory and only the lane that owned a winner rescans, so a rank
// costs one warp max instead of an N-wide pass. The TPU's one-hot int8
// gather and byte planes are gone: a thread reads its neighbours' three
// coordinates directly. The block math is one thread per centre, all of it
// in registers. The gate statistics leave as per-point sums over the
// ranks, reduced over N outside (no float atomics: run-independent).
#include "sv_common.cuh"

#define F_S_OUT 32
#define F_V_OUT 10
#define F_THREADS 128

template <int NCH>
static __global__ void __launch_bounds__(F_THREADS)
sv_round3_first_block_kernel(
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

  float ctr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ctr[i] = valid ? x[(size_t)i * N + n] : 0.f;
  float sacc[F_S_OUT], vacc[3][F_V_OUT], ss[NSS];
#pragma unroll
  for (int o = 0; o < F_S_OUT; ++o) sacc[o] = -INFINITY;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int o = 0; o < F_V_OUT; ++o) vacc[i][o] = 0.f;
#pragma unroll
  for (int j = 0; j < NSS; ++j) ss[j] = 0.f;

  for (int r = 0; valid && r < k; ++r) {
    const int row = wins[((size_t)b * k + r) * N + n];
    float nb[3], ve[3][NCH];  // per component i: [nbr - ctr, ctr(, cross)]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nb[i] = x[(size_t)i * N + row];
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
    for (int o = 0; o < F_V_OUT; ++o) {
      float wl[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float acc = ve[i][0] * w2[o];
#pragma unroll
        for (int c = 1; c < NCH; ++c) acc += ve[i][c] * w2[c * F_V_OUT + o];
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
      s_out[((size_t)b * F_S_OUT + o) * N + n] = sacc[o];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int o = 0; o < F_V_OUT; ++o)
        v_out[((size_t)b * 3 * F_V_OUT + i * F_V_OUT + o) * N + n] =
            vacc[i][o] * inv_k;
#pragma unroll
    for (int j = 0; j < NSS; ++j) ssum[((size_t)b * NSS + j) * N + n] = ss[j];
  }
}

// pts (B, 3, N) channel-major; aa (B, N) scratch; wins (B, k, N) out;
// s_out (B, 32, N), v_out (B, 30, N) ungated, ssum (B, 3*n_ch, N) per-point
// sums over the ranks of the init scalars, j-major (j*n_ch + c); n_ch is 3
// with cross, else 2 (wz0, wz1 (n_ch, 3), w1 (6*n_ch, 32), w2 (n_ch, 10)).
extern "C" int sv_round3_first_launch(
    const float* pts, float* aa, const float* wz0, const float* wz1,
    const float* w1, const float* a1, const float* b1, const float* w2,
    const float* a2, const float* b2, float* s_out, float* v_out,
    float* ssum, int* wins, int B, int N, int k, int S_out, int V_out,
    int cross, void* stream) {
  if (S_out != F_S_OUT || V_out != F_V_OUT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = sv_knn_select(pts, aa, wins, B, N, 3, k, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + F_THREADS - 1) / F_THREADS, B);
  if (cross)
    sv_round3_first_block_kernel<3><<<grid, F_THREADS, 0, st>>>(
        pts, wins, wz0, wz1, w1, a1, b1, w2, a2, b2, s_out, v_out, ssum, N, k);
  else
    sv_round3_first_block_kernel<2><<<grid, F_THREADS, 0, st>>>(
        pts, wins, wz0, wz1, w1, a1, b1, w2, a2, b2, s_out, v_out, ssum, N, k);
  return (int)cudaGetLastError();
}

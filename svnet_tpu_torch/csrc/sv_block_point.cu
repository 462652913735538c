// Per-point gated SVBlock on Hopper, row-major, no edges and no pooling:
// kernel B8.
//
// Replaces svnet_tpu/ops/pallas/sv_block_point.py::sv_block_point (kernel
// _block_point_kernel): per point, the frame z_i = v_i . wz, the j-major
// invariants sv_j = v_0 z_0j + v_1 z_1j + v_2 z_2j, linear1 over [s | sv]
// (sign(x + beta) +-1 by +-1 when binary, f32 otherwise) + folded BN +
// leaky 0.2, and linear2 * scale2 + VectorBN times the caller's gate.
//
// What bounds it on the H100: linear1, (S + 3V) x S_out products per point
// (2044 x 512 at the SV-PointNet classifier's conv_fuse, 137 G a request of
// 128 x 1024 points), then linear2's 3V x V_out (22.7 G). Binary mode runs
// the tile routine of sv_point_tile.cuh: 128 points a tile where S_out <=
// 256, 64 where S_out <= 512, else 32; linear1 on the tensor cores as an
// int8 K-loop over W1's signs packed once per weight set
// (sv_pack_signs_launch), linear2 as register-tiled fma over +-1 weights
// in channel order (exact). FP mode keeps the f32 kernel below, whose
// linear1 must stay an ordered f32 sum on the CUDA cores (TF32 or bf16
// would round its inputs): a block stages P points' inputs in shared
// memory and runs linear1 and linear2 as register-tiled block GEMMs
// (sv_block_gemm), so each weight value read from L1/L2 serves four
// points. P is 16, halved until the block's buffers fit the shared memory
// limit (8 at conv_fuse); the ragged last block of each cloud masks its
// missing points.
#include "sv_common.cuh"
#include "sv_point_tile.cuh"

#define BP_THREADS 256
#define BP_MAX_P 16

struct BpSmem {
  size_t X, VV, Z, WL, total;
  int P;
};

static BpSmem bp_layout(int P, int S, int V, int V_out) {
  BpSmem L;
  size_t o = 0;
  auto take = [&o](size_t n) { size_t at = o; o += sv_align16(n * 4); return at; };
  L.X = take((size_t)P * (S + 3 * V));
  L.VV = take((size_t)P * 3 * V);
  L.Z = take((size_t)P * 9);
  L.WL = take((size_t)P * 3 * V_out);
  L.total = o;
  L.P = P;
  return L;
}

// The largest P <= BP_MAX_P (a power of two) whose buffers fit; P = 0 when
// not even one point does.
static BpSmem bp_pick(int S, int V, int V_out) {
  for (int P = BP_MAX_P; P >= 1; P /= 2) {
    const BpSmem L = bp_layout(P, S, V, V_out);
    if (L.total <= SV_SMEM_LIMIT) return L;
  }
  BpSmem none = bp_layout(1, S, V, V_out);
  none.P = 0;
  return none;
}

static __global__ void __launch_bounds__(BP_THREADS)
sv_block_point_kernel(
    const float* __restrict__ src, const float* __restrict__ gate,
    const float* __restrict__ wz, const float* __restrict__ w1,
    const float* __restrict__ a1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ scale2, const float* __restrict__ a2,
    const float* __restrict__ b2, float* __restrict__ s_out,
    float* __restrict__ v_out, BpSmem L, int N, int S, int V, int S_out,
    int V_out) {
  extern __shared__ __align__(16) unsigned char sv_smem[];
  float* X = (float*)(sv_smem + L.X);    // (P, S+3V): [s | sv j-major]
  float* VV = (float*)(sv_smem + L.VV);  // (P*3, V): rows p*3 + i
  float* Z = (float*)(sv_smem + L.Z);    // (P, 3, 3)
  float* WL = (float*)(sv_smem + L.WL);  // (P*3, V_out): linear2 * scale2

  const int IN = S + 3 * V, V3 = 3 * V;
  const int b = blockIdx.y, n0 = blockIdx.x * L.P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int np = min(L.P, N - n0);  // points of this block (ragged tail)
  const size_t row0 = (size_t)b * N + n0;
  const float* x = src + row0 * IN;

  for (int i = tid; i < np * IN; i += nth) {
    const int p = i / IN, ch = i % IN;
    const float val = x[i];
    if (ch < S)
      X[(size_t)p * IN + ch] = val;
    else
      VV[(size_t)p * V3 + ch - S] = val;  // (p*3 + i3)*V + c
  }
  __syncthreads();
  for (int i = tid; i < np * 9; i += nth) {
    const int p = i / 9, i3 = (i % 9) / 3, j = i % 3;
    const float* v = VV + ((size_t)p * 3 + i3) * V;
    float z = 0.f;
    for (int c = 0; c < V; ++c) z = __fadd_rn(z, __fmul_rn(v[c], wz[c * 3 + j]));
    Z[i] = z;
  }
  __syncthreads();
  for (int i = tid; i < np * V3; i += nth) {
    const int p = i / V3, j = (i % V3) / V, c = i % V;
    const float* v = VV + (size_t)p * V3;
    const float* z = Z + p * 9;
    X[(size_t)p * IN + S + j * V + c] =
        sv_dot3_rn(v[c], z[j], v[V + c], z[3 + j], v[2 * V + c], z[6 + j]);
  }
  __syncthreads();
  float* so = s_out + row0 * S_out;
  sv_block_gemm<4, 4>(X, IN, np, w1, IN, S_out, [&](int p, int o, float h) {
    so[(size_t)p * S_out + o] = sv_leaky(h * a1[o] + b1[o]);
  });
  sv_block_gemm<4, 4>(VV, V, 3 * np, w2, V, V_out, [&](int e, int o, float h) {
    WL[(size_t)e * V_out + o] = h * scale2[o];
  });
  __syncthreads();
  // VectorBN times the gate, written i-major: v_out[n, i*V_out + o]
  float* vo = v_out + row0 * 3 * V_out;
  for (int i = tid; i < np * V_out; i += nth) {
    const int p = i / V_out, o = i % V_out;
    const float* w = WL + (size_t)p * 3 * V_out + o;
    const float nrm = sqrtf(w[0] * w[0] + w[V_out] * w[V_out] +
                            w[2 * V_out] * w[2 * V_out]) + SV_EPS;
    const float f = (a2[o] + b2[o] / nrm) * gate[(size_t)b * V_out + o];
    float* out = vo + (size_t)p * 3 * V_out + o;
    out[0] = w[0] * f;
    out[V_out] = w[V_out] * f;
    out[2 * V_out] = w[2 * V_out] * f;
  }
}

// Points per block at these widths and mode (0: the widths do not fit).
extern "C" int sv_block_point_ppb(int S, int V, int S_out, int V_out, int binary) {
  if (binary) {
    PtLayout L;
    return pt_pick(L, S, V, S_out, V_out, false) ? L.P : 0;
  }
  return bp_pick(S, V, V_out).P;
}

// Bytes of W1's packed signs (K = S + 3V rows of w1, S_out columns).
extern "C" int sv_pack_bytes(int K, int S_out) { return pt_spad(S_out) * pt_pad32(K); }

// out (sv_pack_bytes) = W1's signs as the tile routine reads them, from
// the folded w1 (K, S_out); run once per weight set.
extern "C" int sv_pack_signs_launch(const float* w1, int8_t* out, int K, int S_out,
                                    void* stream) {
  if (K < 1 || S_out < 1) return (int)cudaErrorInvalidValue;
  const int Kp = pt_pad32(K), rows = pt_spad(S_out);
  const long long n = (long long)rows * Kp;
  pt_pack_signs_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      w1, out, K, S_out, Kp, rows);
  return (int)cudaGetLastError();
}

// src (B, N, S+3V) row-major, vectors i-major; gate (B, V_out); folded
// weights as fold_point_like_params gives them (wz (V, 3), w1 (S+3V, S_out)
// rows [s | sv j-major], w2 (V, V_out), (1, C) affines; binary: w1 and w2
// signs, w1s their packed copy, else w1s unused); outputs s_out
// (B, N, S_out) and v_out (B, N, 3*V_out) gated, i-major.
extern "C" int sv_block_point_launch(
    const float* src, const float* gate, const float* wz, const float* w1,
    const int8_t* w1s, const float* beta, const float* a1, const float* b1,
    const float* w2, const float* scale2, const float* a2, const float* b2,
    float* s_out, float* v_out, int B, int N, int S, int V, int S_out,
    int V_out, int binary, void* stream) {
  if (binary)
    return sv_point_tile<true, false>(src, gate, nullptr, wz, w1s, beta, a1, b1, w2,
                                      scale2, a2, b2, nullptr, s_out, v_out, nullptr,
                                      nullptr, B, N, S, V, S_out, V_out,
                                      (cudaStream_t)stream);
  const BpSmem L = bp_pick(S, V, V_out);
  if (L.P == 0 || B < 1 || B > 65535 || N < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sv_block_point_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + L.P - 1) / L.P, B);
  sv_block_point_kernel<<<grid, BP_THREADS, L.total, (cudaStream_t)stream>>>(
      src, gate, wz, w1, a1, b1, w2, scale2, a2, b2, s_out, v_out, L, N, S,
      V, S_out, V_out);
  return (int)cudaGetLastError();
}

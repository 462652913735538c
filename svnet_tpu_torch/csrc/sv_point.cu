// Per-point tail of SV-DGCNN on Hopper: the gated conv5 SVBlock and the
// SVFuse read-out, channel-major (B3) or row-major (B3r).
//
// Replaces svnet_tpu/ops/pallas/sv_point.py::sv_point_block_cm (kernel
// _point_kernel_cm) and, with ROW, ::sv_point_block (_point_kernel, the
// legacy row-major trunks' tail): Vector2Scalar on the trunk's per-round
// j-major vector blocks (read through a row map, the v_off contract),
// sign(x + beta) +-1 or FP linear1 + BN + leaky, linear2*scale2 +
// VectorBN times the gate, and SVFuse's invariants emitted j-major, plus
// per-16-point-group partial maxima of the scalars and sums of the
// vectors.
//
// What bounds it on the H100: linear1, (S + 3V) x S_out = 505 x 512
// products per point (34 G at B = 128, N = 1024), then the bytes (x is
// 1,022 channels a point). Binary mode runs the tile routine of
// sv_point_tile.cuh with its FUSE epilogue (64 points a tile at the
// SV-DGCNN widths, S_out = 512; pt_pick): linear1 on the tensor cores as
// an int8 K-loop over W1's signs packed once per weight set, linear2 as
// register-tiled fma over +-1 weights in channel order, the scalars' x
// rows and 16-point maxima straight from the accumulators, SVFuse and the
// vector sums from the tile of gated vectors in shared memory. FP mode
// keeps the f32 kernel below (linear1 must stay an ordered f32 sum on the
// CUDA cores): a block stages PF_P points' inputs in shared memory and
// runs linear1 and linear2 as register-tiled block GEMMs. Channel-major
// outputs are written with consecutive threads on consecutive points;
// row-major ones (ROW) along a point's row. Both layouts do the same
// arithmetic, bit for bit.
#include "sv_common.cuh"
#include "sv_point_tile.cuh"

#define PF_P 16  // points per block
#define PF_THREADS 256

struct PfSmem {
  size_t X, VV, Z, WL, ZF, Y, total;
};

static PfSmem pf_layout(int S, int V, int S_out, int V_out) {
  PfSmem L;
  size_t o = 0;
  auto take = [&o](size_t n) { size_t at = o; o += sv_align16(n * 4); return at; };
  L.X = take((size_t)PF_P * (S + 3 * V));
  L.VV = take((size_t)PF_P * 3 * V);
  L.Z = take((size_t)PF_P * 9);
  L.WL = take((size_t)PF_P * 3 * V_out);
  L.ZF = take((size_t)PF_P * 9);
  L.Y = take((size_t)PF_P * S_out);
  L.total = o;
  return L;
}

template <bool ROW>
static __global__ void __launch_bounds__(PF_THREADS)
sv_point_kernel(
    const float* __restrict__ src, const float* __restrict__ gate,
    const int* __restrict__ vrow, const float* __restrict__ wz,
    const float* __restrict__ w1,
    const float* __restrict__ a1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ scale2,
    const float* __restrict__ a2, const float* __restrict__ b2,
    const float* __restrict__ wzf, float* __restrict__ x_out,
    float* __restrict__ smax, float* __restrict__ vsum, PfSmem L, int N,
    int S, int V, int S_out, int V_out) {
  extern __shared__ __align__(16) unsigned char sv_smem[];
  float* X = (float*)(sv_smem + L.X);    // (P, S+3V): [s | sv j-major]
  float* VV = (float*)(sv_smem + L.VV);  // (P*3, V): rows p*3 + i
  float* Z = (float*)(sv_smem + L.Z);    // (P, 3, 3)
  float* WL = (float*)(sv_smem + L.WL);  // (P*3, V_out): linear2, then v5
  float* ZF = (float*)(sv_smem + L.ZF);  // (P, 3, 3)
  float* Y = (float*)(sv_smem + L.Y);    // (P, S_out)

  const int IN = S + 3 * V, Cin = S + 3 * V, Cout = S_out + 3 * V_out;
  const int b = blockIdx.y, n0 = blockIdx.x * PF_P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int np = min(PF_P, N - n0);
  const float* x = src + (size_t)b * Cin * N;

  if constexpr (ROW) {  // [s | v i-major] rows of Cin channels
    for (int i = tid; i < PF_P * S; i += nth) {
      const int p = i / S, ch = i % S;
      X[(size_t)p * IN + ch] = p < np ? x[(size_t)(n0 + p) * Cin + ch] : 0.f;
    }
    for (int i = tid; i < PF_P * 3 * V; i += nth) {
      const int p = i / (3 * V), q = i % (3 * V);  // q = i3*V + c
      VV[(size_t)p * 3 * V + q] =
          p < np ? x[(size_t)(n0 + p) * Cin + S + q] : 0.f;
    }
  } else {
    for (int i = tid; i < PF_P * S; i += nth) {
      const int ch = i / PF_P, p = i % PF_P;
      X[(size_t)p * IN + ch] = p < np ? x[(size_t)ch * N + n0 + p] : 0.f;
    }
    for (int i = tid; i < PF_P * 3 * V; i += nth) {
      const int q = i / PF_P, p = i % PF_P;  // q = i3*V + c
      const int i3 = q / V, c = q % V;
      VV[((size_t)p * 3 + i3) * V + c] =
          p < np ? x[(size_t)vrow[q] * N + n0 + p] : 0.f;
    }
  }
  __syncthreads();
  for (int i = tid; i < PF_P * 9; i += nth) {
    const int p = i / 9, i3 = (i % 9) / 3, j = i % 3;
    const float* v = VV + ((size_t)p * 3 + i3) * V;
    float z = 0.f;
    for (int c = 0; c < V; ++c) z = __fadd_rn(z, __fmul_rn(v[c], wz[c * 3 + j]));
    Z[i] = z;
  }
  __syncthreads();
  for (int i = tid; i < PF_P * 3 * V; i += nth) {
    const int p = i / (3 * V), j = (i % (3 * V)) / V, c = i % V;
    const float* v = VV + (size_t)p * 3 * V;
    const float* z = Z + p * 9;
    X[(size_t)p * IN + S + j * V + c] =
        sv_dot3_rn(v[c], z[j], v[V + c], z[3 + j], v[2 * V + c], z[6 + j]);
  }
  __syncthreads();
  sv_block_gemm<4, 4>(X, IN, PF_P, w1, IN, S_out, [&](int p, int o, float h) {
    Y[(size_t)p * S_out + o] = sv_leaky(h * a1[o] + b1[o]);
  });
  sv_block_gemm<4, 4>(VV, V, 3 * PF_P, w2, V, V_out, [&](int e, int o, float h) {
    WL[(size_t)e * V_out + o] = h * scale2[o];
  });
  __syncthreads();
  // VectorBN times the gate, in place: WL becomes v5
  for (int i = tid; i < PF_P * V_out; i += nth) {
    const int p = i / V_out, o = i % V_out;
    float* w = WL + (size_t)p * 3 * V_out + o;
    const float nrm = sqrtf(w[0] * w[0] + w[V_out] * w[V_out] +
                            w[2 * V_out] * w[2 * V_out]) + SV_EPS;
    const float f = (a2[o] + b2[o] / nrm) * gate[(size_t)b * V_out + o];
    w[0] *= f;
    w[V_out] *= f;
    w[2 * V_out] *= f;
  }
  __syncthreads();
  for (int i = tid; i < PF_P * 9; i += nth) {
    const int p = i / 9, i3 = (i % 9) / 3, j = i % 3;
    const float* v = WL + ((size_t)p * 3 + i3) * V_out;
    float z = 0.f;
    for (int o = 0; o < V_out; ++o) z += v[o] * wzf[o * 3 + j];
    ZF[i] = z;
  }
  __syncthreads();

  // x column ch of block point p
  float* xo = x_out + (size_t)b * Cout * N + (ROW ? (size_t)n0 * Cout : n0);
  auto xat = [&](int p, int ch) -> float& {
    return ROW ? xo[(size_t)p * Cout + ch] : xo[(size_t)ch * N + p];
  };
  for (int i = tid; i < PF_P * S_out; i += nth) {
    const int o = ROW ? i % S_out : i / PF_P, p = ROW ? i / S_out : i % PF_P;
    if (p < np) xat(p, o) = Y[(size_t)p * S_out + o];
  }
  for (int i = tid; i < PF_P * 3 * V_out; i += nth) {
    // q = j*V_out + o
    const int q = ROW ? i % (3 * V_out) : i / PF_P;
    const int p = ROW ? i / (3 * V_out) : i % PF_P;
    const int j = q / V_out, o = q % V_out;
    if (p >= np) continue;
    const float* v = WL + (size_t)p * 3 * V_out;
    const float* z = ZF + p * 9;
    xat(p, S_out + q) =
        v[o] * z[j] + v[V_out + o] * z[3 + j] + v[2 * V_out + o] * z[6 + j];
  }
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;
  for (int o = tid; o < S_out; o += nth) {
    float m = -INFINITY;
    for (int p = 0; p < np; ++p) m = fmaxf(m, Y[(size_t)p * S_out + o]);
    smax[blk * S_out + o] = m;
  }
  for (int q = tid; q < 3 * V_out; q += nth) {  // q = i3*V_out + o
    const int i3 = q / V_out, o = q % V_out;
    float s = 0.f;
    for (int p = 0; p < np; ++p) s += WL[((size_t)p * 3 + i3) * V_out + o];
    vsum[blk * 3 * V_out + q] = s;
  }
}

template <bool ROW>
static int sv_point(const float* src, const float* gate, const int* vrow,
                    const float* wz, const float* w1, const int8_t* w1s,
                    const float* beta, const float* a1, const float* b1,
                    const float* w2, const float* scale2, const float* a2,
                    const float* b2, const float* wzf, float* x_out, float* smax,
                    float* vsum, int B, int N, int S, int V, int S_out,
                    int V_out, int binary, void* stream) {
  if (binary)
    return sv_point_tile<ROW, true>(src, gate, vrow, wz, w1s, beta, a1, b1, w2, scale2,
                                    a2, b2, wzf, x_out, nullptr, smax, vsum, B, N, S, V,
                                    S_out, V_out, (cudaStream_t)stream);
  const PfSmem L = pf_layout(S, V, S_out, V_out);
  if (L.total > SV_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sv_point_kernel<ROW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + PF_P - 1) / PF_P, B);
  sv_point_kernel<ROW><<<grid, PF_THREADS, L.total, (cudaStream_t)stream>>>(
      src, gate, vrow, wz, w1, a1, b1, w2, scale2, a2, b2, wzf, x_out,
      smax, vsum, L, N, S, V, S_out, V_out);
  return (int)cudaGetLastError();
}

// src (B, S+3V, N) channel-major; gate (B, V_out); vrow (3V,) int32: the
// src row of vector component i, reference channel c at vrow[i*V + c];
// folded weights as the JAX fold gives them (wz (V, 3), w1 (S+3V, S_out),
// w2 (V, V_out), wzf (V_out, 3); binary: w1 and w2 signs, w1s the packed
// copy of sv_pack_signs_launch, else unused); outputs x_out (B, S_out+3V_out, N),
// smax (B, ceil(N/16), S_out), vsum (B, ceil(N/16), 3V_out).
extern "C" int sv_point_launch(
    const float* src, const float* gate, const int* vrow, const float* wz,
    const float* w1, const int8_t* w1s, const float* beta, const float* a1,
    const float* b1, const float* w2, const float* scale2, const float* a2,
    const float* b2, const float* wzf, float* x_out, float* smax, float* vsum,
    int B, int N, int S, int V, int S_out, int V_out, int binary, void* stream) {
  return sv_point<false>(src, gate, vrow, wz, w1, w1s, beta, a1, b1, w2, scale2,
                         a2, b2, wzf, x_out, smax, vsum, B, N, S, V, S_out,
                         V_out, binary, stream);
}

// Row-major: src (B, N, S+3V) [s | v flat i-major, column S + i*V + c];
// x_out (B, N, S_out+3V_out), SVFuse's columns j-major; the rest as
// sv_point_launch.
extern "C" int sv_point_rm_launch(
    const float* src, const float* gate, const float* wz, const float* w1,
    const int8_t* w1s, const float* beta, const float* a1, const float* b1,
    const float* w2, const float* scale2, const float* a2, const float* b2,
    const float* wzf, float* x_out, float* smax, float* vsum, int B, int N,
    int S, int V, int S_out, int V_out, int binary, void* stream) {
  return sv_point<true>(src, gate, nullptr, wz, w1, w1s, beta, a1, b1, w2, scale2,
                        a2, b2, wzf, x_out, smax, vsum, B, N, S, V, S_out,
                        V_out, binary, stream);
}

// The binary per-point SVBlock over a tile of points, shared by B8
// (sv_block_point.cu) and B3/B3r (sv_point.cu): no edges, no pooling over
// neighbours. Per point: the frame z_i = v_i . wz, the j-major invariants
// sv_j = v_0 z_0j + v_1 z_1j + v_2 z_2j, linear1 = sign([s | sv] + beta)
// by W1's signs + folded BN + leaky 0.2, linear2 = v . sign(W2) * scale2 +
// VectorBN times the caller's gate. FUSE adds B3's epilogue: SVFuse's
// frame and j-major invariants of the gated vectors, and per 16-point
// group the maxima of the scalars and sums of the vectors.
//
// What bounds it on the H100. linear1 is (S + 3V) x S_out products per
// point (2044 x 512 at the SV-PointNet classifier's conv_fuse, 137 G per
// request of 128 x 1024 points); linear2 is 3V x V_out adds of real inputs
// (22.7 G at conv_fuse) that must keep their channel order to stay
// bitwise. Every other stage is a few thousand operations a point.
//
// Design. A block of PT_THREADS threads owns a tile of P = 16 MT points
// (MT = 8 where S_out <= 256, 4 where S_out <= 512, else 2; pt_pick) and
// walks it in two phases over one shared-memory region:
//   vector phase  the tile's vectors stream through shared memory in
//                 chunks of PT_VC channels (cp.async, double-buffered,
//                 beside the matching rows of W2). A thread owns 4 points
//                 x PT_OG outputs x the 3 components and sums linear2 in
//                 channel order: W2 holds signs, so v * w is exact and one
//                 fma gives the bits of the plain version's product and
//                 add. 3P threads walk the frames' channel sums meanwhile.
//                 VectorBN and the gate run on the accumulators; the gated
//                 vectors land in a shared tile, leave coalesced (B8) or
//                 feed SVFuse and the vector sums (FUSE).
//   scalar phase  linear1's operand is built whole, as int8 signs of
//                 [s | sv] + beta (invariants from the frames), P x Cin
//                 bytes; W1's signs, packed once per weight set as int8
//                 rows o of Kp = pad32(Cin) bytes (sv_pack_signs_launch),
//                 stream through a ring of PT_NST stages of PT_KC = 32
//                 columns. Each warp owns every point of the tile x 8 ntw
//                 outputs and accumulates m16n8k32 int8 products in s32
//                 (sv_mma_s8; exact, so in any order); BN + leaky run on
//                 the accumulators, which leave straight to device memory
//                 (and, FUSE, fold into the 16-point maxima by shuffles).
// Ragged tiles: points past N read as zero and are never written; K and
// S_out are zero-padded in the packed weights and in the operand.
#pragma once

#include <stdint.h>

#include "sv_common.cuh"
#include "sv_mma.cuh"

#define PT_THREADS 512
#define PT_KC 32   // linear1 depth per ring stage: one m16n8k32 step
#define PT_NST 3   // ring stages
#define PT_VC 32   // vector channels per chunk of the vector phase
#define PT_OG 6    // linear2 outputs per thread (x 4 points x 3 components)
#define PT_U 8     // operand items a thread loads at once

static __host__ __device__ inline int pt_pad32(int n) { return (n + 31) & ~31; }

// n8 output tiles per warp of linear1 (16 warps side by side over S_out),
// even so that one ldmatrix serves two
static __host__ __device__ inline int pt_ntw(int S_out) {
  const int t = ((S_out + 7) / 8 + 15) / 16;
  return t < 2 ? 2 : (t + 1) & ~1;
}

// rows of the packed W1 (every warp's columns, zero past S_out)
static __host__ __device__ inline int pt_spad(int S_out) { return 128 * pt_ntw(S_out); }

struct PtLayout {
  int MT, P, Kp, lda, ntw, spad, ldv, ldw2, ldvo, items;
  size_t a, ring, vs, w2s, vo, z, wzs, zf, wzfs, total;
};

// The shared-memory layout of a tile of 16 MT points; false if its buffers
// or linear2's items (one a thread) do not fit. The vector phase (vs, w2s;
// then vo) and the scalar phase (a, ring) share one region.
static bool pt_layout(PtLayout& L, int MT, int S, int V, int S_out, int V_out,
                      bool fuse) {
  auto al = [](size_t n) { return (n + 127) & ~(size_t)127; };
  L.MT = MT;
  L.P = 16 * MT;
  L.Kp = pt_pad32(S + 3 * V);
  L.lda = L.Kp + 16;  // an odd multiple of 16 bytes: ldmatrix without conflicts
  L.ntw = pt_ntw(S_out);
  L.spad = pt_spad(S_out);
  L.ldv = 3 * L.P + 4;  // 4 mod 32: the transposing stage hits 32 banks
  const int og = (V_out + PT_OG - 1) / PT_OG;
  L.ldw2 = PT_OG * og;
  L.ldvo = (3 * V_out) | 1;  // odd: a warp down a column hits 32 banks
  L.items = (L.P / 4) * og;
  const size_t a = al((size_t)L.P * L.lda), ring = (size_t)PT_NST * L.spad * (PT_KC + 16);
  const size_t vs = al((size_t)2 * PT_VC * L.ldv * 4), w2s = al((size_t)2 * PT_VC * L.ldw2 * 4);
  const size_t vo = al((size_t)L.P * L.ldvo * 4);
  L.a = 0;
  L.ring = a;
  L.vs = 0;
  L.w2s = vs;
  L.vo = 0;
  size_t region = a + al(ring);
  if (vs + w2s > region) region = vs + w2s;
  if (vo > region) region = vo;
  L.z = region;
  L.wzs = L.z + al((size_t)L.P * 9 * 4);
  L.zf = L.wzs + al((size_t)V * 3 * 4);
  L.wzfs = L.zf + (fuse ? al((size_t)L.P * 9 * 4) : 0);
  L.total = L.wzfs + (fuse ? al((size_t)V_out * 3 * 4) : 0);
  return MT * L.ntw <= 16 && L.items <= PT_THREADS && L.total <= SV_SMEM_LIMIT;
}

// The largest tile whose accumulators and buffers fit: 128 points where
// S_out <= 256 (the narrow blocks, whose time is the tiles' latency), 64
// where S_out <= 512, else 32.
static bool pt_pick(PtLayout& L, int S, int V, int S_out, int V_out, bool fuse) {
  return pt_layout(L, 8, S, V, S_out, V_out, fuse) ||
         pt_layout(L, 4, S, V, S_out, V_out, fuse) ||
         pt_layout(L, 2, S, V, S_out, V_out, fuse);
}

static __device__ __forceinline__ void pt_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sv_smem_u32(dst)), "l"(src)
               : "memory");
}

static __device__ __forceinline__ int8_t pt_sign8(float x) {
  return (int8_t)((x > 0.f) - (x < 0.f));
}

// W1's signs as the tile routine reads them: out[o * Kp + k] = sign(w1[k,
// o]) for o < O, k < K (w1 (K, O) row-major, the folded sign weights),
// zero up to pt_spad(O) rows and Kp = pt_pad32(K) columns.
static __global__ void pt_pack_signs_kernel(const float* __restrict__ w1,
                                            int8_t* __restrict__ out, int K, int O,
                                            int Kp, int rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * Kp) return;
  const int o = (int)(i / Kp), k = (int)(i % Kp);
  out[i] = o < O && k < K ? pt_sign8(w1[(size_t)k * O + o]) : (int8_t)0;
}

// src: ROW (B, N, S+3V) rows [s | v i-major]; else (B, S+3V, N) with the
// vector rows through vrow (B3). Outputs: !FUSE (B8) s_out (B, N, S_out)
// and v_out (B, N, 3 V_out) gated, i-major; FUSE x_out in s_out's place,
// (B, S_out + 3 V_out, N) or ROW (B, N, ...), SVFuse's channels j-major,
// and smax / vsum (B, ceil(N/16), .) per 16-point group.
template <bool ROW, bool FUSE, int MT>
static __global__ void __launch_bounds__(PT_THREADS, 1)
sv_point_tile_kernel(
    const float* __restrict__ src, const float* __restrict__ gate,
    const int* __restrict__ vrow, const float* __restrict__ wz,
    const int8_t* __restrict__ w1s, const float* __restrict__ beta,
    const float* __restrict__ a1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ scale2,
    const float* __restrict__ a2, const float* __restrict__ b2,
    const float* __restrict__ wzf, float* __restrict__ s_out,
    float* __restrict__ v_out, float* __restrict__ smax,
    float* __restrict__ vsum, PtLayout L, int N, int S, int V, int S_out,
    int V_out) {
  constexpr int P = 16 * MT, NTW = 16 / MT;
  extern __shared__ __align__(16) unsigned char sv_smem[];
  int8_t* A = (int8_t*)(sv_smem + L.a);        // (P, lda) linear1's signs
  int8_t* ring = (int8_t*)(sv_smem + L.ring);  // (PT_NST, spad, PT_KC + 16) W1's signs
  float* VS = (float*)(sv_smem + L.vs);        // (2, PT_VC, ldv): [c][i*P + p]
  float* W2S = (float*)(sv_smem + L.w2s);      // (2, PT_VC, ldw2): rows of w2
  float* VO = (float*)(sv_smem + L.vo);        // (P, ldvo): gated [i*V_out + o]
  float* Zs = (float*)(sv_smem + L.z);         // (P, 3, 3) frames z_i[j]
  float* wzs = (float*)(sv_smem + L.wzs);      // (V, 3)
  float* ZF = (float*)(sv_smem + L.zf);        // (P, 3, 3) SVFuse's frames
  float* wzfs = (float*)(sv_smem + L.wzfs);    // (V_out, 3)

  const int Cin = S + 3 * V, V3o = 3 * V_out;
  const int b = blockIdx.y, n0 = blockIdx.x * P;
  const int tid = threadIdx.x, nth = PT_THREADS, lane = tid & 31, warp = tid >> 5;
  const int np = min(P, N - n0);  // points of this tile (ragged tail)
  const float* x = ROW ? src + ((size_t)b * N + n0) * Cin : src + (size_t)b * Cin * N + n0;
  // scalar c and vector component i, channel c of tile point p
  auto s_at = [&](int p, int c) { return ROW ? x[(size_t)p * Cin + c] : x[(size_t)c * N + p]; };
  auto v_ptr = [&](int p, int i, int c) {
    return ROW ? x + (size_t)p * Cin + S + i * V + c : x + (size_t)vrow[i * V + c] * N + p;
  };

  for (int i = tid; i < 3 * V; i += nth) wzs[i] = wz[i];
  if (FUSE)
    for (int i = tid; i < 3 * V_out; i += nth) wzfs[i] = wzf[i];

  // ---- vector phase: frames and linear2, the vectors in chunks ----------
  const int nch = (V + PT_VC - 1) / PT_VC, ldv = L.ldv, ldw2 = L.ldw2;
  auto stage = [&](int ch, int buf) {
    const int c0 = ch * PT_VC, nc = min(PT_VC, V - c0);
    float* vs = VS + (size_t)buf * PT_VC * ldv;
    if constexpr (ROW) {  // a warp reads 8 channels of 4 (i, p) rows
      const int ncp = (nc + 7) & ~7;
      for (int e = tid; e < 3 * P * ncp; e += nth) {
        const int cc = (e / (24 * P)) * 8 + (e & 7), t = (e >> 3) % (3 * P);
        const int i = t / P, p = t % P;
        if (cc < nc) sv_cp4(vs + cc * ldv + t, v_ptr(p < np ? p : 0, i, c0 + cc), p < np);
      }
    } else {  // consecutive threads on consecutive points
      for (int e = tid; e < 3 * P * nc; e += nth) {
        const int cc = e / (3 * P), t = e % (3 * P), i = t / P, p = t % P;
        sv_cp4(vs + cc * ldv + t, v_ptr(p < np ? p : 0, i, c0 + cc), p < np);
      }
    }
    float* ws = W2S + (size_t)buf * PT_VC * ldw2;
    for (int e = tid; e < nc * ldw2; e += nth) {
      const int cc = e / ldw2, o = e % ldw2;
      sv_cp4(ws + e, w2 + (size_t)(c0 + cc) * V_out + (o < V_out ? o : 0), o < V_out);
    }
  };
  // frames: thread nth-1-f owns (p, i) = (f % P, f / P) for f < 3P
  const int f = nth - 1 - tid, fp = f % P, fi = f / P;
  const int pg = tid % (P / 4), og = tid / (P / 4);  // linear2: points 4 pg.., outputs PT_OG og..
  const bool active = tid < L.items, frame = f < 3 * P;
  float vacc[4][3][PT_OG];  // linear2's sums
#pragma unroll
  for (int pp = 0; pp < 4; ++pp)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int jj = 0; jj < PT_OG; ++jj) vacc[pp][i][jj] = 0.f;
  float z0 = 0.f, z1 = 0.f, z2 = 0.f;
  stage(0, 0);
  sv_cp_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) stage(ch + 1, (ch + 1) & 1);
    sv_cp_commit();
    sv_cp_wait<1>();
    __syncthreads();
    const int c0 = ch * PT_VC, nc = min(PT_VC, V - c0);
    const float* vs = VS + (size_t)(ch & 1) * PT_VC * ldv;
    const float* ws = W2S + (size_t)(ch & 1) * PT_VC * ldw2;
    if (frame)  // z_i[j] = sum_c v_i[c] wz[c][j], channel by channel
      for (int c = 0; c < nc; ++c) {
        const float v = vs[c * ldv + fi * P + fp];
        const float* w = wzs + (c0 + c) * 3;
        z0 = __fadd_rn(z0, __fmul_rn(v, w[0]));
        z1 = __fadd_rn(z1, __fmul_rn(v, w[1]));
        z2 = __fadd_rn(z2, __fmul_rn(v, w[2]));
      }
    if (active)  // linear2: +-1 weights, so fma(v, w, acc) = acc + v * w exactly rounded
      for (int c = 0; c < nc; ++c) {
        float v[3][4], w[PT_OG];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float4 q = *(const float4*)(vs + c * ldv + i * P + 4 * pg);
          v[i][0] = q.x, v[i][1] = q.y, v[i][2] = q.z, v[i][3] = q.w;
        }
#pragma unroll
        for (int k = 0; k < PT_OG / 2; ++k) {
          const float2 q = *(const float2*)(ws + c * ldw2 + PT_OG * og + 2 * k);
          w[2 * k] = q.x, w[2 * k + 1] = q.y;
        }
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int jj = 0; jj < PT_OG; ++jj)
              vacc[pp][i][jj] = __fmaf_rn(v[i][pp], w[jj], vacc[pp][i][jj]);
      }
    __syncthreads();  // this buffer is refilled two chunks on
  }
  if (frame) {
    float* z = Zs + fp * 9 + fi * 3;
    z[0] = z0, z[1] = z1, z[2] = z2;
  }
  // linear2 * scale2, VectorBN and the gate into the tile of gated vectors
  if (active)
#pragma unroll
    for (int jj = 0; jj < PT_OG; ++jj) {
      const int o = PT_OG * og + jj, oc = min(o, V_out - 1);
      const float sc = scale2[oc], aa = a2[oc], bb = b2[oc], g = gate[(size_t)b * V_out + oc];
      if (o >= V_out) break;
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const float w0 = vacc[pp][0][jj] * sc, w1 = vacc[pp][1][jj] * sc,
                    w2v = vacc[pp][2][jj] * sc;
        const float nrm = sqrtf(w0 * w0 + w1 * w1 + w2v * w2v) + SV_EPS;
        const float fac = (aa + bb / nrm) * g;
        float* out = VO + (4 * pg + pp) * L.ldvo + o;
        out[0] = w0 * fac;
        out[V_out] = w1 * fac;
        out[2 * V_out] = w2v * fac;
      }
    }
  __syncthreads();

  if constexpr (!FUSE) {  // v_out rows of the tile: one contiguous run
    float* vo = v_out + ((size_t)b * N + n0) * V3o;
    for (int e = tid; e < np * V3o; e += nth) vo[e] = VO[(e / V3o) * L.ldvo + e % V3o];
  } else {
    // SVFuse's frame zf_i[j] = sum_o v5_i[o] wzf[o][j], output by output
    if (tid < 3 * P) {
      const int p = tid % P, i = tid / P;
      const float* v = VO + p * L.ldvo + i * V_out;
      float y0 = 0.f, y1 = 0.f, y2 = 0.f;
      for (int o = 0; o < V_out; ++o) {
        const float vv = v[o];
        y0 = __fadd_rn(y0, __fmul_rn(vv, wzfs[o * 3]));
        y1 = __fadd_rn(y1, __fmul_rn(vv, wzfs[o * 3 + 1]));
        y2 = __fadd_rn(y2, __fmul_rn(vv, wzfs[o * 3 + 2]));
      }
      float* z = ZF + p * 9 + i * 3;
      z[0] = y0, z[1] = y1, z[2] = y2;
    }
    __syncthreads();
    // SVFuse's invariants, x channels S_out + j*V_out + o
    const int Cout = S_out + V3o;
    float* xo = ROW ? s_out + ((size_t)b * N + n0) * Cout : s_out + (size_t)b * Cout * N + n0;
    for (int e = tid; e < P * V3o; e += nth) {
      const int q = ROW ? e % V3o : e / P, p = ROW ? e / V3o : e % P;
      if (p >= np) continue;
      const int j = q / V_out, o = q % V_out;
      const float* v = VO + p * L.ldvo;
      const float* z = ZF + p * 9;
      const float val = sv_dot3_rn(v[o], z[j], v[V_out + o], z[3 + j], v[2 * V_out + o], z[6 + j]);
      if (ROW)
        xo[(size_t)p * Cout + S_out + q] = val;
      else
        xo[(size_t)(S_out + q) * N + p] = val;
    }
    // the gated vectors' sums per 16-point group, in point order
    const size_t nblk = (N + 15) / 16;
    for (int e = tid; e < MT * V3o; e += nth) {
      const int g = e / V3o, q = e % V3o, p0 = 16 * g;
      if (p0 >= np) continue;
      float s = 0.f;
      for (int p = p0; p < min(p0 + 16, np); ++p) s += VO[p * L.ldvo + q];
      vsum[((size_t)b * nblk + n0 / 16 + g) * V3o + q] = s;
    }
  }
  __syncthreads();  // the gated tile is consumed: the region takes A and the ring

  // ---- scalar phase: linear1 on the tensor cores -------------------------
  const int nk = L.Kp / PT_KC;
  auto load_w = [&](int kc, int st) {
    int8_t* dst = ring + (size_t)st * L.spad * (PT_KC + 16);
    for (int e = tid; e < 2 * L.spad; e += nth) {
      const int o = e >> 1, h = e & 1;
      pt_cp16(dst + o * (PT_KC + 16) + 16 * h, w1s + (size_t)o * L.Kp + kc * PT_KC + 16 * h);
    }
  };
  for (int s = 0; s < PT_NST - 1; ++s) {
    if (s < nk) load_w(s, s);
    sv_cp_commit();
  }
  // the operand: sign(s + beta) and sign(sv_j + beta), j-major; zero past
  // the tile's points and past Cin. A thread loads PT_U items before it
  // signs any, so that their loads are in flight together.
  const int SV = S + V, nA = P * SV;
  for (int e0 = tid; e0 < nA; e0 += PT_U * nth) {
    float q[PT_U][3], bq[PT_U][3];
#pragma unroll
    for (int u = 0; u < PT_U; ++u) {
      const int e = min(e0 + u * nth, nA - 1);
      const int p = ROW ? e / SV : e % P, c = ROW ? e % SV : e / P, pc = p < np ? p : 0;
      if (c < S) {
        q[u][0] = s_at(pc, c), q[u][1] = q[u][2] = 0.f;
        bq[u][0] = beta[c], bq[u][1] = bq[u][2] = 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          q[u][j] = *v_ptr(pc, j, c - S);
          bq[u][j] = beta[c + j * V];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PT_U; ++u) {
      const int e = e0 + u * nth;
      if (e >= nA) break;
      const int p = ROW ? e / SV : e % P, c = ROW ? e % SV : e / P;
      int8_t* a = A + p * L.lda;
      if (c < S) {
        a[c] = p < np ? pt_sign8(q[u][0] + bq[u][0]) : (int8_t)0;
      } else {
        const float* z = Zs + p * 9;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          a[c + j * V] = p < np ? pt_sign8(sv_dot3_rn(q[u][0], z[j], q[u][1], z[3 + j], q[u][2],
                                                      z[6 + j]) + bq[u][j])
                                : (int8_t)0;
      }
    }
  }
  const int kpad = L.Kp - Cin;
  for (int e = tid; e < P * kpad; e += nth) A[(e / kpad) * L.lda + Cin + e % kpad] = 0;

  int acc[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
  const int ntw = L.ntw, col0 = warp * ntw * 8;  // this warp's first output
  const bool busy = col0 < S_out;                // warp-uniform
  const sv_bf16* pa = sv_frag_a((const sv_bf16*)A, L.lda / 2, 0);
  for (int kc = 0; kc < nk; ++kc) {
    sv_cp_wait<PT_NST - 2>();
    __syncthreads();  // stage kc landed; the stage read at kc - 1 is free
    if (kc + PT_NST - 1 < nk) load_w(kc + PT_NST - 1, (kc + PT_NST - 1) % PT_NST);
    sv_cp_commit();
    if (busy) {
      const sv_bf16* st = (const sv_bf16*)(ring + (size_t)(kc % PT_NST) * L.spad * (PT_KC + 16));
      unsigned bw[NTW / 2][4];  // this warp's columns, then one m-tile at a time
#pragma unroll
      for (int n2 = 0; n2 < NTW / 2; ++n2)
        if (2 * n2 < ntw) sv_ldsm4(bw[n2], sv_frag_b(st, (PT_KC + 16) / 2, col0 + 16 * n2));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        sv_ldsm4(a, pa + (size_t)mt * 16 * (L.lda / 2) + kc * (PT_KC / 2));
#pragma unroll
        for (int n2 = 0; n2 < NTW / 2; ++n2)
          if (2 * n2 < ntw) {
            sv_mma_s8(acc[mt][2 * n2], a, bw[n2][0], bw[n2][1]);
            sv_mma_s8(acc[mt][2 * n2 + 1], a, bw[n2][2], bw[n2][3]);
          }
      }
    }
  }
  // BN + leaky on the accumulators (integers, exact in f32). A lane holds
  // outputs o, o + 1 of rows r and r + 8: row-major rows take them as one
  // float2 where the row length is even
  const size_t nblk = (N + 15) / 16;
  const int Cout = FUSE ? S_out + V3o : S_out;
  const bool pair = (Cout & 1) == 0;
  if (busy)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        if (nt >= ntw) break;
        const int o = col0 + sv_acc_col(lane, nt, 0);
        float al[2], bl[2], m[2] = {-INFINITY, -INFINITY};  // m: FUSE, the group's maxima
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int oc = min(o + h, S_out - 1);
          al[h] = a1[oc], bl[h] = b1[oc];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // no lane leaves before the shuffles
          const int p = mt * 16 + sv_acc_row(lane, 2 * r);
          if (p >= np || o >= S_out) continue;
          float y[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            y[h] = sv_leaky((float)acc[mt][nt][2 * r + h] * al[h] + bl[h]);
            if (FUSE) m[h] = fmaxf(m[h], y[h]);
          }
          if (ROW || !FUSE) {
            float* d = s_out + ((size_t)b * N + n0 + p) * Cout + o;
            if (pair && o + 1 < S_out) {
              *(float2*)d = make_float2(y[0], y[1]);
            } else {
              d[0] = y[0];
              if (o + 1 < S_out) d[1] = y[1];
            }
          } else {
            s_out[((size_t)b * Cout + o) * N + n0 + p] = y[0];
            if (o + 1 < S_out) s_out[((size_t)b * Cout + o + 1) * N + n0 + p] = y[1];
          }
        }
        if constexpr (FUSE) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int sh = 4; sh < 32; sh <<= 1)
              m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], sh));
            if (lane < 4 && o + h < S_out && 16 * mt < np)
              smax[((size_t)b * nblk + n0 / 16 + mt) * S_out + o + h] = m[h];
          }
        }
      }
}

// Launches the tile kernel over B x ceil(N / P) tiles of 16 MT points.
template <bool ROW, bool FUSE>
static int sv_point_tile(const float* src, const float* gate, const int* vrow,
                         const float* wz, const int8_t* w1s, const float* beta,
                         const float* a1, const float* b1, const float* w2,
                         const float* scale2, const float* a2, const float* b2,
                         const float* wzf, float* s_out, float* v_out, float* smax,
                         float* vsum, int B, int N, int S, int V, int S_out, int V_out,
                         cudaStream_t st) {
  PtLayout L;
  if (!pt_pick(L, S, V, S_out, V_out, FUSE) || B < 1 || B > 65535 || N < 1 || w1s == nullptr)
    return (int)cudaErrorInvalidValue;
  auto kern = L.MT == 8   ? sv_point_tile_kernel<ROW, FUSE, 8>
              : L.MT == 4 ? sv_point_tile_kernel<ROW, FUSE, 4>
                          : sv_point_tile_kernel<ROW, FUSE, 2>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + L.P - 1) / L.P, B);
  kern<<<grid, PT_THREADS, L.total, st>>>(src, gate, vrow, wz, w1s, beta, a1, b1, w2, scale2,
                                          a2, b2, wzf, s_out, v_out, smax, vsum, L, N, S, V,
                                          S_out, V_out);
  return (int)cudaGetLastError();
}

// Tile products on the tensor cores for the block kernels (sv_rounds.cuh,
// sv_train.cuh, sv_point_tile.cuh): warp-level mma.sync with f32 (bf16)
// or s32 (int8) accumulation, operands read from shared memory with
// ldmatrix.
//
// Exactness. The serving rounds, B6's forward and the per-point blocks
// multiply sign(x + beta) by the folded sign weights, both in {-1, 0, +1},
// so every product is exact and every partial sum an integer of magnitude
// at most the depth (Cin <= 2044, the SV-PointNet classifier's conv_fuse;
// IN1 <= 272 in the rounds), below 2^24: f32 holds it exactly, so the
// product is exact in any order, in bf16 with f32 accumulation as in int8
// with s32. B6's backward multiplies a real cotangent by the sign weights
// or signs; split into three bf16 pieces (sv_split3) each product is
// exact again and only the order of the f32 sum differs, which int8
// cannot carry: the rounds and B6 use bf16 (sv_mma). The per-point blocks
// have no backward and stream W1's signs packed as int8 from device
// memory, so they use int8 (sv_mma_s8): half the bytes and twice the rate.
//
// Layouts. A bf16 operand with K columns is stored with row stride
// sv_mma_ld(K) elements: K padded with zeros to the MMA depth 16, plus 8,
// so the 8 rows one ldmatrix phase reads lie in 8 distinct 16-byte bank
// groups (no conflicts). Padding rows and columns hold zeros, which add
// nothing; the caller masks the ragged edge of its tiles. An int8 operand
// is read by the same ldmatrix calls, as b16 pairs: a 16 x 32 int8 tile
// is a 16 x 16 b16 one, and its fragments are those of m16n8k32.
#pragma once

#include <cuda_bf16.h>

#include "sv_common.cuh"

typedef __nv_bfloat16 sv_bf16;

static __host__ __device__ inline int sv_pad16(int n) { return (n + 15) & ~15; }
static __host__ __device__ inline int sv_mma_ld(int K) { return sv_pad16(K) + 8; }

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8.
static __device__ __forceinline__ void sv_ldsm4(unsigned (&r)[4], const sv_bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sv_smem_u32(p))
               : "memory");
}

// The same, each matrix transposed on the way to the registers.
static __device__ __forceinline__ void sv_ldsm4_t(unsigned (&r)[4], const sv_bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sv_smem_u32(p))
               : "memory");
}

// d += a (16x16, row-major) . b (16x8); d[0..1] row lane/4, d[2..3] row
// lane/4 + 8, columns 2*(lane%4) and 2*(lane%4) + 1.
static __device__ __forceinline__ void sv_mma(float (&d)[4], const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product on int8 operands: d += a (16x32) . b (32x8), s32
// accumulators laid out as sv_mma's f32 ones; a and b loaded with
// sv_ldsm4 from int8 rows read as b16 pairs.
static __device__ __forceinline__ void sv_mma_s8(int (&d)[4], const unsigned (&a)[4],
                                                 unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row and column of accumulator element q (0..3) of n-tile j in a warp's
// 16 x 16 output tile.
static __device__ __forceinline__ int sv_acc_row(int lane, int q) { return (lane >> 2) + (q >> 1) * 8; }
static __device__ __forceinline__ int sv_acc_col(int lane, int j, int q) {
  return j * 8 + 2 * (lane & 3) + (q & 1);
}

// ldmatrix row addresses (at k0 = 0) of the fragments of one 16 x 16 tile:
//   A row-major A[m][k], rows m0..m0+15:          sv_frag_a(A, lda, m0) + k0
//   A from A[k][m] (transposed), rows m0..m0+15:  sv_frag_at(A, lda, m0) + k0 * lda
//   B as Bt[n][k], columns n0..n0+15:             sv_frag_b(Bt, ldb, n0) + k0
//   B from B[k][n] (transposed), cols n0..n0+15:  sv_frag_bt(B, ldb, n0) + k0 * ldb
// An A load gives the four registers of the A operand; a B load gives
// the two registers of n-tile n0 (r[0], r[1]) and of n0 + 8 (r[2], r[3]).
static __device__ __forceinline__ const sv_bf16* sv_frag_a(const sv_bf16* A, int lda, int m0) {
  const int l = threadIdx.x & 31;
  return A + (size_t)(m0 + (l & 15)) * lda + (l >> 4) * 8;
}
static __device__ __forceinline__ const sv_bf16* sv_frag_at(const sv_bf16* A, int lda, int m0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  return A + (size_t)((l & 7) + (mi >> 1) * 8) * lda + m0 + (mi & 1) * 8;
}
static __device__ __forceinline__ const sv_bf16* sv_frag_b(const sv_bf16* Bt, int ldb, int n0) {
  const int l = threadIdx.x & 31;
  return Bt + (size_t)(n0 + (l & 7) + (l >> 4) * 8) * ldb + ((l >> 3) & 1) * 8;
}
static __device__ __forceinline__ const sv_bf16* sv_frag_bt(const sv_bf16* B, int ldb, int n0) {
  const int l = threadIdx.x & 31;
  return B + (size_t)((l & 7) + ((l >> 3) & 1) * 8) * ldb + n0 + (l >> 4) * 8;
}

// Bt[o * ldw + r] = w[r * O + o] (w (K, O) row-major f32 in device memory,
// the folded sign weights), zero for o >= O up to sv_pad16(O) and for
// r >= K up to sv_pad16(K). Run by the whole block, once per block.
static __device__ void sv_stage_signs_t(sv_bf16* Bt, const float* __restrict__ w, int K,
                                        int O) {
  const int Kp = sv_pad16(K), Op = sv_pad16(O), ldw = sv_mma_ld(K);
  for (int i = threadIdx.x; i < Kp * Op; i += blockDim.x) {
    const int r = i / Op, o = i % Op;  // consecutive threads read consecutive o
    Bt[(size_t)o * ldw + r] = __float2bfloat16_rn(r < K && o < O ? w[(size_t)r * O + o] : 0.f);
  }
}

// x = hi + mid + lo exactly, each a bf16 (the three carry the 24 bits of an
// f32 significand; exact for |x| >= 2^-110, about 8e-34, where lo is still
// a normal bf16).
static __device__ __forceinline__ void sv_split3(float x, sv_bf16& hi, sv_bf16& mid, sv_bf16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(hi));
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
}

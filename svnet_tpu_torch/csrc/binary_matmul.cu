// A +-1 by +-1 matrix product by XNOR-popcount on packed signs, on Hopper:
// kernel B9, the bench's subject (svnet_tpu_torch/utils/bench_binary_matmul.py).
//
// Replaces svnet_tpu/ops/pallas/binary_matmul.py::xnor_popcount_matmul
// (kernel _xnor_kernel): out[m, n] = K - 2 * popcount(xp[m] ^ wp[n]) over
// the K/32 packed words of row m of x and column n of w (bit b of word j
// is the sign of element 32j + b, set for +1), written in f32. Exact for
// zero-free operands: the count is an integer, K - 2*count is below 2^24.
//
// What bounds it on the H100: the f32 output (4 bytes per product against
// K/8 bytes of operands per row) and, far below it, the binary tensor
// cores. XOR and popcount on the CUDA cores' integer units run at 16
// popcounts per SM per clock; Hopper's binary mma.sync m16n8k256 runs
// with AND + popcount about 8 times as fast as its int8 mma.sync, and
// with XOR + popcount at about the int8 rate (measured on the H100 by
// ``python -m svnet_tpu_torch.utils.bench_binary_matmul --rates``). So the kernel counts agreements with AND alone:
//   K - 2 * popc(x ^ w) = 2 * (popc(x & w) + popc(~x & ~w)) - K,
// two AND products on the same accumulators. Padding words (the word
// count rounded up to the MMA depth of 8 words) are 0 on both sides: they
// add nothing to popc(x & w) and 32 each to popc(~x & ~w), subtracted at
// the end. Rows and columns past M and N are 0 too and never written.
//
// Design: a block of 8 warps (2 x 4) owns a BM x BN tile of the output, a
// warp MI x NJ MMA tiles of 16 x 8: 128 x 128 (MI = NJ = 4, 64 s32
// accumulators a thread) where that grid has two blocks an SM or more,
// else 64 x 64 (MI = NJ = 2), whose four times as many blocks overlap one
// block's loads and output with another's MMAs (timed on the H100, the
// larger tile loses below that line and wins well above it). The packed
// words stream through a four-stage cp.async ring of 16-word chunks
// (16-byte copies where both operands start on 16-byte boundaries and the
// rows keep them: L a multiple of 4; row stride 20 words: the 8 rows an
// ldmatrix phase reads lie in 8 distinct 16-byte bank groups), so a K of
// up to 64 words is in flight at once, and ldmatrix hands each lane its
// fragment words directly: in m16n8k256 a register is 32 consecutive bits
// of one row, i.e. one packed word. The output leaves as float2 pairs,
// each warp store filling whole 32-byte sectors.
#include <cuda_runtime.h>

#include <cstdint>

#define XB_KC 16  // packed words per chunk (2 MMA depths of 8 words)
#define XB_LD 20  // row stride of a staged chunk, in words
#define XB_NST 4  // chunks in flight (the bench's 64 words at once)
#define XB_THREADS 256

// dynamic shared memory of the MI x NJ tile: XB_NST chunks of its
// (BM + BN) rows
static constexpr int xb_smem_bytes(int MI, int NJ) {
  return XB_NST * (32 * MI + 32 * NJ) * XB_LD * 4;
}

static __device__ __forceinline__ unsigned xb_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void xb_ldsm4(unsigned (&r)[4], const unsigned* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(xb_smem(p))
               : "memory");
}

// d += popc(a & b) over 256 bits: a 16 x 256 rows, b 256 x 8 columns
static __device__ __forceinline__ void xb_mma_and(int (&d)[4], unsigned a0, unsigned a1,
                                                  unsigned a2, unsigned a3, unsigned b0,
                                                  unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// v4: 16-byte copies (both operands and every row 16-byte aligned)
template <int MI, int NJ>
static __global__ void __launch_bounds__(XB_THREADS)
xnor_popcount_kernel(const unsigned* __restrict__ xp,
                     const unsigned* __restrict__ wp, float* __restrict__ out,
                     int M, int N, int L, bool v4) {
  constexpr int BM = 32 * MI, BN = 32 * NJ, STAGE = (BM + BN) * XB_LD;
  extern __shared__ __align__(16) unsigned xb_smem_words[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 16 * MI, wn = (warp & 3) * 8 * NJ;  // the warp's tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Lp = (L + 7) & ~7, nch = (Lp + XB_KC - 1) / XB_KC;

  // chunk c into its stage: words l0 .. l0 + 15 of each row (the BM rows
  // of x, then the BN of w), zero-filled past M, N or L; one commit group
  // per chunk, empty past the last
  auto stage = [&](int c) {
    unsigned* S = xb_smem_words + (c % XB_NST) * STAGE;
    const int l0 = c * XB_KC, per = v4 ? 4 : 1, nper = XB_KC / per;
    for (int i = tid; c < nch && i < (BM + BN) * nper; i += XB_THREADS) {
      const int r = i / nper, w = (i % nper) * per, l = l0 + w;
      const bool a = r < BM;
      const int g = a ? m0 + r : n0 + r - BM;
      const bool ok = g < (a ? M : N) && l < L;
      const unsigned* src = ok ? (a ? xp : wp) + (size_t)g * L + l : xp;
      const unsigned dst = xb_smem(S + r * XB_LD + w), bytes = ok ? 4 * per : 0;
      if (v4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                     "l"(src), "r"(bytes));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                     "l"(src), "r"(bytes));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  // ldmatrix row addresses: A matrices (rows 0-7 | 8-15) x (words 0-3 |
  // 4-7) give a0..a3; B matrices (words 0-3 | 4-7) x (columns 0-7 | 8-15)
  // give b0, b1 of two n-tiles
  const int q8 = lane >> 3, r8 = lane & 7;
  const int aoff = (wm + (q8 & 1) * 8 + r8) * XB_LD + (q8 >> 1) * 4;
  const int boff = (wn + (q8 >> 1) * 8 + r8) * XB_LD + (q8 & 1) * 4;

#pragma unroll
  for (int c = 0; c < XB_NST - 1; ++c) stage(c);
  for (int c = 0; c < nch; ++c) {
    stage(c + XB_NST - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(XB_NST - 1));
    __syncthreads();
    const unsigned* As = xb_smem_words + (c % XB_NST) * STAGE;
    const unsigned* Bs = As + BM * XB_LD;
    const int ksteps = min(XB_KC, Lp - c * XB_KC) / 8;
    for (int kk = 0; kk < ksteps; ++kk) {
      unsigned a[MI][4], b[NJ / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) xb_ldsm4(a[i], As + aoff + i * 16 * XB_LD + kk * 8);
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j) xb_ldsm4(b[j], Bs + boff + j * 16 * XB_LD + kk * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const unsigned b0 = b[j >> 1][(j & 1) * 2], b1 = b[j >> 1][(j & 1) * 2 + 1];
          xb_mma_and(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b0, b1);
          xb_mma_and(acc[i][j], ~a[i][0], ~a[i][1], ~a[i][2], ~a[i][3], ~b0, ~b1);
        }
    }
    __syncthreads();  // this stage is refilled next
  }

  // out = 2 * (agreements - 32 per padding word) - K
  const int bias = 64 * Lp - 32 * L;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + h * 8;
      if (m >= M) continue;
      float* orow = out + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t4;
        const float v0 = (float)(2 * acc[i][j][2 * h] - bias);
        const float v1 = (float)(2 * acc[i][j][2 * h + 1] - bias);
        if (n + 1 < N && (N & 1) == 0) {
          *(float2*)(orow + n) = make_float2(v0, v1);
        } else {
          if (n < N) orow[n] = v0;
          if (n + 1 < N) orow[n + 1] = v1;
        }
      }
    }
}

template <int MI, int NJ>
static int xnor_popcount_run(const unsigned* xp, const unsigned* wp, float* out, int M,
                             int N, int L, bool v4, cudaStream_t stream) {
  constexpr int smem = xb_smem_bytes(MI, NJ);
  cudaError_t err = cudaFuncSetAttribute(
      xnor_popcount_kernel<MI, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + 32 * NJ - 1) / (32 * NJ), (M + 32 * MI - 1) / (32 * MI));
  xnor_popcount_kernel<MI, NJ><<<grid, XB_THREADS, smem, stream>>>(xp, wp, out, M, N, L, v4);
  return (int)cudaGetLastError();
}

// xp (M, L) and wp (N, L) int32 packed signs, L = K/32 words; out (M, N)
// f32.
extern "C" int xnor_popcount_launch(const int* xp, const int* wp, float* out,
                                    int M, int N, int L, void* stream) {
  if (M <= 0 || N <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool v4 = (L & 3) == 0 && (((uintptr_t)xp | (uintptr_t)wp) & 15) == 0;
  const unsigned *x = (const unsigned*)xp, *w = (const unsigned*)wp;
  const cudaStream_t st = (cudaStream_t)stream;
  if ((long)((M + 127) / 128) * ((N + 127) / 128) >= 2 * sms)
    return xnor_popcount_run<4, 4>(x, w, out, M, N, L, v4, st);
  return xnor_popcount_run<2, 2>(x, w, out, M, N, L, v4, st);
}

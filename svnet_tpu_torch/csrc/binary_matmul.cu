// A +-1 by +-1 matrix product by XNOR-popcount on packed signs, on Hopper:
// kernel B9, the bench's subject (svnet_tpu_torch/utils/bench_binary_matmul.py).
//
// Replaces svnet_tpu/ops/pallas/binary_matmul.py::xnor_popcount_matmul
// (kernel _xnor_kernel): out[m, n] = K - 2 * popcount(xp[m] ^ wp[n]) over
// the K/32 packed words of row m of x and column n of w (bit b of word j
// is the sign of element 32j + b, set for +1), written in f32. Exact for
// zero-free operands: the count is an integer, K - 2*count is below 2^24.
//
// What bounds it on the H100: M*N*K/32 XOR + popcount + add on the CUDA
// cores' integer units (popcount at 16 per SM per clock), against the
// operations of the dense product that the table counts (2*M*N*K +-1 by
// +-1 products at the dense bf16 tensor-core rate) and the bytes of the
// packed operands and the f32 output. The design is the plain first
// version: a block stages BM rows and BN columns of BL packed words in
// shared memory, word-major so that a thread's row and column words are
// conflict-free reads, and each of 256 threads keeps a 4 x 4 tile of
// integer counts in registers; tails in M, N and the word count are masked
// (padding words are 0 on both sides and add nothing).
#include <cuda_runtime.h>

#define XB_BM 64
#define XB_BN 64
#define XB_BL 16
#define XB_THREADS 256

static __global__ void __launch_bounds__(XB_THREADS)
xnor_popcount_kernel(const unsigned* __restrict__ xp,
                     const unsigned* __restrict__ wp, float* __restrict__ out,
                     int M, int N, int L, int K) {
  __shared__ unsigned xs[XB_BL][XB_BM + 1];
  __shared__ unsigned ws[XB_BL][XB_BN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * XB_BM, n0 = blockIdx.x * XB_BN;
  int cnt[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cnt[i][j] = 0;

  for (int l0 = 0; l0 < L; l0 += XB_BL) {
    // consecutive threads on consecutive words of a row: coalesced
    for (int i = tid; i < XB_BM * XB_BL; i += XB_THREADS) {
      const int r = i / XB_BL, l = i % XB_BL, m = m0 + r, w = l0 + l;
      xs[l][r] = (m < M && w < L) ? xp[(size_t)m * L + w] : 0u;
    }
    for (int i = tid; i < XB_BN * XB_BL; i += XB_THREADS) {
      const int r = i / XB_BL, l = i % XB_BL, n = n0 + r, w = l0 + l;
      ws[l][r] = (n < N && w < L) ? wp[(size_t)n * L + w] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < XB_BL; ++l) {
      unsigned a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[l][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ws[l][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cnt[i][j] += __popc(a[i] ^ c[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N)
        out[(size_t)m * N + n] = (float)K - 2.0f * (float)cnt[i][j];
    }
  }
}

// xp (M, L) and wp (N, L) int32 packed signs, L = K/32 words; out (M, N)
// f32.
extern "C" int xnor_popcount_launch(const int* xp, const int* wp, float* out,
                                    int M, int N, int L, void* stream) {
  if (M <= 0 || N <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + XB_BN - 1) / XB_BN, (M + XB_BM - 1) / XB_BM);
  xnor_popcount_kernel<<<grid, XB_THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)xp, (const unsigned*)wp, out, M, N, L, 32 * L);
  return (int)cudaGetLastError();
}

// Row gather for training on Hopper: forward gather and a deterministic
// scatter-add backward.
//
// Replaces svnet_tpu/ops/pallas/edge_gather.py::edge_gather (forward
// _fwd_kernel, backward _bwd_kernel of its custom VJP):
//   forward   out[b, n, j, :] = src[b, idx[b, n, j], :]
//   backward  dsrc[b, m, :]   = sum of g[b, n, j, :] over the edges with
//                               idx[b, n, j] == m
// The TPU builds the gather from one-hot int8 matmuls against byte planes
// of src and the scatter-add from transposed one-hot bf16 matmuls (hi and
// lo planes of the cotangent), because it has no vector gather. Hopper has
// indexed loads, so both directions are plain index arithmetic here.
//
// What bounds it on the H100: device memory. At the SV-PointNet training
// shape (B=32, N=1024, k=20, C=3) the forward moves about 10.9 MB (ids,
// rows, the (B, N, k, C) output), 3.2 us at 3.35 TB/s, and both passes sit
// near launch latency. The forward gives each thread one output element,
// consecutive threads consecutive elements, so the stores coalesce; a row
// of C = 3 floats makes the loads short, which is accepted for now.
//
// The backward uses no float atomics, so its result does not depend on
// the order in which blocks run: it builds the inverse adjacency of idx
// per cloud (integer in-degree counts, an exclusive scan, a fill, then a
// sort of each target's segment into ascending edge order n*k + j) and
// sums each target's incoming cotangent rows in that order, one thread per
// (b, m, c), every addition rounded on its own (-fmad=false has nothing to
// contract here). The plain version (ops/kernels/edge_gather.py) sums in
// the same order, so the two agree bitwise and two launches give identical
// results. A segment's length is its in-degree, which a hub point makes
// far larger than k: no buffer is sized by k, the sort and the sum loop
// over the segment in device memory.
//
// An id outside [0, n_src) never reads outside src: its forward row is NaN
// and the backward ignores the edge.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr long long kMaxBlocks = 1 << 20;  // grid-stride loops beyond this

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__device__ __forceinline__ long long grid_start() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_step() {
  return (long long)gridDim.x * blockDim.x;
}

// out (B, M, k, C) from src (B, n_src, C) and idx (B, M, k); ek = M * k.
__global__ void eg_fwd_kernel(const float* __restrict__ src,
                              const int* __restrict__ idx,
                              float* __restrict__ out, long long total,
                              int n_src, int ek, int C) {
  for (long long o = grid_start(); o < total; o += grid_step()) {
    long long e = o / C;
    int c = (int)(o - e * C);
    long long b = e / ek;
    int m = idx[e];
    out[o] = (m >= 0 && m < n_src) ? src[(b * n_src + m) * C + c]
                                   : __int_as_float(0x7fc00000);
  }
}

// deg[b, m] = number of edges of cloud b whose id is m (integer atomics:
// the counts do not depend on the order).
__global__ void eg_count_kernel(const int* __restrict__ idx, int* deg,
                                long long edges, int n_src, int ek) {
  for (long long e = grid_start(); e < edges; e += grid_step()) {
    int m = idx[e];
    if (m >= 0 && m < n_src) atomicAdd(&deg[(e / ek) * n_src + m], 1);
  }
}

// Inclusive scan of x over the block (blockDim.x a multiple of 32, at most
// 1024); warp_sums holds 32 ints of shared memory. Returns the block total.
__device__ int block_inclusive_scan(int& x, int* warp_sums) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int s = 1; s < 32; s <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, s);
    if (lane >= s) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < n_warps ? warp_sums[lane] : 0;
    for (int s = 1; s < 32; s <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, t, s);
      if (lane >= s) t += y;
    }
    if (lane < n_warps) warp_sums[lane] = t;
  }
  __syncthreads();
  if (w > 0) x += warp_sums[w - 1];
  int total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return total;
}

// off[b, m] = exclusive prefix sum of deg[b, :] within cloud b: where the
// segment of target m starts among the cloud's edges. One block per cloud.
__global__ void eg_scan_kernel(const int* __restrict__ deg,
                               int* __restrict__ off, int n_src) {
  __shared__ int warp_sums[32];
  const int* d = deg + (long long)blockIdx.x * n_src;
  int* o = off + (long long)blockIdx.x * n_src;
  int carry = 0;
  for (int base = 0; base < n_src; base += blockDim.x) {
    int i = base + threadIdx.x;
    int v = i < n_src ? d[i] : 0;
    int x = v;
    int total = block_inclusive_scan(x, warp_sums);
    if (i < n_src) o[i] = carry + x - v;
    carry += total;
  }
}

// list[b, off[m] + r] = the local id n*k + j of an edge of target m; the
// order within a segment is the atomics' and is fixed by eg_sort_kernel.
__global__ void eg_fill_kernel(const int* __restrict__ idx,
                               const int* __restrict__ off, int* cur,
                               int* __restrict__ list, long long edges,
                               int n_src, int ek) {
  for (long long e = grid_start(); e < edges; e += grid_step()) {
    int m = idx[e];
    if (m < 0 || m >= n_src) continue;
    long long b = e / ek;
    long long t = b * n_src + m;
    int p = off[t] + atomicAdd(&cur[t], 1);
    list[b * ek + p] = (int)(e - b * ek);
  }
}

// Insertion sort of each target's segment into ascending edge order; one
// thread per (b, m). Segments hold distinct ids, so the order is unique.
__global__ void eg_sort_kernel(const int* __restrict__ deg,
                               const int* __restrict__ off,
                               int* __restrict__ list, long long targets,
                               int n_src, int ek) {
  for (long long t = grid_start(); t < targets; t += grid_step()) {
    int* seg = list + (t / n_src) * ek + off[t];
    int len = deg[t];
    for (int i = 1; i < len; ++i) {
      int key = seg[i];
      int j = i - 1;
      while (j >= 0 && seg[j] > key) {
        seg[j + 1] = seg[j];
        --j;
      }
      seg[j + 1] = key;
    }
  }
}

// dsrc[b, m, c] = g rows of target m's edges summed in ascending edge
// order from 0, each addition rounded on its own; one thread per
// (b, m, c), c fastest.
__global__ void eg_sum_kernel(const float* __restrict__ g,
                              const int* __restrict__ deg,
                              const int* __restrict__ off,
                              const int* __restrict__ list,
                              float* __restrict__ dsrc, long long total,
                              int n_src, int ek, int C) {
  for (long long o = grid_start(); o < total; o += grid_step()) {
    long long t = o / C;
    int c = (int)(o - t * C);
    long long b = t / n_src;
    const int* seg = list + b * ek + off[t];
    const float* gb = g + b * ek * C + c;
    int len = deg[t];
    float acc = 0.f;
    for (int r = 0; r < len; ++r) acc = __fadd_rn(acc, gb[(long long)seg[r] * C]);
    dsrc[o] = acc;
  }
}

}  // namespace

// src (B, n_src, C), idx (B, M, k) int32 -> out (B, M, k, C).
extern "C" int sv_edge_gather_fwd_launch(const float* src, const int* idx,
                                         float* out, int B, int n_src, int M,
                                         int k, int C, void* stream) {
  long long total = (long long)B * M * k * C;
  if (total == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  eg_fwd_kernel<<<grid_for(total), kThreads, 0, s>>>(src, idx, out, total,
                                                     n_src, M * k, C);
  return (int)cudaGetLastError();
}

// g (B, M, k, C), idx (B, M, k) int32 -> dsrc (B, n_src, C). scratch holds
// 3 * B * n_src + B * M * k ints: in-degrees, segment offsets, fill
// cursors and the edge lists.
extern "C" int sv_edge_gather_bwd_launch(const float* g, const int* idx,
                                         float* dsrc, int* scratch, int B,
                                         int n_src, int M, int k, int C,
                                         void* stream) {
  long long targets = (long long)B * n_src;
  if (targets == 0 || C == 0) return 0;
  long long edges = (long long)B * M * k;
  int ek = M * k;
  cudaStream_t s = (cudaStream_t)stream;
  int* deg = scratch;
  int* off = deg + targets;
  int* cur = off + targets;
  int* list = cur + targets;
  cudaError_t err = cudaMemsetAsync(deg, 0, sizeof(int) * targets, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(cur, 0, sizeof(int) * targets, s);
  if (err != cudaSuccess) return (int)err;
  if (edges > 0) {
    eg_count_kernel<<<grid_for(edges), kThreads, 0, s>>>(idx, deg, edges,
                                                         n_src, ek);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  eg_scan_kernel<<<B, kScanThreads, 0, s>>>(deg, off, n_src);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (edges > 0) {
    eg_fill_kernel<<<grid_for(edges), kThreads, 0, s>>>(idx, off, cur, list,
                                                        edges, n_src, ek);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  eg_sort_kernel<<<grid_for(targets), kThreads, 0, s>>>(deg, off, list,
                                                        targets, n_src, ek);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  long long total = targets * C;
  eg_sum_kernel<<<grid_for(total), kThreads, 0, s>>>(g, deg, off, list, dsrc,
                                                     total, n_src, ek, C);
  return (int)cudaGetLastError();
}

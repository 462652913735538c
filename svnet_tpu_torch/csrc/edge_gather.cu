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
// near launch latency; at the joint widths of the un-fused SV-DGCNN step
// (C = 62, 127) the forward moves 170 and 340 MB. A thread per output
// float with 64-bit divisions per element, as the first version had, is
// bound by integer instructions there: the forward now gives each edge
// row to a group of threads sized to C, which reads the id once and
// copies the row with coalesced vector loads and stores.
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
#include <limits.h>
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

template <int V> struct Vec;
template <> struct Vec<1> { typedef float T; };
template <> struct Vec<2> { typedef float2 T; };
template <> struct Vec<4> { typedef float4 T; };

// out (B, M, k, C) from src (B, n_src, C) and idx (B, M, k); ek = M * k.
// A group of 2^lg threads copies a row: it reads the row's id once and
// moves the row's C floats as C / V vectors of V floats, consecutive
// threads on consecutive vectors. A row's loads depend on its id's, so a
// thread keeps R rows x U vectors of loads in flight before it stores
// them: 4 vectors of one row at the joint widths (C = 62, 127), one
// vector of 4 rows where a row is one vector a thread (C = 3). Index
// arithmetic is 32-bit, one division per row.
template <int V, int U, int R>
__global__ void eg_fwd_kernel(const float* __restrict__ src,
                              const int* __restrict__ idx,
                              float* __restrict__ out, long long edges,
                              int n_src, int ek, int C, int lg) {
  typedef typename Vec<V>::T T;
  const int G = 1 << lg, g = threadIdx.x & (G - 1), cv = C / V;
  const long long groups = (long long)gridDim.x * (blockDim.x >> lg);
  for (long long e0 = (long long)blockIdx.x * (blockDim.x >> lg) + (threadIdx.x >> lg);
       e0 < edges; e0 += R * groups) {
    const T* s[R];
    T* o[R];
    bool in[R], ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      in[r] = r == 0 || e0 + r * groups < edges;
      const int ei = in[r] ? (int)(e0 + r * groups) : 0;  // edges < 2^31
      const int m = idx[ei];
      ok[r] = in[r] && m >= 0 && m < n_src;
      s[r] = reinterpret_cast<const T*>(
          src + ((size_t)(ei / ek) * n_src + (ok[r] ? m : 0)) * C);
      o[r] = reinterpret_cast<T*>(out + (size_t)ei * C);
    }
    for (int v0 = g; v0 < cv; v0 += U * G) {
      T x[R][U];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (v0 + u * G >= cv) break;
          if (ok[r]) {
            x[r][u] = s[r][v0 + u * G];
          } else {
            float* f = reinterpret_cast<float*>(&x[r][u]);
#pragma unroll
            for (int i = 0; i < V; ++i) f[i] = __int_as_float(0x7fc00000);
          }
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (in[r] && v0 + u * G < cv) o[r][v0 + u * G] = x[r][u];
    }
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

template <int V, int U, int R>
static int eg_fwd_run(const float* src, const int* idx, float* out,
                      long long edges, int n_src, int ek, int C, int lg,
                      cudaStream_t s) {
  const int rows = R * (kThreads >> lg);
  long long blocks = (edges + rows - 1) / rows;
  eg_fwd_kernel<V, U, R><<<(int)(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                           kThreads, 0, s>>>(src, idx, out, edges, n_src, ek,
                                             C, lg);
  return (int)cudaGetLastError();
}

// The group of a row: the least power of two with 4 vectors a thread (at
// most 32 threads), and at least 4 threads where the row has that many
// vectors.
template <int V>
static int eg_fwd_launch(const float* src, const int* idx, float* out,
                         long long edges, int n_src, int ek, int C,
                         cudaStream_t s) {
  const int cv = C / V;
  int lg = 0;
  while ((4 << lg) < cv && lg < 5) ++lg;
  while ((1 << lg) < cv && lg < 2) ++lg;
  return (1 << lg) >= cv
             ? eg_fwd_run<V, 1, 4>(src, idx, out, edges, n_src, ek, C, lg, s)
             : eg_fwd_run<V, 4, 1>(src, idx, out, edges, n_src, ek, C, lg, s);
}

// src (B, n_src, C), idx (B, M, k) int32 -> out (B, M, k, C). Rows move as
// float4 when C is a multiple of 4 and both arrays are 16-byte aligned, as
// float2 at 8 bytes, else as floats.
extern "C" int sv_edge_gather_fwd_launch(const float* src, const int* idx,
                                         float* out, int B, int n_src, int M,
                                         int k, int C, void* stream) {
  const long long edges = (long long)B * M * k;
  if (edges == 0 || C == 0) return 0;
  if (edges > INT_MAX) return (int)cudaErrorInvalidValue;  // 32-bit edge ids
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)src | (uintptr_t)out;
  if (C % 4 == 0 && align % 16 == 0)
    return eg_fwd_launch<4>(src, idx, out, edges, n_src, M * k, C, s);
  if (C % 2 == 0 && align % 8 == 0)
    return eg_fwd_launch<2>(src, idx, out, edges, n_src, M * k, C, s);
  return eg_fwd_launch<1>(src, idx, out, edges, n_src, M * k, C, s);
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

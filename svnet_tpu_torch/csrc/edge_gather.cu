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
// the order in which blocks run: each target's incoming cotangent rows are
// summed in ascending edge order n*k + j, from 0, every addition rounded
// on its own (-fmad=false has nothing to contract here), as the plain
// version (ops/kernels/edge_gather.py) sums them: the two agree bitwise
// and two launches give identical results. Two kernels, no memset:
//   eg_adj_kernel   the inverse adjacency, a block per (range of targets,
//                   cloud): the range's in-degrees by shared-memory
//                   integer atomics, their exclusive scan, the fill of
//                   each target's segment with its edge ids, and each
//                   segment put in ascending order by rank (an element's
//                   place is the number of smaller ids in its segment),
//                   all in shared memory; out go each target's segment
//                   start and in-degree and the cloud's sorted edge list.
//   eg_sum_kernel   a thread per (target, float4 / float2 / float of its
//                   row), a target's threads on one id at a time and on
//                   consecutive addresses of its row.
// What bounds it on the H100: the cotangent's bytes, read once (7.9 / 163
// / 333 MB at (32, 1024, 20) and C = 3 / 62 / 127: 0.003 / 0.052 / 0.105
// ms at 3.35 TB/s). The adjacency is the same for every C, so it has to
// cost little beside the C = 3 sum: one kernel, no memset, over ranges of
// targets, so that 32 clouds still fill the card. A block reads all of its
// cloud's ids (from L2, int4 loads where aligned) and keeps the edges of
// its range. A range's edges go through shared memory in windows of whole
// segments of at most `cap` ids; a segment longer than that (a hub point
// named by more edges than fit; no buffer is sized by k) is ranked in a
// device-memory spill buffer instead. How many ranges and the cap:
// ops/kernels/edge_gather.py::adjacency_plan. At (32, 1024, 20) the
// adjacency takes 0.021 ms and the sums 0.009 / 0.065 / 0.139 at C = 3 /
// 62 / 127, 0.37 / 0.80 / 0.75 of the bytes' rate (device time,
// utils/bench_prepass.py, NVIDIA H100 80GB HBM3, 700 W).
//
// An id outside [0, n_src) never reads outside src: its forward row is NaN
// and the backward ignores the edge.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // grid-stride loops beyond this
constexpr int kAdjThreads = 512;

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

// f(e, idx[e]) for the block's share of the cloud's ids e < ek, 8 loads of
// a thread in flight before their calls: int4 loads (32 ids) where the
// cloud's ids start on a 16-byte boundary and ek is a multiple of 4.
template <class F>
__device__ __forceinline__ void eg_for_ids(const int* __restrict__ id, int ek, F f) {
  if ((ek & 3) == 0 && ((uintptr_t)id & 15) == 0) {
    const int4* id4 = reinterpret_cast<const int4*>(id);
    const int n4 = ek >> 2;
    for (int e0 = threadIdx.x; e0 < n4; e0 += 8 * blockDim.x) {
      int4 m[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        m[u] = e < n4 ? id4[e] : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = 4 * (e0 + u * blockDim.x);
        if (e < ek) f(e, m[u].x), f(e + 1, m[u].y), f(e + 2, m[u].z), f(e + 3, m[u].w);
      }
    }
    return;
  }
  for (int e0 = threadIdx.x; e0 < ek; e0 += 8 * blockDim.x) {
    int m[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x;
      m[u] = e < ek ? id[e] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (e0 + u * blockDim.x < ek) f(e0 + u * blockDim.x, m[u]);
  }
}

// Block (r, b) builds the adjacency of targets [m0, m1) = [r n_src / R,
// (r + 1) n_src / R) of cloud b (ids idx + b ek): beg[b, m] where target
// m's segment starts in the cloud's list, deg[b, m] its length, and
// list[b, beg .. beg + deg) its edge ids n*k + j ascending. Shared memory:
// loc (the range's exclusive scan, nt + 1), cur (counts, then fill
// cursors, nt), buf (cap ids).
__global__ void __launch_bounds__(kAdjThreads)
eg_adj_kernel(const int* __restrict__ idx, int* __restrict__ beg,
              int* __restrict__ deg, int* __restrict__ list,
              int* __restrict__ spill, int n_src, int ek, int cap) {
  extern __shared__ int eg_sm[];
  __shared__ int warp_sums[32];
  const int R = gridDim.x, r = blockIdx.x, b = blockIdx.y;
  const int m0 = (int)((long long)r * n_src / R);
  const int nt = (int)((long long)(r + 1) * n_src / R) - m0;
  int* loc = eg_sm;
  int* cur = loc + nt + 1;
  int* buf = cur + nt;
  const int* id = idx + (size_t)b * ek;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) cur[i] = 0;
  __syncthreads();
  int before = 0;  // the cloud's edges to targets below m0
  eg_for_ids(id, ek, [&](int, int m) {
    if (m >= 0 && m < m0) ++before;
    else if ((unsigned)(m - m0) < (unsigned)nt) atomicAdd(&cur[m - m0], 1);
  });
  const int base = block_inclusive_scan(before, warp_sums);  // syncs: counts done
  int carry = 0;
  for (int i0 = 0; i0 < nt; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int v = i < nt ? cur[i] : 0;
    int x = v;
    const int total = block_inclusive_scan(x, warp_sums);
    if (i < nt) {
      loc[i] = carry + x - v;
      beg[(size_t)b * n_src + m0 + i] = base + carry + x - v;
      deg[(size_t)b * n_src + m0 + i] = v;
    }
    carry += total;
  }
  if (threadIdx.x == 0) loc[nt] = carry;
  __syncthreads();
  for (int i = threadIdx.x; i < nt; i += blockDim.x) cur[i] = 0;
  __syncthreads();
  int* out = list + (size_t)b * ek + base;
  for (int w0 = 0; w0 < nt;) {
    // the window: targets [w0, w1), w1 the last whose segments fit in
    // cap ids together, at least one target
    int w1 = w0 + 1, hi = nt;
    while (w1 < hi) {
      const int mid = (w1 + hi + 1) >> 1;
      if (loc[mid] - loc[w0] <= cap) w1 = mid;
      else hi = mid - 1;
    }
    const int p0 = loc[w0], np = loc[w1] - p0;
    int* seg = np <= cap ? buf : spill + (size_t)b * ek + base + p0;
    eg_for_ids(id, ek, [&](int e, int mm) {
      const unsigned m = (unsigned)mm - (unsigned)m0;
      if (m - (unsigned)w0 < (unsigned)(w1 - w0))
        seg[loc[m] - p0 + atomicAdd(&cur[m], 1)] = e;
    });
    __syncthreads();
    for (int q0 = threadIdx.x; q0 < np; q0 += 4 * blockDim.x) {
      int v[4], m[4];  // 4 ids' targets in flight
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * blockDim.x;
        v[u] = q < np ? seg[q] : 0;
        m[u] = q < np ? id[v[u]] - m0 : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q0 + u * blockDim.x >= np) break;
        const int* s = seg + loc[m[u]] - p0;
        const int len = loc[m[u] + 1] - loc[m[u]];
        int rank = 0;
        for (int i = 0; i < len; ++i) rank += s[i] < v[u];
        out[loc[m[u]] + rank] = v[u];
      }
    }
    __syncthreads();  // seg and the cursors' windows are done
    w0 = w1;
  }
}

// dsrc (B, n_src, C) from the adjacency: a thread per (target t = b
// n_src + m, vector v of its C / V vectors of V floats), consecutive
// threads on consecutive vectors, so a target's threads read its ids at
// one address and its rows coalesced. It adds the rows g[b, id] in the
// segment's order from 0.f, 8 rows' loads in flight before their
// additions. total = B n_src C / V < 2^31; o is unsigned, so o plus the
// grid's stride (at most 2^28) stays below 2^32.
template <int V>
__global__ void eg_sum_kernel(const float* __restrict__ g,
                              const int* __restrict__ beg,
                              const int* __restrict__ deg,
                              const int* __restrict__ list,
                              float* __restrict__ dsrc, int total, int n_src,
                              int ek, int cv) {
  typedef typename Vec<V>::T T;
  for (unsigned o = blockIdx.x * blockDim.x + threadIdx.x; o < (unsigned)total;
       o += gridDim.x * blockDim.x) {
    const int t = (int)(o / (unsigned)cv), b = t / n_src;
    const int len = deg[t];
    const int* seg = list + (size_t)b * ek + beg[t];
    const T* gb = reinterpret_cast<const T*>(g) + (size_t)b * ek * cv + ((int)o - t * cv);
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    auto add = [&](const T& y) {
      const float* f = reinterpret_cast<const float*>(&y);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
    };
    int r = 0;
    for (; r + 8 <= len; r += 8) {
      int e[8];
      T y[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) e[q] = seg[r + q];
#pragma unroll
      for (int q = 0; q < 8; ++q) y[q] = gb[(size_t)e[q] * cv];
#pragma unroll
      for (int q = 0; q < 8; ++q) add(y[q]);
    }
    for (; r < len; ++r) add(gb[(size_t)seg[r] * cv]);
    T y;
    float* f = reinterpret_cast<float*>(&y);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = acc[i];
    reinterpret_cast<T*>(dsrc)[o] = y;
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

template <int V>
static int eg_sum_launch(const float* g, const int* beg, const int* deg,
                         const int* list, float* dsrc, long long targets,
                         int n_src, int ek, int C, cudaStream_t s) {
  const int total = (int)(targets * (C / V));
  const long long blocks = ((long long)total + kThreads - 1) / kThreads;
  eg_sum_kernel<V><<<(int)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads, 0,
                     s>>>(g, beg, deg, list, dsrc, total, n_src, ek, C / V);
  return (int)cudaGetLastError();
}

// g (B, M, k, C), idx (B, M, k) int32 -> dsrc (B, n_src, C). scratch holds
// 2 B n_src + 2 B M k ints: the segments' starts and in-degrees, the edge
// lists and the spill. ranges (1 <= ranges <= n_src) blocks a cloud build
// the adjacency, each with windows of at most cap ids in shared memory.
// Rows move as float4 when C is a multiple of 4 and both g and dsrc are
// 16-byte aligned, as float2 at 8 bytes, else as floats.
extern "C" int sv_edge_gather_bwd_launch(const float* g, const int* idx,
                                         float* dsrc, int* scratch, int B,
                                         int n_src, int M, int k, int C,
                                         int ranges, int cap, void* stream) {
  const long long targets = (long long)B * n_src;
  if (targets == 0 || C == 0) return 0;
  const long long edges = (long long)B * M * k;
  if (edges > INT_MAX || targets * C > INT_MAX || B > 65535 || ranges < 1 ||
      ranges > n_src || cap < 1)
    return (int)cudaErrorInvalidValue;
  const int ek = M * k, nt = (n_src + ranges - 1) / ranges;
  const size_t smem = sizeof(int) * (2 * (size_t)nt + 1 + cap);
  if (smem + sizeof(int) * 32 > 48 * 1024)  // beside the 32 ints of warp sums
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* beg = scratch;
  int* deg = beg + targets;
  int* list = deg + targets;
  int* spill = list + edges;
  eg_adj_kernel<<<dim3(ranges, B), kAdjThreads, smem, s>>>(idx, beg, deg, list,
                                                           spill, n_src, ek, cap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const uintptr_t align = (uintptr_t)g | (uintptr_t)dsrc;
  if (C % 4 == 0 && align % 16 == 0)
    return eg_sum_launch<4>(g, beg, deg, list, dsrc, targets, n_src, ek, C, s);
  if (C % 2 == 0 && align % 8 == 0)
    return eg_sum_launch<2>(g, beg, deg, list, dsrc, targets, n_src, ek, C, s);
  return eg_sum_launch<1>(g, beg, deg, list, dsrc, targets, n_src, ek, C, s);
}

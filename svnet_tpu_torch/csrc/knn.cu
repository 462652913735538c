// Standalone kNN on Hopper, exact, fast and approx mode: neighbour ids
// (B, N, k), self included.
//
// Replaces svnet_tpu/ops/pallas/knn.py::knn_pallas: per centre, the k
// largest negative squared distances over all N candidates, without an
// (N, N) array in device memory. Exact mode ranks by the sortable-int key
// of the f32 distance with ties to the minimum row id. Fast mode
// (knn.py:38-96, sv_round2.py:197-210) ranks by the packed key q * 2^ib +
// (2^ib - 1 - row), q the distance quantized on the scale of each key tile
// of T centres (the tile of the TPU kernel's (T, N) block), whose worst
// distance the pre-pass (sv_neg_min_launch) finds; approx mode folds those
// keys to L lanes by key max first (a fixed 256-lane fold,
// sv_round2.py:58). These are the selection's fast and approx
// instantiations of the serving rounds (sv_common.cuh), told the scales,
// T and L.
//
// What bounds it on the H100: B*N*N*C multiply-adds of the distances
// (C = 3, 62, 62, 127 on the training path), rounded op by op in f32 on
// the CUDA cores (no FMA, so that self-distances are exactly 0 and the
// ranking is bitwise the plain version's): twice the instructions of the
// FMA bound. The design is the serving rounds' selection (sv_common.cuh):
// register tiles of 8 centres x 4 candidates per lane over channel chunks
// staged in shared memory, then a per-centre top-k list in registers that
// drops every key below its k-th entry at once and folds the rest in by
// warp insertion or a bitonic merge, so no rank rescans the N keys and
// the shared memory per centre scales with k. The ids are written
// point-major, as knn_pallas returns them.
#include "sv_common.cuh"

// x (B, C, N) channel-major; aa (B, N) scratch; ids (B, N, k) int32.
// Fast mode: tile_scale (B, N / T), the key tiles' scales
// (quant.py::tile_scales); approx mode also L > 0, the fold width. Exact
// mode passes a null tile_scale and T = L = 0.
extern "C" int sv_knn_launch(const float* x, float* aa, int* ids,
                             const float* tile_scale, int B, int N, int C,
                             int k, int T, int L, void* stream) {
  return (int)sv_knn_select(x, aa, ids, B, N, C, k, (cudaStream_t)stream,
                            /*point_major=*/true, /*row_major=*/false,
                            tile_scale, T, L);
}

// Fast mode's pre-pass (sv_common.cuh::sv_neg_min): x (B, N, C) row-major;
// aa (B, N) scratch; neg_min (B, N), each centre's least negative squared
// distance over all N candidates, which quant.py::tile_scales turns into
// the key tiles' scales.
extern "C" int sv_neg_min_launch(const float* x, float* aa, float* neg_min,
                                 int B, int N, int C, void* stream) {
  return (int)sv_neg_min(x, aa, neg_min, B, N, C, (cudaStream_t)stream,
                         /*row_major=*/true);
}

// The pre-pass over a candidate window (sv_common.cuh, SvWindow): x, aa and
// neg_min as sv_neg_min_launch's; keep (B, N / T, N / 128) and ok (one
// int) from ops/window.py on the device; each centre's least negative
// squared distance over its key tile's kept rows, and 0.0 where the
// tile's W-row window has padding (all N rows where ok is 0).
extern "C" int sv_neg_min_window_launch(const float* x, float* aa,
                                        float* neg_min, const int* keep,
                                        const int* ok, int B, int N, int C,
                                        int T, int W, void* stream) {
  return (int)sv_neg_min(x, aa, neg_min, B, N, C, (cudaStream_t)stream,
                         /*row_major=*/true, SvWindow{keep, ok, T, W, 0});
}

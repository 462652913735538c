// Standalone exact kNN on Hopper: neighbour ids (B, N, k), self included.
//
// Replaces svnet_tpu/ops/pallas/knn.py::knn_pallas (exact mode): per
// centre, the k largest negative squared distances over all N candidates,
// ranked by the sortable-int key of the f32 distance with ties to the
// minimum row id, without an (N, N) array in device memory.
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
extern "C" int sv_knn_launch(const float* x, float* aa, int* ids, int B,
                             int N, int C, int k, void* stream) {
  return (int)sv_knn_select(x, aa, ids, B, N, C, k, (cudaStream_t)stream,
                            /*point_major=*/true);
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

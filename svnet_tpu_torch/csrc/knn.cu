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
// ranking is bitwise the plain version's), then k rescans of N keys per
// centre. The design reuses the serving rounds' selection
// (sv_common.cuh): each candidate column is loaded once for four centres,
// the N keys of a centre stay in shared memory, and a warp max picks
// each rank's winner; only the winner's lane rescans its own candidates.
// The ids are written point-major, as knn_pallas returns them.
#include "sv_common.cuh"

// x (B, C, N) channel-major; aa (B, N) scratch; ids (B, N, k) int32.
extern "C" int sv_knn_launch(const float* x, float* aa, int* ids, int B,
                             int N, int C, int k, void* stream) {
  return (int)sv_knn_select(x, aa, ids, B, N, C, k, (cudaStream_t)stream,
                            /*point_major=*/true);
}

// The legacy row-major fused rounds, exact, fast and approx mode, on
// Hopper: the first round and a conv round of SV-DGCNN's
// rounds_impl="round2" trunk.
//
// Replaces svnet_tpu/ops/pallas/sv_round2.py::sv_round2_first (kernel
// _round2_first_kernel) and ::sv_round2 (_round2_kernel): kNN over the
// xyz points or the joint [s | v] features (the f32 distance
// (2*inner - |ctr|^2) - |cand|^2, sortable-int key, ties to the minimum
// row), a direct gather of the neighbour rows, the SVBlock and svpool --
// the functions of sv_round3_first.cu and sv_round3.cu on row-major
// (B, N, C) activations, with row-major outputs s (B, N, S_out) and v
// (B, N, 3*V_out) ungated. What the TPU kernel needed for its gather (the
// int8 byte planes of every source row, one one-hot matmul per rank) is
// gone: a neighbour is one contiguous row here.
//
// What bounds it on the H100: as for the round3 kernels, the distance
// pass and the block's real-valued work in f32 on the CUDA cores (a binary
// linear1 runs on the tensor cores, exact). The selection stages chunks
// of candidate rows in shared memory with coalesced row loads, transposed
// to the channel-major tiles of the other layout (sv_common.cuh, ROW); the block kernel (sv_rounds.cuh, ROW) gathers each
// neighbour's row with consecutive threads on consecutive channels and
// writes each point's outputs as one contiguous row. The arithmetic is the
// round3 kernels' to the bit, so the two trunks agree exactly.
//
// Fast mode (sv_round2.py:197-210, :95-154) is round3's: the packed 18-bit
// key on the scale of each key tile of T centres (the scales from knn.cu's
// pre-pass), the block on the rows through the 16-bit grid (the wrapper's
// src_q), neighbours and centres alike. Approx mode (:213-228) folds the
// keys to L lanes by key max before the top k; round2's fold is a fixed
// 256 lanes, which the wrapper turns into L. The ids stay point-major
// (B, N, k), which the selection writes in every mode.
#include "sv_rounds.cuh"

// pts (B, N, 3) row-major; aa (B, N) scratch; wins (B, N, k) out; s_out
// (B, N, 32), v_out (B, N, 3*V_out) ungated (column i*V_out + c), ssum
// (B, 3*n_ch, N) per-point sums over the ranks of the init scalars,
// j-major (j*n_ch + c); n_ch is 3 with cross, else 2; V_out 10 or 16.
// Fast mode: pts_q (B, N, 3) the points through the gather grid,
// tile_scale (B, N / T) the key tiles' scales; exact mode passes both null
// and T = 0. L: approx mode's fold width, 0 in the other modes.
extern "C" int sv_round2_first_launch(
    const float* pts, float* aa, const float* wz0, const float* wz1,
    const float* w1, const float* a1, const float* b1, const float* w2,
    const float* a2, const float* b2, float* s_out, float* v_out,
    float* ssum, int* wins, const float* pts_q, const float* tile_scale,
    int B, int N, int k, int S_out, int V_out, int cross, int T, int L,
    void* stream) {
  return sv_first_round<true>(pts, aa, wz0, wz1, w1, a1, b1, w2, a2, b2,
                              s_out, v_out, ssum, wins, B, N, k, S_out,
                              V_out, cross, (cudaStream_t)stream, pts_q,
                              tile_scale, T, L);
}

// src (B, N, S+3V) row-major [s | v i-major]; aa (B, N) scratch; folded
// weights as for sv_round3_launch; outputs s_out (B, N, S_out), v_out
// (B, N, 3V_out) ungated, ssum (B, 2S, N) per-point sums of the edge
// scalars over the ranks, wins (B, N, k). src_q (B, N, S+3V), tile_scale,
// T and L as sv_round2_first_launch's.
extern "C" int sv_round2_launch(
    const float* src, float* aa, const float* wz, const float* w1,
    const float* beta, const float* a1, const float* b1, const float* w2,
    const float* scale2, const float* a2, const float* b2, float* s_out,
    float* v_out, float* ssum, int* wins, const float* src_q,
    const float* tile_scale, int B, int N, int S, int V, int S_out,
    int V_out, int k, int binary, int T, int L, void* stream) {
  return sv_conv_round<true>(src, aa, wz, w1, beta, a1, b1, w2, scale2, a2,
                             b2, s_out, v_out, ssum, wins, B, N, S, V, S_out,
                             V_out, k, binary, (cudaStream_t)stream, src_q,
                             tile_scale, T, L);
}

// The round-1 fused rounds, exact and fast mode, on Hopper: the first
// round and a conv round of SV-DGCNN's rounds_impl="round" trunk, kernel
// B10a.
//
// Replaces svnet_tpu/ops/pallas/sv_round.py::sv_round_first (kernel
// _round_first_kernel) and ::sv_round (_round_kernel): kNN over the xyz
// points or the joint [s | v] features by first-occurrence masked argmax
// (ties to the minimum row), the neighbour gather (on the TPU a 3-way
// bf16 split of the rows, exact in f32), the SVBlock and svpool, row-major
// (B, N, C) in and out, v ungated, the gate statistics beside. In exact
// mode that is the function of sv_round2.cu (B10b): the same selection
// order, the same gather, the same block. So the launchers run the same
// row-major templates of sv_rounds.cuh, and their outputs are bitwise
// B10b's; what bounds them on the H100 is what bounds B10b (the distance
// pass and the block's real-valued work in f32 on the CUDA cores).
//
// exact=False (sv_round.py:85-97, :246-253) packs q * 8192 + (8191 - col),
// q the distance on the 18-bit scale of each key tile of T centres: at
// N <= 8192 (the wrapper refuses more) that is B10b's fast key, so the
// launchers pass the same selection arguments (tile_scale, T; no fold,
// L = 0). Its gather rounds rows and centres to bf16 (the TPU's bf16
// one-hot matmul): the wrapper's pts_q / src_q hold them in f32, and the
// block reads those.
#include "sv_rounds.cuh"

// pts (B, N, 3) row-major; aa (B, N) scratch; wins (B, N, k) out; s_out
// (B, N, 32), v_out (B, N, 3*V_out) ungated, ssum (B, 3*n_ch, N)
// per-point sums of the init scalars over the ranks, j-major; n_ch is 3
// with cross, else 2; V_out 10 or 16. exact=False: pts_q (B, N, 3) the
// points through bf16, tile_scale (B, N / T); exact mode passes both null
// and T = 0; L is 0 (no fold).
extern "C" int sv_round_first_launch(
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

// src (B, N, S+3V) row-major [s | v i-major]; aa (B, N) scratch; outputs
// s_out (B, N, S_out), v_out (B, N, 3V_out) ungated, ssum (B, 2S, N)
// per-point sums of the edge scalars over the ranks, wins (B, N, k).
// src_q, tile_scale, T and L as sv_round_first_launch's.
extern "C" int sv_round_launch(
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

// One SV-DGCNN conv round, exact, fast or approx mode, on Hopper.
//
// Replaces svnet_tpu/ops/pallas/sv_round3.py::sv_round3 (kernel
// _round3_kernel, selection _select_rows / _build_key_t): kNN over the
// joint [s | v] features (sortable-int key, min-row tie-break), neighbour
// gather, the SVBlock (Vector2Scalar quadratic invariant, sign(x + beta)
// +-1 or FP linear1, h*a1 + b1, leaky; linear2*scale2 + VectorBN
// f = a2 + b2/(|.| + EPS)), svpool (max; sum * (1/k)) and the per-block
// sums of the edge scalars for the SE gate.
//
// What bounds it on the H100: at the cls shapes (C = 62..127, N = 1024,
// k = 20) the distance pass is B*N*N*C multiply-adds in f32 on the CUDA
// cores (rounded op by op, no FMA, so that self-distances are exactly 0),
// and the block's real-valued work per edge -- frames, invariants and
// linear2 (3 * 2V * V_out products) -- also on the CUDA cores; linear1,
// B*N*k*(2S+6V)*S_out products of signs by signs, runs on the tensor cores
// (bf16, exact), far below their rate. The selection kernel
// (sv_common.cuh) tiles the distances over 8 centres x 4 candidates per
// lane and keeps a top-k list per centre, not its N keys. The block kernel
// (sv_rounds.cuh) walks tiles of 32 centres x 2 ranks on a persistent grid
// with the sign weights staged once per block; the gather reads neighbour
// rows straight from device memory, where the TPU needed one-hot int8
// matmuls over byte planes. The wrapper hands both kernels a row-major
// copy of the source (one read and one write of it), so a neighbour is one
// contiguous row. Pooled maxima and sums stay in shared memory across rank
// chunks; nothing of shape (B, N, k, C) reaches device memory. The gate
// statistics leave as per-point sums over the ranks, reduced over N
// outside (no float atomics: run-independent).
//
// Fast mode (sv_round3.py:199-235, :95-185) changes the selection's key
// to the 18-bit packed key on the scale of each tile of T centres (the
// scales come from knn.cu's pre-pass and quant.py::tile_scales) and feeds
// the block a second source, the rows through the gather grid; the TPU's
// saving, half the one-hot gather planes, has no counterpart here, where
// a neighbour is one row read. Approx mode (sv_round3.py:209-234) is fast
// mode with the selection's candidates folded to L lanes by key max
// before the top k (sv_common.cuh); its grid is 16 or 8 bits as fast's.
// The candidate window (window=, sv_round3.py:548-591, :1196-1205): the
// selection ranks the kept 128-row blocks of each key tile only (an
// O(N * W) scan; the TPU compacts them into VMEM scratch), or all N rows
// where the device-side certificate failed; the block takes absolute ids.
//
// Graph reuse (sv_round3.py:480-540, take_wins): the round is given an
// earlier round's neighbour ids and runs the block kernel alone -- no
// selection, no pre-pass, one launch. In fast and approx mode it reads
// the rows through the gather grid, as a selecting round's block does.
// The TPU's gather compaction (gather_window, :1206-1220) has no
// counterpart: it exists to shrink one-hot gather matmuls, and its result
// is bitwise the full gather, which is what a row read here is.
#include "sv_rounds.cuh"

// src (B, N, S+3V) row-major [s | v i-major] (the wrapper's copy of the
// round's channel-major source); aa (B, N) scratch;
// folded weights in the JAX fold's orientation (wz (2V, 3), w1 (2S+6V,
// S_out), w2 (2V, V_out), per-channel vectors); outputs s_out (B, S_out,
// N), v_out (B, 3V_out, N) ungated, ssum (B, 2S, N) per-point sums of
// the edge scalars over the ranks, wins (B, k, N). Fast mode: src_q
// (B, N, S+3V) the block's rows through the gather grid, tile_scale
// (B, N / T) the key tiles' scales; exact mode passes both null and T = 0.
// L: approx mode's fold width, 0 in the other modes. keep, ok, W, LW: the
// candidate window, as sv_round3_first_launch's.
extern "C" int sv_round3_launch(
    const float* src, float* aa, const float* wz, const float* w1,
    const float* beta, const float* a1, const float* b1, const float* w2,
    const float* scale2, const float* a2, const float* b2, float* s_out,
    float* v_out, float* ssum, int* wins, const float* src_q,
    const float* tile_scale, const int* keep, const int* ok, int B, int N,
    int S, int V, int S_out, int V_out, int k, int binary, int T, int L,
    int W, int LW, void* stream) {
  return sv_conv_round<false>(src, aa, wz, w1, beta, a1, b1, w2, scale2, a2,
                              b2, s_out, v_out, ssum, wins, B, N, S, V, S_out,
                              V_out, k, binary, (cudaStream_t)stream, src_q,
                              tile_scale, T, L, SvWindow{keep, ok, T, W, LW});
}

// A graph-reuse round: the block kernel on the caller's channel-major ids
// wins (B, k, N), the first k ranks of each cloud's ids, cloud b's at
// wins + b * wins_bs (wins_bs >= k * N: the ranks may be a prefix of a
// wider (B, k', N) tensor); src (B, N, S+3V) row-major, through the
// gather grid in fast and approx mode (the wrapper's), the raw rows in
// exact mode; weights and outputs as sv_round3_launch's.
extern "C" int sv_round3_reuse_launch(
    const float* src, const int* wins, long long wins_bs, const float* wz,
    const float* w1, const float* beta, const float* a1, const float* b1,
    const float* w2, const float* scale2, const float* a2, const float* b2,
    float* s_out, float* v_out, float* ssum, int B, int N, int S, int V,
    int S_out, int V_out, int k, int binary, void* stream) {
  if (wins_bs < (long long)k * N) return (int)cudaErrorInvalidValue;
  return sv_conv_block<false, false>(src, wins, nullptr, wz, w1, beta, a1, b1,
                                     w2, scale2, a2, b2, s_out, v_out, ssum, B,
                                     N, S, V, S_out, V_out, k, binary,
                                     (cudaStream_t)stream, wins_bs);
}

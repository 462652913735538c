// The ids-consuming SV-DGCNN rounds, exact and fast mode, on Hopper: the first
// round (kernel B10d) and a conv round with its gate applied (B10c) of the
// rounds_impl="edge" trunk, whose neighbour ids come from a separate kNN
// (B4, csrc/knn.cu, point-major (B, N, k)).
//
// Replaces svnet_tpu/ops/pallas/sv_edge_first.py::sv_edge_first_block
// (kernel _first_kernel) and svnet_tpu/ops/pallas/sv_edge.py::sv_edge_block
// (_sv_edge_kernel): the neighbour gather (on the TPU a one-hot matmul
// over an (N, k*T) one-hot in VMEM, exact in f32), the edge features, the
// SVBlock and svpool, row-major. The first round returns v ungated and the
// init-scalar sums its gate reads; the conv round multiplies the mean over
// k by the caller's gate (B, V_out), computed on the host from the ids'
// degree histogram (ops/kernels/sv_edge.py::svblock_gate), and returns no
// statistics.
//
// exact=False (sv_edge_first.py:40-57, sv_edge.py:57-159): both rounds read
// their rows and centres through one bf16 cast (the TPU's bf16 one-hot
// matmul), which the wrappers make (quant.bf16_rows) and pass as the
// source: the first round needs nothing more. The conv round's linear2
// also reads each edge vector [nbr - ctr | ctr] through bf16 and a w2 that
// the wrapper rounded to bf16 (sv_round_block_kernel's V2BF16); the frames,
// invariants and linear1 keep the f32 differences.
//
// What bounds it on the H100: with no selection inside, the block math --
// frames, invariants and linear2 in f32 on the CUDA cores; a binary
// linear1 (+-1 by +-1) runs on the tensor cores, exact, an FP one in f32
// in row order (sv_rounds.cuh). The
// launchers run the row-major block kernels of the round kernels
// (sv_rounds.cuh) on the caller's ids: a neighbour is one contiguous row,
// gathered straight from device memory by consecutive threads on
// consecutive channels; nothing of shape (B, N, k, C) reaches device
// memory. The wrappers refuse an id outside [0, N), so no read leaves the
// source.
#include "sv_rounds.cuh"

// pts (B, N, 3) row-major; ids (B, N, k) int32 in [0, N); weights of
// fold_first_params (n_ch = 2); outputs s_out (B, N, 32), v_out
// (B, N, 3*V_out) ungated, ssum (B, 6, N) per-point sums of the init
// scalars over the ranks, j-major (j*2 + c); V_out 10 or 16.
extern "C" int sv_edge_first_launch(
    const float* pts, const int* ids, const float* wz0, const float* wz1,
    const float* w1, const float* a1, const float* b1, const float* w2,
    const float* a2, const float* b2, float* s_out, float* v_out,
    float* ssum, int B, int N, int k, int S_out, int V_out, void* stream) {
  return sv_first_block<true>(pts, ids, wz0, wz1, w1, a1, b1, w2, a2, b2,
                              s_out, v_out, ssum, B, N, k, S_out, V_out,
                              /*cross=*/0, (cudaStream_t)stream);
}

// src (B, N, S+3V) row-major [s | v i-major]; ids (B, N, k) int32 in
// [0, N); gate (B, V_out); weights of fold_svblock_params; outputs s_out
// (B, N, S_out) and v_out (B, N, 3V_out) gated: mean over k, then * gate.
// exact = 0: src is the source through bf16 and w2 rounded to bf16 (see
// above); linear2 reads the edge vectors through bf16.
extern "C" int sv_edge_launch(
    const float* src, const int* ids, const float* gate, const float* wz,
    const float* w1, const float* beta, const float* a1, const float* b1,
    const float* w2, const float* scale2, const float* a2, const float* b2,
    float* s_out, float* v_out, int B, int N, int S, int V, int S_out,
    int V_out, int k, int binary, int exact, void* stream) {
  if (exact)
    return sv_conv_block<true, true>(src, ids, gate, wz, w1, beta, a1, b1, w2,
                                     scale2, a2, b2, s_out, v_out, nullptr, B,
                                     N, S, V, S_out, V_out, k, binary,
                                     (cudaStream_t)stream);
  return sv_conv_block<true, true, true>(src, ids, gate, wz, w1, beta, a1, b1,
                                         w2, scale2, a2, b2, s_out, v_out,
                                         nullptr, B, N, S, V, S_out, V_out, k,
                                         binary, (cudaStream_t)stream);
}

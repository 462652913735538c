// Differentiable fused SV-DGCNN conv round for training, on Hopper.
//
// Replaces svnet_tpu/ops/pallas/sv_round3_train.py::make_fused_round
// (kernel _train_round_kernel, phases f1/f2/b1/b2): edges gathered from
// precomputed neighbour ids, Vector2Scalar with a +-1 frame and learned
// scale (binary) or FP, linear1 on sign(x + beta) with the STE clip at
// +-1.2, BatchNorm over the B*N*k edges, VectorBN on the floored norms,
// max/mean pooling over the ranks with the max's cotangent routed to the
// first argmax rank, and the per-point edge-scalar sums of the SE gate.
// The device code is in sv_train.cuh.
//
// What bounds it on the H100: at the cls training shapes (B=32, N=1024,
// k=20; conv4 (S, V) = (64, 21) -> (128, 42)) every pass recomputes
// linear1, B*N*k*(2S+6V)*S_out products (2.1e10 at conv4), and the
// backward adds two more of that size (d(x) and dW1). Binary, they run on
// the tensor cores (sv_mma.cuh): +-1 by +-1 in bf16 for h, exact; a real
// cotangent split into three bf16 pieces by +-1 for d(x) and dW1, each
// product exact, summed in the MMA's order. That leaves the real-valued
// work per edge on the CUDA cores (-fmad=false): frames, invariants and
// linear2 (3 * 2V * V_out products) in every pass, the vector path's
// backward products and the per-chunk barriers. Device-memory traffic is
// small beside it (src and the ids are read once per pass, no (B, N, k,
// C) tensor is stored). The design keeps a chunk of 16 points x 2 ranks
// (8 x 2 in B2) of edge features, h, v2 and their cotangents in shared
// memory with the sign weights, on a persistent grid of one 512-thread
// block per SM at conv4; parameter gradients accumulate per block in a
// private row of device memory (L2-resident) and are reduced by torch, so
// the result does not depend on block scheduling. Only the neighbour half
// of d(src) is scattered with float atomics: the deterministic
// alternative (a gather over the inverse adjacency of the ids) would need
// the per-edge cotangents stored or recomputed a fifth time.
#include "sv_train.cuh"

extern "C" int sv_round3_train_launch(int phase, void* const* ptrs,
                                      const int* dims, void* stream) {
  return tr_run(phase, ptrs, dims, /*first=*/0, stream);
}

extern "C" int sv_round3_train_tile(int phase, const int* dims) {
  return tr_tile(phase, dims, /*first=*/0);
}

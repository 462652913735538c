// Differentiable fused first SV-DGCNN round (FP) for training, on Hopper.
//
// Replaces svnet_tpu/ops/pallas/sv_first_train.py::make_fused_first_round
// (kernel _first_train_kernel, phases f1/f2/b1/b2): xyz edges
// [nbr - ctr, ctr] from precomputed neighbour ids, two Vector2Scalar
// streams (init_scalar's frame and conv1's own), the FP conv1 linear1 over
// their 12 invariants, BatchNorm over the B*N*k edges, VectorBN, max/mean
// pooling over the ranks (first argmax rank) and the init_scalar sums of
// the SE gate. It is the conv-round kernel of sv_train.cuh with S = 0,
// V = 1 (C = 3 coordinates) and init_scalar's invariants in the place of
// the gathered scalars.
//
// What bounds it on the H100: little work per edge (a 12 x 32 linear1 and
// a 2 x 10 linear2, about 1.6e9 FLOP per pass at B=32, N=1024, k=20), so
// the passes are bound by the per-chunk synchronisation and shared-memory
// traffic of the block rather than by operations or device memory: the
// chunk loop is the conv rounds' one, which this design shares instead of
// tuning a second kernel. d(points) is computed exactly like d(src) of a
// conv round (neighbour half by float atomics, centre half per point).
#include "sv_train.cuh"

extern "C" int sv_first_train_launch(int phase, void* const* ptrs,
                                     const int* dims, void* stream) {
  return tr_run(phase, ptrs, dims, /*first=*/1, stream);
}

extern "C" int sv_first_train_tile(int phase, const int* dims) {
  return tr_tile(phase, dims, /*first=*/1);
}

// First SV-DGCNN / SV-PointNet round, exact, fast or approx mode, on Hopper.
//
// Replaces svnet_tpu/ops/pallas/sv_round3.py::sv_round3_first (kernel
// _round3_first_kernel): xyz kNN (sortable-int key, min-row tie-break),
// edges [nbr - ctr, ctr] (DGCNN) or, with cross, [nbr - ctr, ctr,
// nbr x ctr] (SV-PointNet), init Vector2Scalar (wz0) and conv1's /
// conv_pos's Vector2Scalar (wz1), FP linear1 + folded BN + leaky 0.2 -> max
// over k, linear2 + VectorBN -> mean over k, and the init-scalar sums the
// gate reads. The block kernel (sv_rounds.cuh) is a template on the edge
// channel count (2 or 3) and the vector width (10, or 16 for SV-DGCNN part
// segmentation's make_divisible widths); the cross product is two rounded
// products and one subtraction per component, like the plain version.
//
// What bounds it on the H100: the selection. With C = 3 every edge costs a
// few hundred FLOPs, while each centre scans all N candidates k times on
// the TPU. Here a warp keeps a top-k list per centre and
// drops every candidate below its k-th entry at once (sv_common.cuh), so
// no rank costs an N-wide pass. The TPU's one-hot int8
// gather and byte planes are gone: a thread reads its neighbours' three
// coordinates directly. The block math runs near the CUDA cores' issue
// rate: a block of 128 centres splits each edge's work over shared memory
// between three thread maps, so no thread holds the whole block's state
// (sv_rounds.cuh). The gate statistics leave as per-point sums over the
// ranks, reduced over N outside (no float atomics: run-independent).
//
// Fast mode: the selection ranks by the packed key on the key tiles'
// scales (sv_round3.cu), and the block reads the points through the
// gather grid (centres too, so a self-edge is 0). Approx mode: the same,
// with the selection's candidates folded to L lanes (sv_common.cuh).
//
// The candidate window (window=, sv_round3.py:1274-1313, :1574-1583): on
// a Morton-sorted cloud the selection ranks only the 128-row blocks its
// key tile keeps (ops/window.py certifies them on the device), an
// O(N * W) scan in place of O(N^2); the TPU compacts the kept blocks into
// VMEM scratch, here the selection walks the kept-block list. Where the
// certificate fails (ok = 0 on the device) it scans all N rows, with no
// host sync.
#include "sv_rounds.cuh"

// pts (B, 3, N) channel-major; aa (B, N) scratch; wins (B, k, N) out;
// s_out (B, 32, N), v_out (B, 3*V_out, N) ungated, ssum (B, 3*n_ch, N)
// per-point sums over the ranks of the init scalars, j-major (j*n_ch + c);
// n_ch is 3 with cross, else 2 (wz0, wz1 (n_ch, 3), w1 (6*n_ch, 32), w2
// (n_ch, V_out)); V_out is 10 or 16, anything else is refused. Fast mode:
// pts_q (B, 3, N) the points through the gather grid, tile_scale
// (B, N / T) the key tiles' scales; exact mode passes both null and T = 0.
// L: approx mode's fold width, 0 in the other modes. The candidate window
// (W > 0; sv_common.cuh, SvWindow): keep (B, N / T, N / 128) and ok (one
// int) from the pre-pass on the device, key tiles of T centres in every
// mode, LW approx mode's fold width at W; W = 0: none, keep and ok null.
extern "C" int sv_round3_first_launch(
    const float* pts, float* aa, const float* wz0, const float* wz1,
    const float* w1, const float* a1, const float* b1, const float* w2,
    const float* a2, const float* b2, float* s_out, float* v_out,
    float* ssum, int* wins, const float* pts_q, const float* tile_scale,
    const int* keep, const int* ok, int B, int N, int k, int S_out,
    int V_out, int cross, int T, int L, int W, int LW, void* stream) {
  return sv_first_round<false>(pts, aa, wz0, wz1, w1, a1, b1, w2, a2, b2,
                               s_out, v_out, ssum, wins, B, N, k, S_out,
                               V_out, cross, (cudaStream_t)stream, pts_q,
                               tile_scale, T, L, SvWindow{keep, ok, T, W, LW});
}

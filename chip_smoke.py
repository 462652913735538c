#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from svnet_tpu_torch/csrc and drives the
port's paths at full model width and depth (seeded random weights):
binary SV-DGCNN classification serving, exact mode (B=128, N=1024, k=20,
40 classes), through SVDGCNNClsEngine; fused binary training (B=32,
N=1024) through the trainer; binary SV-PointNet classification serving
(B=128, N=1024, k=20) through SVPointNetClsEngine and part segmentation
(B=32, N=2048, k=40, 50 parts) through SVPointNetPsegEngine; binary
SV-PointNet classification training (B=32, N=1024, k=20) through the
trainer, and binary SV-DGCNN training through the un-fused path; binary
SV-DGCNN part segmentation serving (B=32, N=2048, k=40, 50 parts) through
SVDGCNNPsegEngine, both SV-DGCNN engines' legacy row-major trunk
(rounds_impl="round2"), the classifier's "round" and "edge" trunks, and
the XNOR-popcount +-1 product through its bench
(utils/bench_binary_matmul.py); then fast mode (packed 18-bit kNN keys per
key tile, 16- and 8-bit gather grids) and approx mode (those keys folded
to approx_fold lanes, the Morton entry sort) through B1 and B2 of both
SV-DGCNN engines and the SV-PointNet classifier, graph reuse, the
certified Morton candidate window at N = 8192, fast and approx mode
on the legacy row-major trunks (round2 in both SV-DGCNN engines, round in
the classifier) and on the classifier's edge trunk, B4's fast and
approx mode through its own entry point, binary part-segmentation
training of both families (B=32, N=2048, k=40, 50 parts) through the
trainer, and the JAX package's recipe for its serving pick: un-fused
SV-DGCNN partseg training, knob-aware fused training, --preload and KD
through the trainer, and --fused certification on every leg; the VN and
original model families (classification and part segmentation) through
the trainer, ScanObjectNN through run_cls, ModelNet40_v2's farthest-point
sampling, and a learning check on the card. Phases; any failure raises
and the script exits non-zero:

  0  a CUDA device is required; print the card's name and power limit
  1  build the kernels (nvcc), print the build time
  2  each kernel against its plain PyTorch version on the card, on the
     same inputs, at the paths' shapes (plus a ragged B=8, N=1000, k=7
     case). The SV-DGCNN trunks: B1, B2 x3, B3 (round3) and B10b's first
     and conv rounds x3 and B3r (round2), each at the classifier's shapes
     (B=128, N=1024, k=20) and the part segmenter's (B=32, N=2048, k=40;
     V_out=16 in the first round, (32,16)->(32,16), (32,16)->(64,24),
     (64,24)->(128,40), then (256,96)->(512,168)). Serving rounds: neighbour ids agree on >= 99.99% of
     (b, rank, n) and every mismatch is a near-tie (true distances within
     1e-5 relative); on centre points whose neighbour sets agree, outputs
     within rtol=1e-4, atol=1e-5; a binary conv round (B2, B10b) must be
     bitwise its plain version, ids included (linear1's +-1 products run
     on the tensor cores, exact). kNN (B4): ids bitwise the plain
     version's, at the training shapes (B=32, N=1024, k=20, C=3, 62, 62,
     127), on the round3 engines' inputs of every round (cls B=128,
     N=1024, k=20, C=3, 62, 62, 127; partseg B=32, N=2048, k=40, C=3, 80,
     80, 136), each timed beside torch.cdist + torch.topk, and at shapes
     no tile or list of the selection divides (N=1000, 1001, 130; k=1,
     k=N, 33, 40, 64, 100; duplicated points); the selection inside B1,
     B2 (channel-major, rank-major ids) and B10b (row-major, point-major
     ids) at N=1001 k=33, N=1000 k=64 with ties and N=130 k=100, outputs
     and ids bitwise.
     Training rounds (B5, B6; binary and FP): forward outputs, gate means
     and batch statistics within rtol=1e-4, atol=1e-5 (they are equal:
     both sides sum the batch statistics in double), argmax ranks equal
     on >= 99.99%; backward with seeded cotangents: the flip-tolerant bars
     of tests/test_fused_train.py (cosine >= 0.99 on d(src), >= 0.9 on
     each gradient of 8 or more entries) and, tighter than their 5e-2 /
     2e-1, all gradients together within 1e-3 relative (parameter
     gradients are summed in another order, d(src) with atomics); the
     worst relative error over all training-round calls is printed.
     The conv-round block where neither the MMA tile (16) nor the edge
     tile (32 centres x 2 ranks) divides (CONV_FORCED: IN1=28, S_out=13,
     N=1000 and 1001, k=7 and 33, then cls conv4's and partseg conv3's
     widths at ragged N and k): B2, B10b, B10a and B10c, binary and FP,
     every output bitwise; B6 at those odd widths, (8, 1000, 7), both
     modes, to the bars above
     The first-round block where no centre tile (128) or rank chunk (2)
     divides N or k (FIRST_FORCED: N=1000, 1001 and 50, k=1, 7, 33, 40),
     at every instantiation (edge channels 2 and 3, V_out 10 and 16): B1
     (channel-major) and B10b (row-major) with their own selection, B10d
     on B4's ids; outputs and ids bitwise
     B3/B3r: x and the pooled outputs bitwise the plain version's, binary
     and FP (the binary linear1 runs on the tensor cores in int8, exact);
     B8, B3 and B3r also where neither the K chunk (32) nor the MMA tile
     divides the widths and no point tile N (POINT_FORCED: (5, 3) ->
     (13, 7) at N=1001 and 1000, conv_fuse's and partseg conv5's widths
     at N=1001 and 1000, B3 with two vector blocks), binary and FP.
     B7 (edge_gather, forward and scatter-add backward) at the slice's
     shape (32, 1024, 20, C=3), at C=62 and C=127 (each timed beside
     torch.gather and index_add_) and at a ragged (8, 1000, 7) with C=5,
     1 and 64: forward and backward bitwise, two backward launches
     identical.
     B10a (sv_round_first, sv_round conv2-4, binary and FP), B10d
     (sv_edge_first_block) and B10c (sv_edge_block conv2-4, binary and FP)
     at the classifier's shapes and at a ragged B=8, N=1000, k=7 (first
     round and conv2), inputs chained through the plain round trunk:
     outputs bitwise against the plain versions, B10a also bitwise
     against B10b on the same input; B10d and B10c read the same B4 ids
     on both sides, B10c the same host gate (svblock_gate)
  3  serve 5 requests; each launches sv_round3_first once, sv_round3
     three times and sv_point_block_cm once; logits finite, (128, 40);
     top-1 agrees with the plain-version engine on >= 99% of clouds
  4  SO(3) invariance through the kernels (FP model): logits of rotated
     and unrotated clouds within rtol=2e-2, atol=2e-3
  5  train: 1 warm-up + 10 timed steps of the binary model (Adam, --rot
     z) on seeded surface clouds through train_epoch; each step launches
     knn 4 times, the first-round passes once forward and once backward
     and the conv-round passes three times each way; the loss is finite;
     then one BN re-estimation batch and one eval batch (eager model,
     whose four rounds gather through edge_gather_fwd)
  6  one train step through the kernels against the same step through
     their plain versions, from the same weights and batch: loss and new
     BN running statistics within 1e-4 relative (the forward passes are
     equal), gradients within the bars of phase 2, parameter update
     cosine >= 0.999
  7  SV-PointNet cls: serve 5 requests of (128, 1024, 3); each launches
     sv_round3_first once and sv_block_point 7 times; logits finite,
     (128, 40); top-1 agrees with the plain engine on >= 99%; SO(3)
     invariance of the FP engine as in phase 4
  8  SV-PointNet partseg: serve 5 requests of (32, 2048, 3) with one-hot
     categories; each launches sv_round3_first once and sv_block_point 8
     times; logits finite, (32, 2048, 50); per-point top-1 agrees with the
     plain engine on >= 99%
  9  SV-PointNet cls training: 1 warm-up + 10 timed steps of the binary
     model (pointnet_cls Adam, --rot z) on phase 5's clouds through
     train_epoch; each step launches knn once and edge_gather_fwd (B7) once
     and the scatter-add backward never (the step differentiates the
     weights, not the points, as the JAX step does); the loss is finite;
     then one BN re-estimation batch and one eval batch (eager
     SVPointNetCls), each launching knn and edge_gather_fwd once
 10  one SV-PointNet train step through the kernels against the same step
     through the oracle twin (plain kNN and gather): the bars of phase 6
 11  SV-DGCNN training through the un-fused flax-equivalent path
     (train/dgcnn.py): 1 warm-up + 10 timed steps, each launching knn 4
     times, edge_gather_fwd 4 times and edge_gather_bwd 3 times (conv2-4's
     gathers); the loss is finite; then one step through the kernels
     against the oracle twin with the bars of phase 6
 12  SV-DGCNN partseg: serve 5 requests of (32, 2048, 3) with one-hot
     categories through SVDGCNNPsegEngine (round3); each launches
     sv_round3_first once (V_out=16), sv_round3 three times and
     sv_point_block_cm once; logits finite, (32, 2048, 50); per-point
     top-1 agrees with the plain engine on >= 99%; the peak device memory
     of one request; SO(3) invariance of the FP engine as in phase 4
 13  the round2 trunk of both SV-DGCNN engines: 5 cls requests of
     (128, 1024, 3) and 5 partseg requests of (32, 2048, 3); each launches
     sv_round2_first once, sv_round2 three times and sv_point_block (B3r)
     once; top-1 (per cloud, per point) agrees with the plain engine and
     with the round3 engine on the same weights on >= 99%
 14  the classifier's round and edge trunks: 5 requests of (128, 1024, 3)
     each; per request round launches sv_round_first once, sv_round three
     times and sv_point_block once, edge launches knn 4 times,
     sv_edge_first_block once, sv_edge_block three times and
     sv_point_block once, neither any round2 or round3 kernel; logits
     finite, (128, 40); top-1 agrees with the plain engine and with the
     round3 engine on >= 99%; whether round is bitwise the round2 engine
     and the median latency are printed. Then SVDGCNNPsegEngine asked for
     "round" and "edge" serves one request of (32, 2048, 3) each and
     launches the round2 kernels only (sv_round2_first once, sv_round2
     three times, sv_point_block once)
 15  the XNOR-popcount product (B9) through the bench's main at
     (M, K, N) = (4096, 2048, 512), a ragged (1000, 96, 77) and
     XNOR_RAGGED (M and N off the MMA and both block tiles, K/32 = 1,
     7, 10 and 33 words): exact against the dense +-1 product and bitwise
     against the plain version;
     the kernel's time, torch._int_mm's on int8 operands and a bf16
     torch.mm's with f32 output
 16  fast mode: 5 requests each through SVDGCNNClsEngine (128, 1024, 3)
     and SVDGCNNPsegEngine (32, 2048, 3) with mode="fast" at 16- and
     8-bit gathers, and SVPointNetClsEngine (128, 1024, 3) at 16; per
     request the SV-DGCNN engines launch sv_round3_first once, sv_round3
     three times, the pre-pass neg_min four times and sv_point_block_cm
     once, the SV-PointNet one sv_round3_first and neg_min once and
     sv_block_point 7 times; logits finite; top-1 agrees with the fast
     plain engine on >= 99%; the median request time printed beside the
     exact engine's (phases 3, 12, 7) with the card; top-1 agreement with
     exact mode logged (random weights: no bar)
 17  approx mode: 5 requests each through SVDGCNNClsEngine (128, 1024, 3;
     approx_fold 256), SVDGCNNPsegEngine (32, 2048, 3; fold 512) and
     SVPointNetClsEngine (128, 1024, 3; fold 256) at 16- and 8-bit
     gathers; launches per request as in phase 16; logits finite; top-1
     agrees with the approx plain engine on >= 99%; the median printed
     beside fast mode's (phase 16) and exact mode's; at 16 bits the
     SV-DGCNN engines (which Morton-sort at entry) give shuffled clouds
     the same cls logits and the same per-point partseg logits, top-1
     >= 99%; the recall of B1's and conv2's approx ids against exact ids
     on surface clouds, sorted and shuffled, printed (not a bar)
 18  graph reuse, the JAX package's serving pick (bench.py:300-346): 5
     requests each through SVDGCNNClsEngine (128, 1024, 3; approx, 8-bit
     gathers, fold 256, graph_reuse "spatial"), SVDGCNNPsegEngine (32,
     2048, 3; the same with fold 512 and reuse_k 20) and SVDGCNNClsEngine
     in exact mode with graph_reuse "conv2"; per request one
     sv_round3_first, three sv_round3 of which three (spatial) or two
     (conv2) are reuse rounds (sv_round3_reuse: no selection, no
     pre-pass; neg_min once, for B1, in approx mode) and one
     sv_point_block_cm; logits bitwise the oracle twin's; the median
     printed beside approx mode's without reuse (phase 17) and exact
     mode's (phases 3, 12); reuse_gather_window=512 gives the approx engines'
     logits bitwise; the median with the id range check run in each
     reuse round (which the engines skip for emitted ids: what its
     device sync costs) and top-1 against the same engine without reuse
     logged (random weights: no bar)
 19  the certified Morton candidate window (window=): 5 requests each
     through SVDGCNNClsEngine (16, 8192, 3) on Morton-sorted surface
     clouds, exact and approx (8-bit gathers, fold 256), with the W that
     phase 2 found to certify B1 there; per request one sv_round3_first
     and three sv_round3, all through the windowed selection (the
     wrappers' window_launches), the pre-pass's kernels window_tau and
     window_keep four times each, approx mode's windowed scale pre-pass
     four times; exact logits bitwise the engine without a window, a
     4-cloud request bitwise the windowed oracle twin's; then the same
     engine without a window on the same requests; partseg requests of
     (4, 8192, 3), k = 40, exact, windowed and not, logits bitwise;
     medians and each round's kept share of the 128-row blocks and
     certificate printed with the card
 20  the legacy trunks' fast and approx mode: 5 requests each through
     SVDGCNNClsEngine (128, 1024, 3) with rounds_impl="round2" in fast
     and approx mode and "round" in fast mode, and SVDGCNNPsegEngine
     (32, 2048, 3) with "round2" in fast and approx mode (tile 64: key
     tiles of 256); per request the trunk's first round once, its conv
     round three times, the pre-pass neg_min four times and
     sv_point_block once; top-1 agrees with the plain twin on >= 99%
     (bitwise expected); the median printed beside the same trunk in
     exact mode on the same requests and phase 13's, with the card
 21  the edge trunk's fast and approx mode: 5 requests each through
     SVDGCNNClsEngine (128, 1024, 3) with rounds_impl="edge" in fast and
     in approx mode; per request knn four times (the exact kNN: no
     pre-pass), sv_edge_first_block once and sv_edge_block three times
     with exact=False, sv_point_block once, neg_min never; top-1 agrees
     with the plain twin on >= 99% (bitwise expected); approx logits
     bitwise fast's; the medians printed beside the edge trunk in exact
     mode on the same requests and phase 14's, with the card. Then B4's
     modes through their entry point, knn(x, 20, mode, tile=128), on the
     edge trunk's four round inputs (phase 2), counts zeroed first: knn
     and its pre-pass neg_min four times each a mode, ids bitwise
 22  SV-DGCNN part segmentation, binary training through the fused train
     forward (make_fused_train_apply_pseg) at (32, 2048, 40), 50 parts:
     1 warm-up + 10 timed steps (Adam, --rot z, no label smoothing) on
     seeded surface clouds with random categories and random part ids
     inside each category's range, through train_epoch; each step
     launches knn 4 times, the first-round passes once each way and the
     conv-round passes three times each way; the median step and the
     peak device memory printed; one BN re-estimation batch (knn x4, B5
     forward x1, B6 forward x3) and one eval batch through the eager
     SVDGCNNPseg (knn x4, edge_gather_fwd x4), its mean shape IoU
     printed; one step through the kernels against its oracle twin with
     the bars of phase 6
 23  SV-PointNet part segmentation, binary training (make_train_apply_pseg,
     the pointnet_partseg recipe) on phase 22's clouds: each step, the BN
     re-estimation batch and the eval batch (eager SVPointNetPseg) launch
     knn and edge_gather_fwd once; the rest as phase 22
 24  SV-DGCNN part segmentation through the un-fused train forward
     (train/dgcnn.py::make_train_apply_pseg) on phase 22's clouds: each
     step knn x4, edge_gather_fwd x4 and edge_gather_bwd x3 (the edges in
     device memory; the peak printed); BN re-estimation and eval batches
     knn x4, edge_gather_fwd x4; one step against its oracle twin
 25  knob-aware fused training, the serving pick's stage 1 (spatial reuse,
     the 8-bit grid through ste_quant8; partseg also reuse_k 20): cls on
     phase 5's clouds, partseg on phase 22's; each step knn x1 (the xyz
     ids, which every conv round reuses), the first round fwd/bwd x1 and
     the conv rounds fwd/bwd x3; a BN re-estimation batch; a knob-world
     eval batch of the eager model (knn x1, edge_gather_fwd x4); one step
     against its oracle twin
 26  stage 2 through the trainer (train.loop.run_cls on in-memory clouds):
     a binary base and an FP teacher saved by the trainer; --preload of
     the base (its own tree) with the knobs; --preload of the FP
     checkpoint into a binary student (the overlap merge, leaf counts
     printed); --resume-from STAGE1 --preload FP --distill --kd-t 2
     --kd-alpha 0.3 --no-kd-init with the knobs, launches counted over
     the run (a KD step adds the FP teacher's eager forward: knn x4,
     edge_gather_fwd x4), the KD step's median printed; one KD step
     against its oracle twin
 27  certification: --test --fused on each leg of tools/certify_serving.sh
     (10 cls, 10 partseg with fold 512) through the trainer's eval step
     on the stage-1 weights: loss finite, launches per batch as phases 3,
     12, 16-18 count them, seconds; the exact leg equal to the plain
     engine's loss and predictions; the FP weights' exact engine >= 0.99
     top-1 against the eager eval (the binary leg's agreement printed)
 28  the VN and original model families (--model vn|original) through
     train_epoch with the JAX trainer's recipes (--opt auto: PointNet
     Adam, DGCNN SGD at lr x 100), rot z, seeded random weights:
     VN-PointNet, VN-DGCNN, PointNet and DGCNN classification at (32,
     1024, 20) on phase 5's clouds, 1 + 10 steps, and their part
     segmenters at (32, 2048, 40), 50 parts, 3 steps (1 warm-up); per step
     knn and edge_gather_fwd x1 (VN-PointNet), x4 with edge_gather_bwd x3
     (VN-DGCNN cls, DGCNN cls and partseg), x3 with backward x2 (VN-DGCNN
     partseg), none (PointNet); the median step and the peak device memory
     printed; a BN re-estimation batch and an eval batch through the eager
     model; one step against its oracle twin (the plain B4 and B7 on the
     card): loss and running statistics within 1e-4 relative; each
     classifier's eval forward at (32, 1024, 20) against its oracle twin,
     top-1 >= 0.99
 29  the datasets: --dataset scanobjectnn --subset hard through
     train.loop.run_cls from memory (seeded 2,048-point clouds, 15
     classes, each item 1,024 of its points), binary SV-DGCNN through the
     fused train forward at (32, 1024, 20), 11 steps, a BN re-estimation
     batch and the eager eval: launches counted over the run, a 15-class
     head, a finite loss; ModelNet40_v2(uniform=True) on seeded raw text
     clouds of 10,000 points: farthest-point sampling on the card equal to
     the CPU's
 30  the learning check: (a) FP SV-PointNet cls on the three shapes of
     tests/test_learning.py with its numbers (N = 64, k = 8, B = 24, 40
     clouds a class, 20 epochs, pointnet_cls, so3 in training and test):
     the last 5 losses' mean at least 0.2 below the first 5's, test
     accuracy >= 0.8; (b) binary SV-DGCNN cls at (32, 1024, 20) through
     the fused train forward on the same shapes at N = 1024 (64 clouds a
     class), LEARN_EPOCHS epochs, BN re-estimation over 60 batches, the
     eager eval under so3: test accuracy >= 0.6 (chance 1/3); with its
     trained weights ROADMAP C25's two numbers printed, no bar: the
     float32 exact engine against the float32 eager model, and the
     float64 plain engine against the float64 eager model
 31  BiPointNet and PointNet++ (no kernel lies on this path; no counted
     kernel may launch in it): BiPointNet cls (32, 1024), partseg (32,
     2048; 50 parts) and semseg (16, 4096, 9; 13 classes) through
     train.loop.run_cls, run_partseg and run_semseg from memory, float32
     with TF32 off, 1 warm-up + 10 steps and the eager eval, the median
     step and the peak device memory printed; one train step of each (a
     few clouds of the full N) on the card against the same step on the
     CPU from the same tree, both float64: loss, logits and new running
     statistics within 1e-8 relative; the float32 card eval of the
     trained classifier against its float64 card eval, top-1 printed, no
     bar (C25); the semseg learning check on seeded band rooms (13 height
     bands; SEMSEG_LEARN: 300 steps of (16, 1024, 9)): the last 5 losses'
     mean at least 0.2 under the first 5's, point accuracy >= 0.3 (chance
     1/13); the PointNet++ stacks
     at the widths of the SSG and MSG classifiers (and FP at the part
     segmenter's) on (32, 1024) in float64, eval mode, on the card against
     the CPU on 2 of the clouds: FPS, ball-query and 3-NN ids equal,
     outputs within 1e-8

Phase 2 also holds B4 and B7 at the VN and original models' widths
(phase2_zoo, ZOO_ROUNDS): the kNN of each round and the gather of its
input, ids and both passes bitwise their plain versions, each timed
beside cdist + topk, torch.gather and index_add_: VN-DGCNN cls (32,
1024, 20) C = 3, 63, 63, 126 (the flattened 3V vectors: C = 63 and 126
take B7's scalar copies), DGCNN cls C = 3, 64, 64, 128, VN-PointNet cls
C = 3, and at (32, 2048, 40) VN-DGCNN partseg C = 3, 63, 63, DGCNN
partseg C = 3, 3 (the points through Transform_Net), 64, 64, VN-PointNet
partseg C = 3; the backward where the gathered input carries gradient.

Phase 2 also holds knob-aware training's B6 (phase2_knob_train): on the
ids of another round with its input through ste_quant8, binary, forward
and backward to the training bars, inputs chained through the plain
versions: cls (32, 1024, 20) on B4's xyz ids at r = 20 and 10 and
(conv3, conv4) on conv2's; partseg (32, 2048, 40) on B4's ids at r = 20
of k = 40, a strided rank prefix given to B6 as a copy; each pass's
centre points per tile printed; the spatial rounds at r = 20 timed. And
B7 at the un-fused part segmenter's joint widths (phase2_pseg_gather):
(32, 2048, 40), C = 80, 80, 136, forward and backward bitwise, each timed
beside torch.gather and index_add_.

Phase 2 also holds the part segmenters' training kernels
(phase2_pseg_train) at (32, 2048, 40): B4 on the xyz and on the joint
widths 80, 80, 136, B5 at V_out = 16, B6 binary and FP at SV_DGCNN_PSEG's
widths (32, 16) -> (32, 16), (32, 16) -> (64, 24), (64, 24) -> (128, 40),
inputs chained through the plain versions, to the bars above, the centre
points per tile of each pass printed; B7's forward on the points (C = 3)
bitwise; binary calls timed beside their plain versions (B4 also beside
cdist + topk, B7 beside torch.gather): the kernels line's "pseg train"
entries.

Phase 2 also holds the edge trunk's modes (phase2_edge_modes): B10d and
B10c with exact=False against their plain versions, outputs bitwise, at
the cls shape (128, 1024, 20) on B4's exact ids, inputs chained through
the plain exact=False rounds, binary timed beside the same kernel in
exact mode, B10c FP bitwise (its max difference from exact mode logged:
linear2 through bf16); B4 in fast and approx mode (key tiles of 128, the
fixed 256-lane fold) on each round's input at the cls shape (C = 3, 62,
62, 127) and at the partseg shape (32, 2048, 40; C = 3, 80, 80, 136, the
round2 trunk's round inputs), ids bitwise, one pre-pass a call, timed
beside exact B4 and torch.cdist + torch.topk; and the forced shapes:
B10c at CONV_FORCED's (2, 1000, 7) and (2, 1001, 33) (5, 3) -> (13, 7),
binary and FP; B10d at (2, 1000, 7); B4 at KNN_MODE_FORCED (N = 256 at
the fold, 512 folded to 256 on two key tiles, 384 folded to 192 lanes at
k = 40, ties on key tiles of 64).

Phase 2 also holds the legacy trunks' fast and approx mode
(phase2_legacy): B10b (sv_round2_first, sv_round2) in fast and approx
mode at the cls and partseg shapes and B10a (sv_round_first, sv_round)
with exact=False at the cls shape, key tiles from the engines'
heuristic (T = 256), inputs chained through the plain versions, ids
(B10b) and outputs bitwise, binary timed beside the same kernel in exact
mode, FP bitwise; and LEGACY_FORCED ((B, N, k, T) = (2, 1000, 7, 8),
(2, 1024, 33, 256), (3, 256, 40, 64) with duplicated points, (1, 2048,
64, 128), (2, 512, 20, 512)), every first-round instantiation and
B10b's conv round in both modes, B10a's fast.

Phase 2 also holds the window (phase2_window): B1 and B2 with window=W
against their plain versions, ids and outputs bitwise, at phase 19's cls
shape (16, 8192, 20) on Morton-sorted surface clouds in exact, fast and
approx mode at 16 and 8 bits, binary timed beside the same kernel
without a window, FP bitwise, exact also bitwise the full scan; the
window's scale pre-pass (neg_min over the window) on every round's input
and the prune pre-pass (plain PyTorch) timed; shuffled clouds (the
certificate fails and the kernels scan all N, ok read on the card); the
cls shape (128, 1024, 20), where no W < N certifies surface clouds; and
WINDOW_FORCED (strand clouds at T = 128: k = 33, duplicated points
certified and not, approx L = 48, a batch with one shuffled cloud).

Phase 2 also holds graph reuse (phase2_reuse): B2 on given ids
(sv_round3_reuse, "B2 reuse") at the cls and partseg shapes, conv2-4 on
B1's ids (spatial) and conv3-4 on conv2's, at r = k and r = k/2 (a
strided rank prefix), in exact and approx mode at 16 and 8 bits, binary
and FP, bitwise its plain version on the same ids; the serving pick's
calls timed beside the selecting round on the same input; and
REUSE_FORCED ((B, N, k, r) = (2, 1000, 20, 7), (2, 1001, 33, 33), (3,
256, 40, 20); (5, 3) -> (13, 7) binary and FP, cls conv4's widths
binary; exact, fast and approx at 16 and 8 bits): bitwise its plain
version on the strided prefix and on its contiguous copy, one launch, no
pre-pass.

Phase 2 also holds approx mode (phase2_approx): B1 and B2 with
mode="approx" at 16- and 8-bit gathers against their plain versions, ids
and outputs bitwise, at the cls (fold 256, L = 256) and partseg (fold
512, L = 512) shapes on Morton-sorted clouds, inputs chained through the
plain approx versions, binary timed beside the fast and exact twins, FP
bitwise, B1 cross on the SV-PointNet classifier's weights; and
APPROX_FORCED (N = 1000 folding to L = 250, N = 256 and 1024 to L = 64,
k = 20, 33, 40, 64, N = 200 at or below the fold where the ids must be
fast mode's, duplicated points).

Phase 2 also holds fast mode (phase2_fast): B1 and B2 with mode="fast" at
16- and 8-bit gathers against their plain versions, ids and outputs
bitwise, at the cls (key tile T = 256) and partseg (T = 128) shapes,
inputs chained through the plain fast versions, binary and FP, B1 cross
on the SV-PointNet classifier's weights; each call timed beside the same
kernel in exact mode on the same input; the pre-pass (neg_min, each
centre's farthest candidate) bitwise on every round's input, timed beside
torch.cdist + amax; and FAST_FORCED (N = 1000, 1001, 256; k = 7, 33, 40,
64; T = N where no tile divides N, T = 128 and 64 giving several key
tiles a cloud; duplicated points), every B1 and B2 instantiation. The
pre-passes at forced shapes (phase2_prepass_forced): neg_min bitwise at
PREPASS_FORCED ((B, N, C) = (2, 1000, 5), (2, 1001, 33), (3, 130, 1),
(1, 50, 127), (2, 1024, 62) with duplicated points, (1, 256, 3) one
point repeated: N off the 128-row tiles, C off the 16-channel stage) and
window_tau at k = 1, 20, 40, 384 on duplicated rows.

The last lines of output are the card line, one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, N, K, CLASSES = 128, 1024, 20, 40
B_TRAIN = 32  # the JAX trainer's batch (cli/flags.py, tools/bench_train_step.py)
TRAIN_STEPS = 10
RTOL, ATOL = 1e-4, 1e-5
NEAR_TIE = 1e-5
REQUESTS = 5
SEED = 0
MEDIANS: dict[str, float] = {}  # median request ms by serving phase
# SV-PointNet part segmentation: the JAX bench's shapes (bench.py:177-182)
B_PSEG, N_PSEG, K_PSEG, PARTS = 32, 2048, 40, 50
N_RAGGED_POINT = 1001  # divides by no tile of B8 (binary 128, 64, 32; FP 16, 8)
N_RAGGED = 1000  # the SV-DGCNN kernels' ragged case: no tile divides it
# the least time of a kernel's work: bytes over the HBM rate and real-valued
# operations over the f32 rate outside the tensor cores (NVIDIA H100 SXM
# data sheet, at its 700 W limit); the products of +-1 by +-1 (a binary
# round's linear1, B9) over the rate of the binary tensor cores' AND +
# popcount, the fastest at which the card computes them exactly (one AND
# product a +-1 product, with row and column popcounts). The data sheet
# gives no binary rate: this is the one that `python -m
# svnet_tpu_torch.utils.bench_binary_matmul --rates` measured on an NVIDIA
# H100 80GB HBM3 at 700 W (mma.sync m16n8k256, the faster of its two grids),
# 5.2 times the data sheet's dense int8 rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
PM1_OPS_PER_S = 10241e12


def log(*args):
    print(*args, flush=True)


def cloud(batch: int, n: int, gen, device):
    """Seeded clouds scaled into the unit ball, as ModelNet's are."""
    import torch

    pts = torch.randn(batch, n, 3, generator=gen)
    pts = pts / pts.norm(dim=-1).amax(dim=1)[:, None, None]
    return pts.to(device)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


class Report:
    """Per-kernel results of phase 2: largest compared error, and per
    timed call its ms, plain ms, bound (ms, 'bytes'/'operations') and the
    library call's ms (or None)."""

    def __init__(self):
        self.err: dict[str, float] = {}
        self.ms: dict[str, list] = {}
        self.grad_rel: dict[str, float] = {}  # training rounds, per call

    def add(self, name, err, ms=None, plain_ms=None, bound=None, library_ms=None):
        self.err[name] = max(self.err.get(name, 0.0), err)
        if ms is not None:
            self.ms.setdefault(name, []).append((ms, plain_ms, bound, library_ms))


def bound(flops: float, nbytes: float, pm1_flops: float = 0.0):
    """(least ms, what bounds it) of a call moving nbytes, doing flops
    real-valued operations and pm1_flops of +-1 by +-1 products."""
    t_ops = flops / F32_FLOP_PER_S + pm1_flops / PM1_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def knn_flops(b, n, c):
    """Distances of all pairs: c multiply-adds, then 2*inner - |x|^2 - |y|^2."""
    return b * n * n * (2.0 * c + 3.0)


def neg_min_flops(b, n, c):
    """The pre-pass's least work: the inner products of the n (n + 1) / 2
    unordered pairs (an inner product serves both centres), then every
    ordered pair's 2*inner - |x|^2 - |y|^2."""
    return b * (n * (n + 1) / 2.0 * 2.0 * c + n * n * 3.0)


def neg_min_window_flops(keep, T, c):
    """The windowed pre-pass's least work on a certified batch: the inner
    products of each 128 x 128 tile (I <= J) of a cloud that feeds either
    side (an inner product serves both; a diagonal tile's n (n + 1) / 2
    pairs), then 2*inner - |x|^2 - |y|^2 for each ordered pair that is fed.
    keep (B, N/T, N/128): tile I's rows take block J where keep[b, I*128/T,
    J] is set."""
    import torch

    nt = keep.shape[-1]
    rows = torch.arange(nt, device=keep.device) * 128 // T
    fed = keep[:, rows, :] != 0  # (B, I, J)
    either = fed | fed.transpose(1, 2)
    diag = int(torch.diagonal(either, dim1=1, dim2=2).sum())
    off = (int(either.sum()) - diag) // 2
    return (off * 128.0 * 128 + diag * 128.0 * 129 / 2) * 2.0 * c + \
        int(fed.sum()) * 128.0 * 128 * 3.0


def edge_flops(S, V, S_out, V_out, first=False, binary=False, cross=False):
    """Operations of one edge of an SV round, as (real-valued, +-1 by +-1):
    Vector2Scalar frames and invariants (two streams in the first round,
    over 2 or, with the cross product, 3 edge channels), linear1 over
    [scalars | invariants] (signs by signs when binary), linear2 over the
    3 x 2V vector rows, BN, leaky, norms and pooling."""
    twoV = (3 if cross else 2) if first else 2 * V
    IN1 = (3 * twoV if first else 2 * S) + 3 * twoV
    streams = 2 if first else 1
    linear1 = 2.0 * IN1 * S_out
    rest = (streams * (9 * twoV * 2 + 3 * twoV * 5) + 3 * twoV * V_out * 2
            + 6 * S_out + 14 * V_out + (9 if cross else 0))
    return (rest, linear1) if binary else (rest + linear1, 0.0)


def point_cost(b, n, S, V, S_out, V_out, binary):
    """(real-valued operations, bytes, +-1 by +-1 operations) of one B8
    call: frames and invariants, linear1 (signs by signs when binary, after
    x + beta and sign), BN and leaky, linear2 * scale2, VectorBN and gate;
    src read, s and v written once, weights read once."""
    Cin = S + 3 * V
    real = (9 * V * 2 + 3 * V * 5 + 3 * S_out + 3 * V * V_out * 2
            + 3 * V_out + 14 * V_out)
    linear1 = 2.0 * Cin * S_out
    weights = 3 * V + Cin * S_out + Cin + 2 * S_out + V * V_out + 3 * V_out
    nbytes = 4.0 * (b * n * (Cin + S_out + 3 * V_out) + b * V_out + weights)
    if binary:
        return b * n * (real + 2 * Cin), nbytes, b * n * linear1
    return b * n * (real + linear1), nbytes, 0.0


def check_ids(tag, wk, wp, feats):
    """Neighbour-id agreement of kernel (wk) and plain (wp) ids (B, k, N);
    feats (B, N, C) are the features the distances were taken over.
    Returns the (B, N) mask of centre points whose neighbour sets agree."""
    import torch

    wk, wp = wk.long(), wp.long()
    eq = wk == wp
    frac = eq.float().mean().item()
    bad = (~eq).nonzero()
    worst = 0.0
    if len(bad):
        b, n = bad[:, 0], bad[:, 2]
        f = feats.double()
        ctr = f[b, n]
        dk = ((f[b, wk[b, bad[:, 1], n]] - ctr) ** 2).sum(-1)
        dp = ((f[b, wp[b, bad[:, 1], n]] - ctr) ** 2).sum(-1)
        rel = (dk - dp).abs() / torch.maximum(torch.maximum(dk, dp),
                                              torch.full_like(dk, 1e-30))
        worst = rel.max().item()
    log(f"  {tag}: ids agree {frac:.6f} ({len(bad)} mismatches, worst "
        f"relative distance gap {worst:.3g})")
    if frac < 0.9999:
        raise AssertionError(f"{tag}: neighbour ids agree on {frac} < 0.9999")
    if worst > NEAR_TIE:
        raise AssertionError(f"{tag}: a mismatch is not a near-tie ({worst})")
    same = torch.sort(wk, dim=1).values == torch.sort(wp, dim=1).values
    return same.all(dim=1)  # (B, N)


def check_close(tag, got, want, cols=None):
    """got/want (B, C, N) compared on the centre columns ``cols`` (B, N),
    or (B, C) compared as a whole. Returns the max abs error."""
    if cols is not None:
        got = got.transpose(1, 2)[cols]
        want = want.transpose(1, 2)[cols]
    err = (got - want).abs()
    over = err - (ATOL + RTOL * want.abs())
    if not bool((over <= 0).all()):
        raise AssertionError(
            f"{tag}: max abs err {err.max().item():.3g} beyond rtol={RTOL}, "
            f"atol={ATOL} ({int((over > 0).sum())} elements)")
    return err.max().item() if err.numel() else 0.0


def compare_round(rep, tag, name, kern, plain, feats, time_it, cost,
                  view=lambda out: out, bitwise=False):
    """Kernel outputs (s, v, gate stats, wins) against the plain version's;
    cost = (flops, bytes) of the call; ``view`` shows a row-major round's
    outputs channel-major, ids (B, k, N); ``bitwise``: every output and id
    must be torch.equal (a binary conv round's contract). Returns the plain
    outputs."""
    ko, po = kern(), plain()
    sync(ko[0].device)
    same = all(torch_equal(g, w) for g, w in zip(ko, po))
    if bitwise and not same:
        check_equal(tag, ko, po)  # raises with the largest difference
    kv, pv = view(ko), view(po)
    agree = check_ids(tag, kv[3], pv[3], feats)
    err = max(check_close(tag + " s", kv[0], pv[0], agree),
              check_close(tag + " v", kv[1], pv[1], agree))
    whole = agree.all(dim=1)  # batches whose every neighbour set agrees
    if bool(whole.any()):
        err = max(err, check_close(tag + " gate stats", kv[2][whole],
                                   pv[2][whole]))
    ms = plain_ms = None
    if time_it:
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    log(f"  {tag}: outputs max abs err {err:.3g} on {int(agree.sum())} "
        f"of {agree.numel()} points, bitwise {same}; kernel {ms} ms, plain "
        f"{plain_ms} ms, bound {bound(*cost)}")
    rep.add(name, err, ms, plain_ms, bound(*cost))
    return po


def as_cm(out):
    """A row-major round's outputs as channel-major views, ids (B, k, N)."""
    return (out[0].transpose(1, 2), out[1].transpose(1, 2), out[2],
            out[3].transpose(1, 2))


def dgcnn_kernels(row_major: bool):
    """(first, its plain version, conv round, plain, point block, plain) of
    the round3 trunk (B1, B2, B3) or the round2 trunk (B10b, B3r)."""
    from svnet_tpu_torch.ops.kernels import sv_point as kp
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    if row_major:
        return (k2.sv_round2_first, k2.sv_round2_first_plain, k2.sv_round2,
                k2.sv_round2_plain, kp.sv_point_block, kp.sv_point_block_plain)
    return (kr.sv_round3_first, kr.sv_round3_first_plain, kr.sv_round3,
            kr.sv_round3_plain, kp.sv_point_block_cm, kp.sv_point_block_cm_plain)


def kernel_name(fn, tag, row_major):
    """The kernels line's name: the classifier's round3 kernels keep their
    bare names, every other (trunk, model) pair is tagged."""
    return fn.__name__ if tag == "cls" and not row_major else f"{fn.__name__} {tag}"


def phase2(rep, tag, eng, eng_fp, gen, dev, b, n, k):
    """An SV-DGCNN engine's trunk kernels against their plain versions at
    (b, n, k): B1, B2 x3 and B3 for a round3 engine, B10b (first and x3)
    and B3r for a round2 one, inputs chained through the plain versions;
    then a ragged (8, 1000, 7) case."""
    import torch

    from svnet_tpu_torch.infer import se_gate

    rm = eng.row_major
    f_k, f_p, r_k, r_p, p_k, p_p = dgcnn_kernels(rm)
    names = [kernel_name(fn, tag, rm) for fn in (f_k, r_k, p_k)]
    view = as_cm if rm else (lambda out: out)
    dim = -1 if rm else 1  # the channel axis
    S1, V1 = eng.dims["conv1"]

    def first(pts, kk, label, time_it):
        f = eng.folded_first
        kw = dict(S_out=S1, V_out=V1, k=kk)
        bb, nn = pts.shape[:2]
        ef, pm1 = edge_flops(0, 1, S1, V1, True)
        cost = (knn_flops(bb, nn, 3) + bb * nn * kk * ef,
                4.0 * bb * nn * (3 + S1 + 3 * V1 + 6 + kk), bb * nn * kk * pm1)
        return compare_round(
            rep, label, names[0],
            lambda: f_k(pts, f, emit_wins=True, **kw),
            lambda: f_p(pts, f, **kw), pts, time_it, cost, view)

    def conv(src, e, name, kk, label, time_it):
        S, V, S_out, V_out = e.rounds[name]
        kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=kk, binary=e.binary)
        f = e.folded[name]
        feats = src if rm else src.transpose(1, 2)
        bb, nn, C = feats.shape
        ef, pm1 = edge_flops(S, V, S_out, V_out, binary=e.binary)
        cost = (knn_flops(bb, nn, C) + bb * nn * kk * ef,
                4.0 * bb * nn * (C + S_out + 3 * V_out + 2 * S + kk),
                bb * nn * kk * pm1)
        return compare_round(
            rep, label, names[1],
            lambda: r_k(src, f, emit_wins=True, **kw),
            lambda: r_p(src, f, **kw), feats, time_it, cost, view,
            bitwise=e.binary)

    def gated(p, out):
        g = se_gate(p, out[2]).repeat(1, 3)
        return out[1] * (g[:, None, :] if rm else g[:, :, None])

    def point(src5, g5, label, time_it):
        kw = dict(S=eng.S_c, V=eng.V_c, S_out=eng.S5, V_out=eng.V5,
                  binary=True)
        if not rm:
            kw["v_off"] = eng.v_off
        fp_ = eng.folded_point

        def kern():
            return p_k(src5, g5, fp_, **kw)

        def plain():
            return p_p(src5, g5, fp_, **kw)

        ko, pl = kern(), plain()
        sync(dev)
        check_equal(f"{label} binary", ko, pl)
        kw_fp = dict(kw, binary=False)
        check_equal(f"{label} fp", p_k(src5, g5, eng_fp.folded_point, **kw_fp),
                    p_p(src5, g5, eng_fp.folded_point, **kw_fp))
        ms = plain_ms = None
        if time_it:
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        bb = src5.shape[0]
        nn = src5.shape[1] if rm else src5.shape[2]
        S, V, S5, V5 = eng.S_c, eng.V_c, eng.S5, eng.V5
        # linear1 takes signs by signs; the rest is real-valued
        per_point = (2.0 * 3 * V * V5 + 9 * V * 2 + 3 * V * 5 + 9 * V5 * 2
                     + 3 * V5 * 5 + 6 * S5 + 14 * V5)
        cost = bound(bb * nn * per_point,
                     4.0 * bb * nn * (S + 3 * V + S5 + 3 * V5),
                     bb * nn * 2.0 * (S + 3 * V) * S5)
        log(f"  {label}: x, s5_max, v5_mean bitwise (binary and fp); kernel "
            f"{ms} ms, plain {plain_ms} ms, bound {cost}")
        rep.add(names[2], 0.0, ms, plain_ms, cost if time_it else None)

    # main shapes, inputs chained through the plain versions; B4 on the
    # round3 engine's inputs of each round (the edge trunk's shapes)
    trunk = f"{tag} {eng.trunk}"
    pts = cloud(b, n, gen, dev)
    if not rm:
        compare_knn(rep, f"knn {tag} B={b} N={n} C=3 k={k}", pts, k, True)
    po = first(pts, k, f"{names[0]} B={b} N={n} k={k}", True)
    outs = [(po[0], gated(eng.p["conv1"], po))]
    for name in eng.rounds:
        src = torch.cat(outs[-1], dim=dim).contiguous()
        if not rm:
            feats = src.transpose(1, 2).contiguous()
            compare_knn(rep, f"knn {tag} B={b} N={n} C={feats.shape[-1]} "
                        f"k={k} ({name})", feats, k, True)
        po = conv(src, eng, name, k, f"{names[1]} {name} binary", True)
        conv(src, eng_fp, name, k, f"{names[1]} {name} fp", False)
        outs.append((po[0], gated(eng.p[name], po)))
    s = torch.cat([o[0] for o in outs], dim=dim)
    if rm:
        v = torch.cat([o[1].reshape(b, n, 3, -1) for o in outs], dim=-1)
        src5 = torch.cat([s, v.flatten(2)], dim=-1).contiguous()
        g5 = se_gate(eng.p["conv5"], s.transpose(1, 2).contiguous().mean(dim=2))
    else:
        v = torch.cat([o[1] for o in outs], dim=1)
        src5 = torch.cat([s, v], dim=1).contiguous()
        g5 = se_gate(eng.p["conv5"], s.mean(dim=2))
    point(src5, g5.contiguous(), f"{p_k.__name__} {trunk} B={b} N={n}", True)

    # ragged: N and k divide no tile, N no block of the point kernel
    b_r, n_r = 8, N_RAGGED
    pts = cloud(b_r, n_r, gen, dev)
    po = first(pts, 7, f"{names[0]} ragged B={b_r} N={n_r} k=7", False)
    src = torch.cat([po[0], gated(eng.p["conv1"], po)], dim=dim).contiguous()
    conv(src, eng, "conv2", 7, f"{names[1]} conv2 ragged B={b_r} N={n_r} k=7",
         False)
    C5 = eng.S_c + 3 * eng.V_c
    src5 = torch.randn(b_r, n_r, C5, generator=gen).to(dev)
    if not rm:
        src5 = src5.transpose(1, 2).contiguous()
    g5 = torch.rand(b_r, eng.V5, generator=gen).to(dev)
    point(src5, g5, f"{p_k.__name__} {trunk} ragged B={b_r} N={n_r}", False)


def check_equal(tag, got, want):
    """Kernel outputs bitwise equal to the plain version's."""
    import torch

    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            err = ((g.double() - w.double()).abs().max().item()
                   if g.shape == w.shape else float("inf"))
            raise AssertionError(f"{tag}: kernel and plain version differ "
                                 f"(max abs err {err})")


class Tap:
    """Stands in for an SV-PointNet engine's per-point block function: it
    calls that function, adds the B8 launches each call made to the tally
    of the call's widths (S, V, S_out, V_out), and keeps the call's inputs
    when ``keep``."""

    def __init__(self, eng, keep=False):
        from svnet_tpu_torch.ops.kernels import sv_block_point as kb

        self.eng, self.fn, self.keep, self.kb = eng, eng._block, keep, kb
        self.calls, self.launches = [], {}
        eng._block = self

    def __call__(self, src, gate, folded, **kw):
        before = self.kb.sv_block_point.launches
        out = self.fn(src, gate, folded, **kw)
        key = (kw["S"], kw["V"], kw["S_out"], kw["V_out"])
        self.launches[key] = (self.launches.get(key, 0)
                              + self.kb.sv_block_point.launches - before)
        if self.keep:
            self.calls.append((src, gate, folded, kw))
        return out

    def close(self):
        self.eng._block = self.fn


def b8_name(tag, key):
    return f"sv_block_point {tag} {key[0]},{key[1]}->{key[2]},{key[3]}"


def phase2_pointnet(rep, pn, gen, dev):
    """B1 with cross and B8 against their plain versions at the SV-PointNet
    engines' shapes: B8 on the block inputs of one request through each
    plain engine (binary and FP), then a ragged N at the widest blocks."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_block_point as kb
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    for tag, (b, n, k) in (("cls", (B, N, K)), ("pseg", (B_PSEG, N_PSEG, K_PSEG))):
        engs = pn[tag]
        pts = cloud(b, n, gen, dev)
        args = (pts,) if tag == "cls" else (pts, pn["labels"](b, gen))
        f = engs["kernel"].folded_first
        kw = dict(S_out=32, V_out=10, k=k, cross=True)

        def kern():
            return kr.sv_round3_first(pts, f, emit_wins=True, **kw)

        def plain():
            return kr.sv_round3_first_plain(pts, f, **kw)

        ko, po = kern(), plain()
        sync(dev)
        check_equal(f"sv_round3_first cross {tag}", ko, po)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        ef, _ = edge_flops(0, 1, 32, 10, first=True, cross=True)
        cost = bound(knn_flops(b, n, 3) + b * n * k * ef,
                     4.0 * b * n * (3 + 32 + 30 + 9 + k))
        log(f"  sv_round3_first cross B={b} N={n} k={k}: ids and outputs "
            f"bitwise; kernel {ms} ms, plain {plain_ms} ms, bound {cost}")
        rep.add(f"sv_round3_first cross {tag}", 0.0, ms, plain_ms, cost)

        for binary in (True, False):
            oracle = engs["oracle" if binary else "oracle_fp"]
            tap = Tap(oracle, keep=True)
            oracle(*args)
            tap.close()
            for src, gate, folded, bkw in tap.calls:
                key = (bkw["S"], bkw["V"], bkw["S_out"], bkw["V_out"])

                def kern():
                    return kb.sv_block_point(src, gate, folded, **bkw)

                def plain():
                    return kb.sv_block_point_plain(src, gate, folded, **bkw)

                label = (f"{b8_name(tag, key)} {'binary' if binary else 'fp'}"
                         f" B={b} N={n}")
                ko, po = kern(), plain()
                sync(dev)
                check_equal(label, ko, po)
                if not binary:
                    log(f"  {label}: bitwise")
                    continue
                ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
                cost = bound(*point_cost(b, n, *key, binary))
                log(f"  {label} ({kb.points_per_block(*key)} points per "
                    f"block): bitwise; kernel {ms} ms, plain {plain_ms} ms, "
                    f"bound {cost}")
                rep.add(b8_name(tag, key), 0.0, ms, plain_ms, cost)
            del tap

        # ragged: N divides by no block size
        name = "conv_fuse" if tag == "cls" else "conv5"
        for binary in (True, False):
            (S, V, S_out, V_out), folded, _ = engs[
                "oracle" if binary else "oracle_fp"].blocks[name]
            src = torch.randn(8, N_RAGGED_POINT, S + 3 * V, generator=gen).to(dev)
            gate = torch.rand(8, V_out, generator=gen).to(dev)
            bkw = dict(S=S, V=V, S_out=S_out, V_out=V_out, binary=binary)
            label = (f"sv_block_point {name} {'binary' if binary else 'fp'} "
                     f"ragged B=8 N={N_RAGGED_POINT}")
            check_equal(label, kb.sv_block_point(src, gate, folded, **bkw),
                        kb.sv_block_point_plain(src, gate, folded, **bkw))
            log(f"  {label} ({kb.points_per_block(S, V, S_out, V_out, binary)} "
                "points per block): bitwise")


def serve(tag, eng, oracle, requests, counters, want_per, card):
    """Serve the requests through ``eng`` with the launch counts checked
    per request, then through the plain engine; returns (outputs, plain
    outputs, the B8 tally by widths, launches by counter)."""
    import torch

    eng(*requests[0])  # warm-up, outside the counted run
    torch.cuda.synchronize()
    tap = Tap(eng) if hasattr(eng, "_block") else None
    for fn in counters:
        fn.launches = 0
    outs, lat = [], []
    for req in requests:
        before = [fn.launches for fn in counters]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = eng(*req)
        e1.record()
        torch.cuda.synchronize()
        lat.append(e0.elapsed_time(e1))
        per = {fn.__name__: fn.launches - b0 for fn, b0 in zip(counters, before)}
        want = {name: want_per.get(name, 0) for name in per}
        if per != want:
            raise AssertionError(f"{tag}: launches per request {per} != {want}")
        outs.append(out)
    tally = {}
    if tap is not None:
        tap.close()
        tally = tap.launches
    launches = {fn.__name__: fn.launches for fn in counters}
    want, plain_lat = [], []
    for req in requests:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want.append(oracle(*req))
        e1.record()
        torch.cuda.synchronize()
        plain_lat.append(e0.elapsed_time(e1))
    log(f"{tag}: {len(requests)} requests of {tuple(requests[0][0].shape)}; "
        f"launches { {n: c for n, c in launches.items() if c} }"
        + (f"; B8 launches by widths {tally}" if tap is not None else ""))
    MEDIANS[tag] = sorted(lat)[len(lat) // 2]
    log(f"{tag}: latency per request (CUDA events, ms) kernels "
        f"{[round(t, 3) for t in lat]} median {MEDIANS[tag]:.3f}; "
        f"plain {[round(t, 3) for t in plain_lat]} | {card}")
    return torch.cat(outs), torch.cat(want), tally, launches


def phase7(pn, gen, dev, counters, card):
    import torch

    from svnet_tpu_torch.ops import rotations

    engs = pn["cls"]
    requests = [(cloud(B, N, gen, dev),) for _ in range(REQUESTS)]
    got, want, tally, launches = serve(
        "phase 7", engs["kernel"], engs["oracle"], requests, counters,
        {"sv_round3_first": 1, "sv_block_point": 7}, card)
    if got.shape != (REQUESTS * B, CLASSES) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"phase 7: logits {tuple(got.shape)} not finite "
                             f"({REQUESTS * B}, {CLASSES})")
    top1 = (got.argmax(1) == want.argmax(1)).float().mean().item()
    log(f"phase 7: top-1 agreement with the plain engine {top1:.4f}; max "
        f"|dlogit| {(got - want).abs().max().item():.4g} (logit scale "
        f"{want.abs().max().item():.4g})")
    if top1 < 0.99:
        raise AssertionError(f"phase 7: top-1 agreement {top1} < 0.99")
    pts = cloud(16, N, gen, dev)
    rot = rotations.random_rotations(16, gen).to(dev)
    out = engs["kernel_fp"](pts)
    out_r = engs["kernel_fp"](rotations.rotate_points(pts, rot))
    log(f"phase 7: SO(3) invariance (FP engine, kernels): max |dlogit| "
        f"{(out_r - out).abs().max().item():.3g} (logit scale "
        f"{out.abs().max().item():.3g})")
    if not torch.allclose(out_r, out, rtol=2e-2, atol=2e-3):
        raise AssertionError("phase 7: logits not rotation invariant")
    return tally, launches


def phase8(pn, gen, dev, counters, card):
    import torch

    engs = pn["pseg"]
    requests = [(cloud(B_PSEG, N_PSEG, gen, dev), pn["labels"](B_PSEG, gen))
                for _ in range(REQUESTS)]
    got, want, tally, launches = serve(
        "phase 8", engs["kernel"], engs["oracle"], requests, counters,
        {"sv_round3_first": 1, "sv_block_point": 8}, card)
    if (got.shape != (REQUESTS * B_PSEG, N_PSEG, PARTS)
            or not bool(torch.isfinite(got).all())):
        raise AssertionError(f"phase 8: logits {tuple(got.shape)} not finite")
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"phase 8: per-point top-1 agreement with the plain engine "
        f"{agree:.6f}; max |dlogit| {(got - want).abs().max().item():.4g} "
        f"(logit scale {want.abs().max().item():.4g})")
    if agree < 0.99:
        raise AssertionError(f"phase 8: per-point agreement {agree} < 0.99")
    return tally, launches


def dgcnn_engines(dev, w_bin, w_fp):
    """The SV-DGCNN engines of phases 2 and 12-14 besides phase 3's:
    partseg on seeded weights, both trunks, binary with kernels and plain
    and FP with kernels, and the partseg engines asked for "round" and
    "edge" (which run round2); the classifier's round2, round and edge
    trunks on phase 3's weights."""
    import torch

    from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVDGCNNPsegEngine
    from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg

    p_bin = init_params_pseg(PARTS, K_PSEG, True,
                             torch.Generator().manual_seed(SEED + 12))
    p_fp = init_params_pseg(PARTS, K_PSEG, False,
                            torch.Generator().manual_seed(SEED + 13))
    out = {}
    for impl in ("round3", "round2"):
        out[f"pseg {impl}"] = {
            "kernel": SVDGCNNPsegEngine(p_bin, PARTS, K_PSEG, True, device=dev,
                                        rounds_impl=impl),
            "oracle": SVDGCNNPsegEngine(p_bin, PARTS, K_PSEG, True, device=dev,
                                        rounds_impl=impl, oracle=True),
            "kernel_fp": SVDGCNNPsegEngine(p_fp, PARTS, K_PSEG, False,
                                           device=dev, rounds_impl=impl)}
    for impl in ("round2", "round", "edge"):
        out[f"cls {impl}"] = {
            "kernel": SVDGCNNClsEngine(w_bin, CLASSES, K, True, device=dev,
                                       rounds_impl=impl),
            "oracle": SVDGCNNClsEngine(w_bin, CLASSES, K, True, device=dev,
                                       rounds_impl=impl, oracle=True),
            "kernel_fp": SVDGCNNClsEngine(w_fp, CLASSES, K, False, device=dev,
                                          rounds_impl=impl)}
        if impl != "round2":  # the part segmenter runs round2 for them
            out[f"pseg {impl}"] = {"kernel": SVDGCNNPsegEngine(
                p_bin, PARTS, K_PSEG, True, device=dev, rounds_impl=impl)}
    return out


def labels(b, gen, dev):
    """Seeded one-hot object categories (B, 16)."""
    import torch

    cat = torch.randint(0, 16, (b,), generator=gen)
    return torch.nn.functional.one_hot(cat, 16).float().to(dev)


def agreement(tag, got, want):
    """Top-1 agreement over the last axis (clouds or points), required
    >= 0.99; returns it."""
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"{tag}: top-1 agreement {top1:.6f}; max |dlogit| "
        f"{(got - want).abs().max().item():.4g} (logit scale "
        f"{want.abs().max().item():.4g}); bitwise {bool(torch_equal(got, want))}")
    if top1 < 0.99:
        raise AssertionError(f"{tag}: top-1 agreement {top1} < 0.99")
    return top1


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def phase12(dg, gen, dev, counters, card):
    """SV-DGCNN part segmentation serving through the round3 trunk."""
    import torch

    from svnet_tpu_torch.ops import rotations

    engs = dg["pseg round3"]
    requests = [(cloud(B_PSEG, N_PSEG, gen, dev), labels(B_PSEG, gen, dev))
                for _ in range(REQUESTS)]
    got, want, _, launches = serve(
        "phase 12", engs["kernel"], engs["oracle"], requests, counters,
        {"sv_round3_first": 1, "sv_round3": 3, "sv_point_block_cm": 1}, card)
    if (got.shape != (REQUESTS * B_PSEG, N_PSEG, PARTS)
            or not bool(torch.isfinite(got).all())):
        raise AssertionError(f"phase 12: logits {tuple(got.shape)} not finite")
    agreement("phase 12: per-point, vs the plain engine", got, want)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    engs["kernel"](*requests[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    log(f"phase 12: peak device memory of a request {peak / 2**30:.3f} GiB "
        "above the engine's weights")
    pts, lab = cloud(4, N_PSEG, gen, dev), labels(4, gen, dev)
    rot = rotations.random_rotations(4, gen).to(dev)
    out = engs["kernel_fp"](pts, lab)
    out_r = engs["kernel_fp"](rotations.rotate_points(pts, rot), lab)
    log(f"phase 12: SO(3) invariance (FP engine, kernels): max |dlogit| "
        f"{(out_r - out).abs().max().item():.3g} (logit scale "
        f"{out.abs().max().item():.3g})")
    if not torch.allclose(out_r, out, rtol=2e-2, atol=2e-3):
        raise AssertionError("phase 12: logits not rotation invariant")
    return launches, peak


def phase13(dg, eng3, gen, dev, counters, card):
    """The round2 trunk of both SV-DGCNN engines at their full shapes:
    against its plain twin and against the round3 engine on the same
    weights (the same function, the same arithmetic)."""
    import torch

    want_per = {"sv_round2_first": 1, "sv_round2": 3, "sv_point_block": 1}
    out = {}
    for tag, shape, round3 in (
            ("cls", (B, N), eng3),
            ("pseg", (B_PSEG, N_PSEG), dg["pseg round3"]["kernel"])):
        engs = dg[f"{tag} round2"]
        b, n = shape
        requests = [(cloud(b, n, gen, dev),) + (
            (labels(b, gen, dev),) if tag == "pseg" else ())
            for _ in range(REQUESTS)]
        got, want, _, launches = serve(
            f"phase 13 {tag}", engs["kernel"], engs["oracle"], requests,
            counters, want_per, card)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"phase 13 {tag}: logits not finite")
        agreement(f"phase 13 {tag}: round2 vs its plain engine", got, want)
        r3 = torch.cat([round3(*req) for req in requests])
        agreement(f"phase 13 {tag}: round2 vs the round3 engine", got, r3)
        out[tag] = launches
    return out


def phase2_round_edge(rep, eng, eng_fp, gen, dev, b, n, k, time_it):
    """B10a (first and conv rounds), B10d and B10c (conv rounds) against
    their plain versions at (b, n, k), inputs chained through the plain
    round trunk: outputs bitwise, B10a also bitwise B10b's on the same
    input; B10d and B10c read the same B4 ids on both sides and B10c the
    same host gate, so the block alone is compared."""
    import torch

    from svnet_tpu_torch.infer import se_gate
    from svnet_tpu_torch.ops.kernels import sv_edge as ke
    from svnet_tpu_torch.ops.kernels import sv_edge_first as kf
    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels.knn import knn

    shape = f"B={b} N={n} k={k}"

    def compare(name, label, kern, plain, r2, cost, timed=time_it):
        ko, po = kern(), plain()
        sync(dev)
        check_equal(label, ko, po)
        if r2 is not None:
            check_equal(label + " vs B10b", ko, r2())
        ms = plain_ms = None
        if timed:
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        log(f"  {label}: bitwise the plain version"
            + (", and B10b's" if r2 is not None else "")
            + f"; kernel {ms} ms, plain {plain_ms} ms, bound {bound(*cost)}")
        rep.add(name, 0.0, ms, plain_ms, bound(*cost))
        return po

    S1, V1 = eng.dims["conv1"]
    pts = cloud(b, n, gen, dev)
    f, kw = eng.folded_first, dict(S_out=S1, V_out=V1, k=k)
    ef, pm1 = edge_flops(0, 1, S1, V1, True)
    out_b = 4.0 * b * n * (S1 + 3 * V1 + 6)
    po = compare("sv_round_first", f"sv_round_first {shape}",
                 lambda: k1.sv_round_first(pts, f, **kw),
                 lambda: k1.sv_round_first_plain(pts, f, **kw),
                 lambda: k2.sv_round2_first(pts, f, **kw),
                 (knn_flops(b, n, 3) + b * n * k * ef,
                  4.0 * b * n * 3 + out_b, b * n * k * pm1))
    idx = knn(pts, k)
    compare("sv_edge_first_block", f"sv_edge_first_block {shape}",
            lambda: kf.sv_edge_first_block(pts, idx, f, **kw),
            lambda: kf.sv_edge_first_block_plain(pts, idx, f, **kw), None,
            (b * n * k * ef, 4.0 * b * n * (3 + k) + out_b, b * n * k * pm1))
    g = se_gate(eng.p["conv1"], po[2]).repeat(1, 3)
    outs = [(po[0], po[1] * g[:, None, :])]
    for name in eng.rounds if time_it else ("conv2",):
        S, V, S_out, V_out = eng.rounds[name]
        src = torch.cat(outs[-1], dim=-1).contiguous()
        idx = knn(src, k)
        for e, tag in ((eng, "binary"), (eng_fp, "fp")):
            kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k,
                      binary=e.binary)
            f, t = e.folded[name], time_it and tag == "binary"
            ef, pm1 = edge_flops(S, V, S_out, V_out, binary=e.binary)
            C = S + 3 * V
            out_b = 4.0 * b * n * (S_out + 3 * V_out)
            rp = compare(
                "sv_round", f"sv_round {name} {tag} {shape}",
                lambda: k1.sv_round(src, f, **kw),
                lambda: k1.sv_round_plain(src, f, **kw),
                lambda: k2.sv_round2(src, f, **kw),
                (knn_flops(b, n, C) + b * n * k * ef,
                 4.0 * b * n * (C + 2 * S) + out_b, b * n * k * pm1), t)
            gate = ke.svblock_gate(e.p[name], src[..., :S], idx)
            compare(
                "sv_edge_block", f"sv_edge_block {name} {tag} {shape}",
                lambda: ke.sv_edge_block(src, idx, gate, f, **kw),
                lambda: ke.sv_edge_block_plain(src, idx, gate, f, **kw), None,
                (b * n * k * ef, 4.0 * (b * n * (C + k) + b * V_out) + out_b,
                 b * n * k * pm1), t)
            if tag == "binary":
                g = se_gate(e.p[name], rp[2]).repeat(1, 3)
                outs.append((rp[0], rp[1] * g[:, None, :]))


def phase14(dg, eng3, gen, dev, counters, card):
    """The classifier's round and edge trunks: 5 requests of (128, 1024, 3)
    each, launches per request checked, top-1 against the plain engine and
    against the round3 engine; round against the round2 engine (bitwise
    expected); then the part segmenter asked for "round" and "edge", which
    launches the round2 kernels only (C14)."""
    import torch

    out = {}
    for impl, want_per in (
            ("round", {"sv_round_first": 1, "sv_round": 3,
                       "sv_point_block": 1}),
            ("edge", {"knn": 4, "sv_edge_first_block": 1, "sv_edge_block": 3,
                      "sv_point_block": 1})):
        engs = dg[f"cls {impl}"]
        requests = [(cloud(B, N, gen, dev),) for _ in range(REQUESTS)]
        got, want, _, launches = serve(
            f"phase 14 {impl}", engs["kernel"], engs["oracle"], requests,
            counters, want_per, card)
        if (got.shape != (REQUESTS * B, CLASSES)
                or not bool(torch.isfinite(got).all())):
            raise AssertionError(f"phase 14 {impl}: logits {tuple(got.shape)} "
                                 f"not finite ({REQUESTS * B}, {CLASSES})")
        agreement(f"phase 14 {impl}: vs its plain engine", got, want)
        r3 = torch.cat([eng3(*req) for req in requests])
        agreement(f"phase 14 {impl}: vs the round3 engine", got, r3)
        if impl == "round":
            r2 = torch.cat([dg["cls round2"]["kernel"](*req) for req in requests])
            log(f"phase 14 round: bitwise the round2 engine {torch_equal(got, r2)}")
        out[impl] = launches
    req = (cloud(B_PSEG, N_PSEG, gen, dev), labels(B_PSEG, gen, dev))
    r2 = dg["pseg round2"]["kernel"](*req)
    for impl in ("round", "edge"):
        before = [fn.launches for fn in counters]
        got = dg[f"pseg {impl}"]["kernel"](*req)
        sync(dev)
        per = {fn.__name__: fn.launches - b0
               for fn, b0 in zip(counters, before) if fn.launches - b0}
        want = {"sv_round2_first": 1, "sv_round2": 3, "sv_point_block": 1}
        if per != want:
            raise AssertionError(f"phase 14 pseg {impl}: launches {per} != {want}")
        log(f"phase 14: partseg asked for {impl!r} launches {per}; bitwise the "
            f"round2 engine {torch_equal(got, r2)}")
    return out


# (M, K, N) of B9 off its 16 x 8 MMA tiles and its 64 x 64 and 128 x 128
# block tiles (the last shape runs on the 128 x 128), with 1, 7, 10 and 33
# packed words a row (the MMA depth is 8, a chunk 16)
XNOR_RAGGED = ((130, 32, 9), (257, 224, 129), (17, 320, 250), (300, 1056, 131),
               (2100, 320, 2100))


def phase15(rep, counters, card):
    """Kernel B9 through the bench's main at the bench's shape, a ragged
    one and XNOR_RAGGED: exact against the dense product and bitwise
    against the plain version (main raises otherwise), and the kernel's,
    the int8 and the bf16 library products' times. Its launches are the
    bench's: the checks and every timed call."""
    from svnet_tpu_torch.ops.kernels import binary_matmul as kb
    from svnet_tpu_torch.utils import bench_binary_matmul

    for fn in counters:
        fn.launches = 0
    for M, Kd, Nd in ((4096, 2048, 512), (1000, 96, 77), *XNOR_RAGGED):
        res = bench_binary_matmul.main(M, Kd, Nd)
        L = Kd // 32
        cost = bound(0.0, 4.0 * (M * L + Nd * L + M * Nd), 2.0 * M * Kd * Nd)
        log(f"phase 15: ({M}, {Kd}, {Nd}) exact {res['exact_vs_dense']}, "
            f"bitwise the plain version {res['bitwise_vs_plain']}; kernel "
            f"{res['kernel_ms']} ms (with the packing {res['call_ms']}), plain "
            f"{res['plain_ms']}, torch._int_mm {res['int8_ms']} (exact "
            f"{res['int8_exact']}), bf16 torch.mm {res['bf16_ms']} (exact "
            f"{res['bf16_exact']}), bound {cost} | {card}")
        # the kernels line times the bench's own shape, the first; its
        # library call is the faster of the two exact products
        rep.add("xnor_popcount", 0.0, *((res["kernel_ms"], res["plain_ms"],
                                          cost, min(res["int8_ms"],
                                                    res["bf16_ms"]))
                                         if M == 4096 else ()))
    return {"xnor_popcount": kb.xnor_popcount.launches}


def pointnet_engines(dev):
    """The SV-PointNet engines of phases 2, 7 and 8, on seeded weights:
    binary with kernels and plain, FP with kernels and plain, per task."""
    import torch

    from svnet_tpu_torch.infer import SVPointNetClsEngine, SVPointNetPsegEngine
    from svnet_tpu_torch.models import sv_pointnet

    out = {"labels": lambda b, gen: labels(b, gen, dev)}
    for tag, engine, init, args in (
            ("cls", SVPointNetClsEngine, sv_pointnet.init_params, (CLASSES, K)),
            ("pseg", SVPointNetPsegEngine, sv_pointnet.init_params_pseg,
             (PARTS, K_PSEG))):
        w_bin = init(*args, True, torch.Generator().manual_seed(SEED + 5))
        w_fp = init(*args, False, torch.Generator().manual_seed(SEED + 6))
        out[tag] = {
            "weights": w_bin,
            "kernel": engine(w_bin, *args, True, device=dev),
            "oracle": engine(w_bin, *args, True, device=dev, oracle=True),
            "kernel_fp": engine(w_fp, *args, False, device=dev),
            "oracle_fp": engine(w_fp, *args, False, device=dev, oracle=True),
        }
    return out


def cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def check_grads(tag, got: dict, want: dict, total: float, dsrc=None):
    """The flip-tolerant bars: cosine >= 0.99 on d(src) (a pair), >= 0.9 on
    each gradient of 8 or more entries, all together within ``total``
    relative. Returns (max abs err, relative error of all together)."""
    if dsrc is not None:
        c = cos(*dsrc)
        if c < 0.99:
            raise AssertionError(f"{tag}: d(src) cosine {c} < 0.99")
    worst = 1.0
    for name, w in want.items():
        g = got[name]
        if w.numel() >= 8 and float(w.norm() * g.norm()) > 1e-10:
            c = cos(g, w)
            worst = min(worst, c)
            if c < 0.9:
                raise AssertionError(f"{tag}: gradient {name} cosine {c} < 0.9")
    import torch

    names = sorted(want)
    a = torch.cat([got[n].flatten() for n in names])
    b = torch.cat([want[n].flatten() for n in names])
    rel = float((a - b).norm() / (b.norm() + 1e-30))
    if rel > total:
        raise AssertionError(f"{tag}: gradients relative error {rel} > {total}")
    err = float((a - b).abs().max())
    if dsrc is not None:
        err = max(err, float((dsrc[0] - dsrc[1]).abs().max()))
    log(f"  {tag}: gradients relative error {rel:.3g}, worst leaf cosine "
        f"{worst:.6f}" + (f", d(src) cosine {cos(*dsrc):.6f}" if dsrc is not None
                          else ""))
    return err, rel


def compare_knn(rep, tag, x, kk, time_it, name="knn"):
    """Kernel B4 against its plain version, ids bitwise (and, timed,
    torch.cdist + torch.topk as the library yardstick) on channels-last
    x (B, N, C); the kernels line's entry is ``name``."""
    import torch

    from svnet_tpu_torch.ops.kernels.knn import knn
    from svnet_tpu_torch.ops.knn import knn_plain

    ko, po = knn(x, kk), knn_plain(x, kk)
    sync(x.device)
    if not torch.equal(ko, po):
        check_ids(tag, ko.transpose(1, 2), po.transpose(1, 2), x)
        raise AssertionError(f"{tag}: ids not bitwise the plain version's")
    if not time_it:
        log(f"  {tag}: ids bitwise the plain version's")
        rep.add(name, 0.0)
        return po
    bb, nn, C = x.shape

    def library():
        return torch.topk(torch.cdist(x, x), kk, dim=-1, largest=False).indices

    ms, plain_ms, lib_ms = (cuda_ms(lambda: knn(x, kk)),
                            cuda_ms(lambda: knn_plain(x, kk)), cuda_ms(library))
    cost = bound(knn_flops(bb, nn, C), 4.0 * bb * nn * (C + kk))
    log(f"  {tag}: ids bitwise the plain version's; kernel {ms} ms, plain "
        f"{plain_ms} ms, cdist+topk {lib_ms} ms, bound {cost}")
    rep.add(name, 0.0, ms, plain_ms, cost, lib_ms)
    return po


def select_input(b, n, c, dup, gen, dev):
    """Seeded normal features (b, n, c); with dup, every odd row repeats
    an even one, so that exact ties go to the minimum row."""
    import torch

    x = torch.randn(b, n, c, generator=gen)
    if dup:
        h = x[:, 1::2].shape[1]
        x[:, 1::2] = x[:, ::2][:, :h]
    return x.to(dev)


# (B, N, C, k, duplicated points) where no size of the selection divides N
# or k: its blocks of 64 centres and tiles of 128 candidates (N = 1000,
# 1001, 130), k = 1 and k = N, lists of 33-64 entries, two rounds of 64
# ranks (k = 100), exact ties
SELECT_SHAPES = ((8, 1000, 3, 20, False), (8, 1001, 62, 7, False),
                 (2, 50, 5, 1, False), (2, 50, 5, 50, False),
                 (8, 1001, 127, 33, False), (8, 1000, 80, 40, False),
                 (8, 1001, 3, 64, False), (2, 130, 3, 100, False),
                 (8, 300, 62, 20, True), (8, 301, 3, 40, True))


def phase2_select(rep, eng, gen, dev):
    """The selection at shapes that its tiles and lists do not divide: B4
    (channel-major source, point-major ids) bitwise knn_plain's at
    SELECT_SHAPES; the selection inside the rounds, both layouts and both
    id orders, through B1 and B2 (channel-major, rank-major wins) and
    B10b (row-major, point-major wins), first round and conv2, outputs and
    ids bitwise their plain versions, at N = 1001, k = 33; N = 1000,
    k = 64 with ties; N = 130, k = 100."""
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    for b, n, c, k, dup in SELECT_SHAPES:
        compare_knn(rep, f"knn forced B={b} N={n} C={c} k={k}"
                    + (" ties" if dup else ""),
                    select_input(b, n, c, dup, gen, dev), k, False)
    S1, V1 = eng.dims["conv1"]
    S, V, S_out, V_out = eng.rounds["conv2"]
    for n, k, dup in ((1001, 33, False), (1000, 64, True), (130, 100, False)):
        shape = f"B=2 N={n} k={k}" + (" ties" if dup else "")
        pts = select_input(2, n, 3, dup, gen, dev)
        kw = dict(S_out=S1, V_out=V1, k=k)
        for kern, plain in ((kr.sv_round3_first, kr.sv_round3_first_plain),
                            (k2.sv_round2_first, k2.sv_round2_first_plain)):
            check_equal(f"{kern.__name__} forced {shape}",
                        kern(pts, eng.folded_first, emit_wins=True, **kw),
                        plain(pts, eng.folded_first, **kw))
        src = select_input(2, n, S + 3 * V, dup, gen, dev)
        kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=True)
        f = eng.folded["conv2"]
        check_equal(f"sv_round2 conv2 forced {shape}",
                    k2.sv_round2(src, f, emit_wins=True, **kw),
                    k2.sv_round2_plain(src, f, **kw))
        src = src.transpose(1, 2).contiguous()
        check_equal(f"sv_round3 conv2 forced {shape}",
                    kr.sv_round3(src, f, emit_wins=True, **kw),
                    kr.sv_round3_plain(src, f, **kw))
        log(f"  selection in B1, B2, B10b (first, conv2) forced {shape}: "
            "outputs and ids bitwise the plain versions")


def compare_train(rep, tag, names, fwd, x, idx, kp, d, gen, time_it, total):
    """A training round's forward and backward passes (kernel wrappers
    ``fwd``/the matching bwd) against the plain versions on the same
    inputs; returns the plain forward's outputs."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_round3_train as kr

    fwd_k, bwd_k = fwd
    ko = fwd_k(x, idx, kp, d)
    po = kr.train_fwd_plain(x, idx, kp, d)
    sync(x.device)
    err = 0.0
    m = x.shape[1] * d.k  # the gate input is the mean over the N*k edges
    for label, g, w in (("s", ko[0], po[0]), ("v", ko[1], po[1]),
                        ("gate means", ko[2] / m, po[2] / m)):
        err = max(err, check_close(f"{tag} {label}", g, w))
    for label, g, w in zip(("mu1", "var1", "inv1", "mun", "varn", "invn"),
                           ko[3], po[3]):
        err = max(err, check_close(f"{tag} {label}", g, w))
    same = (ko[4] == po[4]).float().mean().item()
    if same < 0.9999:
        raise AssertionError(f"{tag}: argmax ranks agree on {same} < 0.9999")
    B_, N_, C = x.shape
    dso = torch.randn(B_, N_, d.S_out, generator=gen).to(x.device)
    dvo = torch.randn(B_, N_, 3 * d.V_out, generator=gen).to(x.device)
    dss = (torch.randn(B_, d.SX, generator=gen) / (N_ * d.k)).to(x.device)
    saved = (po[4], po[3][0], po[3][2], po[3][3], po[3][5])
    kd, kg = bwd_k(x, idx, kp, d, saved, dso, dvo, dss)
    pd, pg = kr.train_bwd_plain(x, idx, kp, d, saved, dso, dvo, dss)
    sync(x.device)
    berr, rel = check_grads(tag, kg, pg, total, (kd, pd))
    rep.grad_rel[tag] = rel
    log(f"  {tag}: forward max abs err {err:.3g}, argmax ranks agree {same:.6f}")
    if not time_it:
        rep.add(names[0], err)
        rep.add(names[1], berr)
        return po
    E = B_ * N_ * d.k
    ef, pm1 = edge_flops(d.S, d.V, d.S_out, d.V_out, d.first, d.binary)
    # the backward's products take real cotangents: real-valued operations
    mm = 2.0 * d.IN1 * d.S_out + 2.0 * 3 * d.twoV * d.V_out
    fwd_cost = (E * ef, 4.0 * B_ * N_ * (C + d.k + 2 * d.S_out + 3 * d.V_out),
                E * pm1)
    bwd_cost = (E * (ef + 2 * mm),
                4.0 * B_ * N_ * (2 * C + d.k + 2 * d.S_out + 3 * d.V_out),
                E * pm1)
    t = [cuda_ms(lambda: fwd_k(x, idx, kp, d)),
         cuda_ms(lambda: kr.train_fwd_plain(x, idx, kp, d)),
         cuda_ms(lambda: bwd_k(x, idx, kp, d, saved, dso, dvo, dss)),
         cuda_ms(lambda: kr.train_bwd_plain(x, idx, kp, d, saved, dso, dvo, dss))]
    log(f"  {tag}: forward kernel {t[0]} ms, plain {t[1]} ms, bound "
        f"{bound(*fwd_cost)}; backward kernel {t[2]} ms, plain {t[3]} ms, bound "
        f"{bound(*bwd_cost)}")
    rep.add(names[0], err, t[0], t[1], bound(*fwd_cost))
    rep.add(names[1], berr, t[2], t[3], bound(*bwd_cost))
    return po


# (B, N, k, S, V, S_out, V_out) of the conv-round block where neither the
# MMA tile (16 rows, columns, depth) nor the edge tile (32 centres x 2
# ranks) divides: IN1 = 2S + 6V = 28, S_out = 13; then cls conv4's and
# partseg conv3's widths at ragged N and k
CONV_FORCED = ((2, 1000, 7, 5, 3, 13, 7), (2, 1001, 33, 5, 3, 13, 7),
               (2, 1001, 7, 64, 21, 128, 42), (1, 1000, 33, 32, 16, 64, 24))


def round_weights(S, V, S_out, V_out, binary, gen, dev, point=False):
    """Seeded folded weights of a conv round at any widths (signs when
    binary, as the fold gives them); ``point``: of a per-point block (B8,
    B3: S + 3V inputs, V vectors, and B3's wzf)."""
    import torch

    IN1, Vi = (S + 3 * V, V) if point else (2 * S + 6 * V, 2 * V)

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    w1, w2 = r(IN1, S_out), r(Vi, V_out)
    if binary:
        w1, w2 = torch.sign(w1), torch.sign(w2)
    f = {"wz": r(Vi, 3), "w1": w1,
         "beta": 0.3 * r(1, IN1) if binary else torch.zeros(1, IN1),
         "a1": r(1, S_out), "b1": r(1, S_out), "w2": w2,
         "scale2": r(1, V_out).abs() + 0.1, "a2": r(1, V_out), "b2": r(1, V_out)}
    if point:
        f["wzf"] = r(V_out, 3)
    return {name: t.to(dev) for name, t in f.items()}


def round_params(S, V, S_out, V_out, binary, gen, dev):
    """The flax-named subtree of an edge round's SVBlock (2S scalars, 2V
    vectors in) at any widths, initialised as the model initialises it."""
    from svnet_tpu_torch.nn.sv_layers import SVBlock
    from svnet_tpu_torch.train.steps import tree_map
    from svnet_tpu_torch.utils.convert import module_tree

    block = SVBlock(2 * S, 2 * V, S_out, V_out, binary, gen)
    return tree_map(lambda t: t.to(dev), module_tree(block)["params"])


def phase2_forced(rep, dev):
    """The conv-round block at CONV_FORCED, binary and FP: B2
    (channel-major), B10b and B10a (row-major) with their own selection and
    B10c (gated) on B4's ids, every output and id bitwise its plain
    version's; B6 at the odd widths (5, 3) -> (13, 7) at (8, 1000, 7), both
    modes, to the bars of phase 2."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_edge as ke
    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr
    from svnet_tpu_torch.ops.kernels import sv_round3_train as krt
    from svnet_tpu_torch.ops.kernels.knn import knn

    gen = torch.Generator().manual_seed(SEED + 14)
    for b, n, k, S, V, S_out, V_out in CONV_FORCED:
        for binary in (True, False):
            f = round_weights(S, V, S_out, V_out, binary, gen, dev)
            src = torch.randn(b, n, S + 3 * V, generator=gen).to(dev)
            src_cm = src.transpose(1, 2).contiguous()
            kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary)
            idx = knn(src, k)
            gate = torch.rand(b, V_out, generator=gen).to(dev)
            label = (f"B={b} N={n} k={k} ({S},{V})->({S_out},{V_out}) "
                     f"{'binary' if binary else 'fp'}")
            for name, kern, plain in (
                    ("sv_round3", lambda: kr.sv_round3(src_cm, f, emit_wins=True, **kw),
                     lambda: kr.sv_round3_plain(src_cm, f, **kw)),
                    ("sv_round2 cls", lambda: k2.sv_round2(src, f, emit_wins=True, **kw),
                     lambda: k2.sv_round2_plain(src, f, **kw)),
                    ("sv_round", lambda: k1.sv_round(src, f, **kw),
                     lambda: k1.sv_round_plain(src, f, **kw)),
                    ("sv_edge_block", lambda: ke.sv_edge_block(src, idx, gate, f, **kw),
                     lambda: ke.sv_edge_block_plain(src, idx, gate, f, **kw))):
                check_equal(f"{name} {label}", kern(), plain())
                rep.add(name, 0.0)
            log(f"  conv block {label}: B2, B10b, B10a, B10c bitwise their plain "
                "versions")
    b, n, k, (S, V, S_out, V_out) = 8, N_RAGGED, 7, CONV_FORCED[0][3:]
    x = torch.randn(b, n, S + 3 * V, generator=gen).to(dev)
    idx = knn(x, k)
    for binary in (True, False):
        d = krt.RoundDims(S, V, S_out, V_out, k, binary)
        kp = krt.kernel_params(round_params(S, V, S_out, V_out, binary, gen, dev), d)
        compare_train(rep, f"sv_round3_train B={b} N={n} k={k} ({S},{V})->"
                      f"({S_out},{V_out}) {'binary' if binary else 'fp'}",
                      ("sv_round3_train_fwd", "sv_round3_train_bwd"),
                      (krt.sv_round3_train_fwd, krt.sv_round3_train_bwd), x, idx,
                      kp, d, gen, False, 1e-3)


# (B, N, k) where the first-round block's centre tile (128) and rank chunk
# (2) divide neither N nor k, and N below one tile
FIRST_FORCED = ((2, 1000, 1), (2, 1001, 7), (1, 1000, 33), (1, 1001, 40),
                (3, 50, 33))


def phase2_first_forced(rep, dev):
    """The first-round block at FIRST_FORCED and every instantiation (2
    and 3 edge channels, V_out 10 and 16, both layouts): B1 and B10b with
    their own selection and B10d on B4's ids, outputs and ids bitwise
    their plain versions'."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_edge_first as kf
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr
    from svnet_tpu_torch.ops.kernels.knn import knn

    gen = torch.Generator().manual_seed(SEED + 17)
    for b, n, k in FIRST_FORCED:
        for cross in (False, True):
            for V_out in (10, 16):
                n_ch = 3 if cross else 2
                f = {name: torch.randn(*shape, generator=gen).to(dev)
                     for name, shape in (("wz0", (n_ch, 3)), ("wz1", (n_ch, 3)),
                                         ("w1", (6 * n_ch, 32)), ("a1", (1, 32)),
                                         ("b1", (1, 32)), ("w2", (n_ch, V_out)),
                                         ("a2", (1, V_out)), ("b2", (1, V_out)))}
                pts = torch.randn(b, n, 3, generator=gen).to(dev)
                kw = dict(S_out=32, V_out=V_out, k=k, cross=cross)
                label = (f"B={b} N={n} k={k} {'cross' if cross else 'xyz'} "
                         f"V_out={V_out}")
                check_equal(f"sv_round3_first {label}",
                            kr.sv_round3_first(pts, f, emit_wins=True, **kw),
                            kr.sv_round3_first_plain(pts, f, **kw))
                check_equal(f"sv_round2_first {label}",
                            k2.sv_round2_first(pts, f, emit_wins=True, **kw),
                            k2.sv_round2_first_plain(pts, f, **kw))
                rep.add("sv_round3_first", 0.0)
                rep.add("sv_round2_first cls", 0.0)
                if not cross:
                    idx = knn(pts, k)
                    kw.pop("cross")
                    check_equal(f"sv_edge_first_block {label}",
                                kf.sv_edge_first_block(pts, idx, f, **kw),
                                kf.sv_edge_first_block_plain(pts, idx, f, **kw))
                    rep.add("sv_edge_first_block", 0.0)
                log(f"  first block {label}: B1, B10b"
                    + ("" if cross else ", B10d") + " bitwise their plain versions")


# (kernel, B, N, S, V, S_out, V_out) where no K chunk (32) or MMA tile of
# the per-point tile kernel divides Cin = 14 and S_out = 13; conv_fuse's
# and partseg conv5's widths (64- and 32-point tiles) at ragged N; B3
# channel-major with two vector blocks, pooled outputs included
POINT_FORCED = (("B8", 2, 1001, 5, 3, 13, 7), ("B8", 1, 1001, 1024, 340, 512, 170),
                ("B8", 1, 1000, 256, 85, 1024, 341), ("B3", 2, 1001, 5, 3, 13, 7),
                ("B3", 1, 1001, 256, 96, 512, 168), ("B3r", 2, 1000, 5, 3, 13, 7),
                ("B3r", 1, 1000, 256, 96, 512, 168))


def phase2_point_forced(rep, dev):
    """B8, B3 and B3r at POINT_FORCED, binary and FP: every output,
    pooled ones included, bitwise its plain version's."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_block_point as kb
    from svnet_tpu_torch.ops.kernels import sv_point as kp

    gen = torch.Generator().manual_seed(SEED + 15)
    for kern, b, n, S, V, S_out, V_out in POINT_FORCED:
        for binary in (True, False):
            f = round_weights(S, V, S_out, V_out, binary, gen, dev, point=True)
            gate = torch.rand(b, V_out, generator=gen).to(dev)
            kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, binary=binary)
            label = (f"{kern} B={b} N={n} ({S},{V})->({S_out},{V_out}) "
                     f"{'binary' if binary else 'fp'}")
            if kern == "B3":
                src = torch.randn(b, S + 3 * V, n, generator=gen).to(dev)
                V1 = max(1, V // 2)
                kw["v_off"] = ((S, V1), (S + 3 * V1, V - V1))
                fn, plain, name = (kp.sv_point_block_cm, kp.sv_point_block_cm_plain,
                                   "sv_point_block_cm")
            else:
                src = torch.randn(b, n, S + 3 * V, generator=gen).to(dev)
                fn, plain, name = ((kb.sv_block_point, kb.sv_block_point_plain, None)
                                   if kern == "B8" else
                                   (kp.sv_point_block, kp.sv_point_block_plain,
                                    "sv_point_block cls"))
            check_equal(label, fn(src, gate, f, **kw), plain(src, gate, f, **kw))
            if name:
                rep.add(name, 0.0)
            log(f"  point block {label}: bitwise its plain version")


def phase2_train(rep, p_bin, p_fp, gen, dev, b=B_TRAIN, n=N, k=K, time_it=True,
                 rounds=None, suffix=""):
    """B4, B5 and B6 at the training shapes of ``rounds`` (name -> (S, V,
    S_out, V_out); the classifier's by default, the first round's output
    widths those of conv2's input), inputs chained through the plain
    versions (binary model; FP rounds on the same inputs). The kernels
    line's entries are the kernels' names plus ``suffix``."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_first_train as kf
    from svnet_tpu_torch.ops.kernels import sv_round3_train as kr
    from svnet_tpu_torch.ops.kernels.sv_round3 import first_perm
    from svnet_tpu_torch.nn.sv_train import gate
    from svnet_tpu_torch.train.fused import ROUNDS, SUB

    rounds = ROUNDS if rounds is None else rounds
    first_names = ("sv_first_train_fwd" + suffix, "sv_first_train_bwd" + suffix)
    round_names = ("sv_round3_train_fwd" + suffix, "sv_round3_train_bwd" + suffix)
    knn_name = "knn" + suffix
    pts = cloud(b, n, gen, dev)
    idx = compare_knn(rep, f"knn B={b} N={n} C=3 k={k}", pts, k, time_it, knn_name)
    S1, V1 = next(iter(rounds.values()))[:2]
    d = kf.first_dims(S1, V1, k)
    sub = {"init_scalar": p_bin["init_scalar"], **{m: p_bin["conv1"][m] for m in SUB}}
    po = compare_train(rep, f"sv_first_train V_out={V1} B={b} N={n} k={k}",
                       first_names, (kf.sv_first_train_fwd, kf.sv_first_train_bwd),
                       pts, idx, kr.kernel_params(sub, d), d, gen, time_it, 1e-3)
    s_mean = (po[2] / (n * k)).float()[:, first_perm()]
    x = (po[0], po[1].reshape(b, n, 3, V1) * gate(p_bin["conv1"], s_mean)[:, None, None, :])
    for name, (S, V, So, Vo) in rounds.items():
        joint = torch.cat([x[0], x[1].reshape(b, n, -1)], dim=-1).contiguous()
        idx = compare_knn(rep, f"knn B={b} N={n} C={S + 3 * V} k={k} ({name})",
                          joint, k, time_it, knn_name)
        ops = (kr.sv_round3_train_fwd, kr.sv_round3_train_bwd)
        for binary, p in ((True, p_bin), (False, p_fp)):
            d = kr.RoundDims(S, V, So, Vo, k, binary)
            tiles = {ph: kr.tile(d, ph) for ph in ("f1", "f2", "b1", "b2")}
            out = compare_train(
                rep, f"sv_round3_train {name} ({S}, {V}) -> ({So}, {Vo}) "
                f"{'binary' if binary else 'fp'} B={b} N={n} k={k}, centre "
                f"points per tile {tiles}", round_names, ops, joint, idx,
                kr.kernel_params({m: p[name][m] for m in SUB}, d), d, gen,
                time_it and binary, 1e-3)
            if binary:
                po = out
        s_mean = (po[2] / (n * k)).float()
        x = (po[0], po[1].reshape(b, n, 3, Vo) * gate(p_bin[name], s_mean)[:, None, None, :])


def phase2_pseg_train(rep, gen, dev):
    """The part segmenters' training kernels at (B_TRAIN, N_PSEG, K_PSEG):
    B4 on the xyz and the joint widths 80, 80, 136, B5 at V_out = 16 and
    B6 binary and FP at SV_DGCNN_PSEG's widths (phase2_train), then B7's
    forward on the points (the SV-PointNet part segmenter's gather, C = 3)
    bitwise, timed beside torch.gather."""
    import torch

    from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg
    from svnet_tpu_torch.ops.kernels import edge_gather as eg
    from svnet_tpu_torch.ops.kernels.knn import knn
    from svnet_tpu_torch.train.fused import PSEG_ROUNDS
    from svnet_tpu_torch.train.steps import tree_map

    p_bin, p_fp = (tree_map(lambda t: t.to(dev), init_params_pseg(
        PARTS, K_PSEG, binary, torch.Generator().manual_seed(SEED + s))["params"])
        for binary, s in ((True, 20), (False, 21)))
    b, n, k = B_TRAIN, N_PSEG, K_PSEG
    phase2_train(rep, p_bin, p_fp, gen, dev, b, n, k, rounds=PSEG_ROUNDS,
                 suffix=" pseg train")
    pts = cloud(b, n, gen, dev)
    idx = knn(pts, k)
    fk, fp = eg.edge_gather_fwd(pts, idx), eg.edge_gather_fwd_plain(pts, idx)
    sync(dev)
    check_equal(f"edge_gather B={b} N={n} k={k} C=3 forward", (fk,), (fp,))

    def lib_fwd():
        return torch.gather(pts, 1, idx.long().reshape(b, -1, 1)
                            .expand(-1, -1, 3)).reshape(b, n, k, 3)

    t = [cuda_ms(fn, reps=20) for fn in (
        lambda: eg.edge_gather_fwd(pts, idx),
        lambda: eg.edge_gather_fwd_plain(pts, idx), lib_fwd)]
    e = b * n * k
    cost = bound(0.0, 4.0 * (b * n * 3 + e + e * 3))
    log(f"  edge_gather B={b} N={n} k={k} C=3: forward bitwise; kernel {t[0]} "
        f"ms, plain {t[1]} ms, torch.gather {t[2]} ms, bound {cost}")
    rep.add("edge_gather_fwd pseg train", 0.0, t[0], t[1], cost, t[2])


def train_run(tag, apply, weights, recipe, loader, gen, counters, per_step,
              log_card, with_label=False, binary=True):
    """1 + TRAIN_STEPS train steps of ``apply`` (binary: the recipe's Adam;
    ``binary=False``: the recipe's FP optimizer, --opt auto;
    rot z; part segmentation, ``with_label``: the one-hot category handed
    to the forward, no label smoothing) through train_epoch, from
    ``weights``; each launches the counted kernels ``per_step`` times (the
    others never). Returns the launch counts, the median step ms, the peak
    device memory and the state."""
    import numpy as np
    import torch

    from svnet_tpu_torch.train.loop import train_epoch
    from svnet_tpu_torch.train.steps import create_state, make_train_step

    dev, steps = loader.device, len(loader)
    state = create_state(weights, binary=binary, lr=1e-3, epochs=1,
                         steps_per_epoch=steps, recipe=recipe, device=dev)
    step = make_train_step(apply, train_loss(with_label), rot="z",
                           with_label=with_label)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters:
        fn.launches = 0
    out = train_epoch(state, step, loader, gen, lambda m: log("  " + m))
    launches = {fn.__name__: fn.launches for fn in counters}
    want = {name: per_step.get(name, 0) * steps for name in launches}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"{tag}: loss {out['loss']} not finite")
    timed = out["step_ms"][1:]
    median = float(np.median(timed))
    peak = torch.cuda.max_memory_allocated(dev)
    shape = tuple(loader.dataset.data.shape[1:2])
    log(f"{tag}: {steps} train steps of ({loader.batch_size}, {shape[0]}, 3), "
        f"{'binary' if binary else 'FP'}, {recipe} {type(state.opt).__name__}, "
        f"rot z; launches "
        f"{ {n: c for n, c in launches.items() if c} }; loss {out['loss']:.6f}")
    log(f"{tag}: step time (CUDA events, ms) median of {len(timed)} "
        f"{median:.3f}, all {[round(t, 3) for t in timed]}; warm-up "
        f"{out['step_ms'][0]:.3f}; peak device memory {peak / 2**30:.3f} GiB | "
        f"{log_card}")
    return launches, median, peak, state


def train_loss(with_label):
    """The trainers' loss: label smoothing for classification, none for
    part segmentation (the CLIs' ``--smoothing`` defaults); the T-Net term
    for a model that returns (logits, trans_feat) (``model_loss``)."""
    import functools

    from svnet_tpu_torch.train.losses import model_loss

    return functools.partial(model_loss, smoothing=not with_label)


def recal_and_eval(tag, apply, state, model, loader, gen, counters,
                   with_label=False):
    """One BN re-estimation batch through ``apply`` and one eval batch
    through the eager ``model`` (loaded with the state's weights); returns
    the launch counts of each. Part segmentation (``with_label``) prints
    the batch's mean shape IoU."""
    import numpy as np
    import torch

    from svnet_tpu_torch.train.loop import bn_reestimate
    from svnet_tpu_torch.train.metrics import shape_iou
    from svnet_tpu_torch.train.steps import make_eval_step, make_recal_step
    from svnet_tpu_torch.utils.convert import load_tree

    for fn in counters:
        fn.launches = 0
    state.batch_stats = bn_reestimate(make_recal_step(apply, "z", with_label),
                                      state, loader, gen, 1)
    recal = {fn.__name__: fn.launches for fn in counters}
    model = model.to(loader.device).eval()
    load_tree(model, state.tree())
    for fn in counters:
        fn.launches = 0
    batch = next(iter(loader))
    loss, preds = make_eval_step(model, train_loss(with_label), "so3",
                                 with_label)(batch, gen)
    evals = {fn.__name__: fn.launches for fn in counters}
    torch.cuda.synchronize()
    if not bool(torch.isfinite(loss)) or preds.shape != batch["target"].shape:
        raise AssertionError(f"{tag}: eval loss {loss} / preds {preds.shape}")
    iou = ""
    if with_label:
        ious = shape_iou(preds.cpu().numpy(), batch["seg"].cpu().numpy(),
                         batch["category"].cpu().numpy())
        iou = f", mean shape IoU {float(np.mean(ious)):.6f}"
    log(f"{tag}: BN re-estimation batch launches "
        f"{ {n: c for n, c in recal.items() if c} }; eval batch (eager model) "
        f"loss {loss.item():.6f}{iou}, launches "
        f"{ {n: c for n, c in evals.items() if c} }")
    return recal, evals


def step_vs_plain(tag, make_apply, weights, recipe, batch, dev, seed,
                  with_label=False, distiller=None, alpha=0.5, binary=True):
    """One train step through the kernels (``make_apply(False)``) against
    the same step through the plain twin (``make_apply(True)``), from the
    same weights and batch (with a KD ``distiller``: its term at ``alpha``,
    the same teacher on both sides): loss and new BN running statistics
    within 1e-4 relative, gradients within the bars of phase 2, parameter
    update cosine >= 0.999."""
    import torch

    from svnet_tpu_torch.train.steps import create_state, make_train_step, tree_map
    from svnet_tpu_torch.utils.convert import flatten as flat
    from svnet_tpu_torch.utils.convert import to_flax

    res = []
    for oracle in (False, True):
        state = create_state(weights, binary=binary, lr=1e-3, epochs=1,
                             steps_per_epoch=1, recipe=recipe, device=dev)
        step = make_train_step(make_apply(oracle), train_loss(with_label),
                               rot="z", with_label=with_label,
                               distiller=distiller, alpha=alpha)
        loss, _ = step(state, batch, torch.Generator().manual_seed(seed))
        res.append((loss.item(), tree_map(lambda t: t.grad, state.params),
                    state.batch_stats, tree_map(lambda t: t.detach(), state.params)))
    (lk, gk, sk, pk), (lp, gp, sp, pp) = res

    worst = max(float((flat(sk)[n] - w).norm() / (w.norm() + 1e-30))
                for n, w in flat(sp).items())
    w0 = flat(to_flax(weights["params"]))
    du = torch.cat([(v.cpu() - torch.from_numpy(w0[n])).flatten()
                    for n, v in sorted(flat(pk).items())])
    dw = torch.cat([(v.cpu() - torch.from_numpy(w0[n])).flatten()
                    for n, v in sorted(flat(pp).items())])
    c = cos(du, dw)
    log(f"{tag}: one step, kernels vs plain twin: loss {lk:.6f} vs {lp:.6f}; "
        f"BN running stats worst relative error {worst:.3g}; parameter update "
        f"cosine {c:.6f}")
    if abs(lk - lp) > 1e-4 * abs(lp):
        raise AssertionError(f"{tag}: loss {lk} vs plain {lp}")
    check_grads(f"{tag} gradients", flat(gk), flat(gp), 1e-3)
    if worst > 1e-4:
        raise AssertionError(f"{tag}: BN running stats off by {worst}")
    if c < 0.999:
        raise AssertionError(f"{tag}: parameter update cosine {c} < 0.999")


def phase5(dev, gen, counters, log_card):
    """The fused SV-DGCNN train path (phases 5 and 6); returns the launch
    counts of the steps, the median step ms, the peak device memory and
    the loader of seeded surface clouds the later training phases reuse."""
    import numpy as np
    import torch

    from svnet_tpu_torch.data import ArrayDataset, Loader
    from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls, init_params
    from svnet_tpu_torch.train.fused import make_fused_train_apply
    from svnet_tpu_torch.utils.synth import surface_clouds

    steps = TRAIN_STEPS + 1
    clouds = surface_clouds(SEED, steps * B_TRAIN, N)
    labels = np.random.default_rng(SEED).integers(0, CLASSES, steps * B_TRAIN)
    loader = Loader(ArrayDataset(clouds, labels, train=True, seed=SEED), B_TRAIN,
                    shuffle=True, drop_last=True, seed=SEED, device=dev)
    weights = init_params(CLASSES, K, True, torch.Generator().manual_seed(SEED + 2))
    apply = make_fused_train_apply(CLASSES, K, binary=True)
    launches, median, peak, state = train_run(
        "phase 5", apply, weights, "dgcnn", loader, gen, counters,
        {"knn": 4, "sv_first_train_fwd": 1, "sv_first_train_bwd": 1,
         "sv_round3_train_fwd": 3, "sv_round3_train_bwd": 3}, log_card)
    recal, evals = recal_and_eval("phase 5", apply, state,
                                  SVDGCNNCls(CLASSES, K, True), loader, gen,
                                  counters)
    want_recal = {n: {"knn": 4, "sv_first_train_fwd": 1,
                      "sv_round3_train_fwd": 3}.get(n, 0) for n in recal}
    # the eager model gathers the neighbours of each of its four rounds
    # through B7's forward
    want_eval = {n: {"knn": 4, "edge_gather_fwd": 4}.get(n, 0) for n in evals}
    if recal != want_recal or evals != want_eval:
        raise AssertionError(f"phase 5: recal launches {recal}, eval {evals}")

    step_vs_plain("phase 6",
                  lambda oracle: make_fused_train_apply(CLASSES, K, True,
                                                        oracle=oracle),
                  init_params(CLASSES, K, True, torch.Generator().manual_seed(SEED + 3)),
                  "dgcnn", next(iter(loader)), dev, SEED + 4)
    return launches, median, peak, loader


def compare_edge_gather(rep, b, n, k, c, gen, dev, time_it=True, names=None):
    """B7 forward and backward against their plain versions on the same
    seeded inputs, ids from kNN (B4) of seeded clouds: both bitwise, and
    two backward launches identical; timed beside torch.gather and
    index_add_ (float atomics), the library yardsticks, where
    ``time_it``, into the kernels line's ``names`` (forward, backward)
    where given. Returns the cotangent and the ids."""
    import torch

    from svnet_tpu_torch.ops.kernels import edge_gather as eg
    from svnet_tpu_torch.ops.kernels.knn import knn

    tag = f"edge_gather B={b} N={n} k={k} C={c}"
    pts = cloud(b, n, gen, dev)
    idx = knn(pts, k)
    src = pts if c == 3 else torch.randn(b, n, c, generator=gen).to(dev)
    g = torch.randn(b, n, k, c, generator=gen).to(dev)
    fk, fp = eg.edge_gather_fwd(src, idx), eg.edge_gather_fwd_plain(src, idx)
    bk, bk2 = eg.edge_gather_bwd(g, idx, n), eg.edge_gather_bwd(g, idx, n)
    bp = eg.edge_gather_bwd_plain(g, idx, n)
    sync(dev)
    check_equal(tag + " forward", (fk,), (fp,))
    check_equal(tag + " backward", (bk,), (bp,))
    check_equal(tag + " backward, two launches", (bk,), (bk2,))
    flat = (idx.long() + n * torch.arange(b, device=dev)[:, None, None]).reshape(-1)
    hub = int(torch.bincount(flat, minlength=b * n).max())
    if not time_it:
        log(f"  {tag}: forward and backward bitwise, two backward launches "
            f"identical (largest in-degree {hub})")
        return g, idx

    def lib_fwd():
        return torch.gather(src, 1, idx.long().reshape(b, -1, 1)
                            .expand(-1, -1, c)).reshape(b, n, k, c)

    def lib_bwd():
        return torch.zeros(b * n, c, device=dev).index_add_(
            0, flat, g.reshape(-1, c))

    t = [cuda_ms(fn, reps=20) for fn in (
        lambda: eg.edge_gather_fwd(src, idx),
        lambda: eg.edge_gather_fwd_plain(src, idx), lib_fwd,
        lambda: eg.edge_gather_bwd(g, idx, n),
        lambda: eg.edge_gather_bwd_plain(g, idx, n), lib_bwd)]
    e = b * n * k
    fwd_cost = bound(0.0, 4.0 * (b * n * c + e + e * c))
    bwd_cost = bound(float(e * c), 4.0 * (e * c + e + b * n * c))
    log(f"  {tag}: forward and backward bitwise, two backward launches "
        f"identical (largest in-degree {hub}); forward kernel {t[0]} ms, "
        f"plain {t[1]} ms, torch.gather {t[2]} ms, bound {fwd_cost}; "
        f"backward kernel {t[3]} ms, plain {t[4]} ms, index_add_ {t[5]} ms, "
        f"bound {bwd_cost}")
    if names is not None:  # names[1] None: the path runs no backward here
        rep.add(names[0], 0.0, t[0], t[1], fwd_cost, t[2])
        if names[1] is not None:
            rep.add(names[1], 0.0, t[3], t[4], bwd_cost, t[5])
        return g, idx
    # the kernels line times each pass at its main path's shapes: the
    # forward at C=3 (phase 9 gathers the points) and at the joint widths
    # (phase 11: conv2 and conv3 at C=62, conv4 at C=127), the backward
    # at the joint widths
    rep.add("edge_gather_fwd", 0.0, t[0], t[1], fwd_cost, t[2])
    rep.add("edge_gather_bwd", 0.0, *((t[3], t[4], bwd_cost, t[5])
                                      if c != 3 else ()))
    rep.add(f"edge_gather_bwd C={c}", 0.0, t[3], t[4], bwd_cost, t[5])
    return g, idx


# (B, N, k, C, ids) of B7's backward: a hub every centre names (in-degree
# M); a cloud at partseg's (2048, 40); all of a cloud's ids on one target
# range of the adjacency kernel (several windows of it) and on one target
# (a segment above the shared-memory list: the device-memory spill); ids
# outside [0, n_src), which the backward ignores, on M k = 7007 ids (no
# int4 loads); M != n_src
GATHER_FORCED = ((2, 1024, 20, 62, "hub"), (2, 2048, 40, 8, None),
                 (1, 2048, 40, 1, "narrow"), (1, 1024, 20, 127, "one"),
                 (2, 1001, 7, 5, "out"), (3, 500, 9, 3, "wide"))


def gather_forced_ids(b, n, k, kind, gen):
    """Seeded ids (B, M, k) int32 for GATHER_FORCED, and n_src."""
    import torch

    n_src = 2 * n if kind == "wide" else n
    idx = torch.randint(0, n_src, (b, n, k), generator=gen, dtype=torch.int32)
    if kind == "hub":
        idx[:, :, 0] = 7
    elif kind == "narrow":
        idx = torch.randint(0, 64, (b, n, k), generator=gen, dtype=torch.int32)
    elif kind == "one":
        idx[:] = 5
    elif kind == "out":
        idx[:, ::3, 1] = n_src
        idx[:, 1::5, 2] = -1
        idx[0, 0, 0] = -(2 ** 31)
    return idx, n_src


def in_range(g, idx, n_src):
    """(g, idx) for the plain backward with every edge whose id lies
    outside [0, n_src) sent to target 0 with a row of +0.0: a sum that
    starts at +0.0 is unchanged, bit for bit, by adding +0.0 anywhere in
    it, so the plain version's result is the kernel's, which ignores
    such edges."""
    import torch

    bad = (idx < 0) | (idx >= n_src)
    return (torch.where(bad[..., None], torch.zeros_like(g), g),
            torch.where(bad, torch.zeros_like(idx), idx))


def phase2_gather(rep, gen, dev):
    """B7 forward and backward (``compare_edge_gather``) at the slice's
    shape (C=3, the points), the joint widths of get_graph_feature_sv
    (C=62, 127), timed, and a ragged (8, 1000, 7, C) at C = 5, 1, 64; the
    backward bitwise its plain version, one launch a call, two launches
    identical, at GATHER_FORCED."""
    import torch

    from svnet_tpu_torch.ops.kernels import edge_gather as eg

    for c in (3, 62, 127):
        compare_edge_gather(rep, B_TRAIN, N, K, c, gen, dev)
    for c in (5, 1, 64):
        compare_edge_gather(rep, 8, N - 24, 7, c, gen, dev, time_it=False)
    for b, n, k, c, kind in GATHER_FORCED:
        idx, n_src = gather_forced_ids(b, n, k, kind, gen)
        idx = idx.to(dev)
        g = torch.randn(b, n, k, c, generator=gen).to(dev)
        before = eg.edge_gather_bwd.launches
        got = eg.edge_gather_bwd(g, idx, n_src)
        if eg.edge_gather_bwd.launches != before + 1:
            raise AssertionError(f"edge_gather_bwd forced {(b, n, k, c, kind)}: "
                                 f"launches {eg.edge_gather_bwd.launches - before}")
        tag = f"edge_gather_bwd forced B={b} M={n} k={k} C={c} n_src={n_src} {kind}"
        check_equal(tag, (got,), (eg.edge_gather_bwd_plain(*in_range(g, idx, n_src),
                                                            n_src),))
        check_equal(tag + ", two launches", (got,),
                    (eg.edge_gather_bwd(g, idx, n_src),))
    log(f"  edge_gather_bwd at GATHER_FORCED: bitwise, two launches identical")


def phase9(dev, gen, counters, loader, log_card):
    """SV-PointNet cls training (phases 9 and 10) on phase 5's clouds;
    returns the launch counts of the steps, the median step ms and the
    peak device memory."""
    import torch

    from svnet_tpu_torch.models.sv_pointnet import SVPointNetCls, init_params
    from svnet_tpu_torch.train.pointnet import make_train_apply_cls

    apply = make_train_apply_cls(CLASSES, K, True)
    weights = init_params(CLASSES, K, True, torch.Generator().manual_seed(SEED + 7))
    # the step differentiates the weights, not the points: the gather of
    # the points' neighbours runs forward only (so does the JAX step; see
    # tests/test_torch_pointnet_train.py)
    one = {"knn": 1, "edge_gather_fwd": 1}
    launches, median, peak, state = train_run(
        "phase 9", apply, weights, "pointnet_cls", loader, gen, counters, one,
        log_card)
    recal, evals = recal_and_eval("phase 9", apply, state,
                                  SVPointNetCls(CLASSES, K, True), loader, gen,
                                  counters)
    want = {n: one.get(n, 0) for n in recal}
    if recal != want or evals != want:
        raise AssertionError(f"phase 9: recal launches {recal}, eval {evals}")

    step_vs_plain("phase 10",
                  lambda oracle: make_train_apply_cls(CLASSES, K, True,
                                                      oracle=oracle),
                  init_params(CLASSES, K, True, torch.Generator().manual_seed(SEED + 8)),
                  "pointnet_cls", next(iter(loader)), dev, SEED + 9)
    return launches, median, peak


def phase11(dev, gen, counters, loader, log_card):
    """SV-DGCNN training through the un-fused path (train/dgcnn.py), where
    B7's scatter-add backward runs: conv2-4's joint features depend on the
    weights, the points do not. Returns the launch counts of the steps and
    the median step ms."""
    import torch

    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.train.dgcnn import make_train_apply_cls

    weights = init_params(CLASSES, K, True, torch.Generator().manual_seed(SEED + 10))
    launches, median, _, _ = train_run(
        "phase 11", make_train_apply_cls(CLASSES, K, True), weights, "dgcnn",
        loader, gen, counters, {"knn": 4, "edge_gather_fwd": 4,
                                "edge_gather_bwd": 3}, log_card)
    step_vs_plain("phase 11",
                  lambda oracle: make_train_apply_cls(CLASSES, K, True,
                                                      oracle=oracle),
                  weights, "dgcnn", next(iter(loader)), dev, SEED + 11)
    return launches, median


def pseg_loader(dev, steps=TRAIN_STEPS + 1):
    """``steps`` batches of seeded surface clouds (B_TRAIN, N_PSEG)
    with random categories and, per point, random part ids inside the
    category's range; each item's points and ids shuffled together."""
    import numpy as np

    from svnet_tpu_torch.data import Loader, PartArrayDataset
    from svnet_tpu_torch.train.metrics import INDEX_START, SEG_NUM
    from svnet_tpu_torch.utils.synth import surface_clouds

    m = steps * B_TRAIN
    rng = np.random.default_rng(SEED + 22)
    cat = rng.integers(0, 16, m)
    seg = np.stack([INDEX_START[c] + rng.integers(0, SEG_NUM[c], N_PSEG)
                    for c in cat])
    data = PartArrayDataset(surface_clouds(SEED + 22, m, N_PSEG), cat, seg,
                            shuffle=True, seed=SEED)
    return Loader(data, B_TRAIN, shuffle=True, drop_last=True, seed=SEED,
                  device=dev)


def phase_pseg_train(tag, apply_of, model, weights, recipe, per_step,
                     recal_want, eval_want, loader, dev, gen, counters, card,
                     seed, with_label=True, state_out=None, binary=True):
    """Part-segmentation training (classification with ``with_label``
    False): 1 + TRAIN_STEPS steps through train_epoch with the per-step
    launches ``per_step``, one BN re-estimation and one eval batch (the
    eager ``model``) with the stated launches, then one step through the
    kernels against its oracle twin. Returns the launch counts of the
    steps, the median step ms and the peak device memory; the trained
    state goes to ``state_out`` (a list) where given."""
    import torch

    launches, median, peak, state = train_run(
        tag, apply_of(False), weights, recipe, loader, gen, counters, per_step,
        card, with_label=with_label, binary=binary)
    recal, evals = recal_and_eval(tag, apply_of(False), state, model, loader,
                                  gen, counters, with_label=with_label)
    if recal != {n: recal_want.get(n, 0) for n in recal} or \
            evals != {n: eval_want.get(n, 0) for n in evals}:
        raise AssertionError(f"{tag}: recal launches {recal}, eval {evals}")
    if state_out is not None:
        state_out.append(state)
    del state
    torch.cuda.empty_cache()
    step_vs_plain(f"{tag} oracle", apply_of, weights, recipe, next(iter(loader)),
                  dev, seed, with_label=with_label, binary=binary)
    torch.cuda.empty_cache()
    return launches, median, peak


def phase22(dev, gen, counters, loader, card):
    """SV-DGCNN part-segmentation binary training through the fused train
    forward at (B_TRAIN, N_PSEG, K_PSEG): knn x4, B5 fwd/bwd x1, B6
    fwd/bwd x3 a step; the eager SVDGCNNPseg evaluates (knn x4, B7's
    forward x4)."""
    import torch

    from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNPseg, init_params_pseg
    from svnet_tpu_torch.train.fused import make_fused_train_apply_pseg

    weights = init_params_pseg(PARTS, K_PSEG, True,
                               torch.Generator().manual_seed(SEED + 23))
    return phase_pseg_train(
        "phase 22", lambda oracle: make_fused_train_apply_pseg(
            PARTS, K_PSEG, True, oracle=oracle),
        SVDGCNNPseg(PARTS, K_PSEG, True), weights, "dgcnn",
        {"knn": 4, "sv_first_train_fwd": 1, "sv_first_train_bwd": 1,
         "sv_round3_train_fwd": 3, "sv_round3_train_bwd": 3},
        {"knn": 4, "sv_first_train_fwd": 1, "sv_round3_train_fwd": 3},
        {"knn": 4, "edge_gather_fwd": 4}, loader, dev, gen, counters, card,
        SEED + 24)


def phase23(dev, gen, counters, loader, card):
    """SV-PointNet part-segmentation binary training (pointnet_partseg
    recipe) at (B_TRAIN, N_PSEG, K_PSEG): knn x1 and B7's forward x1 a
    step (the step differentiates the weights, not the points); the eager
    SVPointNetPseg evaluates with the same launches."""
    import torch

    from svnet_tpu_torch.models.sv_pointnet import SVPointNetPseg, init_params_pseg
    from svnet_tpu_torch.train.pointnet import make_train_apply_pseg

    weights = init_params_pseg(PARTS, K_PSEG, True,
                               torch.Generator().manual_seed(SEED + 25))
    one = {"knn": 1, "edge_gather_fwd": 1}
    return phase_pseg_train(
        "phase 23", lambda oracle: make_train_apply_pseg(PARTS, K_PSEG, True,
                                                         oracle=oracle),
        SVPointNetPseg(PARTS, K_PSEG, True), weights, "pointnet_partseg", one,
        one, one, loader, dev, gen, counters, card, SEED + 26)


@contextlib.contextmanager
def gather_bits(bits):
    """config.fast_gather_bits = bits inside the block."""
    from svnet_tpu_torch import config

    was = config.fast_gather_bits
    config.set_fast_gather_bits(bits)
    try:
        yield
    finally:
        config.set_fast_gather_bits(was)


def fast_name(kernel, bits, tag):
    """The kernels line's name of a fast-mode entry: 'sv_round3 fast',
    'sv_round3 fast8 pseg', ..."""
    return f"{kernel} fast{'' if bits == 16 else bits}" + ("" if tag == "cls" else f" {tag}")


def compare_neg_min(rep, name, x, time_it):
    """The pre-pass (kernel, each centre's farthest candidate) bitwise its
    plain version on channels-last x (B, N, C); timed beside
    torch.cdist(x, x).amax(-1), the library's farthest distance."""
    import torch

    from svnet_tpu_torch.ops.kernels.knn import neg_min, neg_min_plain

    check_equal(f"{name} C={x.shape[-1]}", (neg_min(x),), (neg_min_plain(x),))
    if not time_it:
        return
    bb, nn, C = x.shape
    ms, plain_ms, lib_ms = (cuda_ms(lambda: neg_min(x)),
                            cuda_ms(lambda: neg_min_plain(x)),
                            cuda_ms(lambda: torch.cdist(x, x).amax(dim=-1)))
    cost = bound(neg_min_flops(bb, nn, C), 4.0 * bb * nn * (C + 1))
    log(f"  {name} B={bb} N={nn} C={C}: bitwise; kernel {ms} ms, plain "
        f"{plain_ms} ms, cdist+amax {lib_ms} ms, bound {cost}")
    rep.add(name, 0.0, ms, plain_ms, cost, lib_ms)


# (B, N, C, input) of the pre-pass: N off its 128-row tiles, C off its
# 16-channel stage, duplicated points, one point repeated
PREPASS_FORCED = ((2, 1000, 5, None), (2, 1001, 33, None), (3, 130, 1, None),
                  (1, 50, 127, None), (2, 1024, 62, "dup"), (1, 256, 3, "same"))


def phase2_prepass_forced(dev):
    """The pre-pass (neg_min) bitwise its plain version at PREPASS_FORCED,
    one launch a call; the window's tau (window_tau) bitwise its plain
    version at k = 1, 20, 40, 384 on duplicated rows (every band distance
    at least twice), (2, 1024, 14) and (3, 256, 5); its block test
    (window_keep) at KEEP_FORCED (``compare_keep_forced``)."""
    import torch

    from svnet_tpu_torch.ops.kernels.knn import neg_min, neg_min_plain
    from svnet_tpu_torch.ops.window import window_tau, window_tau_plain

    gen = torch.Generator().manual_seed(SEED + 50)

    def dup(x):
        x[:, 1::2] = x[:, 0::2][:, : x[:, 1::2].shape[1]]
        return x

    for b, n, c, kind in PREPASS_FORCED:
        x = torch.randn(b, n, c, generator=gen)
        if kind == "dup":
            dup(x)
        elif kind == "same":
            x[:] = x[:, :1]
        x = x.to(dev)
        before = neg_min.launches
        got = neg_min(x)
        if neg_min.launches != before + 1:
            raise AssertionError(f"neg_min ({b}, {n}, {c}): launches "
                                 f"{neg_min.launches - before} != 1")
        check_equal(f"neg_min forced ({b}, {n}, {c}) {kind}", (got,), (neg_min_plain(x),))
    for b, n, c in ((2, 1024, 14), (3, 256, 5)):
        x = dup(torch.randn(b, n, c, generator=gen)).to(dev)
        for k in (1, 20, 40, 384):
            check_equal(f"window_tau forced ({b}, {n}, {c}) k={k}",
                        (window_tau(x, k),), (window_tau_plain(x, k),))
    log(f"  pre-passes at PREPASS_FORCED and window_tau at k = 1, 20, 40, 384 "
        "on duplicated rows: bitwise")
    for b, n, c, T, kind in KEEP_FORCED:
        compare_keep_forced(b, n, c, T, kind, dev)
    log("  window_keep at KEEP_FORCED: bitwise, flags mixed, a tie kept, the "
        "float below it pruned, a NaN tau keeping its tile's blocks")


# (B, N, C, key tile T, input) of the window's block test (window_keep), as
# tests/test_torch_cuda.py's: C = 1, 3, 5 below and off the 16-channel
# stage, 127 off it; T = 128 and T = N; N = 384 (3 blocks, under the 8 of
# a warp); strand clouds and Morton-sorted surface clouds
KEEP_FORCED = ((2, 1024, 1, 128, "strand"), (2, 1024, 3, 1024, "strand"),
               (3, 384, 5, 128, "strand"), (1, 2048, 127, 256, "strand"),
               (2, 1024, 127, 1024, "strand"), (2, 2048, 3, 128, "surface"),
               (1, 384, 127, 384, "strand"))


def compare_keep_forced(b, n, c, T, kind, dev):
    """window_keep bitwise window_keep_plain on x (B, N, C), its boxes and
    tau as prune_prepass raises it (k = 20), one launch a call, 5-95% of
    the flags kept (at T = N, where every block holds centres that keep
    it, only the first 100 centres of a cloud keep anything, with tau at
    most 0.5); a tie (a centre's tau on its lb2 to the last block, in the
    plain version's rounding, the tile's other centres at -1) keeps that
    block and the float below prunes it; a NaN tau keeps every block of
    its tile."""
    import torch

    from svnet_tpu_torch.ops import window as win
    from svnet_tpu_torch.utils.synth import strand_clouds

    x = (surface(b, n, SEED + 51, dev) if kind == "surface" else
         torch.from_numpy(strand_clouds(SEED + 51, b, n, c)).to(dev)).contiguous()
    tau = win.raise_tau(x, win.window_tau_plain(x, K))
    if T == n:
        tau[:, :100] = tau[:, :100].clamp(max=0.5)
        tau[:, 100:] = -1.0
    xb = x.reshape(b, n // 128, 128, x.shape[-1])
    lo, hi = xb.amin(dim=2).contiguous(), xb.amax(dim=2).contiguous()
    tag = f"window_keep forced B={b} N={n} C={x.shape[-1]} T={T} {kind}"
    before = win.window_keep.launches
    got = win.window_keep(x, lo, hi, tau, T)
    if win.window_keep.launches != before + 1:
        raise AssertionError(f"{tag}: launches {win.window_keep.launches - before}")
    want = win.window_keep_plain(x, lo, hi, tau, T)
    check_equal(tag, (got,), (want,))
    share = float(want.float().mean())
    if not 0.05 <= share <= 0.95:
        raise AssertionError(f"{tag}: kept share {share} outside 0.05-0.95")
    bk = n // 128 - 1
    d = torch.clamp(torch.maximum(lo[0, bk] - x[0, 0], x[0, 0] - hi[0, bk]), min=0.0)
    lb2 = d[0] * d[0]
    for ch in range(1, d.shape[0]):
        lb2 = lb2 + d[ch] * d[ch]
    for t, flag in ((lb2, 1), (torch.nextafter(lb2, lb2.new_tensor(-1.0)), 0)):
        tie = tau.clone()
        tie[0, :T] = -1.0
        tie[0, 0] = t
        got = win.window_keep(x, lo, hi, tie, T)
        check_equal(f"{tag} tie", (got,), (win.window_keep_plain(x, lo, hi, tie, T),))
        if int(got[0, 0, bk]) != flag:
            raise AssertionError(f"{tag}: tie flag {int(got[0, 0, bk])} != {flag}")
    nan = tau.clone()
    nan[-1, 5] = float("nan")
    got = win.window_keep(x, lo, hi, nan, T)
    check_equal(f"{tag} NaN tau", (got,), (win.window_keep_plain(x, lo, hi, nan, T),))
    if not bool((got[-1, 0] == 1).all()):
        raise AssertionError(f"{tag}: a NaN tau does not keep its tile's blocks")


# (B, N, k, key tile T or None) of B1 and B2 in fast mode: N and k that no
# tile or list of the selection or the blocks divides (T = N there), exact
# ties (duplicated points), several key tiles a cloud at k = 33
FAST_FORCED = ((2, 1000, 7, None, False), (2, 1001, 33, None, False),
               (1, 1000, 64, None, True), (2, 1024, 33, 128, False),
               (3, 256, 40, 64, True))


def phase2_fast(rep, eng, eng_fp, dg, pn, gen, dev):
    """B1 and B2 in fast mode, at 16- and 8-bit gathers, against their
    plain versions: ids and outputs bitwise. At the main paths' shapes (cls
    (128, 1024, 20), key tile T = 256; partseg (32, 2048, 40), T = 128; B1
    cross on the SV-PointNet classifier's weights), inputs chained through
    the plain fast versions, each call timed beside its exact twin on the
    same input and the pre-pass timed alone (16 bits); then FAST_FORCED,
    binary and FP, xyz and cross, V_out 10 and 16."""
    import torch

    from svnet_tpu_torch.infer import se_gate
    from svnet_tpu_torch.ops.kernels import quant
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    for bits in (16, 8):
        with gather_bits(bits):
            for tag, e, e_fp, (b, n, k) in (
                    ("cls", eng, eng_fp, (B, N, K)),
                    ("pseg", dg["pseg round3"]["kernel"],
                     dg["pseg round3"]["kernel_fp"], (B_PSEG, N_PSEG, K_PSEG))):
                S1, V1 = e.dims["conv1"]
                pts = cloud(b, n, gen, dev)
                T = quant.round3_tiles(n, 3, "fast")
                kw = dict(S_out=S1, V_out=V1, k=k, mode="fast")
                name = fast_name("sv_round3_first", bits, tag)
                f = e.folded_first
                ef, pm1 = edge_flops(0, 1, S1, V1, True)
                cost = bound(knn_flops(b, n, 3) + b * n * k * ef,
                             4.0 * b * n * (3 + S1 + 3 * V1 + 6 + k), b * n * k * pm1)
                po = timed_fast(rep, f"{name} B={b} N={n} k={k} T={T}", name,
                                lambda: kr.sv_round3_first(pts, f, emit_wins=True, **kw),
                                lambda: kr.sv_round3_first_plain(pts, f, **kw),
                                lambda: kr.sv_round3_first(
                                    pts, f, S_out=S1, V_out=V1, k=k),
                                cost)
                if bits == 16:
                    compare_neg_min(rep, "neg_min" + ("" if tag == "cls" else " pseg"),
                                    pts, True)
                g = se_gate(e.p["conv1"], po[2]).repeat(1, 3)
                outs = [(po[0], po[1] * g[:, :, None])]
                for rnd, (S, V, S_out, V_out) in e.rounds.items():
                    src = torch.cat(outs[-1], dim=1).contiguous()
                    C = S + 3 * V
                    T = quant.round3_tiles(n, C, "fast")
                    name = fast_name("sv_round3", bits, tag)
                    ef, pm1 = edge_flops(S, V, S_out, V_out, binary=True)
                    cost = bound(knn_flops(b, n, C) + b * n * k * ef,
                                 4.0 * b * n * (C + S_out + 3 * V_out + 2 * S + k),
                                 b * n * k * pm1)
                    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k)
                    fb, ffp = e.folded[rnd], e_fp.folded[rnd]
                    po = timed_fast(
                        rep, f"{name} {rnd} binary B={b} N={n} k={k} T={T}", name,
                        lambda: kr.sv_round3(src, fb, emit_wins=True, mode="fast", **kw),
                        lambda: kr.sv_round3_plain(src, fb, binary=True, mode="fast", **kw),
                        lambda: kr.sv_round3(src, fb, **kw), cost)
                    check_equal(f"{name} {rnd} fp",
                                kr.sv_round3(src, ffp, binary=False, mode="fast",
                                             emit_wins=True, **kw),
                                kr.sv_round3_plain(src, ffp, binary=False,
                                                   mode="fast", **kw))
                    if bits == 16:
                        rows = src.transpose(1, 2).contiguous()
                        compare_neg_min(rep, "neg_min" + ("" if tag == "cls" else " pseg"),
                                        rows, True)
                        log(f"  gather grid (PyTorch) C={C}: "
                            f"{cuda_ms(lambda: quant.grid_rows(rows))} ms")
                    g = se_gate(e.p[rnd], po[2]).repeat(1, 3)
                    outs.append((po[0], po[1] * g[:, :, None]))
            # B1 cross on the SV-PointNet classifier's first round (timed
            # at 16 bits, which phase 16 serves)
            pts = cloud(B, N, gen, dev)
            f = pn["cls"]["kernel"].folded_first
            kw = dict(S_out=32, V_out=10, k=K, cross=True, mode="fast")
            name = fast_name("sv_round3_first cross", bits, "cls")
            kern = lambda: kr.sv_round3_first(pts, f, emit_wins=True, **kw)
            plain = lambda: kr.sv_round3_first_plain(pts, f, **kw)
            if bits == 16:
                ef, _ = edge_flops(0, 1, 32, 10, first=True, cross=True)
                timed_fast(rep, f"{name} B={B} N={N} k={K}", name, kern, plain,
                           lambda: kr.sv_round3_first(pts, f, S_out=32, V_out=10,
                                                      k=K, cross=True),
                           bound(knn_flops(B, N, 3) + B * N * K * ef,
                                 4.0 * B * N * (3 + 32 + 30 + 9 + K)))
            else:
                check_equal(f"{name} B={B} N={N} k={K}", kern(), plain())
            phase2_fast_forced(bits, gen, dev)


def timed_fast(rep, label, name, kern, plain, exact, cost):
    """A fast-mode call (kern) bitwise its plain version, ids included
    where the wrapper returns them, then timed beside the plain version
    and beside ``exact``, the same kernel in exact mode on the same input.
    Returns the plain outputs."""
    ko, po = kern(), plain()
    sync(ko[0].device)
    check_equal(label, ko, po)
    ms, plain_ms, exact_ms = cuda_ms(kern), cuda_ms(plain), cuda_ms(exact)
    what = "ids and outputs" if len(ko) > 3 else "outputs"  # B10a: no ids
    log(f"  {label}: {what} bitwise; kernel {ms} ms (exact mode "
        f"{exact_ms} ms), plain {plain_ms} ms, bound {cost}")
    rep.add(name, 0.0, ms, plain_ms, cost)
    return po


def phase2_fast_forced(bits, gen, dev):
    """B1 (xyz and cross, V_out 10 and 16) and B2 ((5, 3) -> (13, 7), and
    cls conv4's widths, binary and FP) in fast mode at FAST_FORCED, ids
    and outputs bitwise their plain versions."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    for b, n, k, T, dup in FAST_FORCED:
        pts = select_input(b, n, 3, dup, gen, dev)
        for cross in (False, True):
            for V_out in (10, 16):
                n_ch = 3 if cross else 2
                f = {name: torch.randn(*shape, generator=gen).to(dev)
                     for name, shape in (("wz0", (n_ch, 3)), ("wz1", (n_ch, 3)),
                                         ("w1", (6 * n_ch, 32)), ("a1", (1, 32)),
                                         ("b1", (1, 32)), ("w2", (n_ch, V_out)),
                                         ("a2", (1, V_out)), ("b2", (1, V_out)))}
                kw = dict(S_out=32, V_out=V_out, k=k, cross=cross, mode="fast", T=T)
                check_equal(f"sv_round3_first fast{bits} B={b} N={n} k={k}",
                            kr.sv_round3_first(pts, f, emit_wins=True, **kw),
                            kr.sv_round3_first_plain(pts, f, **kw))
        for S, V, S_out, V_out in ((5, 3, 13, 7), (64, 21, 128, 42)):
            src = select_input(b, n, S + 3 * V, dup, gen, dev)
            src = src.transpose(1, 2).contiguous()
            for binary in (True, False):
                f = round_weights(S, V, S_out, V_out, binary, gen, dev)
                kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k,
                          binary=binary, mode="fast", T=T)
                check_equal(f"sv_round3 fast{bits} B={b} N={n} k={k}",
                            kr.sv_round3(src, f, emit_wins=True, **kw),
                            kr.sv_round3_plain(src, f, **kw))
        log(f"  fast{bits} forced B={b} N={n} k={k} T={T or 'auto'}"
            + (" ties" if dup else "") + ": B1 (xyz, cross; V_out 10, 16) and "
            "B2 (binary, fp) bitwise their plain versions")


def phase16(eng, eng_fp, pn, dg, w_bin, w_fp, gen, dev, counters, card):
    """Fast-mode serving: 5 requests through each of the SV-DGCNN
    classifier (128, 1024, 3) and part segmenter (32, 2048, 3) at 16- and
    8-bit gathers and the SV-PointNet classifier at 16, with the launches
    per request checked, top-1 against the fast plain twin; the median
    beside the exact engine's (phases 3, 12, 7) and fast-vs-exact top-1
    logged (random weights: not a bar), for the classifier also through
    the FP model, whose signs no binarization flips. Returns launches by
    entry name."""
    import torch

    from svnet_tpu_torch.infer import (
        SVDGCNNClsEngine,
        SVDGCNNPsegEngine,
        SVPointNetClsEngine,
    )
    from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg

    p_pseg = init_params_pseg(PARTS, K_PSEG, True,
                              torch.Generator().manual_seed(SEED + 12))
    w_pn = pn["cls"]["weights"]
    dgcnn = {"sv_round3_first": 1, "sv_round3": 3, "neg_min": 4,
             "sv_point_block_cm": 1}
    runs = (("cls", 16, SVDGCNNClsEngine, w_bin, (CLASSES, K), eng, "phase 3",
             lambda: (cloud(B, N, gen, dev),), dgcnn),
            ("pseg", 16, SVDGCNNPsegEngine, p_pseg, (PARTS, K_PSEG),
             dg["pseg round3"]["kernel"], "phase 12",
             lambda: (cloud(B_PSEG, N_PSEG, gen, dev), labels(B_PSEG, gen, dev)),
             dgcnn),
            ("cls", 8, SVDGCNNClsEngine, w_bin, (CLASSES, K), eng, "phase 3",
             lambda: (cloud(B, N, gen, dev),), dgcnn),
            ("pseg", 8, SVDGCNNPsegEngine, p_pseg, (PARTS, K_PSEG),
             dg["pseg round3"]["kernel"], "phase 12",
             lambda: (cloud(B_PSEG, N_PSEG, gen, dev), labels(B_PSEG, gen, dev)),
             dgcnn),
            ("cross", 16, SVPointNetClsEngine, w_pn, (CLASSES, K),
             pn["cls"]["kernel"], "phase 7", lambda: (cloud(B, N, gen, dev),),
             {"sv_round3_first": 1, "neg_min": 1, "sv_block_point": 7}))
    out = {}
    for tag, bits, engine, w, args, exact_eng, exact_phase, request, want_per in runs:
        label = f"phase 16 {tag} fast{bits}"
        with gather_bits(bits):
            fast = engine(w, *args, True, mode="fast", device=dev)
            oracle = engine(w, *args, True, mode="fast", device=dev, oracle=True)
            requests = [request() for _ in range(REQUESTS)]
            got, want, _, launches = serve(label, fast, oracle, requests,
                                           counters, want_per, card)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: logits {tuple(got.shape)} not finite")
        agreement(f"{label}: vs the fast plain engine", got, want)
        exact = torch.cat([exact_eng(*req) for req in requests])
        top1 = (got.argmax(-1) == exact.argmax(-1)).float().mean().item()
        log(f"{label}: median {MEDIANS[label]:.3f} ms, exact mode "
            f"{MEDIANS[exact_phase]:.3f} ms ({exact_phase}) | {card}; top-1 "
            f"agreement with exact mode {top1:.6f} (random weights, not a bar)")
        if (tag, bits) == ("cls", 16):
            fast_fp = SVDGCNNClsEngine(w_fp, CLASSES, K, False, mode="fast",
                                       device=dev)
            got_fp = torch.cat([fast_fp(*req) for req in requests])
            exact_fp = torch.cat([eng_fp(*req) for req in requests])
            log(f"{label}: FP model, fast vs exact mode: top-1 agreement "
                f"{(got_fp.argmax(-1) == exact_fp.argmax(-1)).float().mean().item():.6f}; "
                f"max |dlogit| {(got_fp - exact_fp).abs().max().item():.4g} "
                f"(logit scale {exact_fp.abs().max().item():.4g})")
        if tag == "cross":
            out[fast_name("sv_round3_first cross", bits, "cls")] = \
                launches["sv_round3_first"]
            continue
        out[fast_name("sv_round3_first", bits, tag)] = launches["sv_round3_first"]
        out[fast_name("sv_round3", bits, tag)] = launches["sv_round3"]
        if bits == 16:
            out["neg_min" + ("" if tag == "cls" else " pseg")] = launches["neg_min"]
    return out


@contextlib.contextmanager
def approx_knobs(bits, fold):
    """config.approx_gather_bits = bits, config.approx_fold = fold inside
    the block."""
    from svnet_tpu_torch import config

    was = config.approx_gather_bits, config.approx_fold
    config.set_approx_gather_bits(bits)
    config.set_approx_fold(fold)
    try:
        yield
    finally:
        config.set_approx_gather_bits(was[0])
        config.set_approx_fold(was[1])


def approx_name(kernel, bits, tag):
    """The kernels line's name of an approx-mode entry: 'sv_round3 approx',
    'sv_round3 approx8 pseg', ..."""
    return f"{kernel} approx{'' if bits == 16 else bits}" + ("" if tag == "cls" else f" {tag}")


def timed_approx(rep, label, name, kern, plain, fast, exact, cost):
    """An approx-mode call (kern) bitwise its plain version, ids included,
    then timed beside the plain version and beside ``fast`` and ``exact``,
    the same kernel in those modes on the same input. Returns the plain
    outputs."""
    ko, po = kern(), plain()
    sync(ko[0].device)
    check_equal(label, ko, po)
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    fast_ms, exact_ms = cuda_ms(fast), cuda_ms(exact)
    log(f"  {label}: ids and outputs bitwise; kernel {ms} ms (fast mode "
        f"{fast_ms} ms, exact mode {exact_ms} ms), plain {plain_ms} ms, "
        f"bound {cost}")
    rep.add(name, 0.0, ms, plain_ms, cost)
    return po


# approx mode's fold width on each main path (the JAX package's certified
# serving pick, ACCURACY.md:156-170): cls (N = 1024 -> L = 256), partseg
# (N = 2048 -> L = 512)
FOLD = {"cls": 256, "pseg": 512}


def phase2_approx(rep, eng, eng_fp, dg, pn, gen, dev):
    """B1 and B2 in approx mode, at 16- and 8-bit gathers, against their
    plain versions: ids and outputs bitwise. At the main paths' shapes on
    Morton-sorted clouds, as the engines sort them (cls (128, 1024, 20)
    fold 256; partseg (32, 2048, 40) fold 512; B1 cross on the
    SV-PointNet classifier's weights, unsorted, fold 256), inputs chained
    through the plain approx versions, binary timed beside the fast and
    exact twins on the same input, FP bitwise; then APPROX_FORCED."""
    import torch

    from svnet_tpu_torch.infer import se_gate
    from svnet_tpu_torch.ops import morton
    from svnet_tpu_torch.ops.kernels import quant
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    for bits in (16, 8):
        for tag, e, e_fp, (b, n, k) in (
                ("cls", eng, eng_fp, (B, N, K)),
                ("pseg", dg["pseg round3"]["kernel"],
                 dg["pseg round3"]["kernel_fp"], (B_PSEG, N_PSEG, K_PSEG))):
            with approx_knobs(bits, FOLD[tag]), gather_bits(bits):
                S1, V1 = e.dims["conv1"]
                pts = morton.sort_points(cloud(b, n, gen, dev))[0]
                T = quant.round3_tiles(n, 3, "approx")
                L = quant.fold_width(n)
                kw = dict(S_out=S1, V_out=V1, k=k)
                name = approx_name("sv_round3_first", bits, tag)
                f = e.folded_first
                ef, pm1 = edge_flops(0, 1, S1, V1, True)
                cost = bound(knn_flops(b, n, 3) + b * n * k * ef,
                             4.0 * b * n * (3 + S1 + 3 * V1 + 6 + k), b * n * k * pm1)
                po = timed_approx(
                    rep, f"{name} B={b} N={n} k={k} T={T} L={L}", name,
                    lambda: kr.sv_round3_first(pts, f, emit_wins=True, mode="approx", **kw),
                    lambda: kr.sv_round3_first_plain(pts, f, mode="approx", **kw),
                    lambda: kr.sv_round3_first(pts, f, mode="fast", **kw),
                    lambda: kr.sv_round3_first(pts, f, **kw), cost)
                g = se_gate(e.p["conv1"], po[2]).repeat(1, 3)
                outs = [(po[0], po[1] * g[:, :, None])]
                for rnd, (S, V, S_out, V_out) in e.rounds.items():
                    src = torch.cat(outs[-1], dim=1).contiguous()
                    C = S + 3 * V
                    T = quant.round3_tiles(n, C, "approx")
                    name = approx_name("sv_round3", bits, tag)
                    ef, pm1 = edge_flops(S, V, S_out, V_out, binary=True)
                    cost = bound(knn_flops(b, n, C) + b * n * k * ef,
                                 4.0 * b * n * (C + S_out + 3 * V_out + 2 * S + k),
                                 b * n * k * pm1)
                    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k)
                    fb = e.folded[rnd]
                    po = timed_approx(
                        rep, f"{name} {rnd} binary B={b} N={n} k={k} T={T} L={L}",
                        name,
                        lambda: kr.sv_round3(src, fb, emit_wins=True, mode="approx", **kw),
                        lambda: kr.sv_round3_plain(src, fb, binary=True, mode="approx", **kw),
                        lambda: kr.sv_round3(src, fb, mode="fast", **kw),
                        lambda: kr.sv_round3(src, fb, **kw), cost)
                    ffp = e_fp.folded[rnd]
                    check_equal(f"{name} {rnd} fp",
                                kr.sv_round3(src, ffp, binary=False, mode="approx",
                                             emit_wins=True, **kw),
                                kr.sv_round3_plain(src, ffp, binary=False,
                                                   mode="approx", **kw))
                    g = se_gate(e.p[rnd], po[2]).repeat(1, 3)
                    outs.append((po[0], po[1] * g[:, :, None]))
        with approx_knobs(bits, FOLD["cls"]), gather_bits(bits):
            pts = cloud(B, N, gen, dev)
            f = pn["cls"]["kernel"].folded_first
            kw = dict(S_out=32, V_out=10, k=K, cross=True)
            name = approx_name("sv_round3_first cross", bits, "cls")
            ef, _ = edge_flops(0, 1, 32, 10, first=True, cross=True)
            timed_approx(rep, f"{name} B={B} N={N} k={K}", name,
                         lambda: kr.sv_round3_first(pts, f, emit_wins=True,
                                                    mode="approx", **kw),
                         lambda: kr.sv_round3_first_plain(pts, f, mode="approx", **kw),
                         lambda: kr.sv_round3_first(pts, f, mode="fast", **kw),
                         lambda: kr.sv_round3_first(pts, f, **kw),
                         bound(knn_flops(B, N, 3) + B * N * K * ef,
                               4.0 * B * N * (3 + 32 + 30 + 9 + K)))
        phase2_approx_forced(bits, gen, dev)


# (B, N, k, fold, key tile T or None, duplicated points) of B1 and B2 in
# approx mode: L = 250 (N = 1000, fold 256), no multiple of the
# selection's 128-lane tile, with T = N; L = 64 (fold 64) with 4 and 16
# rows a class and several key tiles a cloud; k = 40 and k = 64 = L
# against a small L; N at or below the fold (the ids are fast mode's);
# exact ties
APPROX_FORCED = ((2, 1000, 20, 256, None, False), (2, 1000, 64, 256, None, True),
                 (3, 256, 40, 64, 64, True), (2, 256, 64, 64, 128, False),
                 (1, 1024, 33, 64, 128, False), (2, 200, 33, 256, None, False))


def phase2_approx_forced(bits, gen, dev):
    """B1 (xyz V_out 10, cross V_out 16) and B2 ((5, 3) -> (13, 7) binary
    and FP, cls conv4's widths binary) in approx mode at APPROX_FORCED,
    ids and outputs bitwise their plain versions; at N <= fold the ids
    equal fast mode's."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    for b, n, k, fold, T, dup in APPROX_FORCED:
        with approx_knobs(bits, fold), gather_bits(bits):
            pts = select_input(b, n, 3, dup, gen, dev)
            for cross, V_out in ((False, 10), (True, 16)):
                n_ch = 3 if cross else 2
                f = {name: torch.randn(*shape, generator=gen).to(dev)
                     for name, shape in (("wz0", (n_ch, 3)), ("wz1", (n_ch, 3)),
                                         ("w1", (6 * n_ch, 32)), ("a1", (1, 32)),
                                         ("b1", (1, 32)), ("w2", (n_ch, V_out)),
                                         ("a2", (1, V_out)), ("b2", (1, V_out)))}
                kw = dict(S_out=32, V_out=V_out, k=k, cross=cross, T=T)
                got = kr.sv_round3_first(pts, f, emit_wins=True, mode="approx", **kw)
                check_equal(f"sv_round3_first approx{bits} B={b} N={n} k={k}",
                            got, kr.sv_round3_first_plain(pts, f, mode="approx", **kw))
                if n <= fold:
                    check_equal(f"sv_round3_first approx{bits} N={n} <= fold: "
                                "fast ids", (got[3],),
                                (kr.sv_round3_first(pts, f, emit_wins=True,
                                                    mode="fast", **kw)[3],))
            for S, V, S_out, V_out, modes in ((5, 3, 13, 7, (True, False)),
                                              (64, 21, 128, 42, (True,))):
                src = select_input(b, n, S + 3 * V, dup, gen, dev)
                src = src.transpose(1, 2).contiguous()
                for binary in modes:
                    f = round_weights(S, V, S_out, V_out, binary, gen, dev)
                    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k,
                              binary=binary, mode="approx", T=T)
                    check_equal(f"sv_round3 approx{bits} B={b} N={n} k={k}",
                                kr.sv_round3(src, f, emit_wins=True, **kw),
                                kr.sv_round3_plain(src, f, **kw))
        log(f"  approx{bits} forced B={b} N={n} k={k} fold={fold} "
            f"T={T or 'auto'}" + (" ties" if dup else "") + ": B1 (xyz, "
            "cross) and B2 (binary, fp) bitwise their plain versions"
            + ("; ids = fast mode's" if n <= fold else ""))


def recall(got, want) -> float:
    """Mean share of each centre's ids (B, k, N) found among ``want``'s."""
    hit = (got[:, :, None, :] == want[:, None, :, :]).any(dim=2)
    return hit.float().mean().item()


def approx_recall(eng, dev):
    """Recall of B1's and conv2's approx ids (fold 256, 16 bits) against
    exact ids on surface clouds (utils/synth.py) at (128, 1024, 20),
    Morton-sorted and shuffled: printed, not a bar. conv2's input is the
    exact first round's output on each cloud, gated."""
    import torch

    from svnet_tpu_torch.infer import se_gate
    from svnet_tpu_torch.ops import morton
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr
    from svnet_tpu_torch.utils.synth import surface_clouds

    pts = torch.from_numpy(surface_clouds(SEED + 17, B, N)).to(dev)
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(SEED + 17))
    S, V, S_out, V_out = eng.rounds["conv2"]
    kw1 = dict(S_out=32, V_out=10, k=K, emit_wins=True)
    kw2 = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, emit_wins=True)
    out = {}
    with approx_knobs(16, FOLD["cls"]):
        for order, cl in (("sorted", morton.sort_points(pts)[0]),
                          ("shuffled", pts[:, perm.to(dev)].contiguous())):
            ex = kr.sv_round3_first(cl, eng.folded_first, **kw1)
            ap = kr.sv_round3_first(cl, eng.folded_first, mode="approx", **kw1)
            g = se_gate(eng.p["conv1"], ex[2]).repeat(1, 3)
            src = torch.cat([ex[0], ex[1] * g[:, :, None]], dim=1).contiguous()
            ex2 = kr.sv_round3(src, eng.folded["conv2"], **kw2)
            ap2 = kr.sv_round3(src, eng.folded["conv2"], mode="approx", **kw2)
            out[order] = (recall(ap[3], ex[3]), recall(ap2[3], ex2[3]))
    log(f"phase 17: approx recall against exact ids, surface clouds "
        f"({B}, {N}, {K}), fold {FOLD['cls']}: B1 sorted {out['sorted'][0]:.6f}, "
        f"shuffled {out['shuffled'][0]:.6f}; conv2 sorted "
        f"{out['sorted'][1]:.6f}, shuffled {out['shuffled'][1]:.6f} (printed, "
        "not a bar; JAX's records: about 0.997 sorted at N=1024, k=20, fold 256)")
    if out["sorted"][0] < out["shuffled"][0]:
        log("phase 17: NOTE B1's sorted recall is below its shuffled recall")


def phase17(eng, pn, dg, w_bin, gen, dev, counters, card):
    """Approx-mode serving: 5 requests through each of the SV-DGCNN
    classifier (128, 1024, 3; fold 256), part segmenter (32, 2048, 3; fold
    512) and SV-PointNet classifier (128, 1024, 3; fold 256) at 16- and
    8-bit gathers, launches per request checked, top-1 against the approx
    plain twin; medians beside exact's and fast's; shuffled clouds give
    the same cls logits and the same un-permuted partseg logits (top-1
    >= 0.99); then the recall of the approx ids. Returns launches by
    entry name."""
    import torch

    from svnet_tpu_torch.infer import (
        SVDGCNNClsEngine,
        SVDGCNNPsegEngine,
        SVPointNetClsEngine,
    )
    from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg
    from svnet_tpu_torch.ops import morton

    p_pseg = init_params_pseg(PARTS, K_PSEG, True,
                              torch.Generator().manual_seed(SEED + 12))
    w_pn = pn["cls"]["weights"]
    dgcnn = {"sv_round3_first": 1, "sv_round3": 3, "neg_min": 4,
             "sv_point_block_cm": 1}

    def cls_req():
        return (cloud(B, N, gen, dev),)

    def pseg_req():
        return cloud(B_PSEG, N_PSEG, gen, dev), labels(B_PSEG, gen, dev)

    runs = []
    for bits in (16, 8):
        runs += [("cls", bits, SVDGCNNClsEngine, w_bin, (CLASSES, K), "phase 3",
                  cls_req, dgcnn),
                 ("pseg", bits, SVDGCNNPsegEngine, p_pseg, (PARTS, K_PSEG),
                  "phase 12", pseg_req, dgcnn),
                 ("cross", bits, SVPointNetClsEngine, w_pn, (CLASSES, K),
                  "phase 7", cls_req,
                  {"sv_round3_first": 1, "neg_min": 1, "sv_block_point": 7})]
    out = {}
    for tag, bits, engine, w, args, exact_phase, request, want_per in runs:
        label = f"phase 17 {tag} approx{bits}"
        with approx_knobs(bits, FOLD["pseg" if tag == "pseg" else "cls"]):
            appr = engine(w, *args, True, mode="approx", device=dev)
            oracle = engine(w, *args, True, mode="approx", device=dev, oracle=True)
            requests = [request() for _ in range(REQUESTS)]
            got, want, _, launches = serve(label, appr, oracle, requests,
                                           counters, want_per, card)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{label}: logits {tuple(got.shape)} not finite")
            agreement(f"{label}: vs the approx plain engine", got, want)
            fast_label = f"phase 16 {tag} fast{bits if tag != 'cross' else 16}"
            log(f"{label}: median {MEDIANS[label]:.3f} ms, fast mode "
                f"{MEDIANS[fast_label]:.3f} ms ({fast_label}), exact mode "
                f"{MEDIANS[exact_phase]:.3f} ms ({exact_phase}) | {card}")
            if tag != "cross" and bits == 16:  # the sorting engines
                pts = requests[0][0]
                sort_ms = cuda_ms(lambda: morton.sort_points(pts))
                t0 = time.perf_counter()
                for _ in range(10):
                    morton.sort_points(pts)
                sync(dev)
                log(f"{label}: the Morton entry sort of a request: device "
                    f"{sort_ms:.4f} ms (CUDA events), host {(time.perf_counter() - t0) * 100:.4f} "
                    f"ms a call (10 calls, synchronized) | {card}")
                perm = torch.randperm(requests[0][0].shape[1],
                                      generator=gen).to(dev)
                shuffled = [(req[0][:, perm].contiguous(), *req[1:])
                            for req in requests]
                got_sh = torch.cat([appr(*req) for req in shuffled])
                if tag == "pseg":  # per-point logits in the shuffled order
                    got = got.reshape(REQUESTS, B_PSEG, N_PSEG, -1)[:, :, perm]
                    got = got.reshape(got_sh.shape)
                agreement(f"{label}: shuffled clouds vs the same clouds", got_sh, got)
        if tag == "cross":
            out[approx_name("sv_round3_first cross", bits, "cls")] = \
                launches["sv_round3_first"]
            continue
        out[approx_name("sv_round3_first", bits, tag)] = launches["sv_round3_first"]
        out[approx_name("sv_round3", bits, tag)] = launches["sv_round3"]
    approx_recall(eng, dev)
    return out


@contextlib.contextmanager
def reuse_knobs(name, r=0, window=0):
    """config.graph_reuse = name, reuse_k = r, reuse_gather_window = window
    inside the block."""
    from svnet_tpu_torch import config

    was = config.graph_reuse, config.reuse_k, config.reuse_gather_window
    config.set_graph_reuse(name)
    config.set_reuse_k(r)
    config.set_reuse_gather_window(window)
    try:
        yield
    finally:
        config.set_graph_reuse(was[0])
        config.set_reuse_k(was[1])
        config.set_reuse_gather_window(was[2])


def reuse_name(mode, bits, tag):
    """The kernels line's name of a reuse round: 'sv_round3_reuse' (exact
    cls), 'sv_round3_reuse approx8', 'sv_round3_reuse approx8 pseg'."""
    if mode == "exact":
        return "sv_round3_reuse" + ("" if tag == "cls" else f" {tag}")
    return approx_name("sv_round3_reuse", bits, tag)


def reuse_cost(b, n, r, S, V, S_out, V_out):
    """(least ms, bound) of a binary reuse round: the block's operations
    only (no selection), src and the ids read once, s, v and the gate sums
    written once."""
    ef, pm1 = edge_flops(S, V, S_out, V_out, binary=True)
    return bound(b * n * r * ef,
                 4.0 * b * n * (S + 3 * V + r + S_out + 3 * V_out + 2 * S),
                 b * n * r * pm1)


# the (ids, ranks) each kernels-line entry of B2 reuse is timed at: those
# of its phase-18 engine (exact cls: conv2's ids, r = k; approx 8-bit cls:
# B1's, r = k; approx 8-bit partseg: B1's, r = 20 = k / 2)
REUSE_TIMED = {("cls", "exact", 16): ("conv2", 1), ("cls", "approx", 8): ("spatial", 1),
               ("pseg", "approx", 8): ("spatial", 2)}


def phase2_reuse(rep, eng, eng_fp, dg, gen, dev):
    """B2 on given ids (graph reuse) against its plain version on the same
    ids, bitwise: at the cls (128, 1024, 20) and partseg (32, 2048, 40)
    shapes on a Morton-sorted cloud, conv2-4 on B1's ids and conv3-4 on
    conv2's, at r = k and r = k/2, in exact mode and approx mode at 16 and
    8 bits (fold 256 / 512), binary and FP; inputs chained through the
    plain reuse rounds on B1's ids; binary calls timed, and the selecting
    round on the same input beside them; then REUSE_FORCED."""
    import torch

    from svnet_tpu_torch.infer import se_gate
    from svnet_tpu_torch.ops import morton
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    for tag, e, e_fp, (b, n, k) in (
            ("cls", eng, eng_fp, (B, N, K)),
            ("pseg", dg["pseg round3"]["kernel"], dg["pseg round3"]["kernel_fp"],
             (B_PSEG, N_PSEG, K_PSEG))):
        pts = morton.sort_points(cloud(b, n, gen, dev))[0]
        for mode, bits in (("exact", 16), ("approx", 16), ("approx", 8)):
            name = reuse_name(mode, bits, tag)
            timed = REUSE_TIMED.get((tag, mode, bits))
            with approx_knobs(bits, FOLD[tag]):
                S1, V1 = e.dims["conv1"]
                po = kr.sv_round3_first_plain(pts, e.folded_first, S_out=S1,
                                              V_out=V1, k=k, mode=mode)
                wins = {"spatial": po[3]}
                g = se_gate(e.p["conv1"], po[2]).repeat(1, 3)
                src = torch.cat([po[0], po[1] * g[:, :, None]], dim=1).contiguous()
                for rnd, (S, V, S_out, V_out) in e.rounds.items():
                    dims = dict(S=S, V=V, S_out=S_out, V_out=V_out, mode=mode)
                    fb, ffp = e.folded[rnd], e_fp.folded[rnd]
                    if rnd == "conv2":
                        wins["conv2"] = kr.sv_round3_plain(src, fb, k=k, binary=True,
                                                           **dims)[3]
                    sel_ms = cuda_ms(lambda: kr.sv_round3(src, fb, k=k, **dims))
                    chain = None
                    for source, w in wins.items():
                        if source == rnd:
                            continue
                        for r in (k, k // 2):
                            kw = dict(dims, k=r, wins_in=w[:, :r])
                            label = (f"{mode}{bits} {tag} {rnd} on {source} ids "
                                     f"B={b} N={n} k={k} r={r}")
                            ko = kr.sv_round3(src, fb, **kw)
                            po = kr.sv_round3_plain(src, fb, binary=True, **kw)
                            sync(dev)
                            check_equal(label + " binary", ko, po)
                            check_equal(label + " fp",
                                        kr.sv_round3(src, ffp, binary=False, **kw),
                                        kr.sv_round3_plain(src, ffp, binary=False, **kw))
                            # as the engines call it: the ids an earlier
                            # round emitted, no range check
                            ms = cuda_ms(lambda: kr.sv_round3(src, fb, emitted=True, **kw))
                            cost = reuse_cost(b, n, r, S, V, S_out, V_out)
                            line = (f"  B2 reuse {label}: bitwise (binary, fp); "
                                    f"kernel {ms:.4f} ms, selecting round "
                                    f"{sel_ms:.4f} ms, bound {cost}")
                            if timed == (source, k // r):
                                plain_ms = cuda_ms(lambda: kr.sv_round3_plain(
                                    src, fb, binary=True, **kw))
                                rep.add(name, 0.0, ms, plain_ms, cost)
                                line += f", plain {plain_ms:.3f} ms"
                            log(line)
                            if source == "spatial" and r == k:
                                chain = po
                    g = se_gate(e.p[rnd], chain[2]).repeat(1, 3)
                    src = torch.cat([chain[0], chain[1] * g[:, :, None]],
                                    dim=1).contiguous()
    for bits in (16, 8):
        phase2_reuse_forced(bits, gen, dev)


# (B, N, k, r) of B2 reuse: the ids of a k selection, their first r ranks
# a strided view at B >= 2 (r < k: a batch stride of k * N, not r * N);
# N and k that no edge tile (32 centres x 2 ranks) divides
REUSE_FORCED = ((2, 1000, 20, 7), (2, 1001, 33, 33), (3, 256, 40, 20))


def phase2_reuse_forced(bits, gen, dev):
    """B2 reuse at REUSE_FORCED in exact, fast and approx mode ((5, 3) ->
    (13, 7) binary and FP, cls conv4's widths binary): bitwise its plain
    version on the strided prefix and on its contiguous copy, one launch
    and no pre-pass a call."""
    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    for b, n, k, r in REUSE_FORCED:
        with approx_knobs(bits, 256), gather_bits(bits):
            for S, V, S_out, V_out, modes in ((5, 3, 13, 7, (True, False)),
                                              (64, 21, 128, 42, (True,))):
                src = select_input(b, n, S + 3 * V, False, gen, dev)
                src = src.transpose(1, 2).contiguous()
                for binary in modes:
                    f = round_weights(S, V, S_out, V_out, binary, gen, dev)
                    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, binary=binary)
                    view = kr.sv_round3(src, f, k=k, emit_wins=True, **kw)[3][:, :r]
                    for mode in ("exact", "fast", "approx"):
                        tag = f"B2 reuse {mode}{bits} B={b} N={n} k={k} r={r}"
                        before = (kr.sv_round3_reuse.launches, kk.neg_min.launches)
                        got = kr.sv_round3(src, f, k=r, mode=mode, wins_in=view, **kw)
                        if (kr.sv_round3_reuse.launches - before[0],
                                kk.neg_min.launches - before[1]) != (1, 0):
                            raise AssertionError(f"{tag}: not one launch without a pre-pass")
                        check_equal(tag, got, kr.sv_round3_plain(
                            src, f, k=r, mode=mode, wins_in=view, **kw))
                        check_equal(tag + " contiguous ids", got, kr.sv_round3(
                            src, f, k=r, mode=mode, wins_in=view.contiguous(), **kw))
        log(f"  reuse{bits} forced B={b} N={n} k={k} r={r}: B2 reuse (exact, "
            "fast, approx; binary, fp) bitwise its plain version on the "
            "strided rank prefix and on its copy; one launch, no pre-pass")


def request_median(eng, requests) -> float:
    """Median device time (CUDA events) of eng on each request, after one
    warm-up request."""
    import torch

    eng(*requests[0])
    lat = []
    for req in requests:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        eng(*req)
        e1.record()
        torch.cuda.synchronize()
        lat.append(e0.elapsed_time(e1))
    return sorted(lat)[len(lat) // 2]


@contextlib.contextmanager
def checked_ids():
    """The engines' reuse rounds run the id range check that they skip for
    the ids an earlier round emitted (sv_round3.check_ids: it waits for
    the device): what the check would cost a request. A measurement only,
    never a path the port takes."""
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    was = kr.check_ids
    kr.check_ids = lambda idx, shape, N, device, in_range=False: was(
        idx, shape, N, device)
    try:
        yield
    finally:
        kr.check_ids = was


def phase18(w_bin, gen, dev, counters, card):
    """The JAX package's serving pick and exact conv2 reuse, 5 requests
    each: launches per request checked, logits bitwise the oracle twin's,
    medians beside approx mode's without reuse (phase 17) and exact mode's
    (phases 3, 12) and beside the same engine with the id range check
    run in each reuse round; reuse_gather_window=512 bitwise the same
    logits. Returns launches by entry name."""
    import torch

    from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVDGCNNPsegEngine
    from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg

    p_pseg = init_params_pseg(PARTS, K_PSEG, True,
                              torch.Generator().manual_seed(SEED + 12))
    spatial = {"sv_round3_first": 1, "sv_round3": 3, "sv_round3_reuse": 3,
               "neg_min": 1, "sv_point_block_cm": 1}
    conv2 = {"sv_round3_first": 1, "sv_round3": 3, "sv_round3_reuse": 2,
             "sv_point_block_cm": 1}

    def cls_req():
        return (cloud(B, N, gen, dev),)

    def pseg_req():
        return cloud(B_PSEG, N_PSEG, gen, dev), labels(B_PSEG, gen, dev)

    # (tag, engine, weights, args, mode, bits, graph_reuse, reuse_k,
    # request, launches per request, the same engine without reuse)
    runs = (("cls", SVDGCNNClsEngine, w_bin, (CLASSES, K), "approx", 8,
             "spatial", 0, cls_req, spatial, "phase 17 cls approx8"),
            ("pseg", SVDGCNNPsegEngine, p_pseg, (PARTS, K_PSEG), "approx", 8,
             "spatial", 20, pseg_req, spatial, "phase 17 pseg approx8"),
            ("cls", SVDGCNNClsEngine, w_bin, (CLASSES, K), "exact", 16,
             "conv2", 0, cls_req, conv2, "phase 3"))
    out = {}
    for tag, engine, w, args, mode, bits, reuse, r, request, want_per, base in runs:
        exact_phase = "phase 3" if tag == "cls" else "phase 12"
        label = f"phase 18 {tag} {mode}{bits if mode != 'exact' else ''} {reuse}" + (
            f" reuse_k={r}" if r else "")
        with approx_knobs(bits, FOLD[tag]):
            eng = engine(w, *args, True, mode=mode, device=dev)
            oracle = engine(w, *args, True, mode=mode, device=dev, oracle=True)
            requests = [request() for _ in range(REQUESTS)]
            with reuse_knobs(reuse, r):
                got, want, _, launches = serve(label, eng, oracle, requests,
                                               counters, want_per, card)
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{label}: logits {tuple(got.shape)} not finite")
                if not torch_equal(got, want):
                    raise AssertionError(f"{label}: logits differ from the oracle "
                                         f"twin's by {(got - want).abs().max().item()}")
                if mode == "approx":
                    with reuse_knobs(reuse, r, 512):
                        windowed = torch.cat([eng(*req) for req in requests])
                    if not torch_equal(windowed, got):
                        raise AssertionError(f"{label}: reuse_gather_window=512 "
                                             "changed the logits")
                with checked_ids():
                    checked = request_median(eng, requests)
            without = torch.cat([eng(*req) for req in requests])
        top1 = (got.argmax(-1) == without.argmax(-1)).float().mean().item()
        log(f"{label}: logits bitwise the oracle twin's"
            + ("; reuse_gather_window=512 bitwise" if mode == "approx" else "")
            + f"; median {MEDIANS[label]:.3f} ms, without reuse "
            f"{MEDIANS[base]:.3f} ms ({base}), exact mode "
            f"{MEDIANS[exact_phase]:.3f} ms ({exact_phase}); with the id range "
            f"check in each reuse round {checked:.3f} ms | {card}; top-1 "
            f"agreement with the engine without reuse {top1:.6f} (random "
            "weights, not a bar)")
        out[reuse_name(mode, bits, tag)] = launches["sv_round3_reuse"]
    return out


# ---------------------------------------------------------------------------
# the legacy row-major trunks' fast and approx mode (round2, round)
# ---------------------------------------------------------------------------

# the legacy trunks' key-tile parameter: the SV-DGCNN engines' default
# (svnet_tpu/infer.py:236, :549), whence T = 256 at N = 1024 and 2048
LEGACY_TILE = 64


def legacy_name(kernel, mode, tag):
    """The kernels line's name of a legacy fast or approx entry:
    'sv_round2 fast', 'sv_round2_first approx pseg', 'sv_round fast'."""
    return f"{kernel} {mode}" + ("" if tag == "cls" else f" {tag}")


def phase2_legacy(rep, eng, eng_fp, dg, gen, dev):
    """B10b (round2) in fast and approx mode at the cls (128, 1024, 20) and
    partseg (32, 2048, 40) shapes and B10a (round) with exact=False at the
    cls shape, against their plain versions: ids (B10b) and outputs
    bitwise, inputs chained through the plain versions, binary timed beside
    the same kernel in exact mode on the same input, FP bitwise; key tiles
    from the engines' heuristic (quant.auto_round_tile); then
    LEGACY_FORCED."""
    import torch

    from svnet_tpu_torch.infer import se_gate
    from svnet_tpu_torch.ops.kernels import quant
    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2

    runs = [("round2", mode, tag, dg[f"{tag} round2"], shape)
            for tag, shape in (("cls", (B, N, K)),
                               ("pseg", (B_PSEG, N_PSEG, K_PSEG)))
            for mode in ("fast", "approx")]
    runs.append(("round", "fast", "cls", {"kernel": eng, "kernel_fp": eng_fp},
                 (B, N, K)))
    for impl, mode, tag, engs, (b, n, k) in runs:
        e, e_fp = engs["kernel"], engs["kernel_fp"]
        if impl == "round2":
            first, first_p, rnd, rnd_p = (k2.sv_round2_first,
                                          k2.sv_round2_first_plain,
                                          k2.sv_round2, k2.sv_round2_plain)
            kmode, xmode = dict(mode=mode), dict(mode="exact")
        else:
            first, first_p, rnd, rnd_p = (k1.sv_round_first,
                                          k1.sv_round_first_plain,
                                          k1.sv_round, k1.sv_round_plain)
            kmode, xmode = dict(exact=False), dict(exact=True)
        ids = dict(emit_wins=True) if impl == "round2" else {}
        S1, V1 = e.dims["conv1"]
        pts = cloud(b, n, gen, dev)
        T = quant.auto_round_tile(n, LEGACY_TILE, k, 3, mode)
        kw = dict(S_out=S1, V_out=V1, k=k, T=T)
        f = e.folded_first
        name = legacy_name(first.__name__, mode, tag)
        ef, pm1 = edge_flops(0, 1, S1, V1, True)
        cost = bound(knn_flops(b, n, 3) + b * n * k * ef,
                     4.0 * b * n * (3 + S1 + 3 * V1 + 6 + k), b * n * k * pm1)
        po = timed_fast(rep, f"{name} B={b} N={n} k={k} T={T}", name,
                        lambda: first(pts, f, **ids, **kmode, **kw),
                        lambda: first_p(pts, f, **kmode, **kw),
                        lambda: first(pts, f, **xmode, **kw), cost)
        g = se_gate(e.p["conv1"], po[2]).repeat(1, 3)
        outs = [(po[0], po[1] * g[:, None, :])]
        for rname, (S, V, S_out, V_out) in e.rounds.items():
            src = torch.cat(outs[-1], dim=-1).contiguous()
            C = S + 3 * V
            T = quant.auto_round_tile(n, LEGACY_TILE, k, C, mode)
            name = legacy_name(rnd.__name__, mode, tag)
            ef, pm1 = edge_flops(S, V, S_out, V_out, binary=True)
            cost = bound(knn_flops(b, n, C) + b * n * k * ef,
                         4.0 * b * n * (C + S_out + 3 * V_out + 2 * S + k),
                         b * n * k * pm1)
            kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, T=T)
            fb, ffp = e.folded[rname], e_fp.folded[rname]
            po = timed_fast(
                rep, f"{name} {rname} binary B={b} N={n} k={k} T={T}", name,
                lambda: rnd(src, fb, binary=True, **ids, **kmode, **kw),
                lambda: rnd_p(src, fb, binary=True, **kmode, **kw),
                lambda: rnd(src, fb, binary=True, **xmode, **kw), cost)
            check_equal(f"{name} {rname} fp",
                        rnd(src, ffp, binary=False, **ids, **kmode, **kw),
                        rnd_p(src, ffp, binary=False, **kmode, **kw))
            g = se_gate(e.p[rname], po[2]).repeat(1, 3)
            outs.append((po[0], po[1] * g[:, None, :]))
    phase2_legacy_forced(gen, dev)


# (B, N, k, key tile T, duplicated points) of the legacy trunks' fast and
# approx mode, as tests/test_torch_cuda.py's: T = 8 at N = 1000 (approx
# L = 250), k = 33 above a 32-entry list, N at the fold (approx is fast)
# with ties, k = 64 over several key tiles, one key tile a cloud
LEGACY_FORCED = ((2, 1000, 7, 8, False), (2, 1024, 33, 256, False),
                 (3, 256, 40, 64, True), (1, 2048, 64, 128, False),
                 (2, 512, 20, 512, False))


def phase2_legacy_forced(gen, dev):
    """B10b's first round (xyz and cross, V_out 10 and 16) and conv round
    ((5, 3) -> (13, 7) and cls conv4's widths, binary and FP) in fast and
    approx mode, and B10a's with exact=False, at LEGACY_FORCED: ids and
    outputs bitwise their plain versions; at N <= 256 approx's ids are
    fast's."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2

    for b, n, k, T, dup in LEGACY_FORCED:
        pts = select_input(b, n, 3, dup, gen, dev)
        for cross in (False, True):
            for V_out in (10, 16):
                n_ch = 3 if cross else 2
                f = {name: torch.randn(*shape, generator=gen).to(dev)
                     for name, shape in (("wz0", (n_ch, 3)), ("wz1", (n_ch, 3)),
                                         ("w1", (6 * n_ch, 32)), ("a1", (1, 32)),
                                         ("b1", (1, 32)), ("w2", (n_ch, V_out)),
                                         ("a2", (1, V_out)), ("b2", (1, V_out)))}
                kw = dict(S_out=32, V_out=V_out, k=k, cross=cross, T=T)
                tag = f"B={b} N={n} k={k} T={T}"
                for mode in ("fast", "approx"):
                    got = k2.sv_round2_first(pts, f, emit_wins=True, mode=mode, **kw)
                    check_equal(f"sv_round2_first {mode} {tag}", got,
                                k2.sv_round2_first_plain(pts, f, mode=mode, **kw))
                    if mode == "approx" and n <= 256:
                        check_equal(f"sv_round2_first approx=fast ids {tag}",
                                    got[3:], k2.sv_round2_first(
                                        pts, f, emit_wins=True, mode="fast", **kw)[3:])
                check_equal(f"sv_round_first fast {tag}",
                            k1.sv_round_first(pts, f, exact=False, **kw),
                            k1.sv_round_first_plain(pts, f, exact=False, **kw))
        for S, V, S_out, V_out in ((5, 3, 13, 7), (64, 21, 128, 42)):
            src = select_input(b, n, S + 3 * V, dup, gen, dev)
            for binary in (True, False):
                f = round_weights(S, V, S_out, V_out, binary, gen, dev)
                kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k,
                          binary=binary, T=T)
                tag = f"B={b} N={n} k={k} T={T}"
                for mode in ("fast", "approx"):
                    check_equal(f"sv_round2 {mode} {tag}",
                                k2.sv_round2(src, f, emit_wins=True, mode=mode, **kw),
                                k2.sv_round2_plain(src, f, mode=mode, **kw))
                check_equal(f"sv_round fast {tag}",
                            k1.sv_round(src, f, exact=False, **kw),
                            k1.sv_round_plain(src, f, exact=False, **kw))
        log(f"  legacy forced B={b} N={n} k={k} T={T}" + (" ties" if dup else "")
            + ": B10b fast and approx, B10a fast (first: xyz, cross; V_out 10, "
            "16; conv: binary, fp) bitwise their plain versions")


def phase20(dg, w_bin, gen, dev, counters, card):
    """The legacy trunks' fast and approx mode at the path shapes: 5
    requests each through SVDGCNNClsEngine (128, 1024, 3) with
    rounds_impl="round2" in fast and approx mode and "round" in fast mode,
    and SVDGCNNPsegEngine (32, 2048, 3) with "round2" in fast and approx
    mode; launches per request checked (the pre-pass once a round); top-1
    against the plain twin (>= 0.99; bitwise expected); the median beside
    the same trunk in exact mode on the same requests and phase 13's.
    Returns launches by entry name."""
    import torch

    from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVDGCNNPsegEngine
    from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg

    p_pseg = init_params_pseg(PARTS, K_PSEG, True,
                              torch.Generator().manual_seed(SEED + 12))
    cls_req = lambda: (cloud(B, N, gen, dev),)  # noqa: E731
    pseg_req = lambda: (cloud(B_PSEG, N_PSEG, gen, dev), labels(B_PSEG, gen, dev))  # noqa: E731
    out = {}
    for impl, mode, tag, engine, w, args, request in (
            ("round2", "fast", "cls", SVDGCNNClsEngine, w_bin, (CLASSES, K), cls_req),
            ("round2", "approx", "cls", SVDGCNNClsEngine, w_bin, (CLASSES, K), cls_req),
            ("round2", "fast", "pseg", SVDGCNNPsegEngine, p_pseg, (PARTS, K_PSEG), pseg_req),
            ("round2", "approx", "pseg", SVDGCNNPsegEngine, p_pseg, (PARTS, K_PSEG), pseg_req),
            ("round", "fast", "cls", SVDGCNNClsEngine, w_bin, (CLASSES, K), cls_req)):
        first, rnd = (("sv_round2_first", "sv_round2") if impl == "round2"
                      else ("sv_round_first", "sv_round"))
        want_per = {first: 1, rnd: 3, "neg_min": 4, "sv_point_block": 1}
        label = f"phase 20 {tag} {impl} {mode}"
        kw = dict(mode=mode, device=dev, rounds_impl=impl, tile=LEGACY_TILE)
        eng = engine(w, *args, True, **kw)
        oracle = engine(w, *args, True, oracle=True, **kw)
        requests = [request() for _ in range(REQUESTS)]
        got, want, _, launches = serve(label, eng, oracle, requests, counters,
                                       want_per, card)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: logits {tuple(got.shape)} not finite")
        agreement(f"{label}: vs its plain engine", got, want)
        exact = dg[f"{tag} {impl}"]["kernel"]  # the same weights, exact mode
        exact_ms = request_median(exact, requests)
        ex = torch.cat([exact(*req) for req in requests])
        top1 = (got.argmax(-1) == ex.argmax(-1)).float().mean().item()
        log(f"{label}: median {MEDIANS[label]:.3f} ms; {impl} exact on the same "
            f"requests {exact_ms:.3f} ms (phase 13 {tag} "
            f"{MEDIANS['phase 13 ' + tag]:.3f} ms) | {card}; top-1 agreement "
            f"with exact mode {top1:.6f} (random weights, not a bar)")
        out[legacy_name(first, mode, tag)] = launches[first]
        out[legacy_name(rnd, mode, tag)] = launches[rnd]
    return out


# ---------------------------------------------------------------------------
# the edge trunk's fast and approx mode (B10c, B10d exact=False), B4's mode
# ---------------------------------------------------------------------------

KNN_TILE = 128  # B4's key tile at both JAX callers (infer.py:305, ops/knn.py:89)
# (B, N, C, k, tile, duplicated points) of B4's modes, as
# tests/test_torch_edge_modes.py's: N at the fold, two key tiles folded
# 512 -> 256, N = 384 folded to 192 lanes at k = 40, ties on tiles of 64
KNN_MODE_FORCED = ((2, 256, 3, 8, 128, False), (2, 512, 16, 20, 128, False),
                   (1, 384, 16, 40, 128, False), (2, 256, 3, 8, 64, True))


def knn_mode_cost(b, n, c, k):
    """(least ms, what bounds it) of B4 in fast or approx mode: the
    distances of all pairs once, then per pair the key (scale, floor,
    clamp, pack: 4 operations; the fold's max is one more in approx mode,
    counted here too); x read once, the ids written once."""
    return bound(knn_flops(b, n, c) + 5.0 * b * n * n, 4.0 * b * n * (c + k))


def compare_knn_mode(rep, tag, x, kk, mode, time_it, tile=KNN_TILE):
    """B4 with ``mode`` (the pre-pass, then the selection on the key tiles'
    scales; folded to 256 lanes in approx mode) bitwise its plain version,
    one kernel and one pre-pass launch a call (knn.neg_min_launches);
    timed beside exact B4 and torch.cdist + torch.topk on the same x.
    Returns the plain ids."""
    import torch

    from svnet_tpu_torch.ops.kernels.knn import knn, knn_mode_plain, neg_min

    before = (knn.launches, neg_min.launches, knn.neg_min_launches)
    ko = knn(x, kk, mode=mode, tile=tile)
    after = (knn.launches, neg_min.launches, knn.neg_min_launches)
    po = knn_mode_plain(x, kk, mode, tile)
    sync(x.device)
    if [a - b for a, b in zip(after, before)] != [1, 1, 1]:
        raise AssertionError(f"{tag}: launches (knn, neg_min, its pre-pass "
                             f"count) {before} -> {after}, not one each")
    if not torch.equal(ko, po):
        check_ids(tag, ko.transpose(1, 2), po.transpose(1, 2), x)
        raise AssertionError(f"{tag}: ids not bitwise the plain version's")
    name = f"knn {mode}"
    if not time_it:
        log(f"  {tag}: ids bitwise the plain version's")
        rep.add(name, 0.0)
        return po
    bb, nn, C = x.shape

    def library():
        return torch.topk(torch.cdist(x, x), kk, dim=-1, largest=False).indices

    ms, plain_ms = (cuda_ms(lambda: knn(x, kk, mode=mode, tile=tile)),
                    cuda_ms(lambda: knn_mode_plain(x, kk, mode, tile)))
    exact_ms, lib_ms = cuda_ms(lambda: knn(x, kk)), cuda_ms(library)
    cost = knn_mode_cost(bb, nn, C, kk)
    log(f"  {tag}: ids bitwise the plain version's; kernel {ms} ms (the "
        f"pre-pass included; exact B4 {exact_ms} ms), plain {plain_ms} ms, "
        f"cdist+topk {lib_ms} ms, bound {cost}")
    rep.add(name, 0.0, ms, plain_ms, cost, lib_ms)
    return po


def phase2_edge_modes(rep, eng, eng_fp, dg, gen, dev):
    """The edge trunk's fast and approx mode against the plain versions at
    the cls shape (128, 1024, 20), inputs chained through the plain
    exact=False rounds: B10d with exact=False (on the bf16 points) and
    B10c with exact=False at conv2-4 (sv_round_block_kernel<true, true,
    true>), binary timed beside the same kernel in exact mode on the same
    input and ids, FP bitwise; B4 in fast and approx mode (T = 128) on
    each round's input, timed beside exact B4 and cdist + topk; B4's modes
    at the partseg shapes (32, 2048, 40) on the round2 trunk's round
    inputs; then the forced shapes (CONV_FORCED's (5, 3) -> (13, 7) at
    N = 1000 and 1001, FIRST_FORCED's (2, 1000, 7), KNN_MODE_FORCED).
    Returns the cls round inputs (B4's inputs on the edge trunk)."""
    import torch

    from svnet_tpu_torch.infer import se_gate
    from svnet_tpu_torch.ops.kernels import sv_edge as ke
    from svnet_tpu_torch.ops.kernels import sv_edge_first as kf
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels.knn import knn

    def timed(label, name, kern, plain, exact, cost):
        ko, po = kern(), plain()
        sync(dev)
        check_equal(label, ko, po)
        ms, plain_ms, exact_ms = cuda_ms(kern), cuda_ms(plain), cuda_ms(exact)
        log(f"  {label}: outputs bitwise; kernel {ms} ms (exact mode "
            f"{exact_ms} ms), plain {plain_ms} ms, bound {cost}")
        rep.add(name, 0.0, ms, plain_ms, cost)
        return po

    b, n, k = B, N, K
    shape = f"B={b} N={n} k={k}"
    S1, V1 = eng.dims["conv1"]
    pts = cloud(b, n, gen, dev)
    feats = [pts]
    for mode in ("fast", "approx"):
        compare_knn_mode(rep, f"knn {mode} cls {shape} C=3", pts, k, mode, True)
    idx = knn(pts, k)
    f, kw = eng.folded_first, dict(S_out=S1, V_out=V1, k=k)
    ef, pm1 = edge_flops(0, 1, S1, V1, True)
    cost = bound(b * n * k * ef, 4.0 * b * n * (3 + k + S1 + 3 * V1 + 6),
                 b * n * k * pm1)
    po = timed(f"sv_edge_first_block exact=False {shape}",
               "sv_edge_first_block exact=False",
               lambda: kf.sv_edge_first_block(pts, idx, f, exact=False, **kw),
               lambda: kf.sv_edge_first_block_plain(pts, idx, f, exact=False, **kw),
               lambda: kf.sv_edge_first_block(pts, idx, f, **kw), cost)
    g = se_gate(eng.p["conv1"], po[2]).repeat(1, 3)
    outs = [(po[0], po[1] * g[:, None, :])]
    for name, (S, V, S_out, V_out) in eng.rounds.items():
        src = torch.cat(outs[-1], dim=-1).contiguous()
        feats.append(src)
        C = S + 3 * V
        for mode in ("fast", "approx"):
            compare_knn_mode(rep, f"knn {mode} cls {shape} C={C} ({name})", src,
                             k, mode, True)
        idx = knn(src, k)
        ef, pm1 = edge_flops(S, V, S_out, V_out, binary=True)
        cost = bound(b * n * k * ef,
                     4.0 * (b * n * (C + k + S_out + 3 * V_out) + b * V_out),
                     b * n * k * pm1)
        kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=True)
        kfp = dict(kw, binary=False)
        fb, ffp = eng.folded[name], eng_fp.folded[name]
        gate = ke.svblock_gate(eng.p[name], src[..., :S], idx)
        po = timed(f"sv_edge_block exact=False {name} binary {shape}",
                   "sv_edge_block exact=False",
                   lambda: ke.sv_edge_block(src, idx, gate, fb, exact=False, **kw),
                   lambda: ke.sv_edge_block_plain(src, idx, gate, fb, exact=False,
                                                  **kw),
                   lambda: ke.sv_edge_block(src, idx, gate, fb, **kw), cost)
        gate_fp = ke.svblock_gate(eng_fp.p[name], src[..., :S], idx)
        got = ke.sv_edge_block(src, idx, gate_fp, ffp, exact=False, **kfp)
        check_equal(f"sv_edge_block exact=False {name} fp {shape}", got,
                    ke.sv_edge_block_plain(src, idx, gate_fp, ffp, exact=False,
                                           **kfp))
        exact = ke.sv_edge_block(src, idx, gate_fp, ffp, **kfp)
        log(f"  sv_edge_block exact=False {name} fp {shape}: outputs bitwise; "
            f"max |dv| from exact mode {(got[1] - exact[1]).abs().max().item():.3g}"
            " (linear2 through bf16)")
        outs.append(po)

    # B4's modes at the partseg shapes, on the round2 trunk's round inputs
    e = dg["pseg round2"]["kernel"]
    bp, np_, kp = B_PSEG, N_PSEG, K_PSEG
    x = cloud(bp, np_, gen, dev)
    rounds = list(e.rounds.items())  # conv2..conv4: the last input is conv3's
    for i in range(len(rounds) + 1):
        for mode in ("fast", "approx"):
            compare_knn_mode(rep, f"knn {mode} pseg B={bp} N={np_} "
                             f"C={x.shape[-1]} k={kp}", x, kp, mode, True)
        if i == len(rounds):
            break
        if i == 0:
            S1, V1 = e.dims["conv1"]
            s, v, _ = k2.sv_round2_first(x, e.folded_first, S_out=S1, V_out=V1,
                                         k=kp)
        else:
            name, (S, V, S_out, V_out) = rounds[i - 1]
            s, v, _ = k2.sv_round2(x, e.folded[name], S=S, V=V, S_out=S_out,
                                   V_out=V_out, k=kp, binary=True)
        x = torch.cat([s, v], dim=-1).contiguous()

    # forced shapes
    for bb, nn, kk_, S, V, S_out, V_out in CONV_FORCED[:2]:
        src = torch.randn(bb, nn, S + 3 * V, generator=gen).to(dev)
        idx = knn(src, kk_)
        gate = torch.rand(bb, V_out, generator=gen).to(dev)
        for binary in (True, False):
            f = round_weights(S, V, S_out, V_out, binary, gen, dev)
            kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=kk_, binary=binary)
            check_equal(f"sv_edge_block exact=False forced B={bb} N={nn} k={kk_}",
                        ke.sv_edge_block(src, idx, gate, f, exact=False, **kw),
                        ke.sv_edge_block_plain(src, idx, gate, f, exact=False,
                                               **kw))
        log(f"  sv_edge_block exact=False forced B={bb} N={nn} k={kk_} "
            f"({S}, {V}) -> ({S_out}, {V_out}): binary and fp bitwise")
    pts = cloud(2, N_RAGGED, gen, dev)
    idx = knn(pts, 7)
    f, kw = eng_fp.folded_first, dict(S_out=32, V_out=10, k=7, exact=False)
    check_equal(f"sv_edge_first_block exact=False forced N={N_RAGGED} k=7",
                kf.sv_edge_first_block(pts, idx, f, **kw),
                kf.sv_edge_first_block_plain(pts, idx, f, **kw))
    for bb, nn, c, kk_, tile, dup in KNN_MODE_FORCED:
        x = select_input(bb, nn, c, dup, gen, dev)
        for mode in ("fast", "approx"):
            compare_knn_mode(rep, f"knn {mode} forced B={bb} N={nn} C={c} "
                             f"k={kk_} T={tile}" + (" ties" if dup else ""),
                             x, kk_, mode, False, tile)
    return feats


def phase21(dg, w_bin, feats, gen, dev, counters, card):
    """The edge trunk's fast and approx mode on the main path: 5 requests
    each through SVDGCNNClsEngine (128, 1024, 3) with rounds_impl="edge"
    in fast and in approx mode; per request knn four times (exact: no
    pre-pass), sv_edge_first_block once, sv_edge_block three times,
    sv_point_block once and neg_min never; top-1 against the plain twin
    (>= 0.99; bitwise expected); approx bitwise fast; the medians beside
    the edge trunk in exact mode on the same requests and phase 14's.
    Then B4's modes through their entry point, knn(x, 20, mode=...,
    tile=128), on the four round inputs of the edge trunk (``feats``),
    the counts zeroed first: knn and neg_min four times each a mode, the
    ids bitwise the plain version's. Returns launches by entry name."""
    import torch

    from svnet_tpu_torch.infer import SVDGCNNClsEngine
    from svnet_tpu_torch.ops.kernels import knn as kk

    requests = [(cloud(B, N, gen, dev),) for _ in range(REQUESTS)]
    want_per = {"knn": 4, "sv_edge_first_block": 1, "sv_edge_block": 3,
                "sv_point_block": 1, "neg_min": 0}
    exact = dg["cls edge"]["kernel"]  # the same weights, exact mode
    exact_ms = request_median(exact, requests)
    out, logits = {}, {}
    for mode in ("fast", "approx"):
        label = f"phase 21 edge {mode}"
        kw = dict(mode=mode, device=dev, rounds_impl="edge")
        eng = SVDGCNNClsEngine(w_bin, CLASSES, K, True, **kw)
        oracle = SVDGCNNClsEngine(w_bin, CLASSES, K, True, oracle=True, **kw)
        pre = kk.knn.neg_min_launches
        got, want, _, launches = serve(label, eng, oracle, requests, counters,
                                       want_per, card)
        if kk.knn.neg_min_launches != pre:
            raise AssertionError(f"{label}: the exact kNN launched a pre-pass")
        if (got.shape != (REQUESTS * B, CLASSES)
                or not bool(torch.isfinite(got).all())):
            raise AssertionError(f"{label}: logits {tuple(got.shape)} not finite")
        agreement(f"{label}: vs its plain engine", got, want)
        ex = torch.cat([exact(*req) for req in requests])
        top1 = (got.argmax(-1) == ex.argmax(-1)).float().mean().item()
        log(f"{label}: median {MEDIANS[label]:.3f} ms; edge exact on the same "
            f"requests {exact_ms:.3f} ms (phase 14 edge "
            f"{MEDIANS['phase 14 edge']:.3f} ms) | {card}; top-1 agreement with "
            f"exact mode {top1:.6f} (random weights, not a bar)")
        logits[mode] = got
        for name in ("sv_edge_first_block", "sv_edge_block"):
            out[f"{name} exact=False"] = (out.get(f"{name} exact=False", 0)
                                          + launches[name])
    if not torch_equal(logits["fast"], logits["approx"]):
        raise AssertionError("phase 21: edge approx logits are not fast's")
    log("phase 21: edge approx logits bitwise edge fast's")
    for mode in ("fast", "approx"):
        for fn in counters:
            fn.launches = 0
        kk.knn.neg_min_launches = 0
        ids = [kk.knn(x, K, mode=mode, tile=KNN_TILE) for x in feats]
        sync(dev)
        per = {fn.__name__: fn.launches for fn in counters if fn.launches}
        if per != {"knn": 4, "neg_min": 4} or kk.knn.neg_min_launches != 4:
            raise AssertionError(f"phase 21 knn {mode}: launches {per}, "
                                 f"pre-pass {kk.knn.neg_min_launches}")
        for x, got in zip(feats, ids):
            if not torch.equal(got, kk.knn_mode_plain(x, K, mode, KNN_TILE)):
                raise AssertionError(f"phase 21 knn {mode}: ids not bitwise")
        log(f"phase 21: knn(x, {K}, mode={mode!r}, tile={KNN_TILE}) on the edge "
            f"trunk's round inputs C={[x.shape[-1] for x in feats]}: launches "
            f"{per}, ids bitwise the plain version's")
        out[f"knn {mode}"] = per["knn"]
    return out


# ---------------------------------------------------------------------------
# the candidate window (window=)
# ---------------------------------------------------------------------------

# the window's cls shape (phase 19): the JAX package's long-cloud lever
# wins at N >= 8192 (README.md:502-506); B = 16, k = 20. The partseg
# request: B = 4, N = 8192, k = 40
B_LONG, N_LONG, B_LONG_PSEG = 16, 8192, 4
# (mode, gather bits) of the window's phase-2 cases; the kernels line
# times exact mode's and approx mode's at 8 bits (the serving pick's)
WINDOW_MODES = (("exact", 16), ("fast", 16), ("fast", 8), ("approx", 16),
                ("approx", 8))
WINDOW_TIMED = (("exact", 16), ("approx", 8))


def window_name(kernel, mode, bits):
    """The kernels line's name of a windowed entry: 'sv_round3 window',
    'sv_round3_first window approx8', 'neg_min window'."""
    return f"{kernel} window" + ("" if mode == "exact" else f" {mode}{bits}")


@contextlib.contextmanager
def mode_knobs(bits, fold):
    """Both gather grids at ``bits`` and the approx fold inside the block."""
    with approx_knobs(bits, fold), gather_bits(bits):
        yield


def surface(b, n, seed, dev, sort=True):
    """Seeded deformed-sphere surface clouds (utils/synth.py), Morton-sorted
    unless ``sort`` is False."""
    import torch

    from svnet_tpu_torch.ops import morton
    from svnet_tpu_torch.utils.synth import surface_clouds

    x = torch.from_numpy(surface_clouds(seed, b, n)).to(dev)
    return morton.sort_points(x)[0] if sort else x


def window_for(x, k, T):
    """A window width that certifies x (B, N, C) with key tiles of T and
    room to spare for other clouds: the kept rows of its fullest tile plus
    512, rounded up to a multiple of 1024."""
    from svnet_tpu_torch.ops.window import prune_prepass

    n = x.shape[1]
    keep, _ = prune_prepass(x, k, T, n - 128)
    W = -(-(int(keep.sum(-1).max()) * 128 + 512) // 1024) * 1024
    if W >= n:
        raise AssertionError(f"phase 2 window: no W < N={n} certifies the "
                             f"sorted clouds (kept rows {W})")
    return W


def window_pairs(x, k, T, W):
    """(centre, candidate) pairs the windowed selection ranks on x: each
    tile's kept rows where the batch certifies, else all N; and ok."""
    from svnet_tpu_torch.ops.window import prune_prepass

    b, n, _ = x.shape
    keep, ok = prune_prepass(x, k, T, W)
    if bool(ok):
        return T * 128.0 * int(keep.sum()), True, float(keep.float().mean())
    return float(b) * n * n, False, float(keep.float().mean())


def timed_window(rep, label, name, kern, plain, full, cost, time_plain):
    """A windowed call (kern) bitwise its plain version, ids included, then
    timed beside ``full``, the same kernel without a window on the same
    input, and (``time_plain``) the plain version."""
    ko, po = kern(), plain()
    sync(ko[0].device)
    check_equal(label, ko, po)
    ms, full_ms = cuda_ms(kern), cuda_ms(full)
    plain_ms = cuda_ms(plain, reps=1) if time_plain else None
    log(f"  {label}: ids and outputs bitwise; kernel {ms} ms (full scan "
        f"{full_ms} ms), plain {plain_ms} ms, bound {cost}")
    if time_plain:
        rep.add(name, 0.0, ms, plain_ms, cost)
    return po


def compare_prepass(rep, x, k, T, W, tag=""):
    """The pre-pass's kernels (ops/window.py: window_tau, each centre's
    k-th band distance; window_keep, the block test) bitwise their plain
    versions on x (B, N, C), each timed beside its plain version, the
    block test on tau raised by prune_prepass's margin; the whole
    pre-pass (prune_prepass, kernels and PyTorch) timed. ``tag`` follows
    the names in ``rep``. Returns the block test's lo, hi and tau."""
    from svnet_tpu_torch.ops import window as win

    b, n, C = x.shape
    nb = n // 128
    tau = win.window_tau(x, k)
    check_equal(f"window_tau C={C}", (tau,), (win.window_tau_plain(x, k),))
    tau = win.raise_tau(x, tau)
    xb = x.reshape(b, nb, 128, C)
    lo, hi = xb.amin(dim=2).contiguous(), xb.amax(dim=2).contiguous()
    keep = win.window_keep(x, lo, hi, tau, T)
    check_equal(f"window_keep C={C}", (keep,),
                (win.window_keep_plain(x, lo, hi, tau, T),))
    costs = {"window_tau": bound(b * n * 384.0 * (2 * C + 3), 4.0 * b * n * (C + 1)),
             "window_keep": bound(b * n * nb * C * 5.0,
                                  4.0 * (b * n * (C + 1) + 2 * b * nb * C
                                         + b * (n // T) * nb))}
    calls = {"window_tau": (lambda: win.window_tau(x, k),
                            lambda: win.window_tau_plain(x, k)),
             "window_keep": (lambda: win.window_keep(x, lo, hi, tau, T),
                             lambda: win.window_keep_plain(x, lo, hi, tau, T))}
    for name, (kern, plain) in calls.items():
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain, reps=1)
        rep.add(name + tag, 0.0, ms, plain_ms, costs[name])
        log(f"  {name}{tag} B={b} N={n} C={C} k={k} T={T}: bitwise; kernel "
            f"{ms} ms, plain {plain_ms} ms, bound {costs[name]}"
            + (f"; kept {float(keep.float().mean()):.4f}" if name == "window_keep"
               else ""))
    pre_ms = cuda_ms(lambda: win.prune_prepass(x, k, T, W))
    log(f"  prune_prepass{tag} C={C}: {pre_ms} ms (both kernels, the boxes, "
        "the margin and ok)")
    return lo, hi, tau


def compare_neg_min_window(rep, name, x, k, T, W):
    """The pre-pass over prune_prepass's window at W (neg_min with
    (T, W, keep, ok)) bitwise its plain version on x (B, N, C), timed
    beside its plain version and the pre-pass without a window."""
    import torch

    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.window import prune_prepass

    b, n, C = x.shape
    keep, okt = prune_prepass(x, k, T, W)
    win = (T, W, keep, okt.to(torch.int32))
    check_equal(f"neg_min window C={C}", (kk.neg_min(x, win),),
                (kk.neg_min_window_plain(x, win),))
    ok = bool(okt)
    cost = bound(neg_min_window_flops(keep, T, C) if ok else neg_min_flops(b, n, C),
                 4.0 * b * n * (C + 1))
    ms = cuda_ms(lambda: kk.neg_min(x, win))
    plain_ms = cuda_ms(lambda: kk.neg_min_window_plain(x, win), reps=1)
    full_ms = cuda_ms(lambda: kk.neg_min(x))
    log(f"  neg_min window B={b} N={n} C={C} T={T} certified {ok}: bitwise; "
        f"kernel {ms} ms (full {full_ms} ms), plain {plain_ms} ms, bound {cost}")
    rep.add(name, 0.0, ms, plain_ms, cost)


def phase2_window(rep, eng, eng_fp, gen, dev):
    """B1 and B2 with the candidate window against their plain versions,
    ids and outputs bitwise, in exact, fast and approx mode (fold 256) at
    16- and 8-bit gathers: at phase 19's cls shape (16, 8192, 20) on
    Morton-sorted surface clouds at a W that certifies B1's input
    (``window_for``; the conv rounds certify or not as their features
    give), inputs chained through the plain windowed versions, binary
    timed beside the same kernel without a window, FP bitwise; exact mode
    also bitwise the full scan. The pre-pass's kernels (``compare_prepass``)
    and approx mode's windowed scale pre-pass bitwise and timed. Then shuffled
    clouds (the certificate fails: the full scan, read on the card), the
    cls shape (128, 1024, 20), where no W < N certifies surface clouds,
    and WINDOW_FORCED. Returns W."""
    import torch

    from svnet_tpu_torch.infer import se_gate
    from svnet_tpu_torch.ops.kernels import quant
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    b, n, k = B_LONG, N_LONG, K
    pts = surface(b, n, SEED + 40, dev)
    T1 = quant.round3_tiles(n, 3, "exact")
    W = window_for(pts, k, T1)
    log(f"  window: W={W} at B={b} N={n} k={k} (B1's key tile T={T1})")
    for mode, bits in WINDOW_MODES:
        timed = (mode, bits) in WINDOW_TIMED
        with mode_knobs(bits, 256):
            S1, V1 = eng.dims["conv1"]
            kw = dict(S_out=S1, V_out=V1, k=k, mode=mode)
            f = eng.folded_first
            T = quant.round3_tiles(n, 3, mode)
            pairs, ok, share = window_pairs(pts, k, T, W)
            ef, pm1 = edge_flops(0, 1, S1, V1, True)
            cost = bound(pairs * 9.0 + b * n * k * ef,
                         4.0 * b * n * (3 + S1 + 3 * V1 + 6 + k), b * n * k * pm1)
            name = window_name("sv_round3_first", mode, bits)
            po = timed_window(
                rep, f"sv_round3_first window {mode}{bits} B={b} N={n} k={k} "
                f"T={T} W={W} certified {ok} kept {share:.4f}", name,
                lambda: kr.sv_round3_first(pts, f, emit_wins=True, window=W, **kw),
                lambda: kr.sv_round3_first_plain(pts, f, window=W, **kw),
                lambda: kr.sv_round3_first(pts, f, **kw), cost, timed)
            if mode == "exact":
                check_equal(f"{name} = the full scan", po,
                            kr.sv_round3_first(pts, f, emit_wins=True, **kw))
            inputs = [pts]
            g = se_gate(eng.p["conv1"], po[2]).repeat(1, 3)
            outs = [(po[0], po[1] * g[:, :, None])]
            for rnd, (S, V, S_out, V_out) in eng.rounds.items():
                src = torch.cat(outs[-1], dim=1).contiguous()
                C = S + 3 * V
                x = src.transpose(1, 2).contiguous()
                inputs.append(x)
                T = quant.round3_tiles(n, C, mode)
                pairs, ok, share = window_pairs(x, k, T, W)
                ef, pm1 = edge_flops(S, V, S_out, V_out, binary=True)
                cost = bound(pairs * (2.0 * C + 3) + b * n * k * ef,
                             4.0 * b * n * (C + S_out + 3 * V_out + 2 * S + k),
                             b * n * k * pm1)
                name = window_name("sv_round3", mode, bits)
                kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, mode=mode)
                fb, ffp = eng.folded[rnd], eng_fp.folded[rnd]
                po = timed_window(
                    rep, f"sv_round3 window {mode}{bits} {rnd} binary B={b} "
                    f"N={n} T={T} certified {ok} kept {share:.4f}", name,
                    lambda: kr.sv_round3(src, fb, emit_wins=True, window=W, **kw),
                    lambda: kr.sv_round3_plain(src, fb, binary=True, window=W, **kw),
                    lambda: kr.sv_round3(src, fb, **kw), cost, timed)
                check_equal(f"sv_round3 window {mode}{bits} {rnd} fp",
                            kr.sv_round3(src, ffp, binary=False, emit_wins=True,
                                         window=W, **kw),
                            kr.sv_round3_plain(src, ffp, binary=False, window=W, **kw))
                if mode == "exact":
                    check_equal(f"{name} {rnd} = the full scan", po,
                                kr.sv_round3(src, fb, emit_wins=True, **kw))
                g = se_gate(eng.p[rnd], po[2]).repeat(1, 3)
                outs.append((po[0], po[1] * g[:, :, None]))
            if mode == "approx" and bits == 8:
                for x in inputs:  # the scale pre-pass over each round's window
                    compare_neg_min_window(rep, window_name("neg_min", mode, bits),
                                           x, k, quant.round3_tiles(n, x.shape[-1], mode), W)
            if mode == "exact":
                for x in inputs:
                    compare_prepass(rep, x, k, quant.round3_tiles(n, x.shape[-1], mode), W)
    # shuffled clouds: the certificate fails, the windowed kernels scan all
    # N rows (ok read on the card)
    shuffled = surface(b, n, SEED + 41, dev, sort=False)
    for mode, bits in (("exact", 16), ("approx", 8)):
        with mode_knobs(bits, 256):
            S1, V1 = eng.dims["conv1"]
            kw = dict(S_out=S1, V_out=V1, k=k, mode=mode)
            f = eng.folded_first
            T = quant.round3_tiles(n, 3, mode)
            _, ok, share = window_pairs(shuffled, k, T, W)
            if ok:
                raise AssertionError(f"phase 2 window: W={W} certifies shuffled "
                                     "clouds")
            got = kr.sv_round3_first(shuffled, f, emit_wins=True, window=W, **kw)
            check_equal(f"sv_round3_first window shuffled {mode}{bits}", got,
                        kr.sv_round3_first_plain(shuffled, f, window=W, **kw))
            check_equal(f"sv_round3_first window shuffled {mode}{bits} = full",
                        got, kr.sv_round3_first(shuffled, f, emit_wins=True, **kw))
            log(f"  sv_round3_first window shuffled {mode}{bits} B={b} N={n} "
                f"W={W}: certified {ok} (kept {share:.4f}); bitwise the plain "
                "version and the full scan")
    # the cls shape: no W < N certifies surface clouds at N = 1024
    pts = surface(B, N, SEED + 42, dev)
    f = eng.folded_first
    S1, V1 = eng.dims["conv1"]
    T = quant.round3_tiles(N, 3, "exact")
    _, ok, share = window_pairs(pts, K, T, 512)
    got = kr.sv_round3_first(pts, f, S_out=S1, V_out=V1, k=K, emit_wins=True,
                             window=512)
    check_equal("sv_round3_first window cls", got, kr.sv_round3_first_plain(
        pts, f, S_out=S1, V_out=V1, k=K, window=512))
    src = torch.cat([got[0], got[1]], dim=1).contiguous()
    S, V, S_out, V_out = eng.rounds["conv2"]
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, window=512)
    check_equal("sv_round3 window cls conv2",
                kr.sv_round3(src, eng.folded["conv2"], emit_wins=True, **kw),
                kr.sv_round3_plain(src, eng.folded["conv2"], binary=True, **kw))
    log(f"  window cls B={B} N={N} k={K} W=512: B1 certified {ok} (kept "
        f"{share:.4f}); B1 and conv2 bitwise their plain versions")
    for bits in (16, 8):
        phase2_window_forced(bits, gen, dev)
    return W


# (B, N, k, W, approx fold, input, key tile T) on strand clouds
# (utils/synth.py), as tests/test_torch_cuda.py's: k = 33 above a
# 32-entry list; duplicated points at a W that certifies (384) and one
# that does not (256); approx W = 384 at fold 64 (L = 48); one cloud of
# the batch shuffled, so the whole batch falls back; T = 256
WINDOW_FORCED = ((2, 1024, 33, 384, 256, None, 128), (3, 512, 20, 256, 256, "dup", 128),
                 (3, 512, 20, 384, 256, "dup", 128), (2, 1024, 20, 384, 64, None, 128),
                 (2, 1024, 20, 384, 256, "mixed", 128), (2, 2048, 20, 768, 256, None, 256))


def strand_input(b, n, c, kind, seed, dev):
    """Strand clouds (B, N, C), duplicated or with the last cloud shuffled
    as ``kind`` says."""
    import torch

    from svnet_tpu_torch.utils.synth import strand_clouds

    x = torch.from_numpy(strand_clouds(seed, b, n, c))
    if kind == "dup":
        h = x[:, 1::2].shape[1]
        x[:, 1::2] = x[:, ::2][:, :h]
    elif kind == "mixed":
        x[-1] = x[-1, torch.randperm(n, generator=torch.Generator().manual_seed(seed))]
    return x.to(dev)


def phase2_window_forced(bits, gen, dev):
    """B1 (xyz) and B2 ((5, 3) -> (13, 7) binary and FP) with the window at
    WINDOW_FORCED in exact, fast and approx mode, ids and outputs bitwise
    their plain versions; the certificate as each case intends."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_round3 as kr
    from svnet_tpu_torch.ops.window import prune_prepass

    for b, n, k, W, fold, kind, T in WINDOW_FORCED:
        with mode_knobs(bits, fold):
            pts = strand_input(b, n, 3, kind, 41, dev)
            rows = strand_input(b, n, 14, kind, 42, dev)
            src = rows.transpose(1, 2).contiguous()
            want_ok = kind is None or (kind == "dup" and W == 384)
            for x in (pts, rows):
                if bool(prune_prepass(x, k, T, W)[1]) != want_ok:
                    raise AssertionError(f"window forced {(b, n, k, W, kind)}: "
                                         f"certificate is not {want_ok}")
            f1 = {name: torch.randn(*shape, generator=gen).to(dev)
                  for name, shape in (("wz0", (2, 3)), ("wz1", (2, 3)),
                                      ("w1", (12, 32)), ("a1", (1, 32)),
                                      ("b1", (1, 32)), ("w2", (2, 10)),
                                      ("a2", (1, 10)), ("b2", (1, 10)))}
            for mode in ("exact", "fast", "approx"):
                kw = dict(S_out=32, V_out=10, k=k, mode=mode, T=T, window=W)
                tag = f"window forced {mode}{bits} B={b} N={n} k={k} W={W}"
                check_equal(f"sv_round3_first {tag}",
                            kr.sv_round3_first(pts, f1, emit_wins=True, **kw),
                            kr.sv_round3_first_plain(pts, f1, **kw))
                for binary in (True, False):
                    f = round_weights(5, 3, 13, 7, binary, gen, dev)
                    kw = dict(S=5, V=3, S_out=13, V_out=7, k=k, binary=binary,
                              mode=mode, T=T, window=W)
                    check_equal(f"sv_round3 {tag}",
                                kr.sv_round3(src, f, emit_wins=True, **kw),
                                kr.sv_round3_plain(src, f, **kw))
        log(f"  window{bits} forced B={b} N={n} k={k} W={W} fold={fold} T={T}"
            + (f" {kind}" if kind else "") + f": certified {want_ok}; B1 and "
            "B2 (binary, fp) bitwise their plain versions in exact, fast and "
            "approx mode")


def check_launches(tag, per, want_per):
    """Launches per request by counter name (``per``) against ``want_per``
    (absent names: none)."""
    want = {name: want_per.get(name, 0) for name in per}
    if per != want:
        raise AssertionError(f"{tag}: launches per request {per} != {want}")


class WindowCount:
    """A wrapper's windowed launches (``<wrapper>.window_launches``) as a
    counter: ``__name__`` '<wrapper> window', ``launches`` read and set."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = f"{fn.__name__} window"

    @property
    def launches(self):
        return self.fn.window_launches

    @launches.setter
    def launches(self, value):
        self.fn.window_launches = value


@contextlib.contextmanager
def window_stats(record, inputs=None):
    """Appends (channels, kept share of the blocks, certified) of each
    windowed round to ``record``, and a copy of the round's input to
    ``inputs`` where it is a list. It reads the certificate on the host,
    so it runs on a pass of its own, never a timed one."""
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    was = kr.round_window

    def spy(x, k, T, window, mode, plain=False):
        if inputs is not None:
            inputs.append(x.clone())
        win = was(x, k, T, window, mode, plain)
        if win is not None:
            record.append((x.shape[-1], round(float(win[2].float().mean()), 4),
                           bool(win[3])))
        return win

    kr.round_window = spy
    try:
        yield
    finally:
        kr.round_window = was


def phase19(w_bin, W, gen, dev, counters, card):
    """The window on the main path: SV-DGCNN cls at (16, 8192, 20) on
    Morton-sorted surface clouds, exact and approx (8-bit gathers, fold
    256), 5 requests each through the windowed engine with the launches
    per request checked (the windowed kernels: B1 x1, B2 x3, approx's
    scale pre-pass x4), then the same engine without a window on the same
    requests; exact logits bitwise the unwindowed engine's; a 4-cloud
    request bitwise the windowed oracle twin's; one partseg request
    (4, 8192, 40) exact, windowed and not, logits bitwise. Prints the
    medians and each round's kept share and certificate. Returns the
    windowed launches by kernels-line name."""
    import torch

    from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVDGCNNPsegEngine
    from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg
    from svnet_tpu_torch.ops import window as win

    wc = [WindowCount(fn) for fn in counters if fn.__name__ in
          ("sv_round3_first", "sv_round3", "neg_min")]
    every = tuple(counters) + tuple(wc) + (win.window_tau, win.window_keep)
    requests = [(surface(B_LONG, N_LONG, SEED + 50 + i, dev),)
                for i in range(REQUESTS)]
    out = {}
    for mode, bits in WINDOW_TIMED:
        tag = f"phase 19 cls {mode}{bits if mode != 'exact' else ''}"
        want_per = {"sv_round3_first": 1, "sv_round3": 3, "sv_point_block_cm": 1,
                    "sv_round3_first window": 1, "sv_round3 window": 3,
                    "window_tau": 4, "window_keep": 4}
        if mode != "exact":
            want_per.update({"neg_min": 4, "neg_min window": 4})
        with mode_knobs(bits, 256):
            eng = SVDGCNNClsEngine(w_bin, CLASSES, K, True, mode=mode,
                                   device=dev, window=W)
            base = SVDGCNNClsEngine(w_bin, CLASSES, K, True, mode=mode,
                                    device=dev)
            eng(*requests[0])
            torch.cuda.synchronize()
            for fn in every:
                fn.launches = 0
            logits, lat = [], []
            for req in requests:
                before = [fn.launches for fn in every]
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                logits.append(eng(*req))
                e1.record()
                torch.cuda.synchronize()
                lat.append(e0.elapsed_time(e1))
                check_launches(tag, {fn.__name__: fn.launches - b0
                                     for fn, b0 in zip(every, before)}, want_per)
            launches = {fn.__name__: fn.launches for fn in every}
            got = torch.cat(logits)
            if got.shape != (REQUESTS * B_LONG, CLASSES) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{tag}: logits {tuple(got.shape)} not finite")
            without = torch.cat([base(*req) for req in requests])
            base_ms = request_median(base, requests)
            MEDIANS[tag] = sorted(lat)[len(lat) // 2]
            if mode == "exact" and not torch_equal(got, without):
                raise AssertionError(f"{tag}: windowed logits differ from the "
                                     "full scan's")
            oracle = SVDGCNNClsEngine(w_bin, CLASSES, K, True, mode=mode,
                                      device=dev, window=W, oracle=True)
            small = requests[0][0][:4]
            if not torch_equal(eng(small), oracle(small)):
                raise AssertionError(f"{tag}: a 4-cloud request differs from "
                                     "the oracle twin's")
            record = []
            with window_stats(record):
                eng(*requests[0])
        top1 = (got.argmax(-1) == without.argmax(-1)).float().mean().item()
        log(f"{tag}: {REQUESTS} requests of ({B_LONG}, {N_LONG}, 3), W={W}; "
            f"launches { {n: c for n, c in launches.items() if c} }; median "
            f"{MEDIANS[tag]:.3f} ms, without the window {base_ms:.3f} ms; "
            f"latencies {[round(t, 3) for t in lat]}; a 4-cloud request "
            "bitwise the oracle twin's; "
            + ("logits bitwise the full scan's" if mode == "exact" else
               f"top-1 agreement with the full scan {top1:.6f} (random "
               "weights, not a bar)")
            + f"; rounds (channels, kept share, certified) {record} | {card}")
        for name in ("sv_round3_first", "sv_round3", "neg_min"):
            if launches.get(f"{name} window"):
                out[window_name(name, mode, bits)] = launches[f"{name} window"]
        if mode == "exact":
            out.update({name: launches[name] for name in ("window_tau", "window_keep")})
    p_pseg = init_params_pseg(PARTS, K_PSEG, True,
                              torch.Generator().manual_seed(SEED + 12))
    eng = SVDGCNNPsegEngine(p_pseg, PARTS, K_PSEG, True, device=dev, window=W)
    base = SVDGCNNPsegEngine(p_pseg, PARTS, K_PSEG, True, device=dev)
    reqs = [(surface(B_LONG_PSEG, N_LONG, SEED + 60 + i, dev),
             labels(B_LONG_PSEG, gen, dev)) for i in range(3)]
    got = torch.cat([eng(*r) for r in reqs])
    if got.shape != (3 * B_LONG_PSEG, N_LONG, PARTS) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"phase 19 pseg: logits {tuple(got.shape)} not finite")
    if not torch_equal(got, torch.cat([base(*r) for r in reqs])):
        raise AssertionError("phase 19 pseg: windowed logits differ from the "
                             "full scan's")
    ms, base_ms = request_median(eng, reqs), request_median(base, reqs)
    record = []
    with window_stats(record):
        eng(*reqs[0])
    log(f"phase 19 pseg exact: requests of ({B_LONG_PSEG}, {N_LONG}, 3), "
        f"k={K_PSEG}, W={W}: logits bitwise the full scan's; median {ms:.3f} "
        f"ms, without the window {base_ms:.3f} ms; rounds (channels, kept "
        f"share, certified) {record} | {card}")
    return out


# ---------------------------------------------------------------------------
# the serving pick's training recipe (ACCURACY.md:180-246): the un-fused
# part segmenter's training, knob-aware fused training (stage 1), KD and
# --preload (stage 2) and the certification legs
# ---------------------------------------------------------------------------

KNOB_R = {"cls": (K, K // 2), "pseg": (K_PSEG // 2,)}  # reuse ranks of phase 2


def phase2_knob_train(rep, gen, dev):
    """B6 on the ids of another round with its input through ste_quant8
    (knob-aware training, train/fused.py::make_trunk), binary, forward and
    backward against the plain version to the training bars: cls (32,
    1024, 20) on B4's xyz ids ("spatial") at r = 20 and 10 and, for conv3
    and conv4, on conv2's ("conv2"); partseg (32, 2048, 40) on B4's ids at
    r = 20, the nearest half of each rank list (a strided prefix, handed
    to B6 as a copy). Inputs chained through the plain versions; each
    round's centre points per tile printed; the recipe's rounds (spatial,
    r = 20) timed ("sv_round3_train_fwd/bwd knob <task>")."""
    import torch

    from svnet_tpu_torch.models.sv_dgcnn import init_params, init_params_pseg
    from svnet_tpu_torch.nn.sv_train import gate, ste_quant8
    from svnet_tpu_torch.ops.kernels import sv_first_train as kf
    from svnet_tpu_torch.ops.kernels import sv_round3_train as kr
    from svnet_tpu_torch.ops.kernels.knn import knn
    from svnet_tpu_torch.ops.kernels.sv_round3 import first_perm
    from svnet_tpu_torch.train.fused import PSEG_ROUNDS, ROUNDS, SUB
    from svnet_tpu_torch.train.steps import tree_map

    ops = (kr.sv_round3_train_fwd, kr.sv_round3_train_bwd)
    for task, rounds, (b, n, k), init, width, seed in (
            ("cls", ROUNDS, (B_TRAIN, N, K), init_params, CLASSES, 30),
            ("pseg", PSEG_ROUNDS, (B_TRAIN, N_PSEG, K_PSEG), init_params_pseg,
             PARTS, 31)):
        p = tree_map(lambda t: t.to(dev), init(
            width, k, True, torch.Generator().manual_seed(SEED + seed))["params"])
        pts = cloud(b, n, gen, dev)
        idx0 = knn(pts, k)
        S1, V1 = rounds["conv2"][:2]
        d1 = kf.first_dims(S1, V1, k)
        sub = {"init_scalar": p["init_scalar"], **{m: p["conv1"][m] for m in SUB}}
        po = kr.train_fwd_plain(pts, idx0, kr.kernel_params(sub, d1), d1)
        s_mean = (po[2] / (n * k)).float()[:, first_perm()]
        x = (po[0], po[1].reshape(b, n, 3, V1)
             * gate(p["conv1"], s_mean)[:, None, None, :])
        r0, wins = KNOB_R[task][0], {"spatial": idx0}
        names = (f"sv_round3_train_fwd knob {task}", f"sv_round3_train_bwd knob {task}")
        for name, (S, V, So, Vo) in rounds.items():
            joint = torch.cat([x[0], x[1].reshape(b, n, -1)], dim=-1)
            if name == "conv2" and task == "cls":
                wins["conv2"] = knn(joint.contiguous(), k)  # the exact input's ids
            src = ste_quant8(joint).contiguous()
            kp = kr.kernel_params({m: p[name][m] for m in SUB},
                                  kr.RoundDims(S, V, So, Vo, k, True))
            for reuse, ids in wins.items():
                if reuse == "conv2" and name == "conv2":
                    continue
                for r in KNOB_R[task]:
                    d = kr.RoundDims(S, V, So, Vo, r, True)
                    tiles = {ph: kr.tile(d, ph) for ph in ("f1", "f2", "b1", "b2")}
                    out = compare_train(
                        rep, f"sv_round3_train {name} ({S}, {V}) -> ({So}, {Vo}) "
                        f"binary on {reuse} ids r={r} of k={k}, ste_quant8 input, "
                        f"B={b} N={n}, centre points per tile {tiles}", names, ops,
                        src, ids[:, :, :r].contiguous(), kp, d, gen,
                        reuse == "spatial" and r == r0, 1e-3)
                    if reuse == "spatial" and r == r0:
                        po = out
            s_mean = (po[2] / (n * r0)).float()
            x = (po[0], po[1].reshape(b, n, 3, Vo)
                 * gate(p[name], s_mean)[:, None, None, :])


def phase2_pseg_gather(rep, gen, dev):
    """B7 forward and backward at the un-fused part segmenter's joint widths
    (32, 2048, 40), C = 80 (conv2's and conv3's input) and 136 (conv4's),
    bitwise, each timed beside torch.gather and index_add_ ("edge_gather_fwd
    pseg unfused", "edge_gather_bwd pseg unfused": the path's three calls)."""
    names = ("edge_gather_fwd pseg unfused", "edge_gather_bwd pseg unfused")
    for c in (80, 80, 136):
        compare_edge_gather(rep, B_TRAIN, N_PSEG, K_PSEG, c, gen, dev, names=names)


def phase24(dev, gen, counters, loader, card):
    """SV-DGCNN part segmentation through the un-fused train forward
    (train/dgcnn.py::make_train_apply_pseg) at (B_TRAIN, N_PSEG, K_PSEG),
    binary, Adam, rot z: knn x4, B7 forward x4 and backward x3 a step, the
    edges in device memory (its peak printed); a BN re-estimation batch
    and an eval batch (knn x4, B7 forward x4), one step against its plain
    twin."""
    import torch

    from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNPseg, init_params_pseg
    from svnet_tpu_torch.train.dgcnn import make_train_apply_pseg

    weights = init_params_pseg(PARTS, K_PSEG, True,
                               torch.Generator().manual_seed(SEED + 32))
    eager = {"knn": 4, "edge_gather_fwd": 4}
    return phase_pseg_train(
        "phase 24", lambda oracle: make_train_apply_pseg(PARTS, K_PSEG, True,
                                                         oracle=oracle),
        SVDGCNNPseg(PARTS, K_PSEG, True), weights, "dgcnn",
        {"knn": 4, "edge_gather_fwd": 4, "edge_gather_bwd": 3}, eager, eager,
        loader, dev, gen, counters, card, SEED + 33)


# the knob-aware recipe's knobs (stage 1): spatial reuse, the 8-bit grid;
# partseg also reuse_k 20 (tools/certify_serving.sh, bench.py:300-346)
def recipe_knobs(task):
    from svnet_tpu_torch.config import TrainKnobs

    return TrainKnobs("spatial", 0 if task == "cls" else K_PSEG // 2, True)


def phase25(dev, gen, counters, loader, p_loader, card):
    """Knob-aware fused training, the recipe's stage 1 (train/fused.py with
    ``knobs``): cls (B_TRAIN, N, K) spatial reuse + 8-bit grid, partseg
    (B_TRAIN, N_PSEG, K_PSEG) the same with reuse_k 20; 1 + TRAIN_STEPS
    steps each (B4 x1, B5 1 + 1, B6 3 + 3 a step), a BN re-estimation
    batch (B4, B5, B6 x3 forward), one knob-world eval batch of the eager
    model (B4 x1, B7 forward x4) and one step against its plain twin.
    Returns {task: (launches, step ms, peak, state)}."""
    import torch

    from svnet_tpu_torch.models.sv_dgcnn import (
        SVDGCNNCls, SVDGCNNPseg, init_params, init_params_pseg)
    from svnet_tpu_torch.train.fused import (
        make_fused_train_apply, make_fused_train_apply_pseg)

    per_step = {"knn": 1, "sv_first_train_fwd": 1, "sv_first_train_bwd": 1,
                "sv_round3_train_fwd": 3, "sv_round3_train_bwd": 3}
    recal = {"knn": 1, "sv_first_train_fwd": 1, "sv_round3_train_fwd": 3}
    evals = {"knn": 1, "edge_gather_fwd": 4}
    out = {}
    for task, make, model, init, width, (ld, k), seed in (
            ("cls", make_fused_train_apply, SVDGCNNCls, init_params, CLASSES,
             (loader, K), 34),
            ("pseg", make_fused_train_apply_pseg, SVDGCNNPseg, init_params_pseg,
             PARTS, (p_loader, K_PSEG), 36)):
        knobs = recipe_knobs(task)
        weights = init(width, k, True, torch.Generator().manual_seed(SEED + seed))
        states = []
        res = phase_pseg_train(
            f"phase 25 {task} {knobs}",
            lambda oracle, make=make, width=width, k=k, knobs=knobs: make(
                width, k, True, oracle=oracle, knobs=knobs),
            model(width, k, True, knobs=knobs), weights, "dgcnn", per_step,
            recal, evals, ld, dev, gen, counters, card, SEED + seed + 1,
            with_label=task == "pseg", state_out=states)
        out[task] = (*res, states[0])
    return out


@contextlib.contextmanager
def echo_captured():
    """stdout captured (and still printed): the trainer's log lines."""
    import io

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, text):
            buf.write(text)
            return sys.__stdout__.write(text)

        def flush(self):
            sys.__stdout__.flush()

    with contextlib.redirect_stdout(Tee()):
        yield buf


def phase26(dev, gen, counters, loader, card, tmp):
    """The recipe's stage 2 through the trainer (``loop.run_cls`` on
    in-memory clouds, the CLI's own flags): a binary base and an FP
    teacher trained one epoch and saved by the trainer; stage 1
    ``--preload BASE --train-knobs --graph-reuse spatial
    --approx-gather-bits 8`` (the student's own tree, every leaf); the FP
    checkpoint preloaded into a binary student (the overlap merge, its
    leaf counts); stage 2 ``--resume-from STAGE1 --preload FP --distill
    --kd-t 2 --kd-alpha 0.3 --no-kd-init`` with the knobs, its launches
    counted over the run (a KD step: the student's B4 x1, B5 1 + 1, B6
    3 + 3 and the FP teacher's eager forward, B4 x4 and B7 forward x4),
    and one KD step against its plain twin. Returns the stage-1 and the
    FP checkpoints' paths, the test set and the KD step's median ms."""
    import re

    import numpy as np
    import torch

    from svnet_tpu_torch.cli.flags import build_parser
    from svnet_tpu_torch.data import ArrayDataset
    from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls
    from svnet_tpu_torch.train.fused import make_fused_train_apply
    from svnet_tpu_torch.train.loop import read_weights, run_cls, tree_shapes
    from svnet_tpu_torch.train.steps import Distiller
    from svnet_tpu_torch.utils.convert import load_tree
    from svnet_tpu_torch.utils.synth import surface_clouds

    test_b = 4
    test_set = ArrayDataset(surface_clouds(SEED + 40, test_b * B_TRAIN, N),
                            np.random.default_rng(SEED + 40).integers(
                                0, CLASSES, test_b * B_TRAIN))
    sets = (loader.dataset, test_set)
    common = ["--epochs", "1", "--bn-reestimate", "1", "--num-workers", "0",
              "--k", str(K), "--batch-size", str(B_TRAIN), "--device", str(dev)]
    knobs = ["--train-knobs", "--graph-reuse", "spatial", "--approx-gather-bits", "8"]

    def run(tag, argv):
        args = build_parser().parse_args(argv + ["--save-dir", f"{tmp}/{tag}"])
        t0 = time.perf_counter()
        with echo_captured() as out:
            metric = run_cls(args, datasets=sets)
        log(f"phase 26 {tag}: run_cls {' '.join(argv)} -> {metric:.6f} "
            f"({time.perf_counter() - t0:.1f} s)")
        return out.getvalue(), f"{tmp}/{tag}/save_models/"

    _, base = run("base", ["--binary"] + common)
    _, fp = run("fp", common)
    fp_best, base_best = fp + "model_best.ckpt", base + "model_best.ckpt"
    text, s1 = run("stage1", ["--binary", "--preload", base_best] + knobs + common)
    n_leaves = len(tree_shapes(read_weights(base_best, dev)))
    if f"preloaded weights from {base_best}" not in text or "overlap" in text:
        raise AssertionError("phase 26: stage 1 did not preload the base whole")
    log(f"phase 26: --preload of the binary base: its own tree, {n_leaves} of "
        f"{n_leaves} leaves loaded")
    text, _ = run("merge", ["--binary", "--preload", fp_best] + common)
    merge = re.search(r"overlap merge: (\d+)/(\d+) params, (\d+)/(\d+) "
                      r"batch_stats leaves", text)
    if merge is None or not int(merge[1]) < int(merge[2]):
        raise AssertionError("phase 26: the FP checkpoint was not overlap-merged")
    log(f"phase 26: --preload of the FP teacher into a binary student: overlap "
        f"merge {merge[1]}/{merge[2]} params, {merge[3]}/{merge[4]} batch_stats "
        "leaves")
    for fn in counters:
        fn.launches = 0
    steps, tests = TRAIN_STEPS + 1, test_b
    text, _ = run("stage2", ["--epochs", "2", "--binary", "--resume-from",
                             s1 + "checkpoint_000.ckpt", "--preload", fp_best,
                             "--distill", "--kd-t", "2", "--kd-alpha", "0.3",
                             "--no-kd-init"] + knobs + common[2:])
    launches = {fn.__name__: fn.launches for fn in counters}
    per_step = {"knn": 5, "sv_first_train_fwd": 1, "sv_first_train_bwd": 1,
                "sv_round3_train_fwd": 3, "sv_round3_train_bwd": 3,
                "edge_gather_fwd": 4}
    want = {n: steps * per_step.get(n, 0) for n in launches}
    for n, c in (("knn", 1 + tests), ("sv_first_train_fwd", 1),
                 ("sv_round3_train_fwd", 3), ("edge_gather_fwd", 4 * tests)):
        want[n] += c  # the BN re-estimation batch, the knob-world eval
    if launches != want or "KD teacher loaded" not in text:
        raise AssertionError(f"phase 26 stage 2: launches {launches} != {want}")
    median = float(re.findall(r"median step ([0-9.]+) ms", text)[-1])
    log(f"phase 26: stage 2, {steps} KD steps of ({B_TRAIN}, {N}, 3) with the "
        f"knobs: launches {launches} ({steps} steps, 1 BN re-estimation batch, "
        f"{tests} eval batches); KD step median {median:.3f} ms | {card}")
    teacher = SVDGCNNCls(CLASSES, K, False).to(dev)
    load_tree(teacher, read_weights(fp_best, dev))
    knobs_c = recipe_knobs("cls")
    step_vs_plain("phase 26 KD oracle",
                  lambda oracle: make_fused_train_apply(CLASSES, K, True,
                                                        oracle=oracle,
                                                        knobs=knobs_c),
                  read_weights(s1 + "model_best.ckpt", dev), "dgcnn",
                  next(iter(loader)), dev, SEED + 41,
                  distiller=Distiller(teacher, 2.0), alpha=0.3)
    torch.cuda.empty_cache()
    return s1 + "model_best.ckpt", fp_best, test_set, median


def float64_witness(task, tree, model, engine, width, k, loader, dev, bar=True,
                    tag="phase 27"):
    """The binary weights in float64, where no binarization sign lies
    within rounding of 0: the exact plain engine (``dtype=torch.float64``)
    against the eager model (``oracle``: B4 and B7 take float32) on the
    same unrotated batches, top-1
    agreement >= 0.99 where ``bar`` (per cloud at cls, per point at
    partseg); the eager model's float32 against its float64 printed beside
    it, the share of top-1 that float32 rounding alone moves. Returns the
    two agreements."""
    import torch

    from svnet_tpu_torch.utils.convert import load_tree

    eng64 = engine(tree, width, k, True, device=dev, oracle=True,
                   dtype=torch.float64)
    eager = {}
    for dtype in (torch.float32, torch.float64):
        m = model(width, k, True, oracle=dtype == torch.float64).to(dev)
        load_tree(m, tree)
        eager[dtype] = m.to(dtype).eval()
    same64 = same32 = total = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for batch in loader:
            args = ((batch["points"],)
                    + ((batch["label"],) if task == "pseg" else ()))
            args64 = tuple(a.double() for a in args)
            want = eager[torch.float64](*args64).argmax(dim=-1)
            same64 += int((eng64(*args64).argmax(dim=-1) == want).sum())
            same32 += int((eager[torch.float32](*args).argmax(dim=-1)
                           == want).sum())
            total += want.numel()
    agree64, agree32 = same64 / total, same32 / total
    log(f"{tag} {task}: binary weights in float64, the plain engine against "
        f"the eager model: top-1 agreement {agree64:.6f} over {total} "
        f"predictions; the eager model's float32 against its float64: "
        f"{agree32:.6f} ({time.perf_counter() - t0:.1f} s)")
    if bar and agree64 < 0.99:
        raise AssertionError(f"{tag} {task}: the float64 plain engine agrees "
                             f"with the float64 eager model on {agree64} < 0.99")
    del eng64, eager
    torch.cuda.empty_cache()
    return agree64, agree32


def phase27(trees, fp_trees, sets, dev, counters, card):
    """Certification: ``--test CKPT --fused`` on each leg of
    tools/certify_serving.sh, the stage-1 weights (cls: phase 26's
    checkpoint; partseg: phase 25's state) through the trainer's eval
    step (``loop.make_fused_eval_step`` under ``loop.knob_scope`` of the
    leg's parsed flags), --rot-test so3: per leg a finite loss, the
    launches per batch as the engines' phases count them (B1 x1, B2 x3 of
    which reuse x2 (conv2) or x3 (spatial), the pre-pass once per
    selecting round in fast and approx mode, B3 x1) and its seconds. The
    exact leg: its predictions and loss equal to those of the plain
    engine on the same batches and rotations, and its top-1 agreement
    with the eager eval printed; the eager model and the engine fold and
    sum a binary net in other orders, so an ulp flips a sign (measured on
    the CPU at (16, 1024, 20), random binary weights: top-1 0.625), and
    the >= 0.99 bar against the eager eval is held on the FP weights
    (``fp_trees``: phase 26's FP teacher, a seeded FP part segmenter),
    where the two agree to 1e-8, and on the binary weights in float64
    (``float64_witness``), where no sign flips. The legs are
    ``cli/certify_serving.py``'s ``CERT_LEGS``."""
    import numpy as np
    import torch

    from svnet_tpu_torch.cli.certify_serving import CERT_LEGS
    from svnet_tpu_torch.cli.flags import build_parser, check_ported
    from svnet_tpu_torch.data import Loader
    from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVDGCNNPsegEngine
    from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls, SVDGCNNPseg
    from svnet_tpu_torch.train.loop import (
        eval_batches, knob_scope, make_fused_eval_step)
    from svnet_tpu_torch.train.steps import make_eval_step
    from svnet_tpu_torch.utils.convert import load_tree

    def run_eval(step, loader):
        return eval_batches(step, loader, torch.Generator().manual_seed(SEED + 50))

    out = {}
    for task, k, width, model, engine in (
            ("cls", K, CLASSES, SVDGCNNCls, SVDGCNNClsEngine),
            ("pseg", K_PSEG, PARTS, SVDGCNNPseg, SVDGCNNPsegEngine)):
        pseg = task == "pseg"
        trainer_task = "partseg" if pseg else "cls"
        parser = build_parser(trainer_task)
        loader = Loader(sets[task], B_TRAIN, shuffle=False, pad_last=True,
                        device=dev)
        loss_fn = train_loss(pseg)
        eager = {}
        for binary, tree in ((True, trees[task]), (False, fp_trees[task])):
            m = model(width, k, binary).to(dev).eval()
            load_tree(m, tree)
            eager[binary] = run_eval(make_eval_step(m, loss_fn, "so3", pseg), loader)
        fp_args = parser.parse_args(["--test", "CKPT", "--fused", "--k", str(k)])
        fp_pred = run_eval(make_fused_eval_step(fp_trees[task], fp_args,
                                                trainer_task, loss_fn, dev),
                           loader)[2]
        top1 = float((fp_pred == eager[False][2]).mean())
        log(f"phase 27 {task}: FP weights, exact engine against the eager eval: "
            f"top-1 agreement {top1:.6f}")
        if top1 < 0.99:
            raise AssertionError(f"phase 27 {task}: FP exact engine agrees with the "
                                 f"eager eval on {top1} < 0.99")
        float64_witness(task, trees[task], model, engine, width, k, loader, dev)
        for leg in CERT_LEGS:
            leg = [str(k // 2) if a == "R" else a for a in leg]
            if pseg and "approx" in leg:
                leg = leg + ["--approx-fold", "512"]
            args = parser.parse_args(["--binary", "--test", "CKPT", "--fused",
                                      "--k", str(k)] + leg)
            check_ported(args)
            selecting = {"none": 3, "conv2": 1, "spatial": 0}[args.graph_reuse]
            per = {"sv_round3_first": 1, "sv_round3": 3, "sv_point_block_cm": 1,
                   "sv_round3_reuse": 3 - selecting,
                   "neg_min": 0 if args.engine_mode == "exact" else 1 + selecting}
            with knob_scope(args):
                step = make_fused_eval_step(trees[task], args, trainer_task,
                                            loss_fn, dev)
                for fn in counters:
                    fn.launches = 0
                t0 = time.perf_counter()
                loss, _, pred, _ = run_eval(step, loader)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            got = {fn.__name__: fn.launches for fn in counters}
            want = {n: len(loader) * per.get(n, 0) for n in got}
            if got != want or not np.isfinite(loss):
                raise AssertionError(f"phase 27 {task} {leg}: loss {loss}, "
                                     f"launches {got} != {want}")
            line = (f"phase 27 {task} {' '.join(leg)}: {len(loader)} batches, loss "
                    f"{loss:.6f}, launches { {n: c for n, c in got.items() if c} }, "
                    f"{secs:.3f} s")
            if args.engine_mode == "exact":
                plain = engine(trees[task], width, k, True, device=dev, oracle=True)
                p_loss, _, p_pred, _ = run_eval(
                    make_eval_step(plain, loss_fn, "so3", pseg), loader)
                if p_loss != loss or not np.array_equal(p_pred, pred):
                    raise AssertionError(f"phase 27 {task}: the exact leg differs "
                                         f"from the plain engine ({loss} / {p_loss})")
                line += (f"; loss and predictions equal to the plain engine's; "
                         f"top-1 agreement with the eager eval "
                         f"{float((pred == eager[True][2]).mean()):.6f} (binary: "
                         "not a bar)")
            log(line + f" | {card}")
            out[f"{task} {' '.join(leg)}"] = secs
    return out


# The VN and original models' kNN rounds at their main path's shapes:
# (entry tag, (B, N, k), ((C, the gather's backward runs), ...)). B4 ranks
# and B7 gathers each round's input: the points (C = 3; no gradient), the
# flattened 3V vectors of VN-DGCNN (x1, x2: 21 vectors, 63; x3: 42, 126),
# the original DGCNN's features (64, 64, 128; partseg: the points through
# Transform_Net's 3 x 3 first, which carry its gradient).
ZOO_ROUNDS = (
    ("VN-DGCNN cls", (B_TRAIN, N, K), ((3, False), (63, True), (63, True),
                                       (126, True))),
    ("DGCNN cls", (B_TRAIN, N, K), ((3, False), (64, True), (64, True),
                                    (128, True))),
    ("VN-PointNet cls", (B_TRAIN, N, K), ((3, False),)),
    ("VN-DGCNN pseg", (B_TRAIN, N_PSEG, K_PSEG), ((3, False), (63, True),
                                                  (63, True))),
    ("DGCNN pseg", (B_TRAIN, N_PSEG, K_PSEG), ((3, False), (3, True),
                                               (64, True), (64, True))),
    ("VN-PointNet pseg", (B_TRAIN, N_PSEG, K_PSEG), ((3, False),)),
)
# phase 28's models: (tag, task, --model, --backbone, per-step launches)
ZOO_MODELS = (
    ("VN-PointNet cls", "cls", "vn", "pointnet", {"knn": 1, "edge_gather_fwd": 1}),
    ("VN-DGCNN cls", "cls", "vn", "dgcnn", {"knn": 4, "edge_gather_fwd": 4,
                                            "edge_gather_bwd": 3}),
    ("PointNet cls", "cls", "original", "pointnet", {}),
    ("DGCNN cls", "cls", "original", "dgcnn", {"knn": 4, "edge_gather_fwd": 4,
                                               "edge_gather_bwd": 3}),
    ("VN-PointNet pseg", "partseg", "vn", "pointnet", {"knn": 1,
                                                       "edge_gather_fwd": 1}),
    ("VN-DGCNN pseg", "partseg", "vn", "dgcnn", {"knn": 3, "edge_gather_fwd": 3,
                                                 "edge_gather_bwd": 2}),
    ("PointNet pseg", "partseg", "original", "pointnet", {}),
    ("DGCNN pseg", "partseg", "original", "dgcnn", {"knn": 4, "edge_gather_fwd": 4,
                                                    "edge_gather_bwd": 3}),
)
PSEG_ZOO_STEPS = 3  # 1 warm-up + 2 timed: the script's time
LEARN_EPOCHS = 30  # phase 30 (b): 180 fused steps


def phase2_zoo(rep, gen, dev):
    """B4 and B7 at the VN and original models' widths (ZOO_ROUNDS): ids
    and both passes bitwise their plain versions, each timed beside
    cdist + topk, torch.gather and index_add_ (the kernels line's
    "knn <model>", "edge_gather_fwd <model>", "edge_gather_bwd <model>");
    C = 63 and 126 take B7's scalar copies, 64 and 128 its float4 ones."""
    import torch

    for tag, (b, n, k), rounds in ZOO_ROUNDS:
        log(f"phase 2 zoo: {tag} at ({b}, {n}, {k}), C = {[c for c, _ in rounds]}")
        for c, bwd in rounds:
            x = cloud(b, n, gen, dev) if c == 3 else \
                torch.randn(b, n, c, generator=gen).to(dev)
            compare_knn(rep, f"{tag} B4 C={c}", x, k, True, name=f"knn {tag}")
            compare_edge_gather(rep, b, n, k, c, gen, dev, names=(
                f"edge_gather_fwd {tag}",
                f"edge_gather_bwd {tag}" if bwd else None))
        torch.cuda.empty_cache()


def zoo_model(task, model, backbone, seed):
    """A seeded VN or original model (``models.get_model``), VN pooling
    mean (the CLI's default)."""
    import torch

    from svnet_tpu_torch.models import get_model

    kw = {"k": K if task == "cls" else K_PSEG,
          "generator": torch.Generator().manual_seed(seed),
          ("num_classes" if task == "cls" else "num_part"):
          CLASSES if task == "cls" else PARTS}
    if model == "vn":
        kw["pooling"] = "mean"
    return get_model(task, backbone, model, **kw)


def phase28(dev, gen, counters, loader, card):
    """The zoo's training (ZOO_MODELS): each VN and original model through
    train_epoch with the JAX trainer's recipe (--opt auto: PointNet's
    Adam, DGCNN's SGD at lr x 100), rot z; cls at (B_TRAIN, N, K) on phase
    5's clouds, 1 + TRAIN_STEPS steps; partseg at (B_TRAIN, N_PSEG,
    K_PSEG), PSEG_ZOO_STEPS steps; each step's launches, a BN
    re-estimation batch and an eval batch through the eager model; one
    step against its oracle twin (loss and running statistics within 1e-4
    relative); for cls an eval forward at (B_TRAIN, N, K) against the
    eager oracle twin, top-1 >= 0.99. Returns {tag: (launches, median ms,
    peak bytes)}."""
    import torch

    from svnet_tpu_torch.utils.convert import load_tree, module_tree

    p_loader = pseg_loader(dev, PSEG_ZOO_STEPS)
    out = {}
    for i, (tag, task, model, backbone, per_step) in enumerate(ZOO_MODELS):
        t0 = time.perf_counter()
        m = zoo_model(task, model, backbone, SEED + 60 + i)
        weights = module_tree(m)
        cls = task == "cls"
        recipe = ("pointnet_cls" if cls else "pointnet_partseg") \
            if backbone == "pointnet" else "dgcnn"
        fwd_only = {n: c for n, c in per_step.items() if n != "edge_gather_bwd"}
        out[tag] = phase_pseg_train(
            f"phase 28 {tag}", lambda oracle, m=m: m.make_train_apply(oracle),
            m, weights, recipe, per_step, fwd_only, fwd_only,
            loader if cls else p_loader, dev, gen, counters, card, SEED + 70 + i,
            with_label=not cls, binary=False)
        if cls:
            load_tree(m, weights)
            twin = zoo_model(task, model, backbone, 0).to(dev).eval()
            load_tree(twin, weights)
            twin.oracle = True
            x = cloud(B_TRAIN, N, gen, dev)
            with torch.no_grad():
                got = m.to(dev).eval()(x)
                want = twin(x)
            got, want = (o[0] if isinstance(o, tuple) else o for o in (got, want))
            top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            log(f"phase 28 {tag}: eval forward ({B_TRAIN}, {N}, {K}) against the "
                f"oracle twin: top-1 agreement {top1:.6f}, max |dlogit| "
                f"{(got - want).abs().max().item():.3g}")
            if top1 < 0.99:
                raise AssertionError(f"phase 28 {tag}: top-1 agreement {top1} < 0.99")
        log(f"phase 28 {tag}: {time.perf_counter() - t0:.1f} s")
        del m
        torch.cuda.empty_cache()
    return out


def phase29(dev, gen, counters, card, tmp):
    """The datasets. ``--dataset scanobjectnn --subset hard`` through
    ``loop.run_cls`` from memory (``ScanArrayDataset``: seeded 2,048-point
    surface clouds, 15 classes, each item 1,024 of its points),
    binary SV-DGCNN through the fused train forward at (B_TRAIN, N, K),
    1 + TRAIN_STEPS steps, a BN re-estimation batch and the eager eval:
    the launches, a 15-class head, a finite loss. Then ModelNet40_v2 with
    ``uniform`` on seeded raw text clouds of 10,000 points: the items'
    farthest-point samples on the card equal to those on the CPU. Returns
    the knn launches of the run."""
    import re

    import numpy as np
    import torch

    from svnet_tpu_torch.cli.flags import build_parser
    from svnet_tpu_torch.data import ModelNet40_v2, ScanArrayDataset
    from svnet_tpu_torch.train.loop import read_weights, run_cls
    from svnet_tpu_torch.utils.synth import surface_clouds

    steps, tests = TRAIN_STEPS + 1, 1
    rng = np.random.default_rng(SEED + 80)
    train = ScanArrayDataset(surface_clouds(SEED + 80, steps * B_TRAIN, 2048),
                             rng.integers(0, 15, steps * B_TRAIN), N, train=True,
                             seed=SEED)
    test = ScanArrayDataset(surface_clouds(SEED + 81, tests * B_TRAIN, 2048),
                            rng.integers(0, 15, tests * B_TRAIN), N, seed=SEED + 1)
    args = build_parser().parse_args([
        "--dataset", "scanobjectnn", "--subset", "hard", "--binary", "--epochs",
        "1", "--bn-reestimate", "1", "--num-workers", "0", "--k", str(K),
        "--batch-size", str(B_TRAIN), "--num-points", str(N), "--device", str(dev),
        "--save-dir", f"{tmp}/scanobjectnn"])
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    with echo_captured() as text:
        acc = run_cls(args, datasets=(train, test))
    launches = {fn.__name__: fn.launches for fn in counters}
    per_step = {"knn": 4, "sv_first_train_fwd": 1, "sv_first_train_bwd": 1,
                "sv_round3_train_fwd": 3, "sv_round3_train_bwd": 3}
    want = {n: steps * per_step.get(n, 0) for n in launches}
    for n, c in (("knn", 4 + 4 * tests), ("sv_first_train_fwd", 1),
                 ("sv_round3_train_fwd", 3), ("edge_gather_fwd", 4 * tests)):
        want[n] += c  # the BN re-estimation batch, the eager eval
    head = read_weights(f"{tmp}/scanobjectnn/save_models/model_best.ckpt",
                        dev)["params"]["linear3"]["kernel"].shape
    loss = float(re.findall(r"TRAIN: loss ([0-9.naif]+)", text.getvalue())[-1])
    median = float(re.findall(r"median step ([0-9.]+) ms", text.getvalue())[-1])
    log(f"phase 29: --dataset scanobjectnn --subset hard, run_cls from memory, "
        f"{steps} binary fused steps of ({B_TRAIN}, {N}, {K}): head {tuple(head)}, "
        f"train loss {loss:.6f}, test acc {acc:.6f}, step median {median:.3f} ms, "
        f"launches { {n: c for n, c in launches.items() if c} } "
        f"({time.perf_counter() - t0:.1f} s) | {card}")
    if launches != want or head[-1] != 15 or not np.isfinite(loss):
        raise AssertionError(f"phase 29: launches {launches} != {want}, head "
                             f"{tuple(head)}, loss {loss}")

    root = Path(tmp) / "modelnet40_normal_resampled"
    root.mkdir()
    (root / "modelnet40_shape_names.txt").write_text("chair\nlamp\n")
    ids = ["chair_0001", "lamp_0002", "chair_0003"]
    (root / "modelnet40_train.txt").write_text("\n".join(ids) + "\n")
    for i, name in enumerate(ids):
        d = root / name.rsplit("_", 1)[0]
        d.mkdir(exist_ok=True)
        pts = surface_clouds(SEED + 90 + i, 1, 10000)[0] * rng.uniform(0.5, 2.0, 3)
        np.savetxt(d / f"{name}.txt", np.concatenate([pts, pts], 1), delimiter=",",
                   fmt="%.6f")
    t0 = time.perf_counter()
    card_set = ModelNet40_v2(str(root), N, "train", uniform=True, device=dev)
    items = [card_set[i] for i in range(len(ids))]
    t_card = time.perf_counter() - t0
    cpu_set = ModelNet40_v2(str(root), N, "train", uniform=True, device="cpu")
    for i, (pts, label) in enumerate(items):
        want_pts, want_label = cpu_set[i]
        if not np.array_equal(pts, want_pts) or label != want_label or \
                pts.shape != (N, 3):
            raise AssertionError(f"phase 29: ModelNet40_v2 item {i}: FPS on the "
                                 "card differs from FPS on the CPU")
    log(f"phase 29: ModelNet40_v2(uniform=True) on {len(ids)} raw clouds of 10,000 "
        f"points: {N} farthest points each, the card's items equal to the CPU's "
        f"({t_card:.2f} s on the card, first call included)")
    return launches


def phase30(dev, gen, counters, card):
    """The learning check. (a) FP SV-PointNet cls on the three shapes of
    tests/test_learning.py (``utils.synth.shape_clouds``) with its
    numbers: N = 64, k = 8, B = 24, 40 clouds a class, 20 epochs, the
    pointnet_cls recipe, so3 in training and test; the mean of the last 5
    losses at least 0.2 below the first 5's, test accuracy >= 0.8. (b)
    Binary SV-DGCNN cls at (B_TRAIN, N, K) through the fused train
    forward on the same shapes at N = 1024 (64 clouds a class, 32 a class
    in the test set: 3 whole batches; so3 in training and test),
    LEARN_EPOCHS epochs of the dgcnn recipe's Adam,
    BN re-estimation over 60 batches, then the eager eval: test accuracy
    >= 0.6 (chance 1/3). With (b)'s weights, C25's two numbers, printed:
    the float32 exact engine against the float32 eager model, and the
    float64 plain engine against the float64 eager model
    (``float64_witness``). Returns the seconds of (a) and (b)."""
    import numpy as np
    import torch

    from svnet_tpu_torch.data import ArrayDataset, Loader
    from svnet_tpu_torch.infer import SVDGCNNClsEngine
    from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls
    from svnet_tpu_torch.models.sv_pointnet import SVPointNetCls
    from svnet_tpu_torch.train import pointnet
    from svnet_tpu_torch.train.fused import make_fused_train_apply
    from svnet_tpu_torch.train.loop import bn_reestimate, eval_batches
    from svnet_tpu_torch.train.steps import (
        create_state, make_eval_step, make_recal_step, make_train_step)
    from svnet_tpu_torch.utils.convert import load_tree, module_tree
    from svnet_tpu_torch.utils.synth import shape_clouds

    secs = []
    for tag, n, k, b, per_class, test_per_class, epochs in (
            ("a", 64, 8, 24, 40, 10, 20), ("b", N, K, B_TRAIN, 64, 32, LEARN_EPOCHS)):
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        x_train, y_train = shape_clouds(rng, per_class, n)
        x_test, y_test = shape_clouds(rng, test_per_class, n)
        train = Loader(ArrayDataset(x_train, y_train), b, shuffle=True,
                       drop_last=True, seed=SEED, device=dev)
        test = Loader(ArrayDataset(x_test, y_test), b, shuffle=False, pad_last=True,
                      device=dev)
        binary = tag == "b"
        if binary:
            model = SVDGCNNCls(3, k, True, torch.Generator().manual_seed(SEED + 95))
            apply, recipe = make_fused_train_apply(3, k, binary=True), "dgcnn"
        else:
            model = SVPointNetCls(3, k, False, torch.Generator().manual_seed(SEED + 95))
            apply, recipe = pointnet.make_train_apply_cls(3, k, False), "pointnet_cls"
        state = create_state(module_tree(model), binary=binary, lr=1e-3,
                             epochs=epochs, steps_per_epoch=len(train),
                             recipe=recipe, device=dev)
        step = make_train_step(apply, train_loss(False), rot="so3")
        g = torch.Generator().manual_seed(SEED + 96)
        losses = []
        for _ in range(epochs):
            for batch in train:
                losses.append(step(state, batch, g)[0])
        losses = [float(v) for v in losses]
        if binary:
            state.batch_stats = bn_reestimate(make_recal_step(apply, "so3"), state,
                                              train, g, 60)
        model = model.to(dev).eval()
        load_tree(model, state.tree())
        _, y_true, y_pred, _ = eval_batches(
            make_eval_step(model, train_loss(False), "so3"), test,
            torch.Generator().manual_seed(SEED + 97))
        acc = float((y_true == y_pred).mean())
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        secs.append(time.perf_counter() - t0)
        log(f"phase 30 ({tag}): {'binary SV-DGCNN fused' if binary else 'FP SV-PointNet'}"
            f" cls on 3 shapes, ({b}, {n}, {k}), {len(losses)} steps ({epochs} "
            f"epochs), so3: loss first 5 {first:.6f}, last 5 {last:.6f}; test acc "
            f"{acc:.6f} on {len(y_true)} clouds ({secs[-1]:.1f} s) | {card}")
        if not binary and not (last < first - 0.2 and acc >= 0.8):
            raise AssertionError(f"phase 30 (a): losses {first} -> {last}, acc {acc}")
        if binary and acc < 0.6:
            raise AssertionError(f"phase 30 (b): test acc {acc} < 0.6")

    # C25 on (b)'s trained weights
    tree = state.tree()
    eng = SVDGCNNClsEngine(tree, 3, K, True, device=dev)
    same = total = 0
    with torch.no_grad():
        for batch in test:
            want = model(batch["points"]).argmax(-1)
            same += int((eng(batch["points"]).argmax(-1) == want).sum())
            total += want.numel()
    agree64, agree32 = float64_witness("cls", tree, SVDGCNNCls, SVDGCNNClsEngine, 3,
                                       K, test, dev, bar=False, tag="phase 30 C25")
    log(f"phase 30 C25: trained binary weights, top-1 agreement of the float32 "
        f"exact engine with the float32 eager model {same / total:.6f}; in float64 "
        f"(plain engine against eager model) {agree64:.6f}; the eager model's "
        f"float32 against its float64 {agree32:.6f} ({total} clouds) | {card}")
    return secs



# phase 31: BiPointNet's three trainers, (task, --model's CLI, B, N, channels)
BI_RUNS = (("cls", B_TRAIN, N, 3), ("partseg", B_PSEG, N_PSEG, 3),
           ("semseg", 16, 4096, 9))
BI_TWIN_B = 4  # clouds of the full N in the float64 card-against-CPU step
SEMSEG_LEARN = (16, 1024, 300)  # the learning check: B, N, steps
# PointNet++ at the widths of the SSG and MSG classifiers and of the part
# segmenter's feature propagation (Qi et al., NeurIPS 2017)
SSG = ((512, 0.2, 32, (64, 64, 128)), (128, 0.4, 64, (128, 128, 256)),
       (None, None, None, (256, 512, 1024)))
MSG = (512, (0.1, 0.2, 0.4), (16, 32, 128), ((32, 32, 64), (64, 64, 128),
                                             (64, 96, 128)))
FP_WIDTHS = ((256, 256), (256, 128), (128, 128, 128))


def bi_datasets(task, b, n, steps):
    """(train, test) in memory for ``task``: ``steps`` batches of seeded
    surface clouds (cls: 40 classes; partseg: categories and their parts)
    or band rooms (semseg), and one test batch."""
    import numpy as np

    from svnet_tpu_torch.data import (ArrayDataset, PartArrayDataset,
                                      RoomArrayDataset)
    from svnet_tpu_torch.train.metrics import INDEX_START, SEG_NUM
    from svnet_tpu_torch.utils.synth import band_rooms, surface_clouds

    rng = np.random.default_rng(SEED + 100)
    out = []
    for i, m in enumerate((steps * b, b)):
        if task == "semseg":
            rooms, labels = band_rooms(SEED + 100 + i, m, n)
            out.append(RoomArrayDataset(rooms, labels, n, train=i == 0, seed=SEED))
        elif task == "cls":
            out.append(ArrayDataset(surface_clouds(SEED + 100 + i, m, n),
                                    rng.integers(0, CLASSES, m), train=i == 0))
        else:
            cat = rng.integers(0, 16, m)
            seg = np.stack([INDEX_START[k] + rng.integers(0, SEG_NUM[k], n)
                            for k in cat])
            out.append(PartArrayDataset(surface_clouds(SEED + 100 + i, m, n), cat,
                                        seg, shuffle=i == 0))
    return out


def bi_args(task, b, n, dev, save):
    """The CLI's arguments of ``task`` for BiPointNet (the JAX CLIs'
    defaults but the batch, the points, one epoch and the device)."""
    from svnet_tpu_torch.cli.flags import build_parser
    from svnet_tpu_torch.cli.main_semseg import build_parser as semseg_parser

    common = ["--epochs", "1", "--batch-size", str(b), "--num-points", str(n),
              "--device", str(dev), "--save-dir", save]
    if task == "semseg":
        return semseg_parser().parse_args(common)
    return build_parser(task, "pointnet").parse_args(
        ["--model", "bipointnet", "--num-workers", "0", *common])


def bi_step_twin(tag, model, batch, task, dev):
    """One train step (forward in train mode, the loss and its gradients)
    of ``model``'s function on the card and on the CPU from the same tree
    and the first BI_TWIN_B clouds of ``batch``, both float64: loss,
    logits and new running statistics within 1e-8 relative (the
    gradients' relative error over all leaves printed: a bias before a
    train-mode BatchNorm has a gradient of 0 up to rounding, so a leaf's
    own relative error says nothing there)."""
    import torch

    from svnet_tpu_torch.train.losses import model_loss
    from svnet_tpu_torch.train.steps import tree_map
    from svnet_tpu_torch.utils.convert import flatten, module_tree

    tree = module_tree(model)
    res = []
    for d in (dev, torch.device("cpu")):
        params = tree_map(lambda t: t.detach().to(d, torch.float64).clone()
                          .requires_grad_(True), tree["params"])
        stats = tree_map(lambda t: t.to(d, torch.float64), tree["batch_stats"])
        inputs = [batch["points"][:BI_TWIN_B].to(d, torch.float64)]
        if task == "partseg":
            inputs.append(batch["label"][:BI_TWIN_B].to(d, torch.float64))
        (logits, trans_feat), new = model.make_train_apply()(params, stats, *inputs)
        loss = model_loss((logits, trans_feat), batch["target"][:BI_TWIN_B].to(d),
                          task == "cls")
        loss.backward()
        res.append((loss.item(), logits.detach().cpu(),
                    {p: v.cpu() for p, v in flatten(new).items()},
                    {p: v.grad.cpu() for p, v in flatten(params).items()}))
    (lk, xk, sk, gk), (lc, xc, sc, gc) = res

    def rel(a, b):
        return float((a - b).norm() / (b.norm() + 1e-300))

    worst_st = max(rel(sk[p], v) for p, v in sc.items())
    grads = rel(torch.cat([gk[p].flatten() for p in sorted(gc)]),
                torch.cat([gc[p].flatten() for p in sorted(gc)]))
    log(f"{tag}: one float64 train step of {BI_TWIN_B} clouds, card against CPU: "
        f"loss {lk:.12f} vs {lc:.12f}; logits relative error {rel(xk, xc):.3g}; "
        f"running stats worst {worst_st:.3g}; gradients {grads:.3g}")
    if abs(lk - lc) > 1e-8 * abs(lc) or rel(xk, xc) > 1e-8 or worst_st > 1e-8:
        raise AssertionError(f"{tag}: card and CPU float64 steps differ")


def semseg_learning(dev, card):
    """BiPointNet semseg on band rooms (SEMSEG_LEARN: B, N, steps; one
    test batch), the dgcnn recipe's Adam over the steps, no rotation:
    the last 5 losses' mean at least 0.2 under the first 5's, point
    accuracy >= 0.3 (chance 1/13)."""
    import functools

    import numpy as np
    import torch

    from svnet_tpu_torch.data import Loader, RoomArrayDataset
    from svnet_tpu_torch.models import BiPointNetSemseg
    from svnet_tpu_torch.train.loop import eval_batches
    from svnet_tpu_torch.train.losses import model_loss
    from svnet_tpu_torch.train.steps import (create_state, make_eval_step,
                                             make_train_step)
    from svnet_tpu_torch.utils.convert import load_tree, module_tree
    from svnet_tpu_torch.utils.synth import band_rooms

    b, n, steps = SEMSEG_LEARN
    t0 = time.perf_counter()
    x, y = band_rooms(SEED + 110, 8 * b, n)
    xt, yt = band_rooms(SEED + 111, b, n)
    train = Loader(RoomArrayDataset(x, y, n, train=True, seed=SEED), b, shuffle=True,
                   drop_last=True, seed=SEED, device=dev)
    test = Loader(RoomArrayDataset(xt, yt, n), b, device=dev)
    model = BiPointNetSemseg(generator=torch.Generator().manual_seed(SEED + 112))
    model.init_on(next(iter(test))["points"].cpu(),
                  generator=torch.Generator().manual_seed(SEED + 112))
    apply = model.make_train_apply()
    state = create_state(module_tree(model), binary=True, lr=1e-3,
                         epochs=-(-steps // len(train)), steps_per_epoch=len(train),
                         recipe="dgcnn", device=dev)
    loss_fn = functools.partial(model_loss, smoothing=False)
    step = make_train_step(apply, loss_fn, rot="aligned")
    g = torch.Generator().manual_seed(SEED + 113)
    losses = []
    while len(losses) < steps:
        for batch in train:
            losses.append(step(state, batch, g)[0])
            if len(losses) == steps:
                break
    losses = [float(v) for v in losses]
    model = model.to(dev).eval()
    load_tree(model, state.tree())
    _, y_true, y_pred, _ = eval_batches(make_eval_step(model, loss_fn, "aligned"),
                                        test, g)
    acc = float((y_true == y_pred).mean())
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"phase 31 learning: BiPointNet semseg on band rooms ({b}, {n}, 9), {steps} "
        f"steps: loss first 5 {first:.6f}, last 5 {last:.6f}; point acc {acc:.6f} "
        f"({time.perf_counter() - t0:.1f} s) | {card}")
    if not (last < first - 0.2 and acc >= 0.3):
        raise AssertionError(f"phase 31 learning: losses {first} -> {last}, acc {acc}")


def pointnet2_stacks(dev, card):
    """The PointNet++ stacks (SSG, MSG, FP_WIDTHS) on seeded surface clouds
    (B_TRAIN, N) in float64, eval mode (running statistics bumped), on the
    card for all clouds and on the CPU for the first 2: every FPS,
    ball-query and 3-NN id equal, every output within 1e-8 relative.
    Returns the card's seconds."""
    import numpy as np
    import torch

    from svnet_tpu_torch.nn import pointnet2 as p2
    from svnet_tpu_torch.nn.scope import Scope, init_tree
    from svnet_tpu_torch.ops import sampling
    from svnet_tpu_torch.train.steps import tree_map
    from svnet_tpu_torch.utils.synth import surface_clouds

    def stacks(s, xyz):
        """(outputs, ids) of SSG -> FP and of the MSG layer."""
        outs, ids, l_xyz, l_pts = [], [], [xyz], [None]
        for i, (npoint, radius, nsample, mlp) in enumerate(SSG):
            x, pts = l_xyz[-1], l_pts[-1]
            if npoint is not None:
                fps = sampling.farthest_point_sample(x, npoint)
                ids += [fps, sampling.query_ball_point(
                    radius, nsample, x, sampling.index_points(x, fps))]
            new_xyz, new_pts = p2.set_abstraction(
                s.child(f"sa{i}"), x, pts, npoint, radius, nsample, mlp,
                group_all=npoint is None)
            l_xyz.append(new_xyz)
            l_pts.append(new_pts)
            outs.append(new_pts)
        up = l_pts[-1]
        for j, mlp in enumerate(FP_WIDTHS):
            lo = len(SSG) - 1 - j  # dense level
            if l_xyz[lo + 1].shape[1] > 1:
                ids.append(p2.three_nn(l_xyz[lo], l_xyz[lo + 1])[1])
            up = p2.feature_propagation(s.child(f"fp{j}"), l_xyz[lo], l_xyz[lo + 1],
                                        l_pts[lo], up, mlp)
            outs.append(up)
        npoint, radii, counts, mlps = MSG
        new_xyz, msg = p2.set_abstraction_msg(s.child("msg"), xyz, None, npoint,
                                              radii, counts, mlps)
        centres = sampling.index_points(xyz, sampling.farthest_point_sample(xyz, npoint))
        ids += [sampling.query_ball_point(r, k, xyz, centres)
                for r, k in zip(radii, counts)]
        return outs + [new_xyz, msg], ids

    xyz = torch.from_numpy(surface_clouds(SEED + 120, B_TRAIN, N)).double()
    tree = init_tree(stacks, (xyz[:2],), {}, torch.Generator().manual_seed(SEED + 121))
    tree["batch_stats"] = tree_map(lambda v: v + 0.3 * v.abs() + 0.05,
                                   tree["batch_stats"])
    t0 = time.perf_counter()
    with torch.no_grad():
        got, got_ids = stacks(Scope(tree_map(lambda v: v.to(dev), tree)), xyz.to(dev))
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        want, want_ids = stacks(Scope(tree), xyz[:2])
    for i, (g, w) in enumerate(zip(got_ids, want_ids)):
        if not torch.equal(g[:2].cpu(), w):
            raise AssertionError(f"phase 31 PointNet++: ids {i} differ, card and CPU")
    worst = 0.0
    for g, w in zip(got, want):
        g = g[:2].cpu()
        worst = max(worst, float((g - w).norm() / (w.norm() + 1e-300)))
    log(f"phase 31 PointNet++: SSG {[m for *_, m in SSG]}, MSG {list(MSG[3])}, FP "
        f"{list(FP_WIDTHS)} on ({B_TRAIN}, {N}) float64: {len(got_ids)} id tensors "
        f"equal, outputs worst relative error {worst:.3g} (card {t_card:.2f} s) "
        f"| {card}")
    if worst > 1e-8:
        raise AssertionError(f"phase 31 PointNet++: outputs off by {worst}")
    return t_card


def phase31(dev, counters, card, tmp):
    """BiPointNet through its three trainers, its float64 twins, the
    semseg learning check and the PointNet++ stacks (the module docstring,
    phase 31). No counted kernel launches. Returns {task: (median ms,
    peak bytes)}."""
    import re

    import numpy as np
    import torch

    from svnet_tpu_torch import config
    from svnet_tpu_torch.data import Loader
    from svnet_tpu_torch.models import BiPointNetCls, BiPointNetPseg, BiPointNetSemseg
    from svnet_tpu_torch.train import loop
    from svnet_tpu_torch.utils.convert import load_tree

    config.set_full_fp32()
    models = {"cls": lambda: BiPointNetCls(CLASSES),
              "partseg": lambda: BiPointNetPseg(PARTS), "semseg": BiPointNetSemseg}
    out = {}
    for task, b, n, c in BI_RUNS:
        t0 = time.perf_counter()
        train, test = bi_datasets(task, b, n, TRAIN_STEPS + 1)
        args = bi_args(task, b, n, dev, f"{tmp}/bi_{task}")
        run = {"cls": loop.run_cls, "partseg": loop.run_partseg,
               "semseg": loop.run_semseg}[task]
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with echo_captured() as text:
            metric = run(args, datasets=(train, test))
        peak = torch.cuda.max_memory_allocated(dev)
        launched = {fn.__name__: fn.launches for fn in counters if fn.launches}
        median = float(re.findall(r"median step ([0-9.]+) ms", text.getvalue())[-1])
        loss = float(re.findall(r"TRAIN: loss ([0-9.naif]+)", text.getvalue())[-1])
        log(f"phase 31 {task}: BiPointNet through loop.run_{task} from memory, "
            f"({b}, {n}, {c}), {TRAIN_STEPS + 1} steps: train loss {loss:.6f}, test "
            f"metric {metric:.6f}; step median {median:.3f} ms; peak device memory "
            f"{peak / 2**30:.3f} GiB ({time.perf_counter() - t0:.1f} s) | {card}")
        if launched or not np.isfinite(loss):
            raise AssertionError(f"phase 31 {task}: kernels launched {launched}, "
                                 f"loss {loss}")
        out[task] = (median, peak)
        # the float64 twin step, from the trained checkpoint's tree
        model = models[task]()
        load_tree(model, loop.read_weights(
            f"{tmp}/bi_{task}/save_models/model_best.ckpt", "cpu"))
        batch = next(iter(Loader(test, b, device=dev)))
        bi_step_twin(f"phase 31 {task}", model, batch, task, dev)
        if task == "cls":  # C25: float32 against float64 eval on the card
            m32 = model.to(dev).eval()
            with torch.no_grad():
                top32 = m32(batch["points"])[0].argmax(-1)
                top64 = m32.double()(batch["points"].double())[0].argmax(-1)
            log(f"phase 31 C25: trained BiPointNet cls, float32 card eval against "
                f"float64 card eval: top-1 agreement "
                f"{float((top32 == top64).float().mean()):.6f} ({b} clouds) | {card}")
        del model
        torch.cuda.empty_cache()
    semseg_learning(dev, card)
    pointnet2_stacks(dev, card)
    return out


def pseg_test_set():
    """2 batches of seeded surface clouds (B_TRAIN, N_PSEG) with random
    categories and part ids inside each category's range, unshuffled."""
    import numpy as np

    from svnet_tpu_torch.data import PartArrayDataset
    from svnet_tpu_torch.train.metrics import INDEX_START, SEG_NUM
    from svnet_tpu_torch.utils.synth import surface_clouds

    m = 2 * B_TRAIN
    rng = np.random.default_rng(SEED + 42)
    cat = rng.integers(0, 16, m)
    seg = np.stack([INDEX_START[c] + rng.integers(0, SEG_NUM[c], N_PSEG)
                    for c in cat])
    return PartArrayDataset(surface_clouds(SEED + 42, m, N_PSEG), cat, seg)


# phase 32's configurations: (tag, engine key, batch, points, the config
# knobs the engine is exported and served under)
P32_CONFIGS = (
    ("SV-DGCNN cls exact", "cls", B, N, {}),
    ("SV-DGCNN cls serving pick", "pick", B, N,
     {"approx_fold": 256, "approx_gather_bits": 8, "graph_reuse": "spatial"}),
    ("SV-DGCNN partseg exact", "pseg", B_PSEG, N_PSEG, {}),
    ("SV-PointNet cls exact", "pn cls", B, N, {}),
    ("SV-PointNet partseg exact", "pn pseg", B_PSEG, N_PSEG, {}),
    ("SV-DGCNN cls round2", "round2", 16, N, {}),
    ("SV-DGCNN cls edge", "edge", 16, N, {}),
)
P32_REQUESTS = 3


@contextlib.contextmanager
def config_knobs(knobs: dict):
    """``config``'s serving knobs set through their setters, restored
    after."""
    from svnet_tpu_torch import config

    was = {name: getattr(config, name) for name in knobs}
    try:
        for name, value in knobs.items():
            getattr(config, "set_" + name)(value)
        yield
    finally:
        for name, value in was.items():
            setattr(config, name, value)


def phase32(engines, gen, dev, counters, card, ckpt, tmp):
    """AOT export (serve.py) on the card: each of ``P32_CONFIGS``' engines
    (phase 3's, 7's, 8's and 12's seeded weights, the serving pick on
    phase 3's, the round2 and edge trunks at B = 16) exported with
    ``export_engine`` under its knobs, loaded with ``load_engine`` and run,
    outside the knobs, on the requests the live engine answers under them:
    the logits ``torch.equal``, the launches per request the live
    engine's, the graph calling the trunk's ``svnet::`` ops. Printed: the
    artifact's bytes, the export and load seconds, and the median request
    (CUDA events) of both, as a record. Then once: a second process that
    imports only ``svnet_tpu_torch.serve`` loads the classifier's artifact
    from a file and answers a request, equal to this process's logits;
    ``python -m svnet_tpu_torch.serve`` turns phase 26's checkpoint into an
    artifact whose logits equal the live engine's; ``analyze_model`` of
    binary SV-DGCNN cls at N = 1024, k = 20 (on the CPU). Returns the
    phase's seconds."""
    import io

    import torch

    from svnet_tpu_torch.infer import SVDGCNNClsEngine
    from svnet_tpu_torch.serve import export_program, load_engine
    from svnet_tpu_torch.train.loop import read_weights
    from svnet_tpu_torch.utils.analysis import analyze_model

    t_phase = time.perf_counter()
    names = [fn.__name__ for fn in counters]

    def timed(fn, args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        before = [c.launches for c in counters]
        e0.record()
        out = fn(*args)
        e1.record()
        torch.cuda.synchronize()
        per = {n: c.launches - b for n, c, b in zip(names, counters, before)
               if c.launches != b}
        return out, e0.elapsed_time(e1), per

    first = None
    for tag, key, b, n, knobs in P32_CONFIGS:
        eng = engines[key]
        pseg = "pseg" in key
        reqs = [(cloud(b, n, gen, dev),) + ((labels(b, gen, dev),) if pseg else ())
                for _ in range(P32_REQUESTS)]
        with config_knobs(knobs):
            eng(*reqs[0])  # warm-up
            live = [timed(eng, r) for r in reqs]
            t0 = time.perf_counter()
            ep = export_program(eng, *reqs[0])
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            blob = buf.getvalue()
            t_export = time.perf_counter() - t0
        ops = sorted({str(nd.target).split(".")[1] for nd in ep.graph.nodes
                      if nd.op == "call_function"
                      and str(nd.target).startswith("svnet.")})
        t0 = time.perf_counter()
        call = load_engine(blob)
        t_load = time.perf_counter() - t0
        call(*reqs[0])  # warm-up: the first call packs W1's signs
        loaded = [timed(call, r) for r in reqs]
        for i, ((want, _, want_per), (got, _, got_per)) in enumerate(zip(live, loaded)):
            if not torch.equal(got, want):
                raise AssertionError(f"phase 32 {tag}: request {i}: the loaded "
                                     "artifact's logits differ from the live "
                                     f"engine's (max |d| "
                                     f"{(got - want).abs().max().item():.3g})")
            if got_per != want_per or not want_per:
                raise AssertionError(f"phase 32 {tag}: request {i}: launches "
                                     f"{got_per} != the live engine's {want_per}")
        # the pre-pass runs inside a selecting round's op, and a reuse round
        # also counts on sv_round3's launches
        inside = {"neg_min"} | ({"sv_round3"} if "sv_round3_reuse" in ops else set())
        missing = set(want_per) - set(ops) - inside
        if missing:
            raise AssertionError(f"phase 32 {tag}: the graph calls {ops}, not "
                                 f"the launched kernels {sorted(missing)}")
        med = [sorted(t for _, t, _ in runs)[len(runs) // 2] for runs in (live, loaded)]
        log(f"phase 32 {tag}: ({b}, {n}, 3), {len(blob)} bytes, export "
            f"{t_export:.2f} s, load {t_load:.2f} s, graph ops {ops}, launches "
            f"per request {want_per} both; median request live {med[0]:.3f} ms, "
            f"loaded {med[1]:.3f} ms | {card}")
        if first is None:
            first = (blob, reqs[0][0], live[0][0])

    # a second process: only svnet_tpu_torch.serve, the artifact from a file
    blob, pts, want = first
    art = Path(tmp) / "engine.pt2"
    art.write_bytes(blob)
    torch.save(pts.cpu(), Path(tmp) / "points.pt")
    code = ("import sys, torch\n"
            "from svnet_tpu_torch.serve import load_engine\n"
            "d = sys.argv[1]\n"
            "call = load_engine(open(d + '/engine.pt2', 'rb').read())\n"
            "out = call(torch.load(d + '/points.pt').cuda())\n"
            "torch.save(out.cpu(), d + '/logits.pt')\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code, str(tmp)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"phase 32: the second process failed:\n{r.stderr[-3000:]}")
    other = torch.load(Path(tmp) / "logits.pt")
    if not torch.equal(other, want.cpu()):
        raise AssertionError("phase 32: the second process's logits differ")
    log(f"phase 32: a second process loaded the cls artifact from a file and "
        f"answered, logits equal ({time.perf_counter() - t0:.1f} s)")

    # the CLI on phase 26's checkpoint
    out = Path(tmp) / "cli.pt2"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "svnet_tpu_torch.serve", "--ckpt",
                        str(ckpt), "--out", str(out), "--batch", "16",
                        "--num-points", str(N), "--k", str(K), "--mode", "exact"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"phase 32: the serve CLI failed:\n{r.stderr[-3000:]}")
    pts = cloud(16, N, gen, dev)
    live = SVDGCNNClsEngine(read_weights(str(ckpt), dev), CLASSES, K, True,
                            device=dev)(pts)
    if not torch.equal(load_engine(out.read_bytes())(pts), live):
        raise AssertionError("phase 32: the CLI's artifact differs from the "
                             "live engine on phase 26's checkpoint")
    log(f"phase 32: {r.stdout.strip()}; its logits equal the live engine's "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    res = analyze_model("cls", "dgcnn", "svnet", binary=True, num_points=N, k=K)
    log(f"phase 32: analyze_model SV-DGCNN cls binary N={N} k={K} (CPU trace, "
        f"{time.perf_counter() - t0:.1f} s): "
        + ", ".join(f"{name} {value:.6f}" for name, value in res.items()))
    return time.perf_counter() - t_phase


def main() -> int:
    t_start = time.perf_counter()
    import torch

    # phase 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    if not (ROOT / "svnet_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: svnet_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from svnet_tpu_torch import config
    from svnet_tpu_torch.infer import SVDGCNNClsEngine
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops import rotations
    from svnet_tpu_torch.ops.kernels import _build
    from svnet_tpu_torch.ops.kernels import binary_matmul as kbm
    from svnet_tpu_torch.ops.kernels import edge_gather as eg
    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.kernels import sv_block_point as kb
    from svnet_tpu_torch.ops.kernels import sv_first_train as kf
    from svnet_tpu_torch.ops.kernels import sv_edge as ke
    from svnet_tpu_torch.ops.kernels import sv_edge_first as kef
    from svnet_tpu_torch.ops.kernels import sv_point as kp
    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr
    from svnet_tpu_torch.ops.kernels import sv_round3_train as krt
    from svnet_tpu_torch.train.steps import tree_map

    dev = config.require_cuda("cuda")
    config.set_full_fp32()  # every oracle on the card runs in full f32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index]
    log(f"phase 0: {torch.cuda.get_device_name(dev)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # phase 1
    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path().name}")

    gen = torch.Generator().manual_seed(SEED)
    w_bin = init_params(CLASSES, K, True, torch.Generator().manual_seed(SEED))
    w_fp = init_params(CLASSES, K, False,
                       torch.Generator().manual_seed(SEED + 1))
    eng = SVDGCNNClsEngine(w_bin, CLASSES, K, True, device=dev)
    eng_fp = SVDGCNNClsEngine(w_fp, CLASSES, K, False, device=dev)
    oracle = SVDGCNNClsEngine(w_bin, CLASSES, K, True, device=dev,
                              oracle=True)

    dg = dgcnn_engines(dev, w_bin, w_fp)

    # phase 2
    log("phase 2: kernels vs plain versions")
    rep = Report()
    phase2(rep, "cls", eng, eng_fp, gen, dev, B, N, K)
    for name, (b, n, k) in (("cls round2", (B, N, K)),
                            ("pseg round3", (B_PSEG, N_PSEG, K_PSEG)),
                            ("pseg round2", (B_PSEG, N_PSEG, K_PSEG))):
        phase2(rep, name.split()[0], dg[name]["kernel"], dg[name]["kernel_fp"],
               gen, dev, b, n, k)
    phase2_round_edge(rep, eng, eng_fp, gen, dev, B, N, K, True)
    phase2_round_edge(rep, eng, eng_fp, gen, dev, 8, N_RAGGED, 7, False)
    phase2_select(rep, eng, gen, dev)
    p_bin = tree_map(lambda t: t.to(dev), w_bin["params"])
    p_fp = tree_map(lambda t: t.to(dev), w_fp["params"])
    phase2_train(rep, p_bin, p_fp, gen, dev)
    phase2_train(rep, p_bin, p_fp, gen, dev, b=8, n=N - 24, k=7, time_it=False,
                 rounds={"conv2": (32, 10, 32, 10)})
    phase2_pseg_train(rep, gen, dev)
    t_recipe = time.perf_counter()
    phase2_knob_train(rep, gen, dev)
    t_recipe = time.perf_counter() - t_recipe
    phase2_forced(rep, dev)
    phase2_first_forced(rep, dev)
    phase2_point_forced(rep, dev)
    worst = max(rep.grad_rel, key=rep.grad_rel.get)
    log(f"phase 2: worst relative gradient error of the training rounds "
        f"{rep.grad_rel[worst]:.3g} ({worst}; bar 1e-3)")
    pn = pointnet_engines(dev)
    phase2_pointnet(rep, pn, gen, dev)
    phase2_gather(rep, gen, dev)
    t0 = time.perf_counter()
    phase2_pseg_gather(rep, gen, dev)
    t_recipe += time.perf_counter() - t0
    phase2_fast(rep, eng, eng_fp, dg, pn, gen, dev)
    phase2_prepass_forced(dev)
    phase2_approx(rep, eng, eng_fp, dg, pn, gen, dev)
    phase2_reuse(rep, eng, eng_fp, dg, gen, dev)
    W_long = phase2_window(rep, eng, eng_fp, gen, dev)
    phase2_legacy(rep, dg["cls round"]["kernel"], dg["cls round"]["kernel_fp"],
                  dg, gen, dev)
    edge_feats = phase2_edge_modes(rep, dg["cls edge"]["kernel"],
                                   dg["cls edge"]["kernel_fp"], dg, gen, dev)
    t_zoo2 = time.perf_counter()
    phase2_zoo(rep, gen, dev)
    t_zoo2 = time.perf_counter() - t_zoo2
    log(f"phase 2 zoo: {t_zoo2:.1f} s")

    # phase 3
    counters = (kr.sv_round3_first, kr.sv_round3, kp.sv_point_block_cm, kk.knn,
                kf.sv_first_train_fwd, kf.sv_first_train_bwd,
                krt.sv_round3_train_fwd, krt.sv_round3_train_bwd,
                kb.sv_block_point, eg.edge_gather_fwd, eg.edge_gather_bwd,
                k2.sv_round2_first, k2.sv_round2, kp.sv_point_block,
                k1.sv_round_first, k1.sv_round, kef.sv_edge_first_block,
                ke.sv_edge_block, kbm.xnor_popcount, kk.neg_min,
                kr.sv_round3_reuse)
    requests = [cloud(B, N, gen, dev) for _ in range(REQUESTS)]
    eng(requests[0])  # warm-up, outside the counted run
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    logits, lat = [], []
    for pts in requests:
        before = [fn.launches for fn in counters]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = eng(pts)
        e1.record()
        torch.cuda.synchronize()
        lat.append(e0.elapsed_time(e1))
        per = [fn.launches - b0 for fn, b0 in zip(counters, before)]
        if per != [1, 3, 1] + [0] * (len(counters) - 3):
            raise AssertionError(f"phase 3: launches per request {per} != "
                                 "[1, 3, 1] serving, 0 training, 0 B8, 0 B7, "
                                 "0 round2, 0 round, 0 edge, 0 B9")
        logits.append(out)
    launches = {fn.__name__: fn.launches for fn in counters}
    got = torch.cat(logits)
    if got.shape != (REQUESTS * B, CLASSES) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"phase 3: logits {tuple(got.shape)} not finite "
                             f"({REQUESTS * B}, {CLASSES})")
    want, plain_lat = [], []
    for pts in requests:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want.append(oracle(pts))
        e1.record()
        torch.cuda.synchronize()
        plain_lat.append(e0.elapsed_time(e1))
    want = torch.cat(want)
    top1 = (got.argmax(1) == want.argmax(1)).float().mean().item()
    dmax = (got - want).abs().max().item()
    log(f"phase 3: {REQUESTS} requests of ({B}, {N}, 3); launches {launches}; "
        f"top-1 agreement with the plain engine {top1:.4f}; max |dlogit| "
        f"{dmax:.4g} (logit scale {want.abs().max().item():.4g})")
    MEDIANS["phase 3"] = sorted(lat)[len(lat) // 2]
    log(f"phase 3: latency per request (CUDA events, ms) kernels "
        f"{[round(t, 3) for t in lat]} median {MEDIANS['phase 3']:.3f}; plain "
        f"{[round(t, 3) for t in plain_lat]} | {card}")
    if top1 < 0.99:
        raise AssertionError(f"phase 3: top-1 agreement {top1} < 0.99")

    # phase 4
    pts = cloud(16, N, gen, dev)
    rot = rotations.random_rotations(16, gen).to(dev)
    out = eng_fp(pts)
    out_r = eng_fp(rotations.rotate_points(pts, rot))
    err = (out_r - out).abs().max().item()
    log(f"phase 4: SO(3) invariance (FP engine, kernels): max |dlogit| "
        f"{err:.3g} (logit scale {out.abs().max().item():.3g})")
    if not torch.allclose(out_r, out, rtol=2e-2, atol=2e-3):
        raise AssertionError("phase 4: logits not rotation invariant")

    # phases 5 and 6
    train_launches, step_ms, peak, loader = phase5(dev, gen, counters, card)
    # each kernel's launches are those of the path that runs it
    launches.update({fn.__name__: train_launches[fn.__name__]
                     for fn in counters[3:8]})

    # phases 7 and 8: SV-PointNet serving
    b8_tally = {}
    for tag, phase in (("cls", phase7), ("pseg", phase8)):
        tally, pn_launches = phase(pn, gen, dev, counters, card)
        launches[f"sv_round3_first cross {tag}"] = pn_launches["sv_round3_first"]
        b8_tally.update({b8_name(tag, key): c for key, c in tally.items()})

    # phases 9 and 10: SV-PointNet cls training
    pn_launches, pn_step_ms, pn_peak = phase9(dev, gen, counters, loader, card)
    launches["edge_gather_fwd"] = pn_launches["edge_gather_fwd"]

    # phase 11: the un-fused SV-DGCNN train path, which runs B7's backward
    dg_launches, dg_step_ms = phase11(dev, gen, counters, loader, card)
    launches["edge_gather_bwd"] = dg_launches["edge_gather_bwd"]

    # phase 12: SV-DGCNN part segmentation serving (round3)
    pseg_launches, pseg_peak = phase12(dg, gen, dev, counters, card)
    for fn in (kr.sv_round3_first, kr.sv_round3, kp.sv_point_block_cm):
        launches[kernel_name(fn, "pseg", False)] = pseg_launches[fn.__name__]

    # phase 13: the round2 trunks of both SV-DGCNN engines
    for tag, r2_launches in phase13(dg, eng, gen, dev, counters, card).items():
        for fn in (k2.sv_round2_first, k2.sv_round2, kp.sv_point_block):
            launches[kernel_name(fn, tag, True)] = r2_launches[fn.__name__]

    # phase 14: the classifier's round and edge trunks; C14
    trunk_launches = phase14(dg, eng, gen, dev, counters, card)
    for impl, fns in (("round", (k1.sv_round_first, k1.sv_round)),
                      ("edge", (kef.sv_edge_first_block, ke.sv_edge_block))):
        for fn in fns:
            launches[fn.__name__] = trunk_launches[impl][fn.__name__]

    # phase 15: B9 through its bench
    launches.update(phase15(rep, counters, card))

    # phase 16: fast-mode serving
    launches.update(phase16(eng, eng_fp, pn, dg, w_bin, w_fp, gen, dev,
                            counters, card))

    # phase 17: approx-mode serving
    launches.update(phase17(eng, pn, dg, w_bin, gen, dev, counters, card))

    # phase 18: graph reuse, the JAX package's serving pick
    launches.update(phase18(w_bin, gen, dev, counters, card))

    # phase 19: the candidate window at N = 8192
    launches.update(phase19(w_bin, W_long, gen, dev, counters, card))

    # phase 20: the legacy trunks' fast and approx mode
    launches.update(phase20(dg, w_bin, gen, dev, counters, card))

    # phase 21: the edge trunk's fast and approx mode; B4's modes
    launches.update(phase21(dg, w_bin, edge_feats, gen, dev, counters, card))

    # phases 22 and 23: part-segmentation training, both families
    p_loader = pseg_loader(dev)
    t_pseg = time.perf_counter()
    ps_launches, ps_step_ms, ps_peak = phase22(dev, gen, counters, p_loader, card)
    pp_launches, pp_step_ms, pp_peak = phase23(dev, gen, counters, p_loader, card)
    t_pseg = time.perf_counter() - t_pseg
    for name in ("sv_first_train_fwd", "sv_first_train_bwd",
                 "sv_round3_train_fwd", "sv_round3_train_bwd"):
        launches[f"{name} pseg train"] = ps_launches[name]
    launches["knn pseg train"] = ps_launches["knn"] + pp_launches["knn"]
    launches["edge_gather_fwd pseg train"] = pp_launches["edge_gather_fwd"]

    # phases 24-27: the serving pick's training recipe
    t0 = time.perf_counter()
    pu_launches, pu_step_ms, pu_peak = phase24(dev, gen, counters, p_loader, card)
    for name in ("edge_gather_fwd", "edge_gather_bwd"):
        launches[f"{name} pseg unfused"] = pu_launches[name]
    knob = phase25(dev, gen, counters, loader, p_loader, card)
    for task in ("cls", "pseg"):
        for name in ("sv_round3_train_fwd", "sv_round3_train_bwd"):
            launches[f"{name} knob {task}"] = knob[task][0][name]
    keep = tempfile.mkdtemp()  # phase 26's stage-1 checkpoint for phase 32
    with tempfile.TemporaryDirectory() as tmp:
        s1_ckpt, fp_ckpt, cls_test, kd_ms = phase26(dev, gen, counters, loader,
                                                    card, tmp)
        shutil.copy(s1_ckpt, Path(keep) / "stage1.ckpt")
        from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg
        from svnet_tpu_torch.train.loop import read_weights

        trees = {"cls": read_weights(s1_ckpt, dev),
                 "pseg": knob["pseg"][3].tree()}
        fp_trees = {"cls": read_weights(fp_ckpt, dev),
                    "pseg": init_params_pseg(PARTS, K_PSEG, False,
                                             torch.Generator().manual_seed(SEED + 43))}
    cert = phase27(trees, fp_trees, {"cls": cls_test, "pseg": pseg_test_set()},
                   dev, counters, card)
    t_recipe += time.perf_counter() - t0

    # phases 28-30: the VN and original models' training, the datasets, the
    # learning check
    t_new = {}
    t0 = time.perf_counter()
    zoo = phase28(dev, gen, counters, loader, card)
    t_new["28"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        phase29(dev, gen, counters, card, tmp)
    t_new["29"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    learn_secs = phase30(dev, gen, counters, card)
    t_new["30"] = time.perf_counter() - t0
    # phase 31: BiPointNet's trainers, PointNet++
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        bi = phase31(dev, counters, card, tmp)
    t_new["31"] = time.perf_counter() - t0
    # phase 32: AOT export of the serving engines
    engines = {"cls": eng, "pseg": dg["pseg round3"]["kernel"],
               "pn cls": pn["cls"]["kernel"], "pn pseg": pn["pseg"]["kernel"],
               "round2": dg["cls round2"]["kernel"], "edge": dg["cls edge"]["kernel"],
               "pick": SVDGCNNClsEngine(w_bin, CLASSES, K, True, mode="approx",
                                        device=dev)}
    try:
        t_new["32"] = phase32(engines, gen, dev, counters, card,
                              Path(keep) / "stage1.ckpt", keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    for tag, _, rounds in ZOO_ROUNDS:
        launches[f"knn {tag}"] = zoo[tag][0]["knn"]
        launches[f"edge_gather_fwd {tag}"] = zoo[tag][0]["edge_gather_fwd"]
        if any(bwd for _, bwd in rounds):
            launches[f"edge_gather_bwd {tag}"] = zoo[tag][0]["edge_gather_bwd"]

    src_of = {"sv_round3_first": ("svnet_tpu_torch/csrc/sv_round3_first.cu",
                                  "svnet_tpu/ops/pallas/sv_round3.py:1462"),
              "sv_round3": ("svnet_tpu_torch/csrc/sv_round3.cu",
                            "svnet_tpu/ops/pallas/sv_round3.py:996"),
              "sv_point_block_cm": ("svnet_tpu_torch/csrc/sv_point.cu",
                                    "svnet_tpu/ops/pallas/sv_point.py:199"),
              "knn": ("svnet_tpu_torch/csrc/knn.cu",
                      "svnet_tpu/ops/pallas/knn.py:99"),
              "sv_first_train_fwd": ("svnet_tpu_torch/csrc/sv_first_train.cu",
                                     "svnet_tpu/ops/pallas/sv_first_train.py:442"),
              "sv_first_train_bwd": ("svnet_tpu_torch/csrc/sv_first_train.cu",
                                     "svnet_tpu/ops/pallas/sv_first_train.py:442"),
              "sv_round3_train_fwd": ("svnet_tpu_torch/csrc/sv_round3_train.cu",
                                      "svnet_tpu/ops/pallas/sv_round3_train.py:522"),
              "sv_round3_train_bwd": ("svnet_tpu_torch/csrc/sv_round3_train.cu",
                                      "svnet_tpu/ops/pallas/sv_round3_train.py:522"),
              "edge_gather_fwd": ("svnet_tpu_torch/csrc/edge_gather.cu",
                                  "svnet_tpu/ops/pallas/edge_gather.py:92"),
              "edge_gather_bwd": ("svnet_tpu_torch/csrc/edge_gather.cu",
                                  "svnet_tpu/ops/pallas/edge_gather.py:92")}
    src_of.update({
        "sv_round_first": ("svnet_tpu_torch/csrc/sv_round.cu",
                           "svnet_tpu/ops/pallas/sv_round.py:361"),
        "sv_round": ("svnet_tpu_torch/csrc/sv_round.cu",
                     "svnet_tpu/ops/pallas/sv_round.py:423"),
        "sv_edge_first_block": ("svnet_tpu_torch/csrc/sv_edge.cu",
                                "svnet_tpu/ops/pallas/sv_edge_first.py:114"),
        "sv_edge_block": ("svnet_tpu_torch/csrc/sv_edge.cu",
                          "svnet_tpu/ops/pallas/sv_edge.py:168"),
        "xnor_popcount": ("svnet_tpu_torch/csrc/binary_matmul.cu",
                          "svnet_tpu/ops/pallas/binary_matmul.py:77")})
    for tag in ("cls", "pseg"):
        src_of[f"sv_round2_first {tag}"] = (
            "svnet_tpu_torch/csrc/sv_round2.cu",
            "svnet_tpu/ops/pallas/sv_round2.py:564")
        src_of[f"sv_round2 {tag}"] = ("svnet_tpu_torch/csrc/sv_round2.cu",
                                      "svnet_tpu/ops/pallas/sv_round2.py:378")
        src_of[f"sv_point_block {tag}"] = ("svnet_tpu_torch/csrc/sv_point.cu",
                                           "svnet_tpu/ops/pallas/sv_point.py:274")
    for name in ("sv_round3_first", "sv_round3", "sv_point_block_cm"):
        src_of[f"{name} pseg"] = src_of[name]
    for bits in (16, 8):
        for tag in ("cls", "pseg"):
            for name in ("sv_round3_first", "sv_round3"):
                src_of[fast_name(name, bits, tag)] = src_of[name]
    src_of[fast_name("sv_round3_first cross", 16, "cls")] = src_of["sv_round3_first"]
    for bits in (16, 8):
        for tag in ("cls", "pseg"):
            for name in ("sv_round3_first", "sv_round3"):
                src_of[approx_name(name, bits, tag)] = src_of[name]
        src_of[approx_name("sv_round3_first cross", bits, "cls")] = \
            src_of["sv_round3_first"]
    # B2 reuse: _round3_kernel's take_wins branch (sv_round3.py:480-540)
    for name in ("sv_round3_reuse", "sv_round3_reuse approx8",
                 "sv_round3_reuse approx8 pseg"):
        src_of[name] = src_of["sv_round3"]
    # the window: the W < N branches of _round3_first_kernel and
    # _round3_kernel (sv_round3.py:1274-1313, :548-591), and the scale
    # pre-pass over the window (the neg the TPU kernel zeroes on padding)
    for mode, bits in WINDOW_TIMED:
        src_of[window_name("sv_round3_first", mode, bits)] = (
            "svnet_tpu_torch/csrc/sv_round3_first.cu",
            "svnet_tpu/ops/pallas/sv_round3.py:1274")
        src_of[window_name("sv_round3", mode, bits)] = (
            "svnet_tpu_torch/csrc/sv_round3.cu",
            "svnet_tpu/ops/pallas/sv_round3.py:548")
    src_of[window_name("neg_min", "approx", 8)] = (
        "svnet_tpu_torch/csrc/knn.cu", "svnet_tpu/ops/pallas/sv_round3.py:590")
    # the pre-pass's two scans (_prune_prepass, XLA in JAX): tau and the
    # block test
    src_of["window_tau"] = ("svnet_tpu_torch/csrc/window.cu",
                            "svnet_tpu/ops/pallas/sv_round3.py:946")
    src_of["window_keep"] = ("svnet_tpu_torch/csrc/window.cu",
                             "svnet_tpu/ops/pallas/sv_round3.py:972")
    # the legacy trunks' fast and approx mode (B10b: _build_key, :213;
    # B10a: exact=False's packed key, sv_round.py:85-97)
    for tag in ("cls", "pseg"):
        for mode in ("fast", "approx"):
            for name in ("sv_round2_first", "sv_round2"):
                src_of[legacy_name(name, mode, tag)] = src_of[f"{name} {tag}"]
    for name in ("sv_round_first", "sv_round"):
        src_of[legacy_name(name, "fast", "cls")] = src_of[name]
    # the edge trunk's exact=False (B10c: sv_edge.py:144-152's bf16
    # linear2) and B4's fast and approx mode (knn.py:38-96)
    for name in ("sv_edge_first_block", "sv_edge_block"):
        src_of[f"{name} exact=False"] = src_of[name]
    for mode in ("fast", "approx"):
        src_of[f"knn {mode}"] = src_of["knn"]
    # the TPU kernel takes each key tile's worst distance from its own
    # (N, T) block (_packed_key_t); here a pre-pass kernel does
    for name in ("neg_min", "neg_min pseg"):
        src_of[name] = ("svnet_tpu_torch/csrc/knn.cu",
                        "svnet_tpu/ops/pallas/sv_round3.py:203")
    for name in ("knn", "sv_first_train_fwd", "sv_first_train_bwd",
                 "sv_round3_train_fwd", "sv_round3_train_bwd", "edge_gather_fwd"):
        src_of[f"{name} pseg train"] = src_of[name]
    # B6 on another round's ids, its input through ste_quant8 (knob-aware
    # training: sv_round3_train.py's kernel at round_k on the caller's
    # ids), and B7 at the un-fused part segmenter's joint widths
    for task in ("cls", "pseg"):
        for name in ("sv_round3_train_fwd", "sv_round3_train_bwd"):
            src_of[f"{name} knob {task}"] = src_of[name]
    for name in ("edge_gather_fwd", "edge_gather_bwd"):
        src_of[f"{name} pseg unfused"] = src_of[name]
    # the VN and original models' rounds: B4 and B7 at their widths
    for tag, _, rounds in ZOO_ROUNDS:
        for name in ("knn", "edge_gather_fwd") + (
                ("edge_gather_bwd",) if any(bwd for _, bwd in rounds) else ()):
            src_of[f"{name} {tag}"] = src_of[name]
    for name in rep.ms:
        if name.startswith("sv_round3_first cross"):
            src_of[name] = src_of["sv_round3_first"]
        elif name.startswith("sv_block_point"):
            src_of[name] = ("svnet_tpu_torch/csrc/sv_block_point.cu",
                            "svnet_tpu/ops/pallas/sv_block_point.py:84")
            launches[name] = b8_tally[name]
    kernels = []
    for name, (source, replaces) in src_of.items():
        times = rep.ms[name]
        lib = [t[3] for t in times if t[3] is not None]

        def mean(vals):
            return sum(vals) / len(vals)

        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rep.err[name],
            # per launch, averaged over the main path's shapes of the kernel
            "ms": mean([t[0] for t in times]),
            "plain_ms": mean([t[1] for t in times]),
            "bound_ms": mean([t[2][0] for t in times]),
            "bound_by": max((t[2][1] for t in times),
                            key=[t[2][1] for t in times].count),
            "library_ms": mean(lib) if lib else None,
        })
    log(f"train step median {step_ms:.3f} ms (B={B_TRAIN}, N={N}, k={K}), peak "
        f"device memory {peak / 2**30:.3f} GiB; SV-PointNet train step median "
        f"{pn_step_ms:.3f} ms, peak {pn_peak / 2**30:.3f} GiB; un-fused SV-DGCNN "
        f"train step median {dg_step_ms:.3f} ms; SV-DGCNN partseg request peak "
        f"{pseg_peak / 2**30:.3f} GiB")
    log(f"partseg train step median (B={B_TRAIN}, N={N_PSEG}, k={K_PSEG}): "
        f"SV-DGCNN {ps_step_ms:.3f} ms, peak {ps_peak / 2**30:.3f} GiB; "
        f"SV-PointNet {pp_step_ms:.3f} ms, peak {pp_peak / 2**30:.3f} GiB; "
        f"phases 22-23 took {t_pseg:.1f} s")
    log(f"un-fused SV-DGCNN partseg train step median (B={B_TRAIN}, N={N_PSEG}, "
        f"k={K_PSEG}) {pu_step_ms:.3f} ms, peak {pu_peak / 2**30:.3f} GiB; knob-aware "
        f"fused step median cls {knob['cls'][1]:.3f} ms (peak "
        f"{knob['cls'][2] / 2**30:.3f} GiB), partseg {knob['pseg'][1]:.3f} ms (peak "
        f"{knob['pseg'][2] / 2**30:.3f} GiB); KD step median {kd_ms:.3f} ms; "
        f"certification legs {sum(cert.values()):.1f} s in all")
    log(f"phases 28-30: zoo train steps median (ms) / peak (GiB): "
        + "; ".join(f"{tag} {med:.3f} / {peak / 2**30:.3f}"
                    for tag, (_, med, peak) in zoo.items())
        + f" | {card}")
    log("phase 31: BiPointNet train steps median (ms) / peak (GiB): "
        + "; ".join(f"{task} {med:.3f} / {peak / 2**30:.3f}"
                    for task, (med, peak) in bi.items())
        + f"; phase 31 took {t_new['31']:.1f} s | {card}")
    log(f"phase 32 took {t_new['32']:.1f} s")
    log(f"phase 2 zoo {t_zoo2:.1f} s; phase 28 {t_new['28']:.1f} s, phase 29 "
        f"{t_new['29']:.1f} s, phase 30 {t_new['30']:.1f} s ((a) "
        f"{learn_secs[0]:.1f} s, (b) {learn_secs[1]:.1f} s)")
    total = time.perf_counter() - t_start
    log(f"chip_smoke: {total:.1f} s, the build included; the recipe's phases "
        f"(phase 2's knob and partseg gather shapes, phases 24-27) {t_recipe:.1f} s, "
        f"{100 * t_recipe / total:.1f}% of it")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

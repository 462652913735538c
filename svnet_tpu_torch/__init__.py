"""PyTorch / CUDA port of svnet_tpu for NVIDIA Hopper (sm_90a).

The JAX package ``svnet_tpu`` is the reference this package is held
against. The layout mirrors it module for module:

  config.py              mode + eps constants, device/precision helpers
  ops/knn.py             exact kNN (sortable-int key, min-row tie-break)
  ops/graph.py           edge features (with the cross product), svpool, svcat
  ops/rotations.py       random rotations and the rotation augmentation
  nn/sv_layers.py        eval-mode SV layer library (nn.Modules, SV_STNkd),
                         ste_sign
  nn/sv_train.py         train-mode SV layers on the flax weight trees
  models/sv_dgcnn.py     SV-DGCNN classifier, eager (the un-fused oracle)
  models/sv_pointnet.py  SV-PointNet classifier and part segmenter, eager
  nn/scope.py            a model as one function of its flax-named weight
                         tree (init, eval, train), ScopedModel
  nn/vn_layers.py        Vector-Neuron layers on a Scope
  models/vn_pointnet.py, vn_dgcnn.py, pointnet.py, dgcnn.py
                         the VN and original families (cls and partseg),
                         get_model (models/__init__.py)
  ops/sampling.py        farthest-point sampling, ball query, grouping
  utils/convert.py       flax variables and reference .pth checkpoints ->
                         this package's weight tree
  utils/synth.py         seeded deformed-sphere clouds
  ops/kernels/fold.py    host-side weight folding for the fused kernels
  ops/kernels/_build.py  nvcc build + ctypes binding of csrc/*.cu
  ops/kernels/sv_round3.py, sv_point.py, sv_block_point.py
                         serving kernels + plain versions
  ops/kernels/knn.py, sv_first_train.py, sv_round3_train.py,
  edge_gather.py         training kernels + plain versions, autograd
  ops/kernels/library.py the serving kernels as svnet:: custom ops
  infer.py               the SV-DGCNN and SV-PointNet engines (cls and
                         partseg, every trunk and mode)
  serve.py               export_engine / load_engine (torch.export)
  utils/analysis.py      Params / MACs / ADDs / BOPs from the aten graph
  train/                 train forwards (fused.py: SV-DGCNN on B5/B6;
                         dgcnn.py, pointnet.py: the flax-equivalent
                         SV-DGCNN and SV-PointNet paths), steps,
                         optimizer, loop
  data/, cli/            ModelNet40, ScanObjectNN, ModelNet40_v2, ShapeNetPart
                         / in-memory datasets, Loader, the
                         CLIs, profile_train_step, certify_serving

This package imports torch and never jax.
"""

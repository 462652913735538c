"""PyTorch / CUDA port of svnet_tpu for NVIDIA Hopper (sm_90a).

The JAX package ``svnet_tpu`` is the reference this package is held
against. The layout mirrors it module for module:

  config.py              mode + eps constants, device/precision helpers
  ops/knn.py             exact kNN (sortable-int key, min-row tie-break)
  ops/graph.py           edge features, svpool, svcat
  ops/rotations.py       random rotations and the rotation augmentation
  nn/sv_layers.py        eval-mode SV layer library (nn.Modules), ste_sign
  models/sv_dgcnn.py     SV-DGCNN classifier, eager (the un-fused oracle)
  utils/convert.py       flax variables <-> this package's weight tree
  utils/synth.py         seeded deformed-sphere clouds
  ops/kernels/fold.py    host-side weight folding for the fused kernels
  ops/kernels/_build.py  nvcc build + ctypes binding of csrc/*.cu
  ops/kernels/sv_round3.py, sv_point.py   serving kernels + plain versions
  ops/kernels/knn.py, sv_first_train.py, sv_round3_train.py
                         training kernels + plain versions, autograd
  infer.py               SVDGCNNClsEngine (round3 path, exact mode)
  train/                 fused train forward, steps, optimizer, loop
  data/, cli/            ModelNet40 / in-memory datasets, Loader, the CLI

This package imports torch and never jax.
"""

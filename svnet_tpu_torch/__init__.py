"""PyTorch / CUDA port of svnet_tpu for NVIDIA Hopper (sm_90a).

The JAX package ``svnet_tpu`` is the reference this package is held
against. The layout mirrors it module for module:

  config.py              mode + eps constants, CUDA/precision helpers
  ops/knn.py             exact kNN (sortable-int key, min-row tie-break)
  ops/graph.py           edge features, svpool, svcat
  ops/rotations.py       random SO(3) rotations for invariance checks
  nn/sv_layers.py        eval-mode SV layer library (nn.Modules)
  models/sv_dgcnn.py     SV-DGCNN classifier, eager (the un-fused oracle)
  utils/convert.py       flax variables -> this package's weight tree
  ops/kernels/fold.py    host-side weight folding for the fused kernels
  ops/kernels/_build.py  nvcc build + ctypes binding of csrc/*.cu
  ops/kernels/sv_round3.py, sv_point.py   kernel wrappers + plain versions
  infer.py               SVDGCNNClsEngine (round3 path, exact mode)

This package imports torch and never jax.
"""

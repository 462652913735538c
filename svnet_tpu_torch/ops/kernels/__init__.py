"""Hand-written Hopper kernels (csrc/*.cu) behind PyTorch wrappers, each
with its plain PyTorch version, and the host-side weight folding."""

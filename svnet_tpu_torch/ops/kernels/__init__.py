"""Hand-written Hopper kernels (csrc/*.cu) behind PyTorch wrappers, each
with its plain PyTorch version, the host-side weight folding, and the
serving wrappers as ``svnet::`` custom ops (library.py)."""

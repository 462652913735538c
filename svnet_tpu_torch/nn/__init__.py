from svnet_tpu_torch.nn.sv_layers import (  # noqa: F401
    BatchNorm,
    Linear,
    SVBlock,
    SV_STNkd,
    SVFuse,
    Vector2Scalar,
    VectorBN,
    binary_matmul,
)

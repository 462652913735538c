from svnet_tpu_torch.data.datasets import (  # noqa: F401
    ArrayDataset,
    ModelNet40,
    PartArrayDataset,
    ShapeNetPart,
)
from svnet_tpu_torch.data.loader import Loader  # noqa: F401

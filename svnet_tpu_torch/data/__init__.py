from svnet_tpu_torch.data.datasets import (  # noqa: F401
    ArrayDataset,
    ModelNet40,
    ModelNet40_v2,
    PartArrayDataset,
    RoomArrayDataset,
    S3DIS,
    ScanArrayDataset,
    ScanObjectNNCls,
    ShapeNetPart,
)
from svnet_tpu_torch.data.loader import Loader  # noqa: F401

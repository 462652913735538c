from svnet_tpu_torch.data.datasets import ArrayDataset, ModelNet40  # noqa: F401
from svnet_tpu_torch.data.loader import Loader  # noqa: F401

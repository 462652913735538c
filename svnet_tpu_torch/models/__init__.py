from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls, init_params  # noqa: F401
from svnet_tpu_torch.models.sv_pointnet import (  # noqa: F401
    SVPointNetCls,
    SVPointNetEncoder,
    SVPointNetPseg,
)

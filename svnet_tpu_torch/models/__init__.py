from svnet_tpu_torch.models.sv_dgcnn import (  # noqa: F401
    SVDGCNNCls,
    SVDGCNNPseg,
    init_params,
    init_params_pseg,
)
from svnet_tpu_torch.models.sv_pointnet import (  # noqa: F401
    SVPointNetCls,
    SVPointNetEncoder,
    SVPointNetPseg,
)

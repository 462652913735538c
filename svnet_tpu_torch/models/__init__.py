"""The model zoo: SV / VN / original / BiPointNet x PointNet / DGCNN x
cls / partseg (BiPointNet: PointNet only, and its semantic segmenter),
and ``get_model``, keyed on the CLI's ``--model`` flag (counterpart of
svnet_tpu/models/__init__.py)."""

from svnet_tpu_torch.models.bipointnet import (  # noqa: F401
    BiPointNetCls,
    BiPointNetLSREMax,
    BiPointNetPartSegLSREMax,
    BiPointNetPseg,
    BiPointNetSemseg,
)
from svnet_tpu_torch.models.dgcnn import DGCNNCls, DGCNNPseg
from svnet_tpu_torch.models.pointnet import PointNetCls, PointNetPseg
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
from svnet_tpu_torch.models.vn_dgcnn import VNDGCNNCls, VNDGCNNPseg
from svnet_tpu_torch.models.vn_pointnet import VNPointNetCls, VNPointNetPseg

_REGISTRY = {
    "cls": {"svnet": {"pointnet": SVPointNetCls, "dgcnn": SVDGCNNCls},
            "vn": {"pointnet": VNPointNetCls, "dgcnn": VNDGCNNCls},
            "original": {"pointnet": PointNetCls, "dgcnn": DGCNNCls},
            "bipointnet": {"pointnet": BiPointNetCls}},
    "partseg": {"svnet": {"pointnet": SVPointNetPseg, "dgcnn": SVDGCNNPseg},
                "vn": {"pointnet": VNPointNetPseg, "dgcnn": VNDGCNNPseg},
                "original": {"pointnet": PointNetPseg, "dgcnn": DGCNNPseg},
                "bipointnet": {"pointnet": BiPointNetPseg}},
}


def get_model(task: str, backbone: str, model: str, **kwargs):
    """The eager eval model of (task 'cls' | 'partseg', backbone
    'pointnet' | 'dgcnn', model 'svnet' | 'vn' | 'original' |
    'bipointnet'), built with ``kwargs`` (num_classes or num_part, k,
    generator; binary for svnet, pooling for vn); a pair with no model
    (BiPointNet on DGCNN) raises ``ValueError``."""
    registry = _REGISTRY[task]
    try:
        cls = registry[model][backbone]
    except KeyError:
        raise ValueError(
            f"no model {model!r} for task={task!r} backbone={backbone!r}; "
            f"available: { {m: sorted(b) for m, b in registry.items()} }"
        ) from None
    return cls(**kwargs)

from svnet_tpu_torch.ops.graph import (  # noqa: F401
    gather_neighbors,
    get_graph_feature,
    get_graph_feature_cross,
    get_graph_feature_sv,
    scalar_graph_feature,
    svcat,
    svexpand,
    svpool,
    vn_graph_feature,
)
from svnet_tpu_torch.ops.knn import knn, knn_plain, pairwise_neg_sqdist  # noqa: F401
from svnet_tpu_torch.ops.rotations import (  # noqa: F401
    apply_rotation_aug,
    random_rotations,
    random_z_rotations,
    rotate_points,
)

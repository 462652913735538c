from svnet_tpu_torch.ops.graph import (  # noqa: F401
    gather_neighbors,
    get_graph_feature,
    get_graph_feature_sv,
    svcat,
    svpool,
)
from svnet_tpu_torch.ops.knn import knn, pairwise_neg_sqdist  # noqa: F401
from svnet_tpu_torch.ops.rotations import random_rotations, rotate_points  # noqa: F401

from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls, init_params  # noqa: F401

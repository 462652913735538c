from svnet_tpu_torch.utils.convert import from_flax, load_tree, module_tree  # noqa: F401

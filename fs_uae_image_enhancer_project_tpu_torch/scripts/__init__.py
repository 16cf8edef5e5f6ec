"""The port's counterparts of the JAX package's kernel benches under the
repo's ``scripts/``, run as ``python -m
fs_uae_image_enhancer_project_tpu_torch.scripts.<name>``."""

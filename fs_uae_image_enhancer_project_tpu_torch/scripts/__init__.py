"""The port's counterparts of the repo's root ``scripts/``: the kernel benches
and studies, and the drivers that make the corpus, bench the served path,
evaluate and build the artifacts. Each runs as ``python -m
fs_uae_image_enhancer_project_tpu_torch.scripts.<name>``."""

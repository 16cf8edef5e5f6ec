"""The benchmark of the PyTorch and CUDA port (``python3 port_bench/run.py``).

Everything it measures is the port, ``fs_uae_image_enhancer_project_tpu_torch``;
nothing here imports JAX or the JAX package. ``BENCHMARK.json`` at the repo's
root names the cells; each configuration, traffic mix and per-layer metric is
a file of its own here, found by its name.
"""

"""``chip_smoke.py``'s benchmark_tools phase rehearsed on the CPU at a small
size (moved out of ``test_torch_benchmark_tools.py`` so that another
worker runs it), with two torch threads."""
import torch

from fs_uae_image_enhancer_project_tpu_torch.benchmark_tools import (
    benchmark_activation_functions as acts)
from test_torch_train_phase import two_torch_threads  # noqa: F401  (autouse: 2 threads)


def test_chip_smoke_benchmark_tools_rehearsal():
    import chip_smoke as cs

    rec = cs.benchmark_tools_phase(torch.device("cpu"), duration_s=0.002, shape=(8, 12),
                                   act_shape=(1, 6, 8, 12))
    cs.check_benchmark_tools(rec)
    assert len(rec["activations"]["table"]) == len(acts.default_names())

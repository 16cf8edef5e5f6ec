"""fs_uae_image_enhancer_project_tpu_torch — the PyTorch/CUDA port.

The same framework as ``fs_uae_image_enhancer_project_tpu`` (the JAX
package, which stays the reference), written in PyTorch for one NVIDIA
H100. Each Pallas kernel of the JAX package becomes a CUDA C++ kernel for
``sm_90a`` under ``ops/cuda``. The layout mirrors the JAX package, so each
module sits where its counterpart does.

Slice 1 holds the deployed frame path: ops, the pix_shuffle model, ONNX
weight import, the uint8 enhance function and the unix-socket frame server.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
:func:`resolve_device` raises when a card is asked for (or implied) and
absent, so nothing carries on quietly on the CPU.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

FRAME_W = 752
FRAME_H = 576
# The deployed graph crops 16 px from the left edge so the model sees 736x576
# (width divisible by 32); the output is padded back with black.
CROP_LEFT = 16
MODEL_W = FRAME_W - CROP_LEFT  # 736
MODEL_H = FRAME_H              # 576


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when ``cuda`` is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev

"""Pixel-space loss primitives on NHWC tensors.

Port of ``fs_uae_image_enhancer_project_tpu/losses/functional.py``:
Charbonnier, the Laplacian high-frequency L1, the YCbCr luminance L1
(kornia's convention) and plain L1.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.conv import depthwise_conv2d

LAPLACIAN_KERNEL = np.array(
    [[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], np.float32
)


def clip(x: torch.Tensor, lo: float, hi=None) -> torch.Tensor:
    """``jnp.clip``: ``maximum(lo, x)``, then ``minimum(hi, x)``. Its
    derivative at a bound is one half (``torch.maximum``'s and JAX's tie
    rule), where ``torch.clamp`` passes all of it: a ReLU model's exact
    zeros sit on the lower bound."""
    x = torch.maximum(x, x.new_tensor(lo))
    return x if hi is None else torch.minimum(x, x.new_tensor(hi))


def l1_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean |o - t|, with JAX's derivative of |d| at d = 0 (+1, where
    ``torch.abs`` takes 0). Where output and target agree exactly (black on
    black after the Laplacian, ReLU-zero features) the gradient is then the
    JAX package's."""
    d = output - target
    return torch.mean(torch.where(d >= 0, d, -d))


def charbonnier_loss(output: torch.Tensor, target: torch.Tensor,
                     epsilon: float = 1e-6) -> torch.Tensor:
    """sqrt((o-t)^2 + eps^2), mean reduction."""
    if output.shape != target.shape:
        raise ValueError(
            f"Output and target must share a shape: {tuple(output.shape)} vs "
            f"{tuple(target.shape)}")
    return torch.mean(torch.sqrt((output - target) ** 2 + epsilon**2))


def laplacian_hf_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between the depthwise-Laplacian-filtered output and target."""
    k = torch.from_numpy(LAPLACIAN_KERNEL).to(output.device, output.dtype)
    return l1_loss(depthwise_conv2d(k, output), depthwise_conv2d(k, target))


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """kornia.color.rgb_to_ycbcr's convention on NHWC [0, 1] input."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) * 0.564 + 0.5
    cr = (r - y) * 0.713 + 0.5
    return torch.stack([y, cb, cr], dim=-1)


def luminance_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 over the Y channel only."""
    return l1_loss(rgb_to_ycbcr(output)[..., 0], rgb_to_ycbcr(target)[..., 0])

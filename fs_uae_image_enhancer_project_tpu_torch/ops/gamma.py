"""sRGB <-> linear transfer functions on tensors.

Port of ``fs_uae_image_enhancer_project_tpu/ops/gamma.py``: the exact
piecewise curves, the gamma-2.2 approximations and the cubic polynomial
approximations. All functions are dtype-preserving; compute in fp32 when
parity at >= 50 dB PSNR matters (bf16 pow loses about 3 decimal digits).
"""
from __future__ import annotations

import torch


def srgb_to_linear(t: torch.Tensor) -> torch.Tensor:
    """Exact piecewise sRGB EOTF. t in [0, 1]."""
    return torch.where(t <= 0.04045, t / 12.92, ((t + 0.055) / 1.055) ** 2.4)


def srgb_to_linear_approx(t: torch.Tensor) -> torch.Tensor:
    """Gamma-2.2 approximation."""
    return t ** 2.2


def srgb_to_linear_poly(t: torch.Tensor) -> torch.Tensor:
    """Cubic polynomial approximation."""
    return 0.012522878 * t**3 + 0.682171111 * t**2 + 0.305306011 * t


def linear_to_srgb(t: torch.Tensor) -> torch.Tensor:
    """Exact piecewise inverse sRGB EOTF. t in [0, 1]."""
    return torch.where(t <= 0.0031308, t * 12.92, 1.055 * (t ** (1.0 / 2.4)) - 0.055)


def linear_to_srgb_approx(t: torch.Tensor) -> torch.Tensor:
    """Gamma-1/2.2 approximation."""
    return t ** (1.0 / 2.2)


def linear_to_srgb_poly(t: torch.Tensor) -> torch.Tensor:
    """Cubic polynomial approximation."""
    return 0.585122381 * t**3 - 0.164759123 * t**2 + 0.579636742 * t

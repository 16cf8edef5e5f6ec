"""Pixel (un)shuffle on NHWC tensors with torch's channel order.

Port of ``fs_uae_image_enhancer_project_tpu/ops/pixel_shuffle.py``. The JAX
package keeps torch's ``(C, ry, rx)`` channel order on NHWC, so here each
function is a permute around ``F.pixel_unshuffle`` / ``F.pixel_shuffle``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_unshuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(N, H*r, W*r, C) -> (N, H, W, C*r*r); output channel ``c*r*r + ry*r + rx``
    holds input ``[..., h*r+ry, w*r+rx, c]``, as torch.nn.PixelUnshuffle."""
    _, hr, wr, _ = x.shape
    if hr % factor or wr % factor:
        raise ValueError(f"spatial dims {(hr, wr)} not divisible by factor {factor}")
    y = F.pixel_unshuffle(x.permute(0, 3, 1, 2), factor)
    return y.permute(0, 2, 3, 1).contiguous()


def pixel_shuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(N, H, W, C*r*r) -> (N, H*r, W*r, C). Inverse of :func:`pixel_unshuffle`."""
    if x.shape[-1] % (factor * factor):
        raise ValueError(
            f"channels {x.shape[-1]} not divisible by factor^2 {factor * factor}"
        )
    y = F.pixel_shuffle(x.permute(0, 3, 1, 2), factor)
    return y.permute(0, 2, 3, 1).contiguous()

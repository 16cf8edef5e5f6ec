"""The combined perceptual criterion.

Port of ``fs_uae_image_enhancer_project_tpu/losses/perceptual.py``:

    total = pixel_w * pixel(o, t)
          + vgg_w   * sum_l w_l * L1(VGG_l(norm(srgb(o))), VGG_l(norm(srgb(t))))
          + hf_w    * L1(laplacian(o), laplacian(t))
          + lum_w   * L1(Y(o'), Y(t'))

with the reference's quirks: when ``input_is_linear`` the output is clamped
to [0, 1] after linear->sRGB for the VGG branch while the target is not
clamped at all; VGG normalization uses std = 1/255; the luminance branch
takes the VGG-normalized tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ops.conv import no_tf32
from ..ops.gamma import linear_to_srgb_approx
from . import vgg as vgg_mod
from .functional import charbonnier_loss, clip, l1_loss, laplacian_hf_loss, luminance_loss
from .ssim import ssim_loss


@dataclass(frozen=True)
class PerceptualConfig:
    pixel_loss_weight: float = 1.0
    vgg_weight: float = 0.006
    pixel_loss_type: str = "l1"  # 'l1' | 'charbonnier'
    charbonnier_epsilon: float = 1e-6
    high_frequency_weight: float = 0.0
    lambda_lum: float = 0.0
    input_is_linear: bool = False


def make_perceptual_loss(cfg: PerceptualConfig, vgg_params=None, *,
                         device=None) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build ``criterion(output, target) -> scalar`` over NHWC float inputs.

    ``vgg_params`` defaults to :func:`losses.vgg.init_vgg16` on ``device``
    (default ``cuda``) when ``cfg.vgg_weight > 0``. The criterion's
    convolutions run with TF32 off; the target's VGG features are computed
    without a graph, since no gradient flows into the target.
    """
    if cfg.pixel_loss_type not in ("l1", "charbonnier"):
        raise ValueError(f"Invalid pixel_loss_type: {cfg.pixel_loss_type}")
    prepared = None
    if cfg.vgg_weight > 0:
        if vgg_params is None:
            vgg_params = vgg_mod.init_vgg16(device)
        prepared = vgg_mod.prepare(vgg_params)

    def criterion(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            if cfg.input_is_linear:
                # the eps clamp on the OUTPUT only: d/dx x**(1/2.2) is infinite at
                # 0, and ReLU outputs are exactly 0 on black. The target gets no
                # clamp (no gradient flows through it, pow(0) is exactly 0, and a
                # clamp would move true black by (1e-6)**(1/2.2) * 255 ~ 0.48)
                eps = 1e-6
                out_srgb = vgg_mod.normalize(
                    clip(linear_to_srgb_approx(clip(output, eps)), 0.0, 1.0))
                tgt_srgb = vgg_mod.normalize(linear_to_srgb_approx(target))
            else:
                out_srgb = vgg_mod.normalize(clip(output, 0.0, 1.0))
                tgt_srgb = vgg_mod.normalize(target)

            if cfg.pixel_loss_type == "l1":
                pixel = l1_loss(output, target)
            else:
                pixel = charbonnier_loss(output, target, cfg.charbonnier_epsilon)

            total = cfg.pixel_loss_weight * pixel
            if prepared is not None:
                fo = vgg_mod.features_nchw(prepared, out_srgb.permute(0, 3, 1, 2))
                with torch.no_grad():
                    ft = vgg_mod.features_nchw(prepared, tgt_srgb.permute(0, 3, 1, 2))
                vgg_loss = sum(w * l1_loss(a, b) for w, a, b in zip(vgg_mod.TAP_WEIGHTS, fo, ft))
                total = total + cfg.vgg_weight * vgg_loss
            if cfg.high_frequency_weight > 0:
                total = total + cfg.high_frequency_weight * laplacian_hf_loss(output, target)
            if cfg.lambda_lum > 0:
                total = total + cfg.lambda_lum * luminance_loss(out_srgb, tgt_srgb)
            return total

    return criterion


def build_criterion(loss_spec, vgg_params=None, *, device=None):
    """Resolve a ``models.LossSpec`` into a criterion function."""
    if loss_spec.kind == "perceptual":
        cfg = PerceptualConfig(
            pixel_loss_weight=loss_spec.pixel_loss_weight,
            vgg_weight=loss_spec.vgg_weight,
            pixel_loss_type=loss_spec.pixel_loss_type,
            high_frequency_weight=loss_spec.high_frequency_weight,
            lambda_lum=loss_spec.lambda_lum,
            input_is_linear=loss_spec.input_is_linear,
        )
        return make_perceptual_loss(cfg, vgg_params, device=device)
    if loss_spec.kind == "ssim":
        def criterion(output, target):
            with no_tf32():
                return ssim_loss(
                    output, target,
                    pixel_loss_type=loss_spec.pixel_loss_type,
                    pixel_loss_weight=loss_spec.pixel_loss_weight,
                    ssim_weight=loss_spec.ssim_weight,
                )
        return criterion
    raise ValueError(f"Unknown loss kind: {loss_spec.kind}")

"""The training losses (port of ``fs_uae_image_enhancer_project_tpu/losses``).

``losses/vgg_selftrain.py`` (the VGG feature self-training) is not ported
yet: its calibration target is the RMS of the JAX package's random VGG,
which torch cannot draw.
"""
from . import functional, perceptual, ssim, vgg  # noqa: F401
from .functional import (  # noqa: F401
    charbonnier_loss,
    l1_loss,
    laplacian_hf_loss,
    luminance_loss,
    rgb_to_ycbcr,
)
from .perceptual import PerceptualConfig, build_criterion, make_perceptual_loss  # noqa: F401
from .ssim import ms_ssim, ssim, ssim_loss  # noqa: F401

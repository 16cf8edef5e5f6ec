"""The training losses (port of ``fs_uae_image_enhancer_project_tpu/losses``):
the pixel and frequency terms, SSIM, the VGG16 features with the JAX
package's fixed-seed random basis (``vgg``), the combined perceptual
criterion, and the VGG feature self-training (``vgg_selftrain``).
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

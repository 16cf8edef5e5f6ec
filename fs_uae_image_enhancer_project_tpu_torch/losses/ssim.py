"""SSIM, MS-SSIM and the reconstructed ``SSIMLoss`` criterion (conv5's).

Port of ``fs_uae_image_enhancer_project_tpu/losses/ssim.py``: single-scale
SSIM (Wang et al. 2004; 11x11 Gaussian window, sigma 1.5, K1 0.01, K2 0.03,
data range 1) over VALID windows, and loss = pixel_w * pixel +
ssim_w * (1 - SSIM).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.gamma import srgb_to_linear_approx
from .functional import charbonnier_loss, clip, l1_loss


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    half = (size - 1) / 2.0
    coords = np.arange(size) - half
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _ssim_and_cs(a, b, *, data_range=1.0, window_size=11, sigma=1.5, k1=0.01, k2=0.03):
    """Mean SSIM and mean contrast-structure term over NHWC batches (VALID
    Gaussian windows, as pytorch_msssim's ``_ssim``)."""
    c = a.shape[-1]
    kern = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(a.device, a.dtype)
    w = kern.reshape(1, 1, window_size, window_size).expand(c, 1, window_size, window_size)

    def filt(x):  # NCHW in, NCHW out
        return F.conv2d(x, w, groups=c)

    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = filt(a * a) - mu_aa
    sigma_bb = filt(b * b) - mu_bb
    sigma_ab = filt(a * b) - mu_ab
    cs_map = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    ssim_map = cs_map * (2 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    return ssim_map.mean(), cs_map.mean()


def ssim(a, b, *, data_range=1.0, window_size=11, sigma=1.5, k1=0.01, k2=0.03):
    """Mean SSIM over NHWC batches (VALID windows)."""
    s, _ = _ssim_and_cs(a, b, data_range=data_range, window_size=window_size, sigma=sigma,
                        k1=k1, k2=k2)
    return s


# Wang et al. 2003 per-scale exponents (pytorch_msssim's)
MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _pool2(x):
    """2x2 average pool that floors (drops a trailing odd row or column)."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, :2 * h2, :2 * w2].reshape(n, h2, 2, w2, 2, c).mean(dim=(2, 4))


def ms_ssim(a, b, *, data_range=1.0, window_size=11, sigma=1.5, k1=0.01, k2=0.03,
            weights=MS_SSIM_WEIGHTS):
    """Multi-scale SSIM over NHWC batches (Wang et al. 2003), as the JAX
    package computes it.

    At each of the first len(weights)-1 scales take the contrast-structure
    term, then 2x2-average-pool (flooring, where pytorch_msssim zero-pads odd
    sides); at the last scale take full SSIM; the result is
    prod(relu(term_i) ** weight_i). Each term is already the mean over the
    batch, so the batch is averaged *before* the product across scales (not
    per image and then averaged, as pytorch_msssim does with
    ``size_average``): the JAX package's order, kept here.

    min(H, W) must be at least window_size * 2 ** (len(weights) - 1) (176 for
    the defaults), so that the last scale still fits a VALID window under
    floor pooling; below it this raises ``ValueError``.
    """
    min_side = min(a.shape[1], a.shape[2])
    need = window_size * 2 ** (len(weights) - 1)
    if min_side < need:
        raise ValueError(
            f"ms_ssim needs min(H,W) >= {need} for window_size={window_size} and "
            f"{len(weights)} scales with floor pooling; got {min_side}")
    terms = []
    for i in range(len(weights)):
        s, cs = _ssim_and_cs(a, b, data_range=data_range, window_size=window_size,
                             sigma=sigma, k1=k1, k2=k2)
        terms.append(s if i == len(weights) - 1 else cs)
        if i < len(weights) - 1:
            a, b = _pool2(a), _pool2(b)
    out = torch.ones((), dtype=a.dtype, device=a.device)
    for wgt, t in zip(weights, terms):
        out = out * clip(t, 0.0) ** wgt
    return out


def ssim_loss(output, target, *, pixel_loss_type="l1", pixel_loss_weight=0.99,
              ssim_weight=0.01, convert_to_linear_for_ssim=False, charbonnier_epsilon=1e-6):
    """The reconstructed SSIMLoss criterion."""
    pl = pixel_loss_type.lower()
    if pl == "l1":
        pixel = l1_loss(output, target)
    elif pl == "charbonnier":
        pixel = charbonnier_loss(output, target, charbonnier_epsilon)
    else:
        raise ValueError(f"Invalid pixel_loss_type: {pixel_loss_type}")
    a, b = output, target
    if convert_to_linear_for_ssim:
        a = srgb_to_linear_approx(clip(a, 0.0, 1.0))
        b = srgb_to_linear_approx(clip(b, 0.0, 1.0))
    return pixel_loss_weight * pixel + ssim_weight * (1.0 - ssim(a, b))

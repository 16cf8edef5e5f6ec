"""VGG16 feature extractor for the perceptual loss (NHWC at the interface).

Port of ``fs_uae_image_enhancer_project_tpu/losses/vgg.py``: torchvision's
``vgg16().features[0..26]``, the slice the reference's PerceptualLoss taps.
The tap indices {3, 8, 17, 26} are reproduced as indices (17 and 26 fall on
conv4_1 and conv5_2 before their relu in torchvision's layout), not by their
relu labels.

Weights load in the JAX package's order of preference: the
torchvision-converted asset ``assets/vgg16_features.npz``, then the committed
self-trained ``assets/vgg16_features_selftrained.npz``. With neither present
:func:`init_vgg16` raises: the JAX package's third choice, a He-normal VGG
drawn from ``jax.random``, cannot be drawn in torch, and different random
features would be a different loss.

The convolutions run in fp32 with TF32 off (the JAX package's
``Precision.HIGHEST``); max-pool is 2x2 VALID.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.conv import no_tf32

# torchvision vgg16 features[0..26] (cfg D): (index, op, out_channels)
VGG16_LAYOUT: Tuple[Tuple[int, str, int], ...] = (
    (0, "conv", 64), (1, "relu", 0), (2, "conv", 64), (3, "relu", 0),
    (4, "pool", 0),
    (5, "conv", 128), (6, "relu", 0), (7, "conv", 128), (8, "relu", 0),
    (9, "pool", 0),
    (10, "conv", 256), (11, "relu", 0), (12, "conv", 256), (13, "relu", 0),
    (14, "conv", 256), (15, "relu", 0),
    (16, "pool", 0),
    (17, "conv", 512), (18, "relu", 0), (19, "conv", 512), (20, "relu", 0),
    (21, "conv", 512), (22, "relu", 0),
    (23, "pool", 0),
    (24, "conv", 512), (25, "relu", 0), (26, "conv", 512),
)

# the reference's tap indices and their loss weights
TAP_INDICES = (3, 8, 17, 26)
TAP_WEIGHTS = (1.0 / 2.6, 1.0 / 4.8, 1.0 / 3.7, 1.0 / 5.6)

# VGG input normalization: std = 1/255 per channel
VGG_MEAN = (0.48235, 0.45882, 0.40784)
VGG_STD = 1.0 / 255.0

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "..", "assets"
)
_ASSET = os.path.join(_ASSET_DIR, "vgg16_features.npz")
_ASSET_SELFTRAINED = os.path.join(_ASSET_DIR, "vgg16_features_selftrained.npz")

Params = List[Dict[str, torch.Tensor]]


def conv_indices() -> List[int]:
    return [i for i, kind, _ in VGG16_LAYOUT if kind == "conv"]


def _load_asset(path: str, device=None) -> Params:
    """An npz asset (``features.{i}.weight`` HWIO, ``.bias``) -> a list of
    ``{"w": HWIO, "b"}`` fp32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        return [{"w": torch.from_numpy(np.asarray(data[f"features.{i}.weight"], np.float32))
                 .to(dev),
                 "b": torch.from_numpy(np.asarray(data[f"features.{i}.bias"], np.float32))
                 .to(dev)}
                for i in conv_indices()]


def init_vgg16(device=None) -> Params:
    """The feature weights: the pretrained asset if present, else the
    self-trained one; raises ``FileNotFoundError`` with neither."""
    for path in (os.path.abspath(_ASSET), os.path.abspath(_ASSET_SELFTRAINED)):
        if os.path.exists(path):
            return _load_asset(path, device)
    raise FileNotFoundError(
        f"no vgg16 asset at {os.path.abspath(_ASSET)} (pretrained) or "
        f"{os.path.abspath(_ASSET_SELFTRAINED)} (self-trained). The port draws no "
        "random VGG (the JAX package's random features come from jax.random, "
        "which torch cannot reproduce): convert torchvision weights with "
        "convert_torchvision_state_dict, or train with vgg_weight=0.")


def convert_torchvision_state_dict(state: Dict[str, np.ndarray], out_path: str) -> None:
    """One-time converter: torchvision vgg16 state_dict (numpy arrays keyed
    ``features.{i}.weight`` OIHW and ``.bias``) -> the HWIO npz asset."""
    out = {}
    for i in conv_indices():
        w = np.asarray(state[f"features.{i}.weight"], np.float32)
        out[f"features.{i}.weight"] = np.transpose(w, (2, 3, 1, 0))  # -> HWIO
        out[f"features.{i}.bias"] = np.asarray(state[f"features.{i}.bias"], np.float32)
    out_path = os.path.abspath(out_path)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, **out)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (1/255) over NHWC sRGB input in [0, 1]."""
    mean = torch.tensor(VGG_MEAN, dtype=x.dtype, device=x.device)
    return (x - mean) / VGG_STD


def prepare(params: Params) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The weights as cuDNN takes them: ``(OIHW, bias)`` a conv, laid out
    once for every call of :func:`features_nchw`."""
    return [(p["w"].permute(3, 2, 0, 1).contiguous(), p["b"]) for p in params]


def features_nchw(prepared, x: torch.Tensor, taps: Tuple[int, ...] = TAP_INDICES):
    """features[0..max(taps)] on an NCHW input, in fp32 with TF32 off; the
    activations at ``taps``, NCHW."""
    out = []
    conv_i = 0
    max_tap = max(taps)
    with no_tf32():
        for i, kind, _ in VGG16_LAYOUT:
            if kind == "conv":
                w, b = prepared[conv_i]
                conv_i += 1
                x = F.conv2d(x, w.to(x.dtype), b.to(x.dtype), padding=1)
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x, 2, 2)
            if i in taps:
                out.append(x)
            if i >= max_tap:
                break
    return out


def extract_features(params: Params, x: torch.Tensor,
                     taps: Tuple[int, ...] = TAP_INDICES) -> List[torch.Tensor]:
    """Run features[0..max(taps)] on NHWC ``x`` (already VGG-normalized);
    the activations at ``taps``, NHWC."""
    feats = features_nchw(prepare(params), x.permute(0, 3, 1, 2), taps)
    return [f.permute(0, 2, 3, 1) for f in feats]

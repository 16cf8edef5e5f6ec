"""VGG16 feature extractor for the perceptual loss (NHWC at the interface).

Port of ``fs_uae_image_enhancer_project_tpu/losses/vgg.py``: torchvision's
``vgg16().features[0..26]``, the slice the reference's PerceptualLoss taps.
The tap indices {3, 8, 17, 26} are reproduced as indices (17 and 26 fall on
conv4_1 and conv5_2 before their relu in torchvision's layout), not by their
relu labels.

Weights load in the JAX package's order of preference: the
torchvision-converted asset ``assets/vgg16_features.npz``, then the committed
self-trained ``assets/vgg16_features_selftrained.npz``, then, with a warning,
the JAX package's fixed-seed He-normal basis (:func:`_random_init`), drawn
here with ``utils.threefry``'s copy of ``jax.random``: the same numbers as
JAX's within 4 ulp, so the same loss. The committed trained rows were
trained under that basis, and the drivers that reproduce them pin it.

The convolutions run in fp32 with TF32 off (the JAX package's
``Precision.HIGHEST``); max-pool is 2x2 VALID.
"""
from __future__ import annotations

import functools
import math
import os
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.conv import no_tf32
from ..utils import threefry

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


def init_vgg16(device=None, key=None) -> Params:
    """Load feature weights by preference order: torchvision-converted
    pretrained asset > in-domain self-trained asset (losses/vgg_selftrain.py)
    > fixed-seed He init (:func:`_random_init` under ``key``, with a loud
    warning), on ``device`` (default ``cuda``)."""
    path = os.path.abspath(_ASSET)
    if os.path.exists(path):
        return _load_asset(path, device)
    self_path = os.path.abspath(_ASSET_SELFTRAINED)
    if os.path.exists(self_path):
        return _load_asset(self_path, device)
    warnings.warn(
        f"no vgg16 asset at {path} (pretrained) or {self_path} "
        "(self-trained): the perceptual loss is using FIXED-SEED RANDOM VGG "
        "features (random-projection loss), not pretrained VGG16. Loss "
        "values are not comparable to the reference's CSVs. See "
        "assets/README.md for the one-time torchvision conversion, or run "
        "scripts/train_vgg_features.py to self-train in-domain features.",
        stacklevel=2,
    )
    return _random_init(key, device=device)


@functools.lru_cache(maxsize=2)
def _random_basis(key_words: Tuple[int, int]) -> Tuple[np.ndarray, ...]:
    """The He-normal weights of :func:`_random_init` under a key, as host
    arrays (drawing the 14.7 M weights takes seconds on a CPU: the process
    keeps the last two keys' draws)."""
    weights = []
    key, cin = key_words, 3
    for _i, kind, cout in VGG16_LAYOUT:
        if kind != "conv":
            continue
        key, wk = threefry.split(key)
        std = math.sqrt(2.0 / (cin * 9))
        w = threefry.normal(wk, (3, 3, cin, cout)) * np.float32(std)
        w.setflags(write=False)
        weights.append(w)
        cin = cout
    return tuple(weights)


def _random_init(key=None, device=None) -> Params:
    """The JAX package's fixed-seed He-normal fallback (a structured
    random-projection perceptual metric, quantified in
    artifacts/training_parity): ``jax.random.key(1234)`` by default, each
    conv's weights ``normal(split(key)[1]) * sqrt(2 / fan_in)``, zero biases.
    ``key`` is a ``utils.threefry`` key. Fresh tensors on ``device``
    (default ``cuda``) on every call: a caller may train them."""
    dev = resolve_device(device)
    words = threefry.key(1234) if key is None else tuple(int(w) for w in key)
    return [{"w": torch.tensor(w, device=dev),
             "b": torch.zeros(w.shape[-1], dtype=torch.float32, device=dev)}
            for w in _random_basis(words)]


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

"""Structured model and activation configuration.

The port's own copy of the pix_shuffle part of
``fs_uae_image_enhancer_project_tpu/models/configs.py``: frozen, hashable
dataclasses that name a model's channel plan and activation slots.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

# An activation slot: (name, frozen config items).
ActSpec = Tuple[str, Tuple[Tuple[str, Any], ...]]


def act(name: str = "identity", **config: Any) -> ActSpec:
    """Build an activation spec, e.g. ``act('biased_prelu', num_parameters=36)``."""
    return (name, tuple(sorted(config.items())))


def act_config(spec: ActSpec) -> Dict[str, Any]:
    return dict(spec[1])



@dataclass(frozen=True)
class ConvLayerSpec:
    """One conv layer: output channels, odd kernel, up to 4 activation slots."""

    out_channels: int
    kernel_size: int = 3
    acts: Tuple[ActSpec, ...] = ()

    def __post_init__(self):
        if self.kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd for symmetric padding")


@dataclass(frozen=True)
class PixShuffleConfig:
    """Config for the production pix_shuffle model.

    7 conv layers between PixelUnshuffle(2)/PixelShuffle(2); residual adds
    after layers 2 and 4 (with a 1x1 projection when channels differ); long
    skip from layer 1 concatenated into layer 6; global identity residual +
    ReLU.
    """

    layers: Tuple[ConvLayerSpec, ...] = ()
    in_channels: int = 3
    shuffle_factor: int = 2

    def __post_init__(self):
        if len(self.layers) != 7:
            raise ValueError("pix_shuffle needs exactly 7 conv layer specs")

    @property
    def unshuffled_channels(self) -> int:
        return self.in_channels * self.shuffle_factor**2

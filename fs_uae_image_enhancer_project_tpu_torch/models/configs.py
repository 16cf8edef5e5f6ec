"""Structured model and activation configuration.

The port's own copy of ``fs_uae_image_enhancer_project_tpu/models/configs.py``:
frozen, hashable dataclasses that name a model's channel plan and activation
slots, and their canonical JSON (:func:`config_to_json`,
:func:`config_from_json`).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Tuple

# An activation slot: (name, frozen config items).
ActSpec = Tuple[str, Tuple[Tuple[str, Any], ...]]


def act(name: str = "identity", **config: Any) -> ActSpec:
    """Build an activation spec, e.g. ``act('biased_prelu', num_parameters=36)``."""
    return (name, tuple(sorted(config.items())))


def act_config(spec: ActSpec) -> Dict[str, Any]:
    return dict(spec[1])


IDENTITY = act("identity")


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


@dataclass(frozen=True)
class ConvStackConfig:
    """Config for the conv3/conv5 family: Conv-BN-(act) stacks.

    conv3: 3 layers, ReLU, no skips. conv5: 5 layers, ReLU, residual adds at
    layers 2 and 4, Sigmoid output.
    """

    channels: Tuple[int, ...]  # per-layer output channels incl. the final 3
    kernel_size: int = 3
    residual_layers: Tuple[int, ...] = ()  # 0-based indices with identity add
    final_act: str = "none"  # 'none' | 'sigmoid'
    uint8_rgba_contract: bool = False  # conv3's deployment forward contract

    def __post_init__(self):
        if self.kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd for symmetric padding")


@dataclass(frozen=True)
class Conv6Config:
    """Config for conv6: the pix_shuffle topology at full resolution, without
    the pixel-(un)shuffle pair. 7 convs with residual adds at layers 2 and 4,
    a long-skip concat into layer 6, a global identity residual + ReLU;
    default 36 channels, the last layer 3."""

    layers: Tuple[ConvLayerSpec, ...] = ()
    in_channels: int = 3

    def __post_init__(self):
        if len(self.layers) != 7:
            raise ValueError("conv6 needs exactly 7 conv layer specs")


@dataclass(frozen=True)
class ResidualUNetConfig:
    """Config for the residual U-Net."""

    input_channels: int = 3
    output_channels: int = 3
    base_channels: int = 36
    unet_depth: int = 2
    blocks_per_level: int = 2
    acts: Tuple[ActSpec, ActSpec, ActSpec, ActSpec] = (
        IDENTITY,
        act("relu"),
        act("relu"),
        IDENTITY,
    )
    internal_block_channels_ratio: float = 1.0


# ---------------------------------------------------------------------------
# serialization (NAS cache keys, CLI round trips)
# ---------------------------------------------------------------------------

def config_to_json(cfg: Any) -> str:
    """Canonical JSON of any config dataclass (sorted keys, the class name
    under ``__type__``), the same text as the JAX package's."""

    def enc(o):
        if dataclasses.is_dataclass(o):
            return {"__type__": type(o).__name__, **dataclasses.asdict(o)}
        raise TypeError(o)

    return json.dumps(cfg, default=enc, sort_keys=True)


_CONFIG_TYPES = {cls.__name__: cls for cls in (
    ConvLayerSpec, PixShuffleConfig, ConvStackConfig, Conv6Config, ResidualUNetConfig)}


def _tupleize(v):
    if isinstance(v, list):
        return tuple(_tupleize(x) for x in v)
    return v


def _layer_spec(x) -> ConvLayerSpec:
    if isinstance(x, ConvLayerSpec):
        return x
    if isinstance(x, dict):
        return ConvLayerSpec(out_channels=x["out_channels"], kernel_size=x["kernel_size"],
                             acts=_tupleize(x["acts"]))
    return ConvLayerSpec(out_channels=x[0], kernel_size=x[1], acts=_tupleize(x[2]))


def config_from_json(s: str) -> Any:
    """The inverse of :func:`config_to_json`."""

    def dec(d: Dict[str, Any]) -> Any:
        cls = _CONFIG_TYPES[d.pop("__type__")]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = _tupleize(d[f.name])
            if f.name == "layers":
                v = tuple(_layer_spec(x) for x in v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def walk(o):
        if isinstance(o, dict):
            o = {k: walk(v) for k, v in o.items()}
            return dec(o) if "__type__" in o else o
        if isinstance(o, list):
            return [walk(x) for x in o]
        return o

    return walk(json.loads(s))

"""Model registry.

``get_model(name, variant)`` returns a :class:`ModelDef`, the counterpart of
the JAX package's registry: a frozen config, ``init(generator=None,
device=None) -> params``, ``apply(params, x) -> y`` (NHWC float, linear light
where ``linear_io``) and the model's training criterion spec (resolved by
``losses.build_criterion``), for every family of the JAX package:
pix_shuffle, conv3, conv5, conv6 (lightweight only) and residual_unet.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, NamedTuple

from . import blocks, conv6, conv_stack, pix_shuffle, residual_unet  # noqa: F401
from .configs import (  # noqa: F401
    ActSpec,
    Conv6Config,
    ConvLayerSpec,
    ConvStackConfig,
    PixShuffleConfig,
    ResidualUNetConfig,
    act,
    config_from_json,
    config_to_json,
)

MODEL_NAMES = ("pix_shuffle", "conv3", "conv5", "conv6", "residual_unet")


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """Which criterion a model trains with (resolved in ``losses``)."""

    kind: str  # 'perceptual' | 'ssim'
    pixel_loss_weight: float = 1.0
    vgg_weight: float = 0.0
    pixel_loss_type: str = "l1"  # 'l1' | 'charbonnier'
    high_frequency_weight: float = 0.0
    lambda_lum: float = 0.0
    input_is_linear: bool = False
    ssim_weight: float = 0.0


class ModelDef(NamedTuple):
    name: str
    variant: str
    config: Any
    # init(generator=None, device=None) -> params
    init: Callable[..., Dict]
    apply: Callable[[Dict, Any], Any]
    loss: LossSpec
    # True if apply() expects/returns linear-light RGB (pix_shuffle family);
    # False for the sRGB-domain models (conv3/conv5)
    linear_io: bool


# the reference's loss per model
_PIX_SHUFFLE_LOSS = LossSpec(
    kind="perceptual", pixel_loss_weight=0.990, vgg_weight=0.007,
    pixel_loss_type="charbonnier", high_frequency_weight=0.003,
    input_is_linear=True,
)
_CONV3_LOSS = LossSpec(
    kind="perceptual", pixel_loss_weight=0.8, vgg_weight=0.2,
    pixel_loss_type="charbonnier",
)
_CONV5_LOSS = LossSpec(
    kind="ssim", pixel_loss_weight=0.99, ssim_weight=0.01, pixel_loss_type="l1",
)


def get_model(name: str, variant: str = "lightweight") -> ModelDef:
    """Build a ModelDef; accepts the ``'<name>_heavy'`` aliases."""
    if name.endswith("_heavy"):
        name, variant = name[: -len("_heavy")], "heavyweight"
    if variant not in ("lightweight", "heavyweight", "heavy"):
        raise ValueError(f"Unknown variant {variant!r} (lightweight|heavyweight)")
    if variant == "heavy":
        variant = "heavyweight"
    if name == "conv6" and variant == "heavyweight":
        raise ValueError("conv6 has no heavyweight variant")
    if name == "pix_shuffle":
        cfg = (pix_shuffle.lightweight_config() if variant == "lightweight"
               else pix_shuffle.heavyweight_config())
        return ModelDef(
            name, variant, cfg,
            partial(pix_shuffle.init, cfg),
            partial(pix_shuffle.apply, cfg=cfg),
            _PIX_SHUFFLE_LOSS, linear_io=True,
        )
    if name in ("conv3", "conv5"):
        cfg = (conv_stack.conv3_config if name == "conv3" else conv_stack.conv5_config)(variant)
        return ModelDef(
            name, variant, cfg,
            partial(conv_stack.init, cfg),
            partial(conv_stack.apply, cfg=cfg),
            _CONV3_LOSS if name == "conv3" else _CONV5_LOSS, linear_io=False,
        )
    if name == "conv6":
        cfg = conv6.default_config()
        return ModelDef(
            name, variant, cfg,
            partial(conv6.init, cfg),
            partial(conv6.apply, cfg=cfg),
            _PIX_SHUFFLE_LOSS, linear_io=True,
        )
    if name == "residual_unet":
        cfg = (residual_unet.lightweight_config() if variant == "lightweight"
               else residual_unet.heavyweight_config())
        return ModelDef(
            name, variant, cfg,
            partial(residual_unet.init, cfg),
            partial(residual_unet.apply, cfg=cfg),
            _PIX_SHUFFLE_LOSS, linear_io=True,
        )
    raise ValueError(f"Unknown model '{name}'. Known: {MODEL_NAMES}")


@dataclasses.dataclass(frozen=True)
class TrainApply:
    """``fn(params, x, **kw)``, the forward the train step differentiates,
    with the model it runs (the spatial split reads its receptive radius
    from ``model``; see :func:`train_apply`)."""

    model: ModelDef

    def __call__(self, params, x, **kw):
        if self.model.name == "pix_shuffle":
            return pix_shuffle.apply_eager(params, x, self.model.config, **kw)
        return self.model.apply(params, x, **kw)


def train_apply(model: ModelDef) -> TrainApply:
    """The forward the train step differentiates. For pix_shuffle that is
    ``pix_shuffle.apply_eager``, never ``apply``: ``apply`` sends a bf16
    CUDA tensor to the fused-stack kernel K1, whose output carries no
    gradient (K1 has no backward, as the Pallas kernel has none). The other
    families' ``apply`` is eager already."""
    return TrainApply(model)


def count_params(params) -> int:
    """Number of scalars in a nested parameter dict."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())

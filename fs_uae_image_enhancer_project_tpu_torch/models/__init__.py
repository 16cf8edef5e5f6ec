"""Model registry.

``get_model("pix_shuffle", variant)`` returns a :class:`ModelDef`, the
counterpart of the JAX package's registry. The other families (conv3, conv5,
conv6, residual_unet) are ported in a later slice.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, NamedTuple

from . import pix_shuffle
from .configs import ActSpec, ConvLayerSpec, PixShuffleConfig, act  # noqa: F401

MODEL_NAMES = ("pix_shuffle", "conv3", "conv5", "conv6", "residual_unet")


class ModelDef(NamedTuple):
    name: str
    variant: str
    config: Any
    # init(generator=None, device=None) -> params
    init: Callable[..., Dict]
    apply: Callable[[Dict, Any], Any]
    # True if apply() expects/returns linear-light RGB (pix_shuffle family)
    linear_io: bool


def get_model(name: str, variant: str = "lightweight") -> ModelDef:
    """Build a ModelDef; accepts the ``'<name>_heavy'`` aliases."""
    if name.endswith("_heavy"):
        name, variant = name[: -len("_heavy")], "heavyweight"
    if variant not in ("lightweight", "heavyweight", "heavy"):
        raise ValueError(f"Unknown variant {variant!r} (lightweight|heavyweight)")
    if variant == "heavy":
        variant = "heavyweight"
    if name == "pix_shuffle":
        cfg = (pix_shuffle.lightweight_config() if variant == "lightweight"
               else pix_shuffle.heavyweight_config())
        return ModelDef(
            name, variant, cfg,
            partial(pix_shuffle.init, cfg),
            partial(pix_shuffle.apply, cfg=cfg),
            linear_io=True,
        )
    if name in MODEL_NAMES:
        raise NotImplementedError(
            f"model family {name!r} is not ported yet (slice C of the port)"
        )
    raise ValueError(f"Unknown model '{name}'. Known: {MODEL_NAMES}")


def count_params(params) -> int:
    """Number of scalars in a nested parameter dict."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())

"""Operations and bytes of a configuration, from its layer shapes.

A layer is ``{"name", "cin", "cout", "k"}``: a ``k x k`` SAME convolution,
with an optional output ``height`` and ``width`` of its own. A layer without
them is at the configuration's ``resolution``, so a network whose layers sit
at several resolutions (a U-Net's levels) lists each layer's own. A
multiply-add counts as two operations; activations, adds, shuffles, concats
and the wrapper's elementwise work are not counted.
"""
from __future__ import annotations

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def pixels(config: dict, layer: dict) -> int:
    """The layer's output pixels: its own ``height`` x ``width``, or the
    configuration's ``resolution``."""
    res = config["resolution"]
    return layer.get("height", res["height"]) * layer.get("width", res["width"])


def flop_per_frame(config: dict) -> float:
    """The model's operations on one frame."""
    return 2.0 * sum(l["k"] * l["k"] * l["cin"] * l["cout"] * pixels(config, l)
                     for l in config["layers"])


def bytes_per_frame(config: dict) -> float:
    """The bytes the model's stack must move on one frame at the least: the
    first layer's input and the last layer's output once, each at that
    layer's pixels, in the compute dtype, and its weights."""
    layers = config["layers"]
    first, last = layers[0], layers[-1]
    size = DTYPE_BYTES[config["compute_dtype"]]
    weights = sum(l["k"] * l["k"] * l["cin"] * l["cout"] + l["cout"] for l in layers)
    return size * (pixels(config, first) * first["cin"] + pixels(config, last) * last["cout"]
                   + weights)

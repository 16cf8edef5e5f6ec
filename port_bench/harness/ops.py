"""Operations and bytes of a configuration, from its layer shapes.

A layer is ``{"name", "cin", "cout", "k"}``: a ``k x k`` SAME convolution at
the configuration's ``resolution``. A multiply-add counts as two
operations; activations, adds and the wrapper's elementwise work are not
counted.
"""
from __future__ import annotations

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def macs_per_pixel(layers) -> int:
    return sum(l["k"] * l["k"] * l["cin"] * l["cout"] for l in layers)


def flop_per_frame(config: dict) -> float:
    """The model's operations on one frame."""
    res = config["resolution"]
    return 2.0 * macs_per_pixel(config["layers"]) * res["height"] * res["width"]


def bytes_per_frame(config: dict) -> float:
    """The bytes the model's stack must move on one frame at the least: its
    input and its output once, in the compute dtype, and its weights."""
    res, layers = config["resolution"], config["layers"]
    size = DTYPE_BYTES[config["compute_dtype"]]
    pixels = res["height"] * res["width"]
    weights = sum(l["k"] * l["k"] * l["cin"] * l["cout"] + l["cout"] for l in layers)
    return size * (pixels * (layers[0]["cin"] + layers[-1]["cout"]) + weights)

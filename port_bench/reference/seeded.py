"""The initializers of a configuration whose graph is made from a seed
(``graph_from_seed``), made by the benchmark itself.

Every layer of the configuration's ``layers`` is a convolution named as its
graph names it (``enc0_block0.conv1``): its weight (OIHW) and its bias,
drawn in the listing's order from one CPU ``torch.Generator`` seeded with the
spec's ``seed``, uniform within ``1 / sqrt(fan_in)`` as ``torch.nn.Conv2d``
draws them by default, and rounded to the spec's ``dtype``; and the
deployment contract's gamma exponents, 2.2 and 1/2.2, in that dtype. The
harness hands the same draw to the program, which writes its graph from it
with its own exporter; the reference takes it from here, not from that graph.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float16": torch.float16}
EXPONENTS = {"gamma_srgb_to_linear_exponent": 2.2, "gamma_linear_to_srgb_exponent": 1.0 / 2.2}


def weights(config: dict) -> Dict[str, torch.Tensor]:
    """``{"<layer>.weight": (cout, cin, k, k), "<layer>.bias": (cout,)}`` in
    float32, holding values of the spec's dtype."""
    spec = config["graph_from_seed"]
    if spec["dtype"] not in DTYPES:
        raise ValueError(f"graph_from_seed dtype must be one of {sorted(DTYPES)}, "
                         f"got {spec['dtype']!r}")
    gen = torch.Generator().manual_seed(int(spec["seed"]))
    out = {}
    for layer in config["layers"]:
        cin, cout, k = layer["cin"], layer["cout"], layer["k"]
        bound = 1.0 / math.sqrt(cin * k * k)
        for key, shape in (("weight", (cout, cin, k, k)), ("bias", (cout,))):
            u = torch.rand(shape, generator=gen, dtype=torch.float32)
            out[f"{layer['name']}.{key}"] = (
                ((u * 2 - 1) * bound).to(DTYPES[spec["dtype"]]).float())
    return out


def initializers(config: dict) -> Dict[str, np.ndarray]:
    """What the reference takes from a graph, made here: the drawn weights
    and the contract's exponents, as numpy arrays of the spec's dtype."""
    dtype = config["graph_from_seed"]["dtype"]
    out = {k: v.numpy().astype(dtype) for k, v in weights(config).items()}
    out.update((k, np.asarray(v, dtype)) for k, v in EXPONENTS.items())
    return out

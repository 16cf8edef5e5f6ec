"""Frozen fp32 forward of the shipped lightweight pix_shuffle graph.

``artifacts/model_pix_shuffle/pix_shuffle.onnx``: unshuffle by 2 (CRD order,
channel ``c * 4 + dy * 2 + dx``), seven 3x3 SAME convs at half resolution
with channels 12-36-36-72-72-36-[36 | 36]-36-12, a residual add after conv2
and after conv4, layer 1's output concatenated into conv6, shuffle by 2
(DepthToSpace, CRD), the global identity residual and a ReLU. The
activations, slot by slot as the graph holds them:

- layer 1: sinlu(a, b), relu6;
- layer 2: telu; the add; sinlu(a, b); biased PReLU (x - bias, slope);
- layer 3: none;
- layer 4: mish, biased PReLU; the add; tanh, ReLU;
- layer 5: none;
- layer 6: mish, relu6;
- layer 7: biased PReLU.

The graph computes in float16; this forward computes in float32 from the
same (float16) initializers.
"""
from __future__ import annotations

import torch

from .common import channel, mish, prelu, relu6, sinlu, telu

OPS = (
    ["Transpose", "Slice", "Cast", "Div", "Pow", "Reshape", "Transpose", "Reshape"]
    + ["Conv", "Sigmoid", "Mul", "Sin", "Mul", "Add", "Mul", "Clip"]
    + ["Conv", "Exp", "Tanh", "Mul", "Add", "Sigmoid", "Mul", "Sin", "Mul", "Add", "Mul",
       "Sub", "PRelu"]
    + ["Conv"]
    + ["Conv", "Softplus", "Tanh", "Mul", "Sub", "PRelu", "Add", "Tanh", "Relu"]
    + ["Conv", "Concat"]
    + ["Conv", "Softplus", "Tanh", "Mul", "Clip"]
    + ["Conv", "Sub", "PRelu", "DepthToSpace", "Add", "Relu"]
    + ["Pow", "Mul", "Clip", "Cast", "Pad", "Transpose"]
)


def unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


def shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def forward(p: dict, conv, x: torch.Tensor) -> torch.Tensor:
    """Linear-light float32 NCHW RGB (H and W even) -> the model's output."""

    def bprelu(t, slot):
        return prelu(t - channel(p[f"{slot}.bias"]), channel(p[f"{slot}.slope"]))

    h1 = relu6(sinlu(conv("conv1", unshuffle(x)), p["l1_act1.a"], p["l1_act1.b"]))
    t = h1 + telu(conv("conv2", h1))
    h2 = bprelu(sinlu(t, p["l2_act3.a"], p["l2_act3.b"]), "l2_act4")
    h3 = conv("conv3", h2)
    t = h3 + bprelu(mish(conv("conv4", h3)), "l4_act2")
    h4 = torch.relu(torch.tanh(t))
    h5 = conv("conv5", h4)
    h6 = relu6(mish(conv("conv6", torch.cat([h1, h5], dim=1))))
    h7 = bprelu(conv("conv7", h6), "l7_act2")
    return torch.relu(x + shuffle(h7))

"""Frozen fp32 forward of the shipped conv6 graph.

``artifacts/model_conv6/conv6.onnx``: the pix_shuffle topology at full
resolution, no shuffle: seven 3x3 SAME convs, channels 3-36-36-36-36-36-
[36 | 36]-36-3, a residual add after conv2 and after conv4, layer 1's output
concatenated into conv6, the global identity residual and a ReLU. The
activations, slot by slot as the graph holds them:

- layer 1: ReLU;
- layer 2: mish, biased ReLU (relu(x - bias)); the add; tanh, relu6;
- layer 3: none;
- layer 4: telu, leaky ReLU (slope 0.01); the add; tanh;
- layer 5: none;
- layer 6: mish, PReLU;
- layer 7: sinlu(a, b), PReLU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import channel, mish, prelu, relu6, sinlu, telu

OPS = (
    ["Transpose", "Slice", "Cast", "Div", "Pow"]
    + ["Conv", "Relu"]
    + ["Conv", "Softplus", "Tanh", "Mul", "Sub", "Relu", "Add", "Tanh", "Clip"]
    + ["Conv"]
    + ["Conv", "Exp", "Tanh", "Mul", "LeakyRelu", "Add", "Tanh"]
    + ["Conv", "Concat"]
    + ["Conv", "Softplus", "Tanh", "Mul", "PRelu"]
    + ["Conv", "Sigmoid", "Mul", "Sin", "Mul", "Add", "Mul", "PRelu", "Add", "Relu"]
    + ["Pow", "Mul", "Clip", "Cast", "Pad", "Transpose"]
)

LEAKY_SLOPE = 0.01


def forward(p: dict, conv, x: torch.Tensor) -> torch.Tensor:
    """Linear-light float32 NCHW RGB -> the model's output."""
    h1 = torch.relu(conv("conv1", x))
    t = h1 + torch.relu(mish(conv("conv2", h1)) - channel(p["l2_act2.bias"]))
    h2 = relu6(torch.tanh(t))
    h3 = conv("conv3", h2)
    h4 = torch.tanh(h3 + F.leaky_relu(telu(conv("conv4", h3)), LEAKY_SLOPE))
    h5 = conv("conv5", h4)
    h6 = prelu(mish(conv("conv6", torch.cat([h1, h5], dim=1))), channel(p["l6_act2.slope"]))
    h7 = prelu(sinlu(conv("conv7", h6), p["l7_act1.a"], p["l7_act1.b"]),
               channel(p["l7_act2.slope"]))
    return torch.relu(x + h7)

"""Frozen fp32 forward of a residual U-Net graph, either variant.

``fs_uae_enhance_unet`` graphs (the shipped lightweight
``artifacts/model_residual_unet/residual_unet.onnx``, or one made from a
seed): unshuffle by 2 (CRD order) and a 1x1 ``stem``; ``depth`` encoder
levels ``enc<d>`` of residual blocks, an unshuffle before each level but
the first; the ``bottleneck`` blocks; ``depth`` decoder stages ``dec<i>``,
each a shuffle by 2 (DepthToSpace, CRD) and a concat of the encoder's
features one level up (the model's input at the top), then blocks, or the
1x1 ``dec_final`` at the top; a ReLU. The depth and the blocks a level
follow from the initializers' names.

A residual block ``<block><i>``: 1x1 ``conv1``, 3x3 ``conv2``, ReLU, 1x1
``conv3``, ReLU, plus the identity (through the 1x1 ``proj`` where the
channels change): the four activation slots identity, ReLU, ReLU, identity.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .pix_shuffle import shuffle, unshuffle

WRAP_IN = ["Transpose", "Slice", "Slice", "Cast", "Div", "Pow"]
UNSHUFFLE = ["Reshape", "Transpose", "Reshape"]
WRAP_OUT = ["Pow", "Mul", "Clip", "Cast", "Pad", "Pad", "Transpose"]


def structure(p) -> Tuple[int, int]:
    """The depth and the residual blocks a level, from the names in ``p``."""
    depth = blocks = 0
    while f"enc{depth}_block0.conv1.weight" in p:
        depth += 1
    while f"enc0_block{blocks}.conv1.weight" in p:
        blocks += 1
    return depth, blocks


def _block_ops(p, name: str) -> List[str]:
    proj = ["Conv"] if f"{name}.proj.weight" in p else []
    return ["Conv", "Conv", "Relu", "Conv", "Relu"] + proj + ["Add"]


def ops(p) -> List[str]:
    """The op types of the graph whose initializers are ``p`` (cropped on the
    left, as the exporter writes it)."""
    depth, blocks = structure(p)
    out = WRAP_IN + UNSHUFFLE + ["Conv"]
    for d in range(depth):
        out += UNSHUFFLE if d else []
        for i in range(blocks):
            out += _block_ops(p, f"enc{d}_block{i}")
    for i in range(blocks):
        out += _block_ops(p, f"bottleneck_block{i}")
    for i in range(depth):
        out += ["DepthToSpace", "Concat"]
        if i == depth - 1:
            out += ["Conv"]
        else:
            for j in range(blocks):
                out += _block_ops(p, f"dec{i}_block{j}")
    return out + ["Relu"] + WRAP_OUT


def block(p, conv, name: str, x: torch.Tensor) -> torch.Tensor:
    t = torch.relu(conv(f"{name}.conv2", conv(f"{name}.conv1", x)))
    t = torch.relu(conv(f"{name}.conv3", t))
    identity = conv(f"{name}.proj", x) if f"{name}.proj.weight" in p else x
    return identity + t


def forward(p: dict, conv, x: torch.Tensor) -> torch.Tensor:
    """Linear-light float32 NCHW RGB (H and W divisible by 2^depth) -> the
    model's output."""
    depth, blocks = structure(p)
    original = x
    t = conv("stem", unshuffle(x))
    feats = []
    for d in range(depth):
        if d:
            t = unshuffle(t)
        for i in range(blocks):
            t = block(p, conv, f"enc{d}_block{i}", t)
        feats.append(t)
    for i in range(blocks):
        t = block(p, conv, f"bottleneck_block{i}", t)
    for i in range(depth):
        level = depth - 1 - i
        t = torch.cat([shuffle(t), feats[level - 1] if level else original], dim=1)
        if level == 0:
            t = conv("dec_final", t)
        else:
            for j in range(blocks):
                t = block(p, conv, f"dec{i}_block{j}", t)
    return torch.relu(t)

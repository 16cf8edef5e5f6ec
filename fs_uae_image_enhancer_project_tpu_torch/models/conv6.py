"""conv6: the pix_shuffle topology at full resolution.

Port of ``fs_uae_image_enhancer_project_tpu/models/conv6.py``: full-resolution
float RGB in and out (no pixel shuffle), 7 convs with residual adds after
layers 2 and 4 (1x1 bias-free projections when channels differ), a long skip
from layer 1 concatenated into layer 6, a global identity residual and a
final ReLU; per-layer act1..4 slots, default 36 channels, the last layer 3.
NHWC tensors, parameters in the JAX package's nested dict (HWIO convs).

The forward is eager PyTorch (cuDNN's convolutions on a card): the JAX
package runs it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import resolve_device
from ..ops.activations import apply_activation, init_activation
from ..ops.conv import conv2d, init_conv, no_tf32
from .configs import Conv6Config, ConvLayerSpec, act, act_config

Params = Dict[str, dict]


def default_config() -> Conv6Config:
    """The 36-channel stack with the pix_shuffle default activations."""
    return Conv6Config(
        layers=(
            ConvLayerSpec(36, 3, (act("identity"), act("relu"))),
            ConvLayerSpec(36, 3, (act("mish"), act("biased_relu"), act("tanh"), act("relu6"))),
            ConvLayerSpec(36, 3, (act("identity"), act("identity"))),
            ConvLayerSpec(36, 3, (act("telu"), act("leaky_relu"), act("tanh"), act("identity"))),
            ConvLayerSpec(36, 3, (act("identity"), act("identity"))),
            ConvLayerSpec(36, 3, (act("mish"), act("prelu"))),
            ConvLayerSpec(3, 3, (act("sinlu"), act("prelu"))),
        )
    )


def init(cfg: Conv6Config, generator: Optional[torch.Generator] = None,
         device=None) -> Params:
    """Fresh parameters (torch.nn.Conv2d's default init), drawn from
    ``generator`` on the CPU and placed on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    L = cfg.layers
    chans = [l.out_channels for l in L]
    kw = dict(generator=generator, device=dev)
    cins = [cfg.in_channels, chans[0], chans[1], chans[2], chans[3],
            chans[0] + chans[4], chans[5]]
    p: Params = {f"conv{i + 1}": init_conv(cins[i], chans[i], L[i].kernel_size, **kw)
                 for i in range(7)}
    if chans[0] != chans[1]:
        p["skip1_proj"] = init_conv(chans[0], chans[1], 1, use_bias=False, **kw)
    if chans[2] != chans[3]:
        p["skip2_proj"] = init_conv(chans[2], chans[3], 1, use_bias=False, **kw)
    for li, layer in enumerate(L, start=1):
        for si, (name, items) in enumerate(layer.acts, start=1):
            p[f"l{li}_act{si}"] = init_activation(name, dict(items), **kw)
    return p


def _acts(p: Params, cfg: Conv6Config, li: int, slots, x):
    for si in slots:
        spec = cfg.layers[li - 1].acts[si - 1]
        # .get: parameter-free slots may be absent from imported dicts
        x = apply_activation(spec[0], p.get(f"l{li}_act{si}", {}), x, act_config(spec))
    return x


def apply(p: Params, x: torch.Tensor, cfg: Conv6Config) -> torch.Tensor:
    """Forward in ``x.dtype``; fp32 is fp32 on a card (TF32 off)."""
    with no_tf32():
        identity = x
        x = _acts(p, cfg, 1, (1, 2), conv2d(p["conv1"], x))
        long_skip = short = x
        x = _acts(p, cfg, 2, (1, 2), conv2d(p["conv2"], x))
        if "skip1_proj" in p:
            short = conv2d(p["skip1_proj"], short)
        x = _acts(p, cfg, 2, (3, 4), short + x)
        x = _acts(p, cfg, 3, (1, 2), conv2d(p["conv3"], x))
        short = x
        x = _acts(p, cfg, 4, (1, 2), conv2d(p["conv4"], x))
        if "skip2_proj" in p:
            short = conv2d(p["skip2_proj"], short)
        x = _acts(p, cfg, 4, (3, 4), short + x)
        x = _acts(p, cfg, 5, (1, 2), conv2d(p["conv5"], x))
        x = _acts(p, cfg, 6, (1, 2), conv2d(p["conv6"], torch.cat([long_skip, x], dim=-1)))
        x = _acts(p, cfg, 7, (1, 2), conv2d(p["conv7"], x))
        return torch.relu(identity + x)

"""The production pix_shuffle super-resolution model in PyTorch.

Port of ``fs_uae_image_enhancer_project_tpu/models/pix_shuffle.py``: 7 SAME
3x3 convs between PixelUnshuffle(2)/PixelShuffle(2), so the stack runs at
half resolution on 4x channels; per-layer dual/quad activation slots;
residual adds after conv2/conv4 (1x1 bias-free projection when channels
differ); long skip from layer 1 concatenated into layer 6; global identity
residual + final ReLU. NHWC tensors, parameters in a nested dict with the
JAX package's keys and HWIO conv weights.

On a CPU tensor :func:`apply` runs the eager forward in the input's dtype.
On a CUDA tensor it runs the fused-stack CUDA kernel, which takes the
lightweight config only and raises ``ValueError`` on any other config or
shape; there is no quiet fallback to the eager forward on the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import resolve_device
from ..ops.activations import apply_activation, init_activation
from ..ops.conv import conv2d, init_conv, no_tf32
from ..ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from .configs import ActSpec, ConvLayerSpec, PixShuffleConfig, act, act_config

Params = Dict[str, dict]


def lightweight_config() -> PixShuffleConfig:
    """The trained production config."""
    return PixShuffleConfig(
        layers=(
            ConvLayerSpec(36, 3, (act("sinlu"), act("relu6"))),
            ConvLayerSpec(
                36, 3,
                (act("telu"), act("identity"), act("sinlu"),
                 act("biased_prelu", num_parameters=36)),
            ),
            ConvLayerSpec(72, 3, (act("identity"), act("identity"))),
            ConvLayerSpec(
                72, 3,
                (act("mish"), act("biased_prelu", num_parameters=72),
                 act("tanh"), act("relu")),
            ),
            ConvLayerSpec(36, 3, (act("identity"), act("identity"))),
            ConvLayerSpec(36, 3, (act("mish"), act("relu6"))),
            # layer 7 has no out_channels knob: always 3 * factor^2 = 12
            ConvLayerSpec(12, 3, (act("identity"), act("biased_prelu", num_parameters=1))),
        )
    )


def heavyweight_config() -> PixShuffleConfig:
    """Default-act heavy variant."""
    return PixShuffleConfig(
        layers=(
            ConvLayerSpec(36, 3, (act("identity"), act("relu"))),
            ConvLayerSpec(
                36, 3,
                (act("mish"), act("biased_relu"), act("tanh"), act("relu6")),
            ),
            ConvLayerSpec(108, 3, (act("identity"), act("identity"))),
            ConvLayerSpec(
                108, 3,
                (act("telu"), act("leaky_relu"), act("tanh"), act("identity")),
            ),
            ConvLayerSpec(36, 3, (act("identity"), act("identity"))),
            ConvLayerSpec(36, 3, (act("mish"), act("prelu"))),
            ConvLayerSpec(12, 3, (act("sinlu"), act("prelu"))),
        )
    )


def init(cfg: PixShuffleConfig, generator: Optional[torch.Generator] = None,
         device=None) -> Params:
    """Fresh parameters (torch.nn.Conv2d's default init), drawn from
    ``generator`` on the CPU and placed on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    L = cfg.layers
    c_in = cfg.unshuffled_channels  # 12
    chans = [l.out_channels for l in L]
    kw = dict(generator=generator, device=dev)
    params: Params = {}
    params["conv1"] = init_conv(c_in, chans[0], L[0].kernel_size, **kw)
    params["conv2"] = init_conv(chans[0], chans[1], L[1].kernel_size, **kw)
    params["conv3"] = init_conv(chans[1], chans[2], L[2].kernel_size, **kw)
    params["conv4"] = init_conv(chans[2], chans[3], L[3].kernel_size, **kw)
    params["conv5"] = init_conv(chans[3], chans[4], L[4].kernel_size, **kw)
    # layer 6 concatenates layer-1 features with layer-5 output
    params["conv6"] = init_conv(chans[0] + chans[4], chans[5], L[5].kernel_size, **kw)
    params["conv7"] = init_conv(chans[5], c_in, L[6].kernel_size, **kw)
    # skip projections, 1x1 bias-free, only when channels differ
    if chans[0] != chans[1]:
        params["skip1_proj"] = init_conv(chans[0], chans[1], 1, use_bias=False, **kw)
    if chans[2] != chans[3]:
        params["skip2_proj"] = init_conv(chans[2], chans[3], 1, use_bias=False, **kw)
    for li, layer in enumerate(L, start=1):
        for si, (name, cfg_items) in enumerate(layer.acts, start=1):
            params[f"l{li}_act{si}"] = init_activation(name, dict(cfg_items), **kw)
    return params


def _acts(params: Params, cfg: PixShuffleConfig, li: int, slots, x):
    for si in slots:
        spec: ActSpec = cfg.layers[li - 1].acts[si - 1]
        # .get: parameter-free slots may be absent from imported dicts
        x = apply_activation(
            spec[0], params.get(f"l{li}_act{si}", {}), x, act_config(spec)
        )
    return x


def apply_with_intermediates(params: Params, x: torch.Tensor, cfg: PixShuffleConfig):
    """Eager forward that also returns the tagged per-layer activations,
    ``(y, {tag: tensor})``. The fused kernel keeps its intermediates in
    shared memory, so this always takes the eager path (it is the debug dump the
    trainer renders, not the serving path)."""
    captured = {}

    def tap(tag, t):
        captured[tag] = t
        return t

    return _forward(params, x, cfg, tap), captured


def apply(params: Params, x: torch.Tensor, cfg: PixShuffleConfig) -> torch.Tensor:
    """Forward pass. x: (N, H, W, 3) linear-light float in [0, 1]-ish range.

    The route:
    - a CUDA tensor in bf16 with the lightweight config (the deployed path):
      the fused-stack kernel K1 (bf16 compute, fp32 accumulation, one launch
      for the batch), which raises ``ValueError`` for a shape it does not
      take (H or W odd);
    - anything else, on either device (another config, fp32 or another
      dtype, a CPU tensor): :func:`apply_eager`, the reference's own route.
    """
    if x.is_cuda and x.dtype == torch.bfloat16 and cfg == lightweight_config():
        from ..ops.cuda.fused_stack import fused_stack_apply

        return fused_stack_apply(params, x, cfg=cfg)
    return apply_eager(params, x, cfg)


def apply_eager(params: Params, x: torch.Tensor, cfg: PixShuffleConfig) -> torch.Tensor:
    """The eager forward in ``x.dtype`` on any device (cuDNN's convolutions on
    a card), with TF32 off (:func:`ops.conv.no_tf32`), so that fp32 is fp32
    on a card, as in the JAX package. It is the forward the train step
    differentiates: K1 has no backward."""
    with no_tf32():
        return _forward(params, x, cfg, lambda _tag, t: t)


def _forward(params: Params, x: torch.Tensor, cfg: PixShuffleConfig, tap):
    identity = x
    x = pixel_unshuffle(x, cfg.shuffle_factor)
    x = conv2d(params["conv1"], x)
    x = tap("layer1", _acts(params, cfg, 1, (1, 2), x))
    long_skip = x
    short = x
    x = conv2d(params["conv2"], x)
    x = _acts(params, cfg, 2, (1, 2), x)
    if "skip1_proj" in params:
        short = conv2d(params["skip1_proj"], short)
    x = tap("layer2", _acts(params, cfg, 2, (3, 4), short + x))
    x = conv2d(params["conv3"], x)
    x = tap("layer3", _acts(params, cfg, 3, (1, 2), x))
    short = x
    x = conv2d(params["conv4"], x)
    x = _acts(params, cfg, 4, (1, 2), x)
    if "skip2_proj" in params:
        short = conv2d(params["skip2_proj"], short)
    x = tap("layer4", _acts(params, cfg, 4, (3, 4), short + x))
    x = conv2d(params["conv5"], x)
    x = tap("layer5", _acts(params, cfg, 5, (1, 2), x))
    # layer 6: concat long skip (channel axis is trailing in NHWC)
    x = conv2d(params["conv6"], torch.cat([long_skip, x], dim=-1))
    x = tap("layer6", _acts(params, cfg, 6, (1, 2), x))
    x = conv2d(params["conv7"], x)
    x = tap("layer7", _acts(params, cfg, 7, (1, 2), x))
    # back to full resolution; global residual; clamp negatives
    x = pixel_shuffle(x, cfg.shuffle_factor)
    return torch.relu(identity + x)

"""The conv3 / conv5 family: Conv-BN-ReLU stacks (the BatchNorm models).

Port of ``fs_uae_image_enhancer_project_tpu/models/conv_stack.py``: conv3
(3 bias-free convs + BN + ReLU, no skips) and conv5 (5 layers, residual adds
at layers 2 and 4 before the activation, Sigmoid output). Both train on
float sRGB and deploy fused (each BN folded into its conv, :func:`fuse`).
NHWC tensors; parameters in the JAX package's nested dict with HWIO convs.
The deployed graphs (``artifacts/model_conv{3,5}*/``) run through
:func:`apply_fused` in the sRGB domain (``export.enhance``); conv3's own
deployment contract is :func:`apply_uint8_rgba`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import resolve_device
from ..ops.conv import (
    batchnorm_inference,
    batchnorm_train,
    conv2d,
    fuse_conv_bn,
    init_batchnorm,
    init_conv,
    no_tf32,
)
from .configs import ConvStackConfig

Params = Dict[str, dict]


def conv3_config(variant: str = "lightweight") -> ConvStackConfig:
    """Lightweight 32/64, heavyweight 192/256."""
    ch = (32, 64) if variant == "lightweight" else (192, 256)
    return ConvStackConfig(
        channels=(ch[0], ch[1], 3), kernel_size=3, residual_layers=(),
        final_act="none", uint8_rgba_contract=True,
    )


def conv5_config(variant: str = "lightweight") -> ConvStackConfig:
    """Lightweight 32/64, heavyweight 64/128: channels c1, c1, c2, c2, 3 with
    residual adds at layers 2 and 4 (0-based 1 and 3)."""
    c1, c2 = (32, 64) if variant == "lightweight" else (64, 128)
    return ConvStackConfig(
        channels=(c1, c1, c2, c2, 3), kernel_size=3, residual_layers=(1, 3),
        final_act="sigmoid",
    )


def init(cfg: ConvStackConfig, generator: Optional[torch.Generator] = None, device=None,
         in_channels: int = 3) -> Params:
    """Fresh parameters (torch.nn.Conv2d's default init, bias-free convs, BN
    at torch's defaults), drawn from ``generator`` on the CPU and placed on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    params: Params = {}
    cin = in_channels
    for i, cout in enumerate(cfg.channels):
        params[f"conv{i + 1}"] = init_conv(cin, cout, cfg.kernel_size, use_bias=False,
                                           generator=generator, device=dev)
        params[f"bn{i + 1}"] = init_batchnorm(cout, device=dev)
        cin = cout
    return params


def _act(x: torch.Tensor, cfg: ConvStackConfig, is_last: bool) -> torch.Tensor:
    if not is_last:
        return torch.relu(x)
    if cfg.final_act == "sigmoid":
        return torch.sigmoid(x)
    return x


def apply(params: Params, x: torch.Tensor, cfg: ConvStackConfig, *, train: bool = False,
          bn_group=None, bn_rows=None):
    """Float RGB forward, NHWC in and out. With ``train`` it also returns the
    updated batchnorm stats, ``(y, {bn_key: stats})`` (the functional form of
    torch's in-place running-stat update); ``bn_group`` takes the batch
    statistics over that process group's ranks and ``bn_rows = (lo, hi)``
    over a spatial slab's owned rows only (``ops.conv.batchnorm_train``):
    every layer runs at the input's resolution, so a slab's rows are each
    layer's rows. fp32 is fp32 on a card (TF32 off)."""
    new_stats: Params = {}
    n_layers = len(cfg.channels)
    with no_tf32():
        for i in range(n_layers):
            li = i + 1
            skip = x if i in cfg.residual_layers else None
            x = conv2d(params[f"conv{li}"], x)
            bn_key = f"bn{li}"
            if bn_key in params:
                if train:
                    x, new_stats[bn_key] = batchnorm_train(params[bn_key], x,
                                                           group=bn_group, rows=bn_rows)
                else:
                    x = batchnorm_inference(params[bn_key], x)
            if skip is not None:
                x = skip + x  # residual add before the activation
            x = _act(x, cfg, i == n_layers - 1)
    if train:
        return x, new_stats
    return x


def fuse(params: Params, cfg: ConvStackConfig) -> Params:
    """Fold each BN into its conv: the deployment-form parameters."""
    fused: Params = {}
    for i in range(len(cfg.channels)):
        li = i + 1
        conv = params[f"conv{li}"]
        bn = params.get(f"bn{li}")
        fused[f"conv{li}"] = fuse_conv_bn(conv, bn) if bn is not None else dict(conv)
    return fused


def apply_fused(params: Params, x: torch.Tensor, cfg: ConvStackConfig, *,
                relu_before_residual_add: bool = False) -> torch.Tensor:
    """Forward with BN already folded into the convs.

    ``relu_before_residual_add=True`` is the reference's deployed conv5: its
    fused conv+bn+relu units apply ReLU before the skip add (the shipped ONNX
    graphs are Conv->Relu->Add), where training adds and then activates.
    fp32 is fp32 on a card (TF32 off)."""
    n_layers = len(cfg.channels)
    with no_tf32():
        for i in range(n_layers):
            skip = x if i in cfg.residual_layers else None
            x = conv2d(params[f"conv{i + 1}"], x)
            is_last = i == n_layers - 1
            if relu_before_residual_add:
                x = _act(x, cfg, is_last)
                if skip is not None:
                    x = skip + x
            else:
                if skip is not None:
                    x = skip + x
                x = _act(x, cfg, is_last)
    return x


def apply_uint8_rgba(params: Params, x_rgba: torch.Tensor, cfg: ConvStackConfig) -> torch.Tensor:
    """conv3's deployment forward contract: uint8 RGBA NHWC in, float RGBA
    NHWC out scaled to [0, 255] with alpha 255. Raises on any other input,
    and on unfused parameters (``bn*`` entries): :func:`apply_fused` would
    run the bias-free convs with no batchnorm and give wrong pixels."""
    if x_rgba.dtype != torch.uint8 or x_rgba.shape[-1] != 4:
        raise ValueError("Input tensor must be uint8 with 4 channels (RGBA)")
    if any(k.startswith("bn") for k in params):
        raise ValueError(
            "apply_uint8_rgba expects FUSED deployment params; call "
            "conv_stack.fuse(params, cfg) first (the dict still has bn* entries)"
        )
    rgb = x_rgba[..., :3].float() / 255.0
    y = apply_fused(params, rgb, cfg) * 255.0
    alpha = torch.full(y.shape[:-1] + (1,), 255.0, dtype=y.dtype, device=y.device)
    return torch.cat([y, alpha], dim=-1)

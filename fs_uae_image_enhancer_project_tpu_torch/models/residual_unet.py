"""The residual U-Net on NHWC tensors.

Port of ``fs_uae_image_enhancer_project_tpu/models/residual_unet.py``:
PixelUnshuffle(2) and a 1x1 stem, encoder levels of residual feature blocks
(channels ``base * 2^d``, an unshuffle between levels), a bottleneck, a
decoder that upsamples with PixelShuffle(2) and concatenates the skip (the
original input at the top level), and a final ReLU. The input's height and
width must be divisible by ``2**unet_depth``; the forward raises otherwise.

The forward is eager PyTorch (cuDNN's convolutions on a card): the JAX
package runs it outside any Pallas kernel. It opens the spans
``fse.unet.encoder``, ``fse.unet.bottleneck`` and ``fse.unet.decoder``
(``utils/profiler.py``) and counts its calls in ``apply.forwards``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import resolve_device
from ..ops.conv import conv2d, init_conv, no_tf32
from ..ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from ..utils.profiler import span
from .blocks import apply_feature_block, init_feature_block
from .configs import ResidualUNetConfig

Params = Dict[str, dict]


def lightweight_config() -> ResidualUNetConfig:
    return ResidualUNetConfig(
        unet_depth=3, blocks_per_level=1, base_channels=36,
        internal_block_channels_ratio=1.50,
    )


def heavyweight_config() -> ResidualUNetConfig:
    return ResidualUNetConfig(
        unet_depth=4, blocks_per_level=4, base_channels=72,
        internal_block_channels_ratio=1.50,
    )


def _mid(cfg: ResidualUNetConfig, out_ch: int) -> int:
    return max(1, int(out_ch * cfg.internal_block_channels_ratio))


def _level_channels(cfg: ResidualUNetConfig) -> List[int]:
    """Encoder block output channels per level d = 0..depth-1."""
    return [cfg.base_channels * (2 ** d) for d in range(cfg.unet_depth)]


def init(cfg: ResidualUNetConfig, generator: Optional[torch.Generator] = None,
         device=None) -> Params:
    """Fresh parameters, drawn from ``generator`` on the CPU and placed on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    kw = dict(generator=generator, device=dev)
    lc = _level_channels(cfg)

    def blocks(prefix: str, cin: int, out_ch: int, n: int) -> None:
        for i in range(n):
            p[f"{prefix}{i}"] = init_feature_block(
                cin if i == 0 else out_ch, _mid(cfg, out_ch), out_ch, 3, cfg.acts, **kw)

    p: Params = {}
    # stem: PixelUnshuffle(2) + 1x1 conv in*4 -> base
    p["stem"] = init_conv(cfg.input_channels * 4, cfg.base_channels, 1, **kw)
    blocks("enc0_block", cfg.base_channels, lc[0], cfg.blocks_per_level)
    # levels 1..depth-1: unshuffle, then blocks
    for d in range(1, cfg.unet_depth):
        blocks(f"enc{d}_block", lc[d - 1] * 4, lc[d], cfg.blocks_per_level)
    blocks("bottleneck_block", lc[-1], lc[-1], cfg.blocks_per_level)
    # decoder stage i upsamples to level d_val = depth-1-i
    cur = lc[-1]
    for i in range(cfg.unet_depth):
        d_val = cfg.unet_depth - 1 - i
        skip_ch = cfg.input_channels if d_val == 0 else lc[d_val - 1]
        cin = cur // 4 + skip_ch
        if d_val == 0:
            p["dec_final"] = init_conv(cin, cfg.output_channels, 1, **kw)
        else:
            cur = cfg.base_channels * (2 ** d_val)
            blocks(f"dec{i}_block", cin, cur, cfg.blocks_per_level)
    return p


def apply(p: Params, x: torch.Tensor, cfg: ResidualUNetConfig) -> torch.Tensor:
    """Forward in ``x.dtype``; fp32 is fp32 on a card (TF32 off)."""
    _, h, w, _ = x.shape
    factor = 2 ** cfg.unet_depth
    if h % factor or w % factor:
        raise ValueError(
            f"input {h}x{w} must be divisible by 2^depth={factor} "
            "(deployed frames are cropped to 736x576)"
        )
    lc = _level_channels(cfg)

    def blocks(prefix: str, x: torch.Tensor, out_ch: int) -> torch.Tensor:
        for i in range(cfg.blocks_per_level):
            x = apply_feature_block(p[f"{prefix}{i}"], x, cfg.acts, _mid(cfg, out_ch), out_ch)
        return x

    apply.forwards += 1
    with no_tf32():
        original = x
        with span("fse.unet.encoder"):
            x = blocks("enc0_block", conv2d(p["stem"], pixel_unshuffle(x, 2)), lc[0])
            enc_feats = [x]
            for d in range(1, cfg.unet_depth):
                x = blocks(f"enc{d}_block", pixel_unshuffle(x, 2), lc[d])
                enc_feats.append(x)
        with span("fse.unet.bottleneck"):
            x = blocks("bottleneck_block", x, lc[-1])
        with span("fse.unet.decoder"):
            for i in range(cfg.unet_depth):
                d_val = cfg.unet_depth - 1 - i
                skip = original if d_val == 0 else enc_feats[d_val - 1]
                x = torch.cat([pixel_shuffle(x, 2), skip], dim=-1)
                if d_val == 0:
                    x = conv2d(p["dec_final"], x)
                else:
                    x = blocks(f"dec{i}_block", x, cfg.base_channels * (2 ** d_val))
            return torch.relu(x)


apply.forwards = 0

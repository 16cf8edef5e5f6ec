"""Residual blocks on NHWC tensors.

Port of ``fs_uae_image_enhancer_project_tpu/models/blocks.py``:

- the residual feature block: 1x1 -> kxk -> 1x1 bottleneck with four
  activation slots and an identity add through an optional 1x1 projection.
  The 'channel'/'global' ``num_parameters`` placeholders resolve at config
  time (:func:`resolve_block_acts`);
- triplet attention: three branches of Z-pool (max and mean over an axis),
  a 7x7 conv and a sigmoid gate, averaged. The rotations carry the JAX
  package's NHWC axes;
- the dense block: dense-concat 3x3 convs, a 1x1 fusion and a local residual
  through a 1x1 adjustment conv.

Parameters are the JAX package's nested dicts (HWIO convs); ``init_*`` draw
from ``generator`` on the CPU and place the tensors on ``device``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.activations import apply_activation, init_activation
from ..ops.conv import conv2d, init_conv
from .configs import ActSpec

Params = Dict[str, dict]

DEFAULT_BLOCK_ACTS: Tuple[ActSpec, ActSpec, ActSpec, ActSpec] = (
    ("identity", ()),
    ("relu", ()),
    ("identity", ()),
    ("relu", ()),
)


def _resolve(spec: ActSpec, channels: int) -> ActSpec:
    name, items = spec
    cfg = dict(items)
    num = cfg.get("num_parameters")
    if num == "global":
        cfg["num_parameters"] = 1
    elif num == "channel":
        cfg["num_parameters"] = channels
    return (name, tuple(sorted(cfg.items())))


def resolve_block_acts(
    acts: Tuple[ActSpec, ActSpec, ActSpec, ActSpec],
    mid_channels: int,
    out_channels: int,
) -> Tuple[ActSpec, ...]:
    """Resolve 'channel'/'global' num_parameters per slot: slots 1-2 see
    ``mid_channels``, slots 3-4 ``out_channels``."""
    chans = (mid_channels, mid_channels, out_channels, out_channels)
    return tuple(_resolve(spec, ch) for spec, ch in zip(acts, chans))


# ---------------------------------------------------------------------------
# the residual feature block
# ---------------------------------------------------------------------------

def init_feature_block(
    in_channels: int,
    mid_channels: int,
    out_channels: int,
    kernel_size: int,
    acts: Tuple[ActSpec, ...] = DEFAULT_BLOCK_ACTS,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Params:
    if kernel_size % 2 == 0:
        raise ValueError("kernel_size must be odd for symmetric padding")
    acts = resolve_block_acts(acts, mid_channels, out_channels)
    kw = dict(generator=generator, device=device)
    p: Params = {
        "conv1": init_conv(in_channels, mid_channels, 1, **kw),
        "conv2": init_conv(mid_channels, mid_channels, kernel_size, **kw),
        "conv3": init_conv(mid_channels, out_channels, 1, **kw),
    }
    for i, spec in enumerate(acts, start=1):
        p[f"act{i}"] = init_activation(spec[0], dict(spec[1]), **kw)
    if in_channels != out_channels:
        p["proj"] = init_conv(in_channels, out_channels, 1, **kw)
    return p


def apply_feature_block(
    p: Params,
    x: torch.Tensor,
    acts: Tuple[ActSpec, ...],
    mid_channels: int,
    out_channels: int,
) -> torch.Tensor:
    """conv1 -> conv2 -> act1 -> act2 -> conv3 -> act3 -> (+identity or
    proj) -> act4.

    The slots go to ``conv2d``'s epilogue, which folds identity and ReLU
    slots into one pass after the conv: conv2 takes act1 and act2, conv3
    takes act3, the identity or the projection (its conv without its bias,
    which the epilogue adds) and act4."""
    acts = resolve_block_acts(acts, mid_channels, out_channels)
    slots = [(spec, p[f"act{i}"]) for i, spec in enumerate(acts, start=1)]
    identity, bias = x, None
    x = conv2d(p["conv1"], x)
    x = conv2d(p["conv2"], x, pre=slots[:2])
    if "proj" in p:
        identity, bias = conv2d({"w": p["proj"]["w"]}, identity), p["proj"].get("b")
    return conv2d(p["conv3"], x, pre=slots[2:3], residual=identity, residual_bias=bias,
                  post=slots[3:])


# ---------------------------------------------------------------------------
# triplet attention
# ---------------------------------------------------------------------------

def init_triplet_attention(kernel_size: int = 7, *,
                           generator: Optional[torch.Generator] = None,
                           device=None) -> Params:
    kw = dict(use_bias=False, generator=generator, device=device)
    return {
        # each branch: Z-pool (2 channels) -> conv -> sigmoid
        "conv_cw": init_conv(2, 1, kernel_size, **kw),
        "conv_hc": init_conv(2, 1, kernel_size, **kw),
        "conv_hw": init_conv(2, 1, kernel_size, **kw),
    }


def _zpool(x: torch.Tensor) -> torch.Tensor:
    """Max and mean over the trailing axis, concatenated -> (..., 2)."""
    return torch.cat([x.amax(dim=-1, keepdim=True), x.mean(dim=-1, keepdim=True)], dim=-1)


def apply_triplet_attention(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Rotate-to-interact triplet attention over NHWC input."""
    # branch 1: N, C, W, H (H as the channel axis): attention over (C, W)
    b1 = x.permute(0, 3, 2, 1)
    g1 = torch.sigmoid(conv2d(p["conv_cw"], _zpool(b1)))
    b1 = (b1 * g1).permute(0, 3, 2, 1)
    # branch 2: N, H, C, W (W as the channel axis): attention over (H, C)
    b2 = x.permute(0, 1, 3, 2)
    g2 = torch.sigmoid(conv2d(p["conv_hc"], _zpool(b2)))
    b2 = (b2 * g2).permute(0, 1, 3, 2)
    # branch 3: plain spatial attention over (H, W)
    g3 = torch.sigmoid(conv2d(p["conv_hw"], _zpool(x)))
    b3 = x * g3
    return (b1 + b2 + b3) / 3.0


# ---------------------------------------------------------------------------
# the dense block
# ---------------------------------------------------------------------------

DENSE_DEFAULT_ACTS: Tuple[ActSpec, ActSpec] = (("relu", ()), ("identity", ()))


def resolve_dense_acts(acts: Tuple[ActSpec, ActSpec], growth: int) -> Tuple[ActSpec, ...]:
    """'channel'/'global' num_parameters resolve against the growth rate:
    every dense conv outputs ``growth`` channels."""
    return tuple(_resolve(spec, growth) for spec in acts)


def init_dense_block(
    in_channels: int,
    out_channels: Optional[int] = None,
    growth: int = 32,
    n_convs: int = 3,
    acts: Tuple[ActSpec, ActSpec] = DENSE_DEFAULT_ACTS,
    use_attention: bool = False,
    use_local_residual_learning: bool = True,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Params:
    """``n_convs`` dense 3x3 convs (cin grows by ``growth`` each), two
    activation slots a conv, a 1x1 fusion to ``out_channels`` and, only when
    the channel counts differ and local residual learning is on, a 1x1
    residual adjustment conv."""
    out_channels = in_channels if out_channels is None else out_channels
    acts_r = resolve_dense_acts(acts, growth)
    kw = dict(generator=generator, device=device)
    p: Params = {}
    cin = in_channels
    for i in range(n_convs):
        p[f"conv{i + 1}"] = init_conv(cin, growth, 3, **kw)
        for j in (0, 1):
            spec = acts_r[j]
            p[f"l{i + 1}_act{j + 1}"] = init_activation(spec[0], dict(spec[1]), **kw)
        cin += growth
    p["fusion"] = init_conv(cin, out_channels, 1, **kw)
    if use_attention:
        p["attn"] = init_triplet_attention(**kw)
    if use_local_residual_learning and in_channels != out_channels:
        p["adjust"] = init_conv(in_channels, out_channels, 1, **kw)
    return p


def apply_dense_block(
    p: Params,
    x: torch.Tensor,
    n_convs: int = 3,
    growth: Optional[int] = None,
    acts: Tuple[ActSpec, ActSpec] = DENSE_DEFAULT_ACTS,
) -> torch.Tensor:
    """Dense-concat convs (two activation slots each) -> triplet attention
    on the concatenated features -> 1x1 fusion -> the local residual through
    the adjustment conv. As in the reference, with matching channels the
    fusion output is returned with no residual."""
    if growth is None:
        growth = p["conv1"]["w"].shape[-1]
    acts_r = resolve_dense_acts(acts, growth)
    feats = [x]
    for i in range(n_convs):
        h = conv2d(p[f"conv{i + 1}"], torch.cat(feats, dim=-1))
        for j in (0, 1):
            name, items = acts_r[j]
            h = apply_activation(name, p[f"l{i + 1}_act{j + 1}"], h, dict(items))
        feats.append(h)
    cat = torch.cat(feats, dim=-1)
    if "attn" in p:
        cat = apply_triplet_attention(p["attn"], cat)
    out = conv2d(p["fusion"], cat)
    if "adjust" in p:
        out = out + conv2d(p["adjust"], x)
    return out

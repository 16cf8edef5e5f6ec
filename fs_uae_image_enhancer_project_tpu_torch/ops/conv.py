"""NHWC 2-D convolution (plain PyTorch path).

Port of ``conv2d`` / ``init_conv`` in ``fs_uae_image_enhancer_project_tpu/
ops/conv.py``. Parameters are ``{"w": (kh, kw, cin, cout) HWIO, "b": (cout,)}``
in fp32, tensors are NHWC at the public functions, and the compute dtype is
the input's (weights are cast to match). Init mirrors torch.nn.Conv2d's
defaults: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias.

On a card, a float32 convolution goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; callers that need full fp32
(the JAX package uses ``Precision.HIGHEST``) set it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def init_conv(
    cin: int,
    cout: int,
    kernel_size: int = 3,
    use_bias: bool = True,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype=torch.float32,
) -> Params:
    """Conv params with torch.nn.Conv2d's default scheme, drawn on the CPU
    from ``generator`` and moved to ``device``."""
    fan_in = cin * kernel_size * kernel_size
    bound_w = math.sqrt(6.0 / ((1.0 + 5.0) * fan_in))  # kaiming_uniform a=sqrt(5)
    u = torch.rand((kernel_size, kernel_size, cin, cout), generator=generator,
                   dtype=dtype)
    params: Params = {"w": ((u * 2 - 1) * bound_w).to(device)}
    if use_bias:
        bound_b = 1.0 / math.sqrt(fan_in)
        u = torch.rand((cout,), generator=generator, dtype=dtype)
        params["b"] = ((u * 2 - 1) * bound_b).to(device)
    return params


def conv2d(params: Params, x: torch.Tensor, *, padding: str = "SAME") -> torch.Tensor:
    """Stride-1 NHWC conv with optional bias; output dtype = input dtype.

    ``padding`` is "SAME" (odd kernels, as every conv of the model zoo) or
    "VALID".
    """
    w = params["w"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    if padding == "SAME":
        pad = w.shape[-1] // 2
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    b = params.get("b")
    y = F.conv2d(x.permute(0, 3, 1, 2), w,
                 None if b is None else b.to(x.dtype), padding=pad)
    return y.permute(0, 2, 3, 1)

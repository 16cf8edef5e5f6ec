"""NHWC 2-D convolution and batchnorm (plain PyTorch path).

Port of ``fs_uae_image_enhancer_project_tpu/ops/conv.py``: ``conv2d``,
``init_conv``, the depthwise conv of the Laplacian loss, batchnorm in
inference and training mode (with batch statistics synchronised over a
process group, over a spatial slab's owned rows under sp), and the conv-BN
fold. Parameters are
``{"w": (kh, kw, cin, cout) HWIO, "b": (cout,)}`` in fp32, tensors are NHWC
at the public functions, and the compute dtype is
the input's (weights are cast to match). Init mirrors torch.nn.Conv2d's
defaults: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias.

On a card, a float32 convolution goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; callers that need full fp32
(the JAX package uses ``Precision.HIGHEST``) run under :func:`no_tf32`.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
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
    "VALID". The bias is added to the conv's output in the input's dtype, as
    the JAX package adds it: in bf16 the sum rounds twice there, where a
    bias fused into the CPU's convolution rounds once (0.002 dB of sRGB PSNR
    over a validation set). cuDNN adds a bias in a pass of its own anyway.
    """
    w = params["w"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    if padding == "SAME":
        pad = w.shape[-1] // 2
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, padding=pad).permute(0, 2, 3, 1)
    b = params.get("b")
    return y if b is None else y.add_(b.to(x.dtype))


@contextlib.contextmanager
def no_tf32():
    """Full fp32 in cuDNN's convolutions and in matmuls for the block (the
    JAX package's ``Precision.HIGHEST``); the flags are restored after. The
    flags are read when a kernel is launched, so a backward pass that must be
    fp32 runs inside the block too."""
    keep = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = keep


def depthwise_conv2d(kernel: torch.Tensor, x: torch.Tensor, *,
                     padding: str = "SAME") -> torch.Tensor:
    """Depthwise conv of NHWC ``x`` with one (kh, kw) kernel shared by every
    channel (the Laplacian high-frequency loss filter)."""
    c = x.shape[-1]
    kh, kw = kernel.shape
    w = kernel.to(x.dtype).reshape(1, 1, kh, kw).expand(c, 1, kh, kw)
    if padding == "SAME":
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad, groups=c).permute(0, 2, 3, 1)


def init_batchnorm(c: int, *, device=None, dtype=torch.float32) -> Params:
    """BatchNorm2d params and running stats (torch defaults)."""
    return {
        "scale": torch.ones((c,), dtype=dtype, device=device),
        "bias": torch.zeros((c,), dtype=dtype, device=device),
        "mean": torch.zeros((c,), dtype=dtype, device=device),
        "var": torch.ones((c,), dtype=dtype, device=device),
    }


def batchnorm_inference(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batchnorm over the NHWC channel axis, running stats."""
    inv = torch.rsqrt(params["var"].float() + eps)
    scale = params["scale"].float() * inv
    shift = params["bias"].float() - params["mean"].float() * scale
    return x * scale.to(x.dtype) + shift.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group. Every rank's loss depends on the sum, so the
    gradient of a rank's input is the group's sum of the incoming gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def batchnorm_train(params: Params, x: torch.Tensor, momentum: float = 0.1,
                    eps: float = 1e-5, group=None, rows: Optional[Tuple[int, int]] = None):
    """Training-mode batchnorm: ``(y, updated stats)``.

    Batch statistics over (N, H, W) in fp32; the running stats follow
    torch's ``running = (1 - momentum) * running + momentum * batch`` with
    the unbiased variance. The new stats carry no gradient.

    With a process ``group`` (the ranks of the mesh, each with an equal
    block of the batch) the statistics are the whole batch's, as the JAX
    package's are under GSPMD: the per-channel sum, then the sum of squared
    deviations from the global mean, are all-reduced over the group
    (differentiably), and ``n`` counts every rank's rows.

    ``rows = (lo, hi)`` takes the statistics over the slab's owned rows
    ``[lo, hi)`` of the height axis only (a spatial slab's halo rows are
    other ranks' rows, and must not count twice); every row, the halo's
    included, is normalised with them.
    """
    xf = x.float()
    owned = xf if rows is None else xf[:, rows[0]:rows[1]]
    n = owned.shape[0] * owned.shape[1] * owned.shape[2]
    if group is None:
        mean = owned.mean(dim=(0, 1, 2))
        var = owned.var(dim=(0, 1, 2), unbiased=False)
    else:
        n *= dist.get_world_size(group)
        mean = _AllReduceSum.apply(owned.sum(dim=(0, 1, 2)), group) / n
        var = _AllReduceSum.apply(((owned - mean) ** 2).sum(dim=(0, 1, 2)), group) / n
    y = ((xf - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]).to(x.dtype)
    mean, var = mean.detach(), var.detach()
    unbiased = var * (n / max(n - 1, 1))
    new_stats = {
        "scale": params["scale"],
        "bias": params["bias"],
        "mean": (1 - momentum) * params["mean"] + momentum * mean,
        "var": (1 - momentum) * params["var"] + momentum * unbiased,
    }
    return y, new_stats


def fuse_conv_bn(conv: Params, bn: Params, eps: float = 1e-5) -> Params:
    """Fold a batchnorm into the conv before it: the deployed form, one conv
    a layer."""
    w = conv["w"].float()
    b = conv.get("b")
    b = torch.zeros((w.shape[-1],), device=w.device) if b is None else b.float()
    inv = torch.rsqrt(bn["var"].float() + eps)
    gamma, beta, mean = bn["scale"].float(), bn["bias"].float(), bn["mean"].float()
    return {"w": w * (gamma * inv).reshape(1, 1, 1, -1), "b": beta + (b - mean) * gamma * inv}

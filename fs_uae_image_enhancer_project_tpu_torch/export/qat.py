"""int8 quantization-aware training (QAT) and the int8 conv-stack path.

Port of ``fs_uae_image_enhancer_project_tpu/export/qat.py``. The JAX
package closed the int8 question on its TPU as a measured negative; on the
H100 it is open again (int8 runs at twice the bf16 rate there), and
``scripts/bench_int8_qat.py`` of this package answers it with the card's
numbers. Nothing on the served path dispatches here.

The scheme, the same numerics in fake-quant training and int8 deployment:
weights symmetric int8 per output channel; conv inputs symmetric int8 per
tensor with static calibrated scales; int32 accumulation; dequantize, bias
and activation in float. Training uses a straight-through estimator and
distils the fp32 model's outputs (the parity metric is output PSNR against
the fp32 path, so the distillation loss is the deployment objective).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..models.configs import ConvStackConfig
from ..ops.conv import conv2d, no_tf32
from .quantized import _qconv, quantize_weight

Params = Dict[str, dict]


# ---------------------------------------------------------------------------
# fake-quant primitives (straight-through estimator)
# ---------------------------------------------------------------------------

def weight_scales(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric scale of an HWIO weight."""
    return w.abs().amax(dim=(0, 1, 2)).clamp_min(1e-12) / 127.0


def fq_weight(w: torch.Tensor) -> torch.Tensor:
    """STE fake-quant: the value is quantized, the gradient is the identity.
    The scales come from the current weights at every step, so the deployed
    scales are the final weights' (:func:`quantize_conv_stack`)."""
    s = weight_scales(w)
    wq = torch.round(w / s).clamp(-127, 127) * s
    return w + (wq - w).detach()


def fq_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """STE fake-quant of a conv input with a fixed per-tensor scale (the
    quotient rounded as ``quantized.quantize_act`` rounds it)."""
    s = torch.tensor(scale, dtype=x.dtype).to(x.device)
    xq = torch.round(x / s).clamp(-127, 127) * scale
    return x + (xq - x).detach()


# ---------------------------------------------------------------------------
# conv-stack (conv3/conv5 family, fused deployment form) int8 paths
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate_conv_stack(params: Params, cfg: ConvStackConfig, frames: List[np.ndarray], *,
                         relu_before_residual_add: bool = False) -> Dict[str, float]:
    """Each conv input's max |x| over calibration frames (sRGB [0, 1] float,
    the conv stacks' deployment domain), divided by 127; fp32 on the
    parameters' device (no TF32)."""
    dev = params["conv1"]["w"].device
    out = {f"conv{i + 1}": 0.0 for i in range(len(cfg.channels))}

    def conv(name, t):
        # record the conv's input, then run the real conv: _stack_forward
        # supplies the order
        out[name] = max(out[name], float(t.abs().max()))
        return conv2d(params[name], t)

    for f in frames:
        x = torch.as_tensor(np.asarray(f, np.float32), device=dev)
        x = x[None] if x.dim() == 3 else x
        with no_tf32():
            _stack_forward(conv, x, cfg, relu_before_residual_add)
    return {k: max(v, 1e-6) / 127.0 for k, v in out.items()}


def _stack_forward(conv: Callable[[str, torch.Tensor], torch.Tensor], x: torch.Tensor,
                   cfg: ConvStackConfig, relu_before_residual_add: bool) -> torch.Tensor:
    """The fused stack's control flow around a pluggable conv (the one copy
    of ``models.conv_stack.apply_fused``'s semantics here)."""
    n_layers = len(cfg.channels)

    def act(t, is_last):
        if not is_last:
            return torch.relu(t)
        return torch.sigmoid(t) if cfg.final_act == "sigmoid" else t

    for i in range(n_layers):
        skip = x if i in cfg.residual_layers else None
        x = conv(f"conv{i + 1}", x)
        is_last = i == n_layers - 1
        if relu_before_residual_add:
            x = act(x, is_last)
            if skip is not None:
                x = skip + x
        else:
            if skip is not None:
                x = skip + x
            x = act(x, is_last)
    return x


def apply_fused_fakequant(params: Params, x: torch.Tensor, cfg: ConvStackConfig,
                          act_scales: Dict[str, float], *,
                          relu_before_residual_add: bool = False) -> torch.Tensor:
    """The differentiable int8-simulated forward (the QAT training graph),
    accumulating in ``x.dtype``: full fp32 on a card (TF32 off, scoped to
    the convs, as JAX's ``Precision.HIGHEST``); the bias added after the
    conv, as in JAX."""

    def conv(name, t):
        p = params[name]
        t = fq_act(t, act_scales[name])
        w = fq_weight(p["w"].to(t.dtype))
        with no_tf32():
            y = conv2d({"w": w}, t)
        if "b" in p:
            y = y + p["b"].to(t.dtype)
        return y

    return _stack_forward(conv, x, cfg, relu_before_residual_add)


def quantize_conv_stack(params: Params) -> Params:
    """Fused conv-stack weights frozen to int8, with the scales
    :func:`fq_weight` trained against (``quantized.quantize_weight``)."""
    return {name: quantize_weight(p) for name, p in params.items()}


def apply_fused_int8(qparams: Params, x: torch.Tensor, cfg: ConvStackConfig,
                     act_scales: Dict[str, float], *,
                     relu_before_residual_add: bool = False) -> torch.Tensor:
    """The int8 deployment forward: int8 x int8 -> int32 through
    ``quantized._qconv`` (``torch._int_mm``, cuBLASLt's int8 tensor-core
    product on a card)."""

    def conv(name, t):
        return _qconv(qparams[name], t, act_scales[name])

    return _stack_forward(conv, x, cfg, relu_before_residual_add)


# ---------------------------------------------------------------------------
# QAT distillation finetune
# ---------------------------------------------------------------------------

def qat_distill_conv_stack(
    params: Params,
    cfg: ConvStackConfig,
    sample_batches: List[np.ndarray],
    *,
    relu_before_residual_add: bool = False,
    steps: int = 300,
    lr: float = 2e-5,
    act_scales: Dict[str, float] = None,
    verbose: int = 1,
) -> Tuple[Params, Dict[str, float], List[float]]:
    """Fine-tune fused weights under fake-quant to match the fp32 model.

    ``sample_batches``: NHWC sRGB [0, 1] float arrays (crops of real frames),
    moved to the parameters' device. The teacher is the fp32
    ``models.conv_stack.apply_fused`` of the initial parameters; the student
    starts at the same weights with quantizers inserted and trains with
    optax's ``adam(lr)`` (``parallel.train_step.make_optimizer`` without
    weight decay or schedule) on the Charbonnier mean ``sqrt(d^2 + 1e-12)``.
    Returns (trained fp32 parameters, act_scales, loss curve); deploy with
    :func:`quantize_conv_stack` and the returned act_scales."""
    from ..models.conv_stack import apply_fused
    from ..parallel.train_step import make_optimizer

    if act_scales is None:
        act_scales = calibrate_conv_stack(params, cfg, sample_batches[:4],
                                          relu_before_residual_add=relu_before_residual_add)
    dev = params["conv1"]["w"].device
    teacher = {k: {n: t.detach() for n, t in p.items()} for k, p in params.items()}
    student = {k: {n: t.detach().clone().requires_grad_(True) for n, t in p.items()}
               for k, p in params.items()}
    leaves = [t for p in student.values() for t in p.values()]
    opt, _sched = make_optimizer(lr, weight_decay=0.0)(leaves)

    curve: List[float] = []
    for s in range(steps):
        x = torch.as_tensor(np.asarray(sample_batches[s % len(sample_batches)], np.float32),
                            device=dev)
        with torch.no_grad():
            y_t = apply_fused(teacher, x, cfg, relu_before_residual_add=relu_before_residual_add)
        y_s = apply_fused_fakequant(student, x, cfg, act_scales,
                                    relu_before_residual_add=relu_before_residual_add)
        loss = torch.sqrt((y_s - y_t) ** 2 + 1e-6 ** 2).mean()
        opt.zero_grad(set_to_none=True)
        with no_tf32():
            loss.backward()
        opt.step()
        curve.append(float(loss.detach()))
        if verbose and (s % 50 == 0 or s == steps - 1):
            print(f"  qat step {s}: distill loss {curve[-1]:.6f}", flush=True)
    trained = {k: {n: t.detach() for n, t in p.items()} for k, p in student.items()}
    return trained, act_scales, curve

"""int8 inference of the lightweight pix_shuffle model.

Port of ``fs_uae_image_enhancer_project_tpu/export/quantized.py``. The JAX
package measured this path on its TPU as a negative (int8 ran at bf16 rate
there); that verdict does not carry over to the H100, whose dense int8 rate
is twice its bf16 rate. ``scripts/bench_int8_qat.py`` of this package
measures it on the card. Nothing on the served path dispatches here.

The scheme is the JAX package's:

- weights: symmetric int8 per output channel (scale from max |w|);
- conv inputs: symmetric int8 per tensor, with static scales from a
  calibration pass over real frames (the activations between convs stay in
  the compute dtype);
- each conv accumulates in int32 and is dequantized by ``x_scale *
  w_scale[cout]``, then the bias is added.

torch has no int8 convolution, so :func:`_qconv` is a zero-padded im2col
(NHWC, ``SAME``, the ``(kh, kw, cin)`` order of an HWIO weight) and
``torch._int_mm`` (cuBLASLt's int8 tensor-core product on a card, to
int32). cuBLASLt wants K and N multiples of 8 and, at some shapes, the
rows a multiple of 32, so K, ``cout`` and the rows are padded with zeros
(which keeps the integer sums exact) and the output sliced; the CPU takes
the same padded product.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..models.configs import PixShuffleConfig
from ..models.pix_shuffle import _acts
from ..ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle

Params = Dict[str, dict]

CONV_ORDER = ["conv1", "conv2", "conv3", "conv4", "conv5", "conv6", "conv7"]


def quantize_weight(p: dict) -> dict:
    """Per-output-channel symmetric int8 quantization of one conv's
    parameters (the single copy of the scheme, shared with ``export/qat.py``):
    ``{"w_q": int8 HWIO, "w_scale": fp32 (cout,), "b": as given}`` on the
    weight's device."""
    wt = p["w"]
    w = wt.detach().to("cpu", torch.float32).numpy()
    scale = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    q = {"w_q": torch.from_numpy(w_q).to(wt.device),
         "w_scale": torch.from_numpy(scale.astype(np.float32)).to(wt.device)}
    if "b" in p:
        q["b"] = p["b"]
    return q


def quantize_weights(params: Params) -> Params:
    """Every conv weight of the pix_shuffle model to int8."""
    q: Params = dict(params)
    for name in CONV_ORDER + ["skip1_proj", "skip2_proj"]:
        if name in params:
            q[name] = quantize_weight(params[name])
    return q


def quantize_act(x: torch.Tensor, x_scale: float) -> torch.Tensor:
    """``clip(round(x / x_scale), -127, 127)`` as int8, rounded as JAX rounds
    it: the Python scale is first rounded to ``x.dtype`` (JAX's weak type),
    the quotient is a true division (a device tensor: torch multiplies by the
    reciprocal for a scalar divisor) rounded to ``x.dtype``, then rounded
    half to even."""
    s = torch.tensor(x_scale, dtype=x.dtype).to(x.device, torch.float32)
    q = (x.float() / s).to(x.dtype)
    return torch.round(q).clamp(-127, 127).to(torch.int8)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def im2col(xq: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(N, H, W, C) -> (N*H*W, K8), ``SAME`` zero padding (XLA's: the lower
    side takes the smaller half), columns in ``(dy, dx, c)`` order and zero
    columns up to K8, the next multiple of 8 of ``kh*kw*C``."""
    n, h, w, c = xq.shape
    ph, pw = kh - 1, kw - 1
    xp = F.pad(xq, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    cols = [xp[:, dy:dy + h, dx:dx + w] for dy in range(kh) for dx in range(kw)]
    k = kh * kw * c
    if _round8(k) > k:
        cols.append(xq.new_zeros((n, h, w, _round8(k) - k)))
    return torch.cat(cols, dim=-1).reshape(n * h * w, -1)


def qconv_acc(w_q: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """The int32 accumulators of an int8 ``SAME`` conv: (N, H, W, cout)
    from int8 NHWC codes and an int8 HWIO weight, through ``torch._int_mm``."""
    kh, kw, cin, cout = w_q.shape
    n, h, w, _ = xq.shape
    cols = im2col(xq, kh, kw)
    k8, n8 = cols.shape[1], _round8(cout)
    wm = F.pad(w_q.reshape(kh * kw * cin, cout), (0, n8 - cout, 0, k8 - kh * kw * cin))
    rows = cols.shape[0]
    if rows % 32:
        # zero rows: on an H100 cuBLASLt refuses (NOT_SUPPORTED) some row
        # counts that are not multiples of 32 at small K, e.g. 680 x 32
        # (tests/test_torch_cuda.py::test_qconv_accumulators_equal_the_cpu)
        cols = F.pad(cols, (0, 0, 0, 32 - rows % 32))
    # B row-major: column-major B is faster where cuBLASLt takes it, but it
    # refuses that layout at some shapes (scripts/bench_int8_qat.py's conv2
    # breakdown times both)
    acc = torch._int_mm(cols, wm.contiguous())
    return acc[:rows, :cout].reshape(n, h, w, cout)


def _qconv(qp: dict, x: torch.Tensor, x_scale: float) -> torch.Tensor:
    """int8 conv: the input quantized with its static scale, int32
    accumulation, dequantized per output channel, then the bias, in
    ``x.dtype``."""
    y = qconv_acc(qp["w_q"], quantize_act(x, x_scale))
    y = y.float() * (qp["w_scale"] * x_scale)
    if "b" in qp:
        y = y + qp["b"].float()
    return y.to(x.dtype)


@torch.no_grad()
def calibrate(params: Params, cfg: PixShuffleConfig,
              frames: List[np.ndarray]) -> Dict[str, float]:
    """Each conv input's max |x| over calibration frames (linear-light float
    (H, W, 3) or (1, H, W, 3) arrays, as the enhance wrapper makes them),
    divided by 127. Every input comes from the model's own taps
    (``models.pix_shuffle.apply_with_intermediates``): conv1 sees the
    unshuffled input, conv k+1 layer k's output, conv6 concat(layer1,
    layer5). fp32 on the parameters' device (no TF32)."""
    from ..models.pix_shuffle import apply_with_intermediates
    from ..ops.conv import no_tf32

    dev = params["conv1"]["w"].device
    maxes = {name: 0.0 for name in CONV_ORDER}
    for frame in frames:
        x = torch.as_tensor(np.asarray(frame, np.float32), device=dev)
        x = x[None] if x.dim() == 3 else x
        with no_tf32():
            _y, caps = apply_with_intermediates(params, x, cfg)
        u = pixel_unshuffle(x, cfg.shuffle_factor)

        def amax(t):
            return t.abs().max()

        stats = {
            "conv1": amax(u), "conv2": amax(caps["layer1"]), "conv3": amax(caps["layer2"]),
            "conv4": amax(caps["layer3"]), "conv5": amax(caps["layer4"]),
            "conv6": torch.maximum(amax(caps["layer1"]), amax(caps["layer5"])),
            "conv7": amax(caps["layer6"]),
        }
        for k, v in stats.items():
            maxes[k] = max(maxes[k], float(v))
    return {k: max(v, 1e-6) / 127.0 for k, v in maxes.items()}


def apply_quantized(qparams: Params, x: torch.Tensor, cfg: PixShuffleConfig,
                    scales: Dict[str, float]) -> torch.Tensor:
    """The int8 forward, mirroring ``models.pix_shuffle._forward``."""
    identity = x
    t = pixel_unshuffle(x, cfg.shuffle_factor)
    t = _qconv(qparams["conv1"], t, scales["conv1"])
    t = _acts(qparams, cfg, 1, (1, 2), t)
    long_skip = t
    short = t
    t2 = _qconv(qparams["conv2"], t, scales["conv2"])
    t2 = _acts(qparams, cfg, 2, (1, 2), t2)
    if "skip1_proj" in qparams:
        short = _qconv(qparams["skip1_proj"], short, scales["conv2"])
    t = short + t2
    t = _acts(qparams, cfg, 2, (3, 4), t)
    t = _qconv(qparams["conv3"], t, scales["conv3"])
    t = _acts(qparams, cfg, 3, (1, 2), t)
    short = t
    t2 = _qconv(qparams["conv4"], t, scales["conv4"])
    t2 = _acts(qparams, cfg, 4, (1, 2), t2)
    if "skip2_proj" in qparams:
        short = _qconv(qparams["skip2_proj"], short, scales["conv4"])
    t = short + t2
    t = _acts(qparams, cfg, 4, (3, 4), t)
    t = _qconv(qparams["conv5"], t, scales["conv5"])
    t = _acts(qparams, cfg, 5, (1, 2), t)
    t = torch.cat([long_skip, t], dim=-1)
    t = _qconv(qparams["conv6"], t, scales["conv6"])
    t = _acts(qparams, cfg, 6, (1, 2), t)
    t = _qconv(qparams["conv7"], t, scales["conv7"])
    t = _acts(qparams, cfg, 7, (1, 2), t)
    t = pixel_shuffle(t, cfg.shuffle_factor)
    return torch.relu(identity + t)


def make_quantized_enhance(
    params: Params,
    cfg: PixShuffleConfig,
    calibration_frames: List[np.ndarray],
    *,
    compute_dtype=torch.bfloat16,
    crop_left: int = 0,
    srgb_to_linear_exponent: float = 2.2,
    linear_to_srgb_exponent: float = 0.4546,
    device=None,
):
    """The int8 uint8-RGBA enhance on ``device`` (default ``cuda``; the
    parameters' device). ``calibration_frames`` are linear-light float
    (H, W, 3) arrays. The default ``linear_to_srgb_exponent`` is the JAX
    function's 0.4546, not ``make_enhance_fn``'s 1/2.2."""
    from .enhance import make_enhance_fn

    scales = calibrate(params, cfg, calibration_frames)
    qparams = quantize_weights(params)
    return make_enhance_fn(
        functools.partial(apply_quantized, cfg=cfg, scales=scales), qparams,
        crop_left=crop_left, compute_dtype=compute_dtype,
        srgb_to_linear_exponent=srgb_to_linear_exponent,
        linear_to_srgb_exponent=linear_to_srgb_exponent, device=device)

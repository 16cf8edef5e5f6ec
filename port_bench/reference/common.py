"""The plain reference's shared parts: the uint8 RGBA wrapper contract, the
activations and a convolution in a stated precision.

Plain PyTorch in float32 (TF32 off), NCHW. Nothing here imports the program.
The wrapper contract of a shipped enhance graph, uint8 ``(N, H, W, 4)`` RGBA
in and out:

- alpha dropped, the frame's width cropped on the left by ``crop_left``;
- ``/255``, then ``pow`` by the graph's sRGB-to-linear exponent;
- the model, whose output is clamped at 0 and raised to the graph's
  linear-to-sRGB exponent;
- ``x255``, clipped to [0, 255] and truncated to uint8; the cropped columns
  black, alpha 255.

A configuration's module (``pix_shuffle.py``, ``conv6.py``,
``residual_unet.py``) gives the model's frozen forward over the graph's
initializers, by name, and the op types that its graph must hold: ``OPS``,
or ``ops(initializers)`` where they follow from the graph's depth. A graph
made from a seed is read for its op types only: its initializers are the
benchmark's own (``seeded.py``), from which the program wrote it.
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import seeded
from .onnx_reader import read_graph

PRECISIONS = ("fp32", "fp8")


def sinlu(x, a, b):
    return torch.sigmoid(x) * (x + a * torch.sin(b * x))


def mish(x):
    return x * torch.tanh(F.softplus(x))


def telu(x):
    return x * torch.tanh(torch.exp(x))


def prelu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def relu6(x):
    return x.clamp(0.0, 6.0)


def channel(v: torch.Tensor) -> torch.Tensor:
    """A per-channel (or scalar) activation parameter, broadcast over NCHW."""
    return v.reshape(1, -1, 1, 1)


class Conv:
    """3x3 SAME convolutions with float32 accumulation, in the input's dtype.
    ``fp8`` rounds each convolution's input and weight to float8 e4m3 first."""

    def __init__(self, weights: dict, precision: str = "fp32"):
        self.w, self.precision = weights, precision

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return t.to(torch.float8_e4m3fn).float()
        return t.float()

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.w[f"{name}.weight"]
        y = F.conv2d(self._round(x), self._round(w), None, padding=w.shape[-1] // 2)
        return (y + channel(self.w[f"{name}.bias"]).float()).to(x.dtype)


class Reference:
    """One configuration's reference enhance, from its shipped graph.

    ``fp32`` is the plain reference. ``fp8`` is the control, one precision
    below the configuration's bfloat16: the model's convolutions take float8
    e4m3 operands, and its other operations run in bfloat16, as the program
    runs them (the wrapper's gamma stays float32)."""

    def __init__(self, config: dict, graph_path: str, device, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.dtype = torch.float32 if precision == "fp32" else torch.bfloat16
        self.model = importlib.import_module(f"{__package__}.{config['name']}")
        graph = read_graph(graph_path)
        inits = graph.initializers
        ops = [n.op_type for n in graph.nodes]
        expected = self.model.ops(inits) if hasattr(self.model, "ops") else self.model.OPS
        if ops != expected:
            raise ValueError(f"{graph_path} is not the graph the frozen {config['name']} "
                             f"forward was written for: its op types are {ops}")
        if "graph_from_seed" in config:
            inits = seeded.initializers(config)
        self.device = torch.device(device)
        self.s2l = float(inits["gamma_srgb_to_linear_exponent"])
        self.l2s = float(inits["gamma_linear_to_srgb_exponent"])
        self.crop_left = int(config["wrapper"]["crop_left"])
        self.weights = {
            k: torch.as_tensor(np.asarray(v, np.float32), device=self.device).to(
                torch.float32 if k.endswith(".weight") else self.dtype)
            for k, v in inits.items() if np.issubdtype(v.dtype, np.floating)}
        self.conv = Conv(self.weights, precision)

    @torch.no_grad()
    def __call__(self, frames) -> torch.Tensor:
        """uint8 (N, H, W, 4) RGBA frames -> the enhanced uint8 frames, on the
        reference's device."""
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            u8 = torch.as_tensor(frames).to(self.device)
            n, h, w, _ = u8.shape
            c = self.crop_left
            x = u8[:, :, c:, :3].permute(0, 3, 1, 2).float() / 255.0
            x = x ** self.s2l
            y = self.model.forward(self.weights, self.conv, x.to(self.dtype)).float()
            y = y.clamp(min=0.0) ** self.l2s
            y = torch.floor((y * 255.0).clamp(0.0, 255.0)).to(torch.uint8)
            out = torch.zeros((n, h, w, 4), dtype=torch.uint8, device=self.device)
            out[:, :, c:, :3] = y.permute(0, 2, 3, 1)
            out[..., 3] = 255
            return out
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def enhanced_in_blocks(ref: Reference, frames: np.ndarray, block: int = 4) -> np.ndarray:
    """The reference's uint8 output of ``frames`` on the host, ``block``
    frames at a time, so that it fits beside whatever the device holds."""
    out = [ref(frames[i:i + block]).cpu().numpy() for i in range(0, len(frames), block)]
    return np.concatenate(out) if out else frames[:0]


def differences(a: np.ndarray, b: np.ndarray) -> dict:
    """How two uint8 frames differ, in levels over every byte (alpha
    included): the mean absolute difference, the root mean square and the
    largest."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16)).astype(np.float64)
    return {"mae": float(d.mean()), "rmse": math.sqrt(float(np.mean(d * d))),
            "max": int(d.max())}

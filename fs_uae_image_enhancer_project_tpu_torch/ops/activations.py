"""Functional activation registry on NHWC tensors.

Port of ``fs_uae_image_enhancer_project_tpu/ops/activations.py``: the 20
names of the reference registry, including the custom TeLU, ScaledTanh,
SinLU, BiasedReLU and BiasedPReLU. Activations are functions over
``(params, x)``. The learnable ones (prelu, sinlu, biased_relu,
biased_prelu) keep their parameters in a small dict made by
:func:`init_activation`; parameter-free ones get an empty dict, so every
slot has one interface. "Per-channel" parameters broadcast over the trailing
channel axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _gelu(x, approximate: str = "none"):
    if approximate not in ("none", "tanh"):
        raise ValueError(
            f"gelu approximate must be 'none' or 'tanh', got {approximate!r}"
        )
    return F.gelu(x, approximate=approximate)


def _telu(x):
    """TeLU: x * tanh(exp(x))."""
    return x * torch.tanh(torch.exp(x))


def _scaled_tanh(x):
    """(tanh(x) + 1) / 2, which maps to [0, 1]."""
    return (torch.tanh(x) + 1.0) * 0.5


_SIMPLE = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,  # alias, as in the reference registry
    "mish": _mish,
    "telu": _telu,
    "scaled_tanh": _scaled_tanh,
}

# configurable but parameter-free (config values are static python numbers)
_CONFIGURED = {"elu", "gelu", "leaky_relu", "softplus", "softmax", "log_softmax"}

_LEARNABLE = {"prelu", "sinlu", "biased_relu", "biased_prelu"}

ACTIVATION_NAMES = sorted(set(_SIMPLE) | _CONFIGURED | _LEARNABLE)

# accepted config keys per activation; anything else raises, as a misspelled
# key raises TypeError in the reference's module constructors
_ALLOWED_CONFIG: Dict[str, frozenset] = {
    "elu": frozenset({"alpha"}),
    "gelu": frozenset({"approximate"}),
    "leaky_relu": frozenset({"negative_slope"}),
    "softplus": frozenset({"beta", "threshold"}),
    "softmax": frozenset({"axis"}),
    "log_softmax": frozenset({"axis"}),
    "prelu": frozenset({"num_parameters", "init"}),
    "sinlu": frozenset(),
    "biased_relu": frozenset({"num_parameters"}),
    "biased_prelu": frozenset({"num_parameters", "init"}),
}


def _canonical(name: str) -> str:
    n = name.lower()
    if n not in _SIMPLE and n not in _CONFIGURED and n not in _LEARNABLE:
        raise ValueError(
            f"Unsupported activation: '{name}'. Supported: {ACTIVATION_NAMES}"
        )
    return n


def _check_config(n: str, config: Dict[str, Any]) -> None:
    allowed = _ALLOWED_CONFIG.get(n, frozenset())
    unknown = set(config) - allowed
    if unknown:
        raise TypeError(
            f"activation '{n}' got unexpected config key(s) "
            f"{sorted(unknown)}; allowed: {sorted(allowed)}"
        )


def init_activation(
    name: str,
    config: Optional[Dict[str, Any]] = None,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Params:
    """Parameter dict for one activation slot (fp32, on ``device``).

    ``config`` mirrors the reference factory's ``params`` kwarg, e.g.
    ``{'num_parameters': 36}`` for per-channel prelu variants. The random
    biases of biased_relu/biased_prelu are drawn from ``generator`` on the CPU
    and then moved, so a seed gives the same values on every device.
    """
    n = _canonical(name)
    config = dict(config or {})
    _check_config(n, config)
    f32 = torch.float32

    def uniform(num):
        u = torch.rand((num,), generator=generator, dtype=f32)
        return (u * 0.2 - 0.1).to(device)

    if n == "prelu":
        num = int(config.get("num_parameters", 1))
        init = float(config.get("init", 0.25))
        return {"slope": torch.full((num,), init, dtype=f32, device=device)}
    if n == "sinlu":
        # sigmoid(x) * (x + a*sin(b*x)), a = b = 1 at init
        return {"a": torch.ones((1,), dtype=f32, device=device),
                "b": torch.ones((1,), dtype=f32, device=device)}
    if n == "biased_relu":
        return {"bias": uniform(int(config.get("num_parameters", 1)))}
    if n == "biased_prelu":
        num = int(config.get("num_parameters", 1))
        init = float(config.get("init", 0.25))
        return {"bias": uniform(num),
                "slope": torch.full((num,), init, dtype=f32, device=device)}
    return {}


def _bcast_channel(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a (num_parameters,) vector across the NHWC channel axis:
    per-channel when num_parameters == C, a scalar when it is 1."""
    if p.shape[0] == x.shape[-1]:
        return p.to(x.dtype)
    if p.shape[0] != 1:
        raise ValueError(
            f"activation has {p.shape[0]} per-channel parameters but the "
            f"input has {x.shape[-1]} channels"
        )
    return p.reshape(()).to(x.dtype)


def apply_activation(
    name: str,
    params: Params,
    x: torch.Tensor,
    config: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Apply activation ``name`` with parameter dict ``params`` and ``config``."""
    n = _canonical(name)
    config = dict(config or {})
    _check_config(n, config)

    if n in _SIMPLE:
        return _SIMPLE[n](x)
    if n == "elu":
        return F.elu(x, alpha=float(config.get("alpha", 1.0)))
    if n == "gelu":
        return _gelu(x, str(config.get("approximate", "none")))
    if n == "leaky_relu":
        return F.leaky_relu(x, float(config.get("negative_slope", 0.01)))
    if n == "softplus":
        # torch switches to identity above threshold, as the JAX port does
        return F.softplus(x, beta=float(config.get("beta", 1.0)),
                          threshold=float(config.get("threshold", 20.0)))
    if n == "softmax":
        return torch.softmax(x, dim=int(config.get("axis", -1)))
    if n == "log_softmax":
        return torch.log_softmax(x, dim=int(config.get("axis", -1)))
    if n == "prelu":
        slope = _bcast_channel(params["slope"], x)
        return torch.where(x >= 0, x, slope * x)
    if n == "sinlu":
        a = params["a"].reshape(()).to(x.dtype)
        b = params["b"].reshape(()).to(x.dtype)
        return torch.sigmoid(x) * (x + a * torch.sin(b * x))
    if n == "biased_relu":
        return torch.relu(x - _bcast_channel(params["bias"], x))
    if n == "biased_prelu":
        shifted = x - _bcast_channel(params["bias"], x)
        slope = _bcast_channel(params["slope"], x)
        return torch.where(shifted >= 0, shifted, slope * shifted)
    raise AssertionError(f"unreachable: {n}")

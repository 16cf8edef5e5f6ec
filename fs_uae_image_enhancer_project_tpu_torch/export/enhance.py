"""The deployed enhance function: uint8 RGBA frames in, uint8 RGBA frames out.

Port of ``fs_uae_image_enhancer_project_tpu/export/enhance.py``, every
family of the JAX package. Contract: uint8 ``(N, 576, 752, 4)`` RGBA chunky
-> uint8 ``(N, 576, 752, 4)`` RGBA chunky:

- alpha dropped, optional left crop (16 for the current exporter, 0 for the
  shipped ``pix_shuffle.onnx``);
- ``/255`` then ``pow 2.2`` in fp32 (bf16 pow costs about 2 dB); the conv
  stacks (conv3, conv5) work in the sRGB domain and skip the gamma pair;
- the model in ``compute_dtype`` (bf16 by default). On a card the
  lightweight pix_shuffle model runs as the fused-stack CUDA kernel; the
  other families run eager (cuDNN's convolutions), as the JAX package runs
  them outside any Pallas kernel;
- ``pow 1/2.2``, ``x255``, clip, uint8 (truncating, as XLA's convert),
  the crop padded back with black, alpha 255.

:func:`make_enhance_fn` runs the two ends eagerly around ``model_apply``
(:func:`to_model_input`, :func:`to_uint8`). For the lightweight pix_shuffle
graph on a card, :func:`enhance_from_onnx` returns
``ops/cuda/fused_enhance.py``'s enhance instead: one kernel launch a call,
with both ends folded into K1 through tables made from these two functions.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from .. import CROP_LEFT, resolve_device
from ..utils.profiler import span


def frames_on(frames, dev: torch.device) -> torch.Tensor:
    """``frames`` (an array or a tensor) as a tensor on ``dev``; the move of
    a host batch to a card, as the frame server hands one over, is the span
    ``fse.upload``."""
    frames = torch.as_tensor(frames)
    if frames.device.type == dev.type:
        return frames.to(dev, non_blocking=True)
    with span("fse.upload"):
        return frames.to(dev, non_blocking=True)


def to_model_input(rgb: torch.Tensor, *, compute_dtype=torch.bfloat16, srgb_domain: bool = False,
                   exponent: float = 2.2) -> torch.Tensor:
    """The prologue's arithmetic on uint8 colour values: ``/255``, ``pow``
    (unless ``srgb_domain``) in fp32, then ``compute_dtype``."""
    x = rgb.float() / 255.0
    if not srgb_domain:
        x = x ** exponent
    return x.to(compute_dtype)


def to_uint8(y: torch.Tensor, *, srgb_domain: bool = False, exponent: float = 1.0 / 2.2
             ) -> torch.Tensor:
    """The epilogue's arithmetic on the model's output: fp32, ``clamp(min=0)``
    and ``pow`` (unless ``srgb_domain``), ``x255``, clip, uint8."""
    y = y.float()
    if not srgb_domain:
        y = y.clamp(min=0.0) ** exponent
    return (y * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def make_enhance_fn(
    model_apply: Callable,
    params,
    *,
    crop_left: int = CROP_LEFT,
    compute_dtype=torch.bfloat16,
    srgb_domain: bool = False,
    srgb_to_linear_exponent: float = 2.2,
    linear_to_srgb_exponent: float = 1.0 / 2.2,
    device=None,
):
    """Build ``enhance(frames_u8) -> frames_u8`` over NHWC uint8 RGBA batches.

    ``model_apply(params, x)`` maps NHWC float -> NHWC float at the same
    spatial size; ``params`` live on ``device`` (default ``cuda``). Frames may
    be numpy arrays or tensors; they are moved to ``device``, and the result
    is a uint8 tensor there. ``srgb_domain=True`` skips the gamma pair.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def enhance(frames) -> torch.Tensor:
        with span("fse.enhance"):
            frames = frames_on(frames, dev)
            with span("fse.enhance.prologue"):
                if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 4:
                    raise ValueError(
                        "enhance expects uint8 RGBA NHWC frames, got "
                        f"{frames.dtype} {tuple(frames.shape)}"
                    )
                n, h, w, _ = frames.shape
                x = to_model_input(frames[:, :, crop_left:, :3], compute_dtype=compute_dtype,
                                   srgb_domain=srgb_domain, exponent=srgb_to_linear_exponent)
            with span("fse.enhance.model"):
                y = model_apply(params, x)
            with span("fse.enhance.epilogue"):
                y = to_uint8(y, srgb_domain=srgb_domain, exponent=linear_to_srgb_exponent)
                out = torch.empty((n, h, w, 4), dtype=torch.uint8, device=dev)
                out[:, :, :crop_left, :3] = 0
                out[:, :, crop_left:, :3] = y
                out[..., 3] = 255
            return out

    return enhance


def default_enhance_fn(variant: str = "lightweight", seed: int = 0, *, device=None, **kwargs):
    """Enhance fn over a freshly initialized pix_shuffle model, seeded."""
    from ..models import get_model

    m = get_model("pix_shuffle", variant)
    params = m.init(torch.Generator().manual_seed(seed), device=device)
    return make_enhance_fn(m.apply, params, device=device, **kwargs), params


def _leaf_shapes(tree, prefix: str = "") -> dict:
    """{dotted path: shape} of a nested dict's leaves (empty dicts have none)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_shapes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def _graft_onto(shape_node, param_node):
    """Rebuild imported parameters in ``init``'s structure: it restores the
    empty dicts of parameter-free activation slots, which the ONNX round
    trip cannot carry."""
    if isinstance(shape_node, dict):
        return {k: _graft_onto(v, param_node.get(k) if isinstance(param_node, dict) else None)
                for k, v in shape_node.items()}
    return np.asarray(param_node, np.float32)


def _match_structure(model_def, params):
    """``params`` grafted onto ``model_def.init``'s structure if every leaf
    (by path and shape) matches, else None. The structure comes from an
    ``init`` on the meta device, which allocates and draws nothing."""
    with torch.device("meta"):
        shapes = model_def.init(device="meta")
    if _leaf_shapes(shapes) != _leaf_shapes(params):
        return None
    return _graft_onto(shapes, params)


def enhance_from_onnx(path: str, *, device=None, **kwargs):
    """Enhance fn with the weights of a shipped ONNX artifact (or one the
    exporter wrote), reproducing that artifact's wrapper contract (crop,
    gamma exponents or the sRGB domain). pix_shuffle takes the lightweight
    config only, and its enhance is ``ops/cuda/fused_enhance.py``'s (on a
    card one launch of K1 a call); conv6 and the U-Net must match their
    ``init``'s structure;
    the conv stacks take the deployed graphs' semantics (ReLU before the
    residual add, no final sigmoid)."""
    from ..interop import params_from_jax
    from ..models import get_model
    from .onnx_import import import_any

    imp = import_any(path)
    contract = dict(crop_left=imp.crop_left,
                 srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
                 linear_to_srgb_exponent=imp.linear_to_srgb_exponent,
                 device=device, **kwargs)
    if imp.kind in ("conv6", "residual_unet"):
        variants = ("lightweight",) if imp.kind == "conv6" else ("lightweight", "heavyweight")
        for variant in variants:
            m = get_model(imp.kind, variant)
            params = _match_structure(m, imp.params)
            if params is not None:
                return make_enhance_fn(m.apply, params_from_jax(params, device=device), **contract)
        raise ValueError(
            f"artifact {path} matches no {imp.kind} variant of {list(variants)}; "
            "build the enhance fn with make_enhance_fn and the matching config"
        )
    if imp.kind == "pix_shuffle":
        # only the lightweight config is reconstructable (activation specs
        # are not recoverable from weights alone)
        expected = [36, 36, 72, 72, 36, 36, 12]
        got = [imp.params[f"conv{i + 1}"]["w"].shape[-1] for i in range(7)]
        if got != expected:
            raise ValueError(
                f"artifact {path} has conv channels {got}, not the lightweight "
                f"pix_shuffle {expected}; build the enhance fn with make_enhance_fn "
                "and the matching config"
            )
        from ..ops.cuda.fused_enhance import make_fused_enhance_fn

        return make_fused_enhance_fn(params_from_jax(imp.params, device=device), **contract)
    # the conv stacks' deployed graphs: sRGB domain, ReLU before the add
    from ..models.configs import ConvStackConfig
    from ..models.conv_stack import apply_fused

    cfg = ConvStackConfig(
        channels=tuple(imp.params[f"conv{i + 1}"]["w"].shape[-1]
                       for i in range(imp.num_conv_layers)),
        residual_layers=imp.residual_layers,
        final_act="none",
    )
    return make_enhance_fn(
        functools.partial(apply_fused, cfg=cfg,
                          relu_before_residual_add=imp.relu_before_residual_add),
        params_from_jax(imp.params, device=device),
        crop_left=0, srgb_domain=True, device=device, **kwargs,
    )

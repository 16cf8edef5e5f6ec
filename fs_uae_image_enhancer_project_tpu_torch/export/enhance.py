"""The deployed enhance function: uint8 RGBA frames in, uint8 RGBA frames out.

Port of ``fs_uae_image_enhancer_project_tpu/export/enhance.py`` for the
pix_shuffle kind. Contract: uint8 ``(N, 576, 752, 4)`` RGBA chunky ->
uint8 ``(N, 576, 752, 4)`` RGBA chunky:

- alpha dropped, optional left crop (16 for the current exporter, 0 for the
  shipped ``pix_shuffle.onnx``);
- ``/255`` then ``pow 2.2`` in fp32 (bf16 pow costs about 2 dB);
- the model in ``compute_dtype`` (bf16 by default). On a card the
  lightweight pix_shuffle model runs as the fused-stack CUDA kernel;
- ``pow 1/2.2``, ``x255``, clip, uint8 (truncating, as XLA's convert),
  the crop padded back with black, alpha 255.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import CROP_LEFT, resolve_device


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
        frames = torch.as_tensor(frames).to(dev, non_blocking=True)
        if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 4:
            raise ValueError(
                f"enhance expects uint8 RGBA NHWC frames, got {frames.dtype} {tuple(frames.shape)}"
            )
        n, h, w, _ = frames.shape
        x = frames[:, :, crop_left:, :3].float() / 255.0
        if not srgb_domain:
            x = x ** srgb_to_linear_exponent
        y = model_apply(params, x.to(compute_dtype)).float()
        if not srgb_domain:
            y = y.clamp(min=0.0) ** linear_to_srgb_exponent
        y = (y * 255.0).clamp(0.0, 255.0).to(torch.uint8)
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


def enhance_from_onnx(path: str, *, device=None, **kwargs):
    """Enhance fn with the weights of a pix_shuffle ONNX artifact, reproducing
    that artifact's wrapper contract (crop and gamma exponents)."""
    from ..interop import params_from_jax
    from ..models import get_model
    from .onnx_import import artifact_kind, import_pix_shuffle
    from .onnx_proto import load_model

    model = load_model(path)
    kind = artifact_kind(model)
    if kind != "pix_shuffle":
        raise NotImplementedError(
            f"artifact {path} is a {kind} graph; only pix_shuffle is ported so "
            "far (the other families come with slice C of the port)"
        )
    imp = import_pix_shuffle(path, model=model)
    # only the lightweight config is reconstructable (activation specs are
    # not recoverable from weights alone)
    expected = [36, 36, 72, 72, 36, 36, 12]
    got = [imp.params[f"conv{i + 1}"]["w"].shape[-1] for i in range(7)]
    if got != expected:
        raise ValueError(
            f"artifact {path} has conv channels {got}, not the lightweight "
            f"pix_shuffle {expected}; build the enhance fn with make_enhance_fn "
            "and the matching config"
        )
    m = get_model("pix_shuffle")
    return make_enhance_fn(
        m.apply,
        params_from_jax(imp.params, device=device),
        crop_left=imp.crop_left,
        srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
        linear_to_srgb_exponent=imp.linear_to_srgb_exponent,
        device=device,
        **kwargs,
    )

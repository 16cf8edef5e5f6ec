"""Self-supervised in-domain training of the VGG16-topology feature encoder.

Port of ``fs_uae_image_enhancer_project_tpu/losses/vgg_selftrain.py``, the
trainer of the committed ``assets/vgg16_features_selftrained.npz``. The
reference's perceptual loss taps a frozen pretrained torchvision VGG16; where
that file cannot be had, this trains the same topology
(:data:`.vgg.VGG16_LAYOUT`, the same layer indices and taps) in-domain, as
the encoder of a reconstruction autoencoder over Amiga frames and their
palette-quantized/dithered variants: to reconstruct both through the /16
bottleneck the encoder must keep the local differences (residual dither,
blur, colour shifts) that the perceptual term is there to see.

Magnitude calibration: after training, each tap's RMS is rescaled to a
target on a probe batch (:func:`rescale_taps`; exact under the positive
homogeneity of relu and max-pool: scaling a conv's weight AND bias by c > 0
scales every later pre-bias activation by c), so the model zoo's
``vgg_weight`` values keep their meaning. The JAX package's target is the
tap RMS of a fixed-seed random VGG drawn with ``jax.random``, which torch
cannot draw: :func:`random_baseline_rms` returns the values the asset's JSON
stores for it.

The optimizer is ``torch.optim.Adam`` with optax's defaults (``optax.adam``:
b1 0.9, b2 0.999, eps 1e-8 outside the square root, no weight decay).
Tensors are NHWC; the decoder's convs are HWIO as everywhere in the port.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.conv import conv2d, init_conv, no_tf32
from ..ops.pixel_shuffle import pixel_shuffle
from . import vgg as vgg_mod
from .functional import charbonnier_loss

# decoder: tap-26 feature (H/16, W/16, 512) -> (H, W, 3), four x2
# pixel-shuffle stages (conv to 4*cout then depth-to-space).
_DECODER_STAGES: Tuple[Tuple[int, int], ...] = (
    (512, 256), (256, 128), (128, 64), (64, 32),
)
_DECODER_OUT = 32
ASSET_JSON = os.path.join(os.path.dirname(vgg_mod._ASSET_SELFTRAINED),
                          "vgg16_features_selftrained.json")


def init_decoder(generator: Optional[torch.Generator] = None,
                 device=None) -> List[Dict[str, torch.Tensor]]:
    """The decoder's convs (torch.nn.Conv2d's default init), drawn from
    ``generator`` on the CPU and placed on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    params = [init_conv(cin, cout * 4, 3, generator=generator, device=dev)
              for cin, cout in _DECODER_STAGES]
    params.append(init_conv(_DECODER_OUT, 3, 3, generator=generator, device=dev))
    return params


def decoder_apply(params: List[Dict], f: torch.Tensor) -> torch.Tensor:
    for p in params[:-1]:
        f = torch.relu(pixel_shuffle(conv2d(p, f), 2))
    return conv2d(params[-1], f)


def autoencode(enc_params: vgg_mod.Params, dec_params: List[Dict], x_srgb: torch.Tensor, *,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Reconstruct sRGB [0,1] patches through the tap-26 bottleneck; fp32 out."""
    xn = vgg_mod.normalize(x_srgb).to(compute_dtype)
    (deep,) = vgg_mod.extract_features(enc_params, xn, taps=(26,))
    with no_tf32():
        return decoder_apply(dec_params, deep).float()


def reconstruction_loss(enc_params: vgg_mod.Params, dec_params: List[Dict],
                        x_srgb: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    recon = autoencode(enc_params, dec_params, x_srgb, compute_dtype=compute_dtype)
    return charbonnier_loss(recon, x_srgb, 1e-6)


def make_train_step(enc_params: vgg_mod.Params, dec_params: List[Dict], lr: float = 1e-3, *,
                    compute_dtype=torch.bfloat16) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step(x_srgb) -> loss``: one Adam step (optax's ``adam(lr)``) on the
    encoder and decoder, whose tensors become leaves that require grad and
    are updated in place. ``step.optimizer`` is the optimizer."""
    tensors = [t for p in list(enc_params) + list(dec_params) for _k, t in sorted(p.items())]
    for t in tensors:
        t.requires_grad_(True)
    opt = torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(x_srgb: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        with no_tf32():
            loss = reconstruction_loss(enc_params, dec_params, x_srgb,
                                       compute_dtype=compute_dtype)
            loss.backward()
        opt.step()
        return loss.detach()

    step.optimizer = opt
    return step


# ---------------------------------------------------------------------------
# tap-magnitude calibration
# ---------------------------------------------------------------------------

@torch.no_grad()
def measure_tap_rms(enc_params: vgg_mod.Params, probe_srgb: np.ndarray) -> List[float]:
    """RMS of each perceptual tap on a probe batch (sRGB [0,1] NHWC), fp32."""
    x = torch.as_tensor(np.asarray(probe_srgb, np.float32)).to(enc_params[0]["w"].device)
    feats = vgg_mod.extract_features(enc_params, vgg_mod.normalize(x))
    return [float(torch.sqrt(torch.mean(f.float() ** 2))) for f in feats]


def _tap_last_conv(tap_index: int) -> int:
    """conv_indices() position of the conv layer that produces ``tap_index``
    (taps are either the conv output itself or its relu)."""
    convs = vgg_mod.conv_indices()
    last = [i for i in convs if i <= tap_index]
    return convs.index(last[-1])


def rescale_taps(enc_params: vgg_mod.Params, probe_srgb: np.ndarray,
                 target_rms: List[float]) -> vgg_mod.Params:
    """Scale each tap segment's final conv (weight AND bias) so tap RMS on
    the probe batch equals ``target_rms``; exact per tap under relu/pool
    positive homogeneity, applied shallow->deep with re-measurement so
    upstream scaling is accounted for. Returns new parameters."""
    params = [{k: v.detach() for k, v in p.items()} for p in enc_params]
    for k, tap in enumerate(vgg_mod.TAP_INDICES):
        rms = measure_tap_rms(params, probe_srgb)[k]
        g = target_rms[k] / max(rms, 1e-12)
        ci = _tap_last_conv(tap)
        params[ci] = {"w": params[ci]["w"] * g, "b": params[ci]["b"] * g}
    return params


def random_baseline_rms(probe_srgb: Optional[np.ndarray] = None) -> List[float]:
    """The calibration target: the tap RMS of the JAX package's fixed-seed
    random VGG (``jax.random.key(1234)``, He-normal) on the asset's probe
    batch, as the asset's JSON stores it (``tap_rms_target_random``). torch
    cannot draw ``jax.random``'s numbers, so the port reads the values the
    JAX package measured; ``probe_srgb`` is accepted for the JAX package's
    signature and not read."""
    with open(ASSET_JSON) as f:
        return [float(v) for v in json.load(f)["tap_rms_target_random"]]


# ---------------------------------------------------------------------------
# asset I/O
# ---------------------------------------------------------------------------

def save_asset(enc_params: vgg_mod.Params, out_path: str) -> None:
    """Write the drop-in npz (torchvision-compatible keys, HWIO weights: the
    layout ``vgg.init_vgg16`` loads)."""
    out = {}
    for ci, i in enumerate(vgg_mod.conv_indices()):
        out[f"features.{i}.weight"] = enc_params[ci]["w"].detach().cpu().numpy().astype(np.float32)
        out[f"features.{i}.bias"] = enc_params[ci]["b"].detach().cpu().numpy().astype(np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **out)

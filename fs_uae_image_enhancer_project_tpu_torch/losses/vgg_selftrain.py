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
``vgg_weight`` values keep their meaning. The target is the tap RMS of the
JAX package's fixed-seed random VGG on that probe
(:func:`random_baseline_rms`), the basis drawn by ``vgg._random_init``.

The decoder's initial weights are JAX's ``init_conv`` uniforms under a
``utils.threefry`` key (:func:`init_decoder`), so a seed gives JAX's
decoder. :func:`make_train_step` takes the optimizer: a learning rate for
plain Adam (``optax.adam``'s defaults: b1 0.9, b2 0.999, eps 1e-8 outside
the square root, no weight decay), or a factory such as
:func:`clipped_adamw`, the committed asset's optax chain
``chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(0, lr,
warmup, steps), weight_decay=1e-5))`` written in torch.
Tensors are NHWC; the decoder's convs are HWIO as everywhere in the port.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..ops.conv import conv2d, no_tf32
from ..ops.pixel_shuffle import pixel_shuffle
from ..utils import threefry
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


def init_conv(key, cin: int, cout: int, kernel_size: int = 3,
              device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ops.conv.init_conv`` under a ``utils.threefry``
    key: torch.nn.Conv2d's bounds, weight and bias uniform from the two
    keys of ``split(key)``, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    kw, kb = threefry.split(key)
    fan_in = cin * kernel_size * kernel_size
    bound_w = math.sqrt(6.0 / ((1.0 + 5.0) * fan_in))  # kaiming_uniform a=sqrt(5)
    bound_b = 1.0 / math.sqrt(fan_in)
    w = threefry.uniform(kw, (kernel_size, kernel_size, cin, cout), -bound_w, bound_w)
    b = threefry.uniform(kb, (cout,), -bound_b, bound_b)
    return {"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)}


def init_decoder(key, device=None) -> List[Dict[str, torch.Tensor]]:
    """The decoder's convs as the JAX package's ``init_decoder`` draws them
    under the same key (a ``utils.threefry`` key, e.g. ``threefry.key(seed)``),
    on ``device`` (default ``cuda``)."""
    keys = threefry.split(key, len(_DECODER_STAGES) + 1)
    params = [init_conv(k, cin, cout * 4, 3, device)
              for k, (cin, cout) in zip(keys, _DECODER_STAGES)]
    params.append(init_conv(keys[-1], _DECODER_OUT, 3, 3, device))
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


class ClippedAdamW(torch.optim.Optimizer):
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay=wd))`` as a torch optimizer, update for update:

    - the gradients are scaled by ``max_norm / norm`` only where their global
      norm is at least ``max_norm``, with no epsilon (``clip_grad_norm_``
      adds 1e-6 to the norm);
    - Adam's moments move on every update, the first included, and are
      bias-corrected with ``1 - b ** t`` rounded in float32, as jax's weak
      types round it (in float64 the correction of b2 is 1.3e-5 apart);
    - the decay is decoupled and applies to every leaf, biases included:
      ``p -= lr(t) * (adam + wd * p)``, with ``lr`` read from ``schedule``
      at the update's count from 0, so that update 0 takes ``schedule(0)``.
    """

    def __init__(self, params, schedule: Callable[[int], float], *, max_norm: float = 1.0,
                 weight_decay: float = 1e-5, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(schedule=schedule, max_norm=max_norm,
                                      weight_decay=weight_decay, b1=b1, b2=b2, eps=eps))
        self.count = 0

    def lr(self) -> float:
        """The learning rate the next update takes."""
        return float(self.param_groups[0]["schedule"](self.count))

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        params = [p for p in group["params"] if p.grad is not None]
        grads = [p.grad for p in params]
        lr, b1, b2 = self.lr(), group["b1"], group["b2"]
        self.count += 1
        t = np.float32(self.count)
        bc1 = float(np.float32(1) - np.power(np.float32(b1), t))
        bc2 = float(np.float32(1) - np.power(np.float32(b2), t))
        # one launch a list, not a leaf: the 26 leaves of the VGG
        # autoencoder made the per-leaf loop host-bound
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = torch.where(norm < group["max_norm"], torch.ones_like(norm),
                           group["max_norm"] / norm)
        for p in params:
            if not self.state[p]:
                self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p))
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        grads = torch._foreach_mul(grads, clip)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        u = torch._foreach_div(mus, bc1)
        torch._foreach_div_(u, denom)
        torch._foreach_add_(u, params, alpha=group["weight_decay"])
        torch._foreach_mul_(u, lr)
        torch._foreach_sub_(params, u)
        return None


def warmup_cosine_decay(peak: float, warmup: int, steps: int,
                        init: float = 0.0, end: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(init, peak, warmup, steps,
    end)`` at an update count, in float32: linear from ``init`` to ``peak``
    over ``warmup`` counts, then cosine to ``end`` at ``steps``. Raises
    ``ValueError`` where optax does (``steps <= warmup``)."""
    if steps - warmup <= 0:
        raise ValueError(f"the cosine decay needs steps > warmup ({steps} <= {warmup})")
    alpha = 0.0 if peak == 0.0 else end / peak
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(count) / f32(warmup)
            return float((f32(init) - f32(peak)) * frac + f32(peak))
        c = f32(min(count - warmup, steps - warmup))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(steps - warmup)))
        return float(f32(peak) * ((f32(1) - f32(alpha)) * cosine + f32(alpha)))

    return schedule


def clipped_adamw(lr: float, warmup: int, steps: int, *, max_norm: float = 1.0,
                  weight_decay: float = 1e-5) -> Callable[[Sequence[torch.Tensor]], ClippedAdamW]:
    """The committed asset's optimizer for :func:`make_train_step`:
    ``ClippedAdamW`` over ``warmup_cosine_decay(lr, warmup, steps)``."""
    schedule = warmup_cosine_decay(lr, warmup, steps)
    return lambda tensors: ClippedAdamW(tensors, schedule, max_norm=max_norm,
                                        weight_decay=weight_decay)


def make_train_step(enc_params: vgg_mod.Params, dec_params: List[Dict],
                    optimizer: Union[float, Callable] = 1e-3, *,
                    compute_dtype=torch.bfloat16) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step(x_srgb) -> loss``: one optimizer update on the encoder and
    decoder, whose tensors become leaves that require grad and are updated in
    place. ``optimizer`` is a learning rate (plain Adam, ``optax.adam(lr)``)
    or a factory of the leaves' optimizer (:func:`clipped_adamw`), as the
    JAX package's ``make_train_step(optimizer)`` takes the optax one.
    ``step.optimizer`` is the optimizer."""
    tensors = [t for p in list(enc_params) + list(dec_params) for _k, t in sorted(p.items())]
    for t in tensors:
        t.requires_grad_(True)
    if callable(optimizer):
        opt = optimizer(tensors)
    else:
        opt = torch.optim.Adam(tensors, lr=optimizer, betas=(0.9, 0.999), eps=1e-8)

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


def random_baseline_rms(probe_srgb: np.ndarray, device=None) -> List[float]:
    """Tap RMS of the fixed-seed random VGG (the quantified fallback,
    ``vgg._random_init()``) on ``probe_srgb``, measured on ``device``
    (default ``cuda``): the calibration target that keeps vgg_weight
    semantics unchanged."""
    return measure_tap_rms(vgg_mod._random_init(device=device), probe_srgb)


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

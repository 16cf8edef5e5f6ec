"""Shared helpers of the drivers in this directory.

Port of the repo's ``scripts/common.py``: the capped PSNR of two uint8
frames, the one cross-run scoring protocol (:func:`vggfree_eval`), and where
the port's trained checkpoints live: under a work directory that each
driver takes as ``--work_dir`` (default :data:`WORK_DIR`), where the JAX
script names fixed paths of one machine. Also a seeded many-coloured
frame (:func:`gradient_noise`) for runs that need no corpus.
"""
from __future__ import annotations

import os
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARTIFACTS = os.path.join(REPO, "artifacts")
# where the port's training drivers write their runs (a directory git ignores)
WORK_DIR = os.path.join(REPO, "build", "work")

# the provenance tag of the corpus the trained checkpoints were trained on
# (numbers are not comparable across corpora)
CURRENT_CORPUS_TAG = "r4-rebuild"

# the port's trained checkpoints, relative to the work directory; the
# trainer names a checkpoint by family without the variant suffix
TRAINED_CKPTS = {
    "conv6": "train_conv6/checkpoint_best_conv6",
    "residual_unet": "train_unet/checkpoint_best_residual_unet",
    "pix_shuffle_heavy": "train_psh/checkpoint_best_pix_shuffle",
    "pix_shuffle_long": "train_psh_long/checkpoint_best_pix_shuffle",
}


def gradient_noise(h: int, w: int, seed: int, sigma: float = 24.0):
    """A seeded smooth gradient plus Gaussian noise, uint8 (h, w, 3): a frame
    whose crops keep many colours, as a photo's do (at ``sigma`` 48 a 188x144
    crop keeps more than 256 RGB444 colours)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)], -1)
    return np.clip(base + rng.normal(0, sigma, (h, w, 3)) + 30, 1, 255).astype(np.uint8)


def trained_checkpoint(name: str, work_dir: str = WORK_DIR) -> Optional[str]:
    """The directory of ``name``'s trained checkpoint under ``work_dir``, or
    None where there is none."""
    rel = TRAINED_CKPTS.get(name)
    path = os.path.join(work_dir, rel) if rel else None
    return path if path and os.path.isdir(path) else None


def psnr_u8(a, b) -> float:
    """PSNR between uint8 image arrays, capped at the 99.0 dB sentinel for
    bit-identical inputs (mse == 0)."""
    import numpy as np

    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return round(99.0 if mse == 0 else 10 * np.log10(255.0**2 / mse), 2)


def vggfree_eval(model, params, val_iter, *, device=None) -> dict:
    """The one cross-run scoring protocol: the model's pixel criterion with
    VGG off and the sRGB PSNR over a deterministic validation iterator, as
    the JAX script scores it (the model in bf16, its output in fp32).

    Beside the pixel loss and the PSNR it gives the sRGB MS-SSIM where the
    crop allows 5 scales (None below that). ``params`` live on ``device``
    (default ``cuda``); the batches are uint8 (or float) numpy arrays.

    Returns ``{"loss", "srgb_psnr_db", "ms_ssim_srgb", "batches"}``.
    """
    import dataclasses

    import numpy as np
    import torch

    from .. import resolve_device
    from ..data import batch_transform
    from ..losses import build_criterion
    from ..losses.ssim import ms_ssim

    dev = resolve_device(device)
    criterion = build_criterion(dataclasses.replace(model.loss, vgg_weight=0.0), device=dev)
    to_float = batch_transform(model.linear_io)
    losses, mses, msssims = [], [], []
    with torch.no_grad():
        for lr_b, hr_b in val_iter:
            lr_b = to_float(torch.as_tensor(lr_b).to(dev))
            hr_b = to_float(torch.as_tensor(hr_b).to(dev))
            y = model.apply(params, lr_b.to(torch.bfloat16)).float()
            losses.append(criterion(y, hr_b))
            # PSNR in the sRGB domain (linear io -> gamma for display)
            ys = y.clamp(min=0) ** (1 / 2.2)
            ts = hr_b.clamp(min=0) ** (1 / 2.2)
            mses.append(torch.mean((ys - ts) ** 2))
            try:
                msssims.append(ms_ssim(ys.clamp(0.0, 1.0), ts.clamp(0.0, 1.0)))
            except ValueError:  # a crop too small for 5 scales
                msssims.append(torch.full((), float("nan"), device=dev))
    if not losses:
        return {"loss": float("nan"), "srgb_psnr_db": float("nan"),
                "ms_ssim_srgb": None, "batches": 0}
    losses = torch.stack(losses).float().cpu().numpy()
    mses = torch.stack(mses).float().cpu().numpy()
    msssims = torch.stack(msssims).float().cpu().numpy()
    mse = float(np.mean(mses))
    ms_mean = float(np.mean(msssims))
    return {
        "loss": float(np.mean(losses)),
        "srgb_psnr_db": float(10 * np.log10(1.0 / mse)) if mse > 0 else 99.0,
        "ms_ssim_srgb": None if np.isnan(ms_mean) else ms_mean,
        "batches": int(len(mses)),
    }

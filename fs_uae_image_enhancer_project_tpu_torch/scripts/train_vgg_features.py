"""Self-train the VGG16-topology perceptual feature encoder in-domain.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.train_vgg_features \\
        --data DIR --gt DIR [--steps 6000] [--batch_size 32] [--patch 128] \\
        [--work DIR] [--out FILE] [--resume] [--device cpu]

Port of the repo's ``scripts/train_vgg_features.py``, with its arguments,
defaults, log lines, checkpoint and asset: the VGG16 topology trained as a
reconstruction autoencoder (``losses.vgg_selftrain``) over random patches of
the generator's crops and the ground-truth frames (:class:`PatchSampler`,
numpy: the same seed draws the same patches), its tap magnitudes rescaled
to the fixed-seed random VGG's on a probe batch (the target computed by
``vgg_selftrain.random_baseline_rms(probe)``), and the encoder shipped as
``assets/vgg16_features_selftrained.npz`` with its JSON, the asset
``vgg.init_vgg16`` prefers over the random basis.

The initial weights are JAX's: the encoder ``vgg._random_init(key(seed))``,
the decoder ``vgg_selftrain.init_decoder(key(seed + 100))``, both drawn with
``utils.threefry``. The optimizer is the root script's optax chain,
``clip_by_global_norm(1.0)`` then ``adamw`` on a warmup-cosine schedule
from 0 with weight decay 1e-5 (``vgg_selftrain.clipped_adamw``), and each
step runs the autoencoder in bf16 as the JAX package's does.

``<work>/latest.npz`` holds the JAX script's keys (``step``, ``enc{i}_w``,
``enc{i}_b``, ``dec{i}_w``, ``dec{i}_b``), so a checkpoint crosses between
the two in either direction. It is written every 1000 steps. ``--resume``
loads its weights and step and,
as the root script does, starts a FRESH optimizer and schedule: the moments
are zero and the learning rate warms up again from 0. The last line is one
JSON object: the asset's meta.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from .common import REPO, WORK_DIR


class PatchSampler:
    """Random square uint8 sRGB patches from a RAM-cached image subset.

    Mixes clean GT crops, their styled (palette/dither) variants, and the
    full GT frames: the encoder must represent both clean and degraded
    appearance (sensitivity, not invariance; vgg_selftrain's docstring).
    """

    def __init__(self, files, patch: int, cache_n: int, seed: int):
        from PIL import Image

        rng = np.random.default_rng(seed)
        files = list(files)
        rng.shuffle(files)
        self.images = []
        for p in files[:cache_n]:
            with Image.open(p) as img:
                a = np.asarray(img.convert("RGB"), np.uint8)
            if a.shape[0] >= patch and a.shape[1] >= patch:
                self.images.append(a)
        if not self.images:
            raise RuntimeError("no usable images")
        self.patch = patch
        self.rng = rng

    def batch(self, n: int) -> np.ndarray:
        out = np.empty((n, self.patch, self.patch, 3), np.uint8)
        for i in range(n):
            img = self.images[self.rng.integers(0, len(self.images))]
            y = self.rng.integers(0, img.shape[0] - self.patch + 1)
            x = self.rng.integers(0, img.shape[1] - self.patch + 1)
            out[i] = img[y: y + self.patch, x: x + self.patch]
        return out


def save_checkpoint(path: str, step: int, enc, dec) -> None:
    """``latest.npz`` with the JAX script's keys, fp32."""
    payload = {"step": np.asarray(step)}
    for name, params in (("enc", enc), ("dec", dec)):
        for i, p in enumerate(params):
            payload[f"{name}{i}_w"] = p["w"].detach().float().cpu().numpy()
            payload[f"{name}{i}_b"] = p["b"].detach().float().cpu().numpy()
    np.savez(path, **payload)


def load_checkpoint(path: str, enc, dec) -> int:
    """Copy ``latest.npz``'s weights into ``enc`` and ``dec`` in place;
    returns its step."""
    import torch

    with np.load(path) as data:
        for name, params in (("enc", enc), ("dec", dec)):
            for i, p in enumerate(params):
                for k in ("w", "b"):
                    p[k].copy_(torch.from_numpy(np.asarray(data[f"{name}{i}_{k}"])))
        return int(data["step"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Self-train the VGG16 feature encoder")
    ap.add_argument("--data", default=os.path.join(WORK_DIR, "dataset_lores", "train"))
    ap.add_argument("--gt", default=os.path.join(WORK_DIR, "gt_frames"))
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--patch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--cache_images", type=int, default=1400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work", default=os.path.join(WORK_DIR, "train_vgg"))
    ap.add_argument("--out", default=os.path.join(
        REPO, "assets", "vgg16_features_selftrained.npz"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..losses import vgg as vgg_mod
    from ..losses import vgg_selftrain as st
    from ..utils import threefry

    dev = resolve_device(args.device)
    files = sorted(glob.glob(os.path.join(args.data, "*", "*.png")))
    gt_files = sorted(glob.glob(os.path.join(args.gt, "*.png")))
    print(f"corpus: {len(files)} crop files + {len(gt_files)} GT frames", flush=True)
    sampler = PatchSampler(files + gt_files, args.patch, args.cache_images, args.seed)
    val_sampler = PatchSampler(files + gt_files, args.patch, 200, args.seed + 1)
    val_batch = torch.from_numpy(val_sampler.batch(args.batch_size)).to(dev)
    probe = val_sampler.batch(16).astype(np.float32) / 255.0
    print(f"cached {len(sampler.images)} train / {len(val_sampler.images)} val images",
          flush=True)

    enc = vgg_mod._random_init(threefry.key(args.seed), device=dev)
    dec = st.init_decoder(threefry.key(args.seed + 100), device=dev)

    os.makedirs(args.work, exist_ok=True)
    start = 0
    ckpt = os.path.join(args.work, "latest.npz")
    if args.resume and os.path.exists(ckpt):
        start = load_checkpoint(ckpt, enc, dec)
        print(f"resumed at step {start} (optimizer state fresh)", flush=True)
    # the optimizer's schedule counts from 0 on every launch, a resume included
    step_fn = st.make_train_step(enc, dec, st.clipped_adamw(args.lr, args.warmup, args.steps))

    def prep(x_u8):
        return x_u8.to(torch.float32) / 255.0

    @torch.no_grad()
    def val_loss_fn():
        return st.reconstruction_loss(enc, dec, prep(val_batch))

    t0 = time.time()
    # a --resume run already at or past --steps skips the loop (the asset is
    # regenerated only): vl must still exist for the meta below
    vl = None
    with open(os.path.join(args.work, "train_log.jsonl"), "a") as log:
        for step in range(start, args.steps):
            x_u8 = torch.from_numpy(sampler.batch(args.batch_size)).to(dev)
            loss = step_fn(prep(x_u8))
            if step % 100 == 0 or step == args.steps - 1:
                vl = float(val_loss_fn())
                rec = {"step": step, "loss": float(loss), "val": vl,
                       "sec": round(time.time() - t0, 1)}
                print(json.dumps(rec), flush=True)
                log.write(json.dumps(rec) + "\n")
                log.flush()
            if step and step % 1000 == 0:
                save_checkpoint(ckpt, step, enc, dec)

    # calibrate tap magnitudes to the random baseline, then ship
    enc_host = [{k: v.detach() for k, v in p.items()} for p in enc]
    target = st.random_baseline_rms(probe, device=dev)
    before = st.measure_tap_rms(enc_host, probe)
    enc_cal = st.rescale_taps(enc_host, probe, target)
    after = st.measure_tap_rms(enc_cal, probe)
    print(f"tap rms before={before}\n        target={target}\n"
          f"         after={after}", flush=True)
    st.save_asset(enc_cal, args.out)
    meta = {
        "steps": args.steps, "batch": args.batch_size, "patch": args.patch,
        "corpus_files": len(files) + len(gt_files),
        "tap_rms_trained": before, "tap_rms_target_random": target,
        "tap_rms_calibrated": after,
        "final_val_recon_charbonnier": vl,
    }
    with open(args.out.replace(".npz", ".json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"asset written: {args.out}", flush=True)
    print(json.dumps(meta), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

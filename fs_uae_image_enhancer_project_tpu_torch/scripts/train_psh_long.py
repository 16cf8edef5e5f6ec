"""Long fresh pix_shuffle training run for the head-to-head study.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.train_psh_long \\
        [--data DIR] [--out DIR] [--epochs 120] [--samples_per_epoch 4096] \\
        [--samples_dir DIR] [--device cpu]

Port of the repo's ``scripts/train_psh_long.py``, with its arguments,
defaults and protocol: the training-parity study's plateau leg (the same
gather, the ``split_pairs(seed=0)`` 10% held-out pool, uint8 batches, the
criterion pinned to the JAX package's fixed-seed random VGG,
``vgg._random_init()``, the learning rate, batch and accumulation of the
reference's ``train_pix_shuffle.sh``) trained longer and wider: 2x the
samples an epoch and patience 20, so the run is not capped by the 50-epoch
budget the committed plateau model had. Validation runs through the
fused-stack kernel (K1) on a card. The process registers as preemptible
(``utils.platform.register_preemptible_pid``): a bench run may stop it, and
the same command resumes from the CSV.

The checkpoints go to ``--out``, by default ``train_psh_long`` under the
port's work directory (``common.TRAINED_CKPTS["pix_shuffle_long"]``, which
``eval_headtohead`` reads). ``--samples_dir`` renders a directory of frames
at each new best (the root script renders the reference's samples where its
machine has them). The last line is one JSON object: the best validation
loss and its epoch, the epochs run and the checkpoint directory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .common import WORK_DIR


def build_parser(out_default: str, description: str) -> argparse.ArgumentParser:
    """The long run's command line (the root script's flags plus
    ``--samples_dir`` and ``--device``), ``--out`` defaulting to
    ``out_default``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--data", default=os.path.join(WORK_DIR, "dataset_lores", "train"))
    ap.add_argument("--out", default=out_default)
    ap.add_argument("--crop_size", type=int, nargs=2, default=[376, 288])
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--samples_per_epoch", type=int, default=4096)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--accumulation_steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.000544)
    ap.add_argument("--patience", type=int, default=20)
    ap.add_argument("--samples_dir", default=None,
                    help="frames rendered at each new best (default: none)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run(argv, variant: str, out_default: str, description: str) -> int:
    """The long run of pix_shuffle's ``variant``: parse ``argv``, train,
    print the summary line."""
    args = build_parser(out_default, description).parse_args(argv)

    from ..data import SRDataset, gather_all_samples_from_directory, split_pairs
    from ..losses import vgg as vgg_mod
    from ..models import get_model
    from ..train.trainer import Trainer, TrainerConfig
    from ..utils.platform import register_preemptible_pid

    # a bench run kills a registered trainer by this pid file (one card; the
    # CSV resume makes the kill lossless); registering waits out a live bench
    register_preemptible_pid()
    crop = tuple(args.crop_size)
    pairs = gather_all_samples_from_directory(args.data, crop, verbose=1)
    train_pool, val_pool = split_pairs(pairs, 0.1)  # the study's exact split
    print(f"pool: {len(train_pool)} train / {len(val_pool)} val", flush=True)

    tr = SRDataset(train_pool, crop, args.samples_per_epoch, batch_size=args.batch_size,
                   seed=0, transfer_dtype="uint8")
    va = SRDataset(val_pool, crop, max(args.samples_per_epoch // 8, 64),
                   batch_size=args.batch_size, flips=False, seed=1, transfer_dtype="uint8")

    model = get_model("pix_shuffle", variant)
    cfg = TrainerConfig(
        num_epochs=args.epochs, lr=args.lr, batch_size=args.batch_size,
        accumulation_steps=args.accumulation_steps,
        checkpoint_interval=10, early_stopping_patience=args.patience,
        checkpoint_dir=args.out, samples_dir=args.samples_dir, verbose=1,
        device=args.device,
    )
    # pinned random basis: the committed plateau run's exact criterion
    trainer = Trainer(model, cfg, vgg_mod._random_init(device=args.device))
    best_val, best_epoch, _ = trainer.train(tr, va)
    print(f"best val {best_val:.5f} @ epoch {best_epoch}", flush=True)
    epochs = []
    if os.path.exists(trainer.metrics_file):
        with open(trainer.metrics_file) as f:
            epochs = [json.loads(line) for line in f if line.strip()]
    print(json.dumps({"model": f"pix_shuffle {model.variant}", "best_val": best_val,
                      "best_epoch": best_epoch, "epochs": epochs,
                      "train_pairs": len(train_pool), "val_pairs": len(val_pool),
                      "val_samples": len(va) * args.batch_size,
                      "checkpoint_dir": args.out}), flush=True)
    return 0


def main(argv=None) -> int:
    return run(argv, "lightweight", os.path.join(WORK_DIR, "train_psh_long"),
               "Long fresh pix_shuffle training run")


if __name__ == "__main__":
    sys.exit(main())

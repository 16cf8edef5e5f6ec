"""Training CLI: the JAX package's flags (``train/cli.py``) plus ``--device``.

    python -m fs_uae_image_enhancer_project_tpu_torch.train.cli \
        --model_type pix_shuffle --generator_train_dir path/to/train \
        --epochs 50 --train_samples 50000 --crop_size 376 288

Trains on one card (``--device cuda``, the default) or on the CPU
(``--device cpu``). ``--n_devices`` or ``--spatial`` above 1 exit 1: one card
cannot hold an ``nccl`` group of more than one rank, and the CLI has no
multi-process launcher yet. The sharded train step runs in ``gloo``
processes on the CPU (``parallel.dryrun``, ``parallel.mesh.spawn_ranks``).
"""
from __future__ import annotations

import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Train an image enhancement model.")
    ap.add_argument(
        "--model_type", required=True,
        choices=[
            "conv3", "conv3_heavy", "conv5", "conv5_heavy",
            "pix_shuffle", "pix_shuffle_heavy", "conv6", "residual_unet",
        ],
    )
    # accepted for compatibility: the reference parses it and never reads it
    ap.add_argument("--edge_checkpoint_path", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--checkpoint_interval", type=int, default=5)
    ap.add_argument("--accumulation_steps", type=int, default=16)
    ap.add_argument("--checkpoint_dir", default=".")
    ap.add_argument("--early_stopping_patience", type=int, default=10)
    ap.add_argument("--generator_train_dir", required=True)
    ap.add_argument("--train_samples", type=int, default=10000)
    ap.add_argument("--val_samples", type=int, default=1000)
    ap.add_argument("--val_split_ratio", type=float, default=0.1)
    ap.add_argument("--crop_size", type=int, nargs=2, default=[752, 576], metavar=("W", "H"))
    ap.add_argument("--styles_to_include", nargs="*", default=None)
    ap.add_argument("--samples_dir", default=None,
                    help="directory of frames to render each improving epoch")
    ap.add_argument("--inference_always", action="store_true")
    ap.add_argument("--learning_rate", type=float, default=0.001)
    ap.add_argument("--n_devices", type=int, default=1,
                    help="devices in the training mesh; the CLI trains on 1")
    ap.add_argument("--spatial", type=int, default=1,
                    help="spatial mesh axis size; the CLI trains on 1")
    ap.add_argument("--verbose", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda with no card raises")
    args = ap.parse_args(argv)
    if args.edge_checkpoint_path is not None and args.verbose >= 1:
        print("Warning: --edge_checkpoint_path is accepted for compatibility "
              "but unused (the reference never reads it either).", file=sys.stderr)
    if args.n_devices > 1 or args.spatial > 1:
        print(f"Error: --n_devices {args.n_devices} --spatial {args.spatial}: the CLI "
              "trains on one card (one card cannot hold an nccl group of more than one "
              "rank; the CLI's multi-card route is ROADMAP.md, section 1). The sharded "
              "train step runs over gloo processes on the CPU: python -m "
              "fs_uae_image_enhancer_project_tpu_torch.parallel.dryrun 4.", file=sys.stderr)
        return 1

    from .. import resolve_device
    from ..data import SRDataset, gather_all_samples_from_directory, split_pairs
    from ..models import get_model
    from .trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    model = get_model(args.model_type)
    crop = tuple(args.crop_size)
    styles = set(args.styles_to_include) if args.styles_to_include else None
    pairs = gather_all_samples_from_directory(args.generator_train_dir, crop, styles,
                                              verbose=args.verbose)
    if not pairs:
        print("Error: no sample pairs found.", file=sys.stderr)
        return 1
    train_pool, val_pool = split_pairs(pairs, args.val_split_ratio)
    # conv3/conv5 train in the sRGB domain; batches cross to the card as
    # uint8 and become fp32 there
    train_ds = SRDataset(train_pool, crop, args.train_samples, batch_size=args.batch_size,
                         linear=model.linear_io, transfer_dtype="uint8")
    val_ds = SRDataset(val_pool, crop, args.val_samples, batch_size=args.batch_size,
                       linear=model.linear_io, flips=False, seed=1, transfer_dtype="uint8")
    cfg = TrainerConfig(
        num_epochs=args.epochs,
        lr=args.learning_rate,
        batch_size=args.batch_size,
        accumulation_steps=args.accumulation_steps,
        checkpoint_interval=args.checkpoint_interval,
        early_stopping_patience=args.early_stopping_patience,
        checkpoint_dir=args.checkpoint_dir,
        samples_dir=args.samples_dir,
        inference_always=args.inference_always,
        verbose=args.verbose,
        device=str(device),
    )
    best_val, best_epoch, avg_inf = Trainer(model, cfg).train(train_ds, val_ds)
    print(f"Best validation loss: {best_val:.4f} at epoch {best_epoch}")
    print(f"Average inference time: {avg_inf:.4f} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())

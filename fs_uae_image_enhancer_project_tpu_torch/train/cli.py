"""Training CLI: the JAX package's flags (``train/cli.py``) plus ``--device``.

    python -m fs_uae_image_enhancer_project_tpu_torch.train.cli \
        --model_type pix_shuffle --generator_train_dir path/to/train \
        --epochs 50 --train_samples 50000 --crop_size 376 288

Trains on one card (``--device cuda``, the default) or on the CPU
(``--device cpu``). ``--n_devices N`` (with ``--spatial S``, which must divide
it) trains on a dp x sp = N/S x S mesh: one process a rank, spawned here
(``parallel.mesh.spawn_ranks``), joined in one process group: ``nccl`` with
one card a rank on ``--device cuda``, ``gloo`` on ``--device cpu``. With
fewer cards visible than ``--n_devices`` the CLI exits 1: it never trains on
fewer ranks or on the CPU instead.
"""
from __future__ import annotations

import sys
from typing import List, Optional


def _train(args, train_pool, val_pool, mesh=None):
    """Train as ``args`` say, on this process's rank of ``mesh`` (or alone):
    ``(best_val, best_epoch, avg_inference_seconds)``."""
    from .. import resolve_device
    from ..data import SRDataset
    from ..models import get_model
    from .trainer import Trainer, TrainerConfig

    model = get_model(args.model_type)
    crop = tuple(args.crop_size)
    # conv3/conv5 train in the sRGB domain; batches cross to the card as
    # uint8 and become fp32 there
    train_ds = SRDataset(train_pool, crop, args.train_samples, batch_size=args.batch_size,
                         linear=model.linear_io, transfer_dtype="uint8")
    val_ds = SRDataset(val_pool, crop, args.val_samples, batch_size=args.batch_size,
                       linear=model.linear_io, flips=False, seed=1, transfer_dtype="uint8")
    cfg = TrainerConfig(
        num_epochs=args.epochs,
        mesh=mesh,
        lr=args.learning_rate,
        batch_size=args.batch_size,
        accumulation_steps=args.accumulation_steps,
        checkpoint_interval=args.checkpoint_interval,
        early_stopping_patience=args.early_stopping_patience,
        checkpoint_dir=args.checkpoint_dir,
        samples_dir=args.samples_dir,
        inference_always=args.inference_always,
        verbose=args.verbose,
        device=str(mesh.device if mesh is not None else resolve_device(args.device)),
    )
    return Trainer(model, cfg).train(train_ds, val_ds)


def _train_rank(args, train_pool, val_pool):
    """One rank of the mesh (run by ``spawn_ranks`` in a process group)."""
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(args.n_devices, sp=args.spatial, device=args.device)
    return _train(args, train_pool, val_pool, mesh)


def build_parser():
    """The JAX CLI's flags plus ``--device``."""
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
                    help="devices in the training mesh (dp x sp), one process each; "
                         "1 = one card")
    ap.add_argument("--spatial", type=int, default=1,
                    help="spatial (image-height) mesh axis size; must divide "
                         "--n_devices; batch parallelism gets the rest")
    ap.add_argument("--verbose", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; nccl, one card a rank) or cpu (gloo "
                         "processes); cuda with no card raises")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.edge_checkpoint_path is not None and args.verbose >= 1:
        print("Warning: --edge_checkpoint_path is accepted for compatibility "
              "but unused (the reference never reads it either).", file=sys.stderr)

    # the mesh arithmetic fails in milliseconds, before the directory walk
    sharded = args.n_devices > 1 or args.spatial > 1
    if sharded:
        if args.n_devices % args.spatial:
            print(f"Error: --spatial {args.spatial} must divide "
                  f"--n_devices {args.n_devices}.", file=sys.stderr)
            return 1
        dp_axis = args.n_devices // args.spatial
        if args.batch_size % dp_axis:
            print(f"Error: --batch_size {args.batch_size} must be divisible "
                  f"by the dp axis ({dp_axis}).", file=sys.stderr)
            return 1
        if args.crop_size[1] % args.spatial:
            print(f"Error: crop height {args.crop_size[1]} must be divisible "
                  f"by --spatial {args.spatial} (the sp axis shards the "
                  "image height).", file=sys.stderr)
            return 1

    import torch

    from .. import resolve_device
    from ..data import gather_all_samples_from_directory, split_pairs

    if sharded and torch.device(args.device).type == "cuda":
        visible = torch.cuda.device_count()
        if visible < args.n_devices:
            print(f"Error: --n_devices {args.n_devices} but only {visible} devices "
                  "visible (--device cpu runs the ranks as gloo processes for a CPU "
                  "mesh).", file=sys.stderr)
            return 1
    resolve_device(args.device)
    crop = tuple(args.crop_size)
    styles = set(args.styles_to_include) if args.styles_to_include else None
    pairs = gather_all_samples_from_directory(args.generator_train_dir, crop, styles,
                                              verbose=args.verbose)
    if not pairs:
        print("Error: no sample pairs found.", file=sys.stderr)
        return 1
    train_pool, val_pool = split_pairs(pairs, args.val_split_ratio)
    if sharded:
        from ..parallel.mesh import spawn_ranks

        if args.verbose >= 1:
            print(f"Training mesh: dp={args.n_devices // args.spatial} x sp={args.spatial} "
                  f"({args.n_devices} devices)", flush=True)
        # a training run has no time limit; a failing rank stops them all
        results = spawn_ranks(_train_rank, args.n_devices, (args, train_pool, val_pool),
                              device=args.device, timeout=float("inf"))
        best_val, best_epoch, avg_inf = results[0]
    else:
        best_val, best_epoch, avg_inf = _train(args, train_pool, val_pool)
    print(f"Best validation loss: {best_val:.4f} at epoch {best_epoch}")
    print(f"Average inference time: {avg_inf:.4f} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())

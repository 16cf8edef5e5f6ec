"""Train the NAS study's best trial to a real checkpoint and score it.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.train_nas_winner \\
        [--nas_out DIR] [--data DIR] [--out DIR] [--epochs 40] \\
        [--eval_samples 1024] [--fps_seconds 5] [--device cpu]

Port of the repo's ``scripts/train_nas_winner.py``, with its arguments,
defaults and report. It

1. reads the study's best trial (``<nas_out>/best_trial.json``, by default
   the committed ``artifacts/nas_r5``),
2. rebuilds its Conv6Config with ``nas.studies.config_from_trial_params``
   (a replay, not a search),
3. trains it under the family's full criterion with the trial's own
   learning rate and the JAX package's fixed-seed random VGG basis
   (``vgg._random_init()``, pinned as for every other trained row),
4. scores it under the one cross-run protocol (``common.vggfree_eval``) on
   ``--eval_samples`` held-out draws and measures its FPS at the deployment
   shape, 576x752 bf16 (``nas.studies.measure_fps``, ``--fps_seconds``),
5. writes ``winner_trained.json`` into ``--nas_out``.

``--eval_samples`` and ``--fps_seconds`` are the root script's fixed 1024
and 5.0 made arguments. conv6 runs eagerly (cuDNN's convolutions: no kernel
of the repo). Preemptible as ``train_psh_long`` is. The last line is one
JSON object: the report.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from functools import partial

from .common import ARTIFACTS, WORK_DIR, vggfree_eval


def winner_model(nas_out: str, study: str):
    """``(best trial, its Conv6Config, the conv6 ModelDef that trains it)``
    from ``<nas_out>/best_trial.json``."""
    from ..models import conv6 as conv6_mod
    from ..models import get_model
    from ..nas.studies import config_from_trial_params

    with open(os.path.join(nas_out, "best_trial.json")) as f:
        bt = json.load(f)["best_trial"]
    cfg = config_from_trial_params(study, bt["params"])
    model = get_model("conv6")._replace(
        variant=f"nas_winner_trial{bt['number']}", config=cfg,
        init=partial(conv6_mod.init, cfg), apply=partial(conv6_mod.apply, cfg=cfg))
    return bt, cfg, model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train and score the NAS winner")
    ap.add_argument("--nas_out", default=os.path.join(ARTIFACTS, "nas_r5"))
    ap.add_argument("--study", default="prune_act_r2")
    ap.add_argument("--data", default=os.path.join(WORK_DIR, "dataset_lores", "train"))
    ap.add_argument("--out", default=os.path.join(WORK_DIR, "train_conv6_nas"))
    ap.add_argument("--crop_size", type=int, nargs=2, default=[376, 288])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--samples_per_epoch", type=int, default=2048)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--accumulation_steps", type=int, default=4)
    ap.add_argument("--patience", type=int, default=15)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: the winning trial's own learning_rate")
    ap.add_argument("--eval_samples", type=int, default=1024)
    ap.add_argument("--fps_seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..data import SRDataset, gather_all_samples_from_directory, split_pairs
    from ..losses import vgg as vgg_mod
    from ..models import count_params
    from ..nas.studies import measure_fps
    from ..train.trainer import Trainer, TrainerConfig, load_params
    from ..utils.platform import register_preemptible_pid

    register_preemptible_pid()  # a bench run may preempt us; the run resumes
    dev = resolve_device(args.device)
    bt, cfg, model = winner_model(args.nas_out, args.study)
    lr = args.lr if args.lr is not None else float(bt["params"].get("learning_rate", 0.000544))

    def fresh():
        return model.init(torch.Generator().manual_seed(0), device=dev)

    crop = tuple(args.crop_size)
    pairs = gather_all_samples_from_directory(args.data, crop, verbose=1)
    train_pool, val_pool = split_pairs(pairs, 0.1)  # the studies' split
    n_params = count_params(fresh())
    print(f"pool: {len(train_pool)} train / {len(val_pool)} val; "
          f"winner trial {bt['number']} lr={lr:.6g} params={n_params}", flush=True)

    tr = SRDataset(train_pool, crop, args.samples_per_epoch, batch_size=args.batch_size,
                   seed=0, transfer_dtype="uint8")
    va = SRDataset(val_pool, crop, max(args.samples_per_epoch // 8, 64),
                   batch_size=args.batch_size, flips=False, seed=1, transfer_dtype="uint8")
    tcfg = TrainerConfig(
        num_epochs=args.epochs, lr=lr, batch_size=args.batch_size,
        accumulation_steps=args.accumulation_steps,
        checkpoint_interval=10, early_stopping_patience=args.patience,
        checkpoint_dir=args.out, verbose=1, device=args.device,
    )
    best_val, best_epoch, _ = Trainer(
        model, tcfg, vgg_mod._random_init(device=dev)  # the pinned basis
    ).train(tr, va)
    print(f"best val {best_val:.5f} @ epoch {best_epoch}", flush=True)

    # score under the one cross-run protocol and the deployment-shape FPS
    ck = os.path.join(args.out, "checkpoint_best_conv6")
    params = load_params(ck, fresh())
    va2 = SRDataset(val_pool, crop, args.eval_samples, batch_size=args.batch_size,
                    flips=False, seed=1, transfer_dtype="uint8")
    r = vggfree_eval(model, params, iter(va2), device=dev)
    fps = measure_fps(cfg, duration_s=args.fps_seconds, device=dev)

    out = {
        "study": args.study,
        "winner_trial": bt["number"],
        "winner_lr": lr,
        "trained_epochs_budget": args.epochs,
        "best_epoch": best_epoch,
        "best_val_own_metric": best_val,
        "samples_per_epoch": args.samples_per_epoch,
        "eval": r,
        "fps_deployment_shape": fps,
        "checkpoint": ck,
        "protocol": "common.vggfree_eval on the split_pairs(seed=0) held-out "
                    "pool (same as eval_headtohead rows); FPS via "
                    "nas.studies.measure_fps at 576x752 bf16",
    }
    path = os.path.join(args.nas_out, "winner_trained.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The training-parity study: the random-VGG term's worth and the plateau.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.training_parity_study \\
        --data DIR [--ablation_epochs 12] [--plateau_epochs 50] \\
        [--skip ablation selfvgg plateau] [--corpus_tag TAG] [--device cpu]

Port of the repo's ``scripts/training_parity_study.py``, with its arguments,
defaults, legs and ``eval_summary.json``:

(a) ``ablation``: two runs identical except for the VGG term (vgg_weight 0
    against the default with the JAX package's fixed-seed random VGG,
    ``vgg._random_init()``, pinned), the same seeds, data and epochs;
(c) ``selfvgg``: the same run with the committed self-trained features
    (``assets/vgg16_features_selftrained.npz``), skipped with a message
    where the asset is absent;
(b) ``plateau``: the full criterion, pinned to the random basis, to plateau.

Every run is scored under the one cross-run protocol
(``common.vggfree_eval``: the pixel criterion with VGG off, sRGB PSNR, sRGB
MS-SSIM, on the ``split_pairs(seed=0)`` held-out pool), so rows are
comparable whatever features trained them; pix_shuffle's forward there runs
through the fused-stack kernel (K1) on a card, as does the trainer's
validation. ``eval_summary.json`` keeps the root script's rules: each row
carries the ``corpus_tag`` it was measured on, ``last_run`` describes only
this invocation, and a ``--skip plateau`` rerun replaces a plateau row of
another corpus by a ``superseded_by`` pointer, never one of the current
corpus.

The runs and the summary go to the module constant :data:`OUT`, the
``training_parity`` directory under the port's work directory (the root
script writes the repo's ``artifacts/training_parity``, which holds the JAX
package's committed rows). Preemptible as ``train_psh_long`` is. The last
line is one JSON object: the summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from .common import CURRENT_CORPUS_TAG, WORK_DIR, vggfree_eval

OUT = os.path.join(WORK_DIR, "training_parity")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The training-parity study")
    ap.add_argument("--data", required=True)
    ap.add_argument("--crop_size", type=int, nargs=2, default=[376, 288])
    ap.add_argument("--ablation_epochs", type=int, default=12)
    ap.add_argument("--plateau_epochs", type=int, default=50)
    ap.add_argument("--samples_per_epoch", type=int, default=2048)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--accumulation_steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.000544)  # train_pix_shuffle.sh
    ap.add_argument("--skip", nargs="*", default=[],
                    choices=["ablation", "plateau", "selfvgg"])
    ap.add_argument("--corpus_tag", default=CURRENT_CORPUS_TAG,
                    help="provenance tag stamped into every row measured "
                         "this run (cross-corpus numbers are not comparable)")
    ap.add_argument("--samples_dir", default=None,
                    help="frames rendered at each new best (default: none)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..data import SRDataset, gather_all_samples_from_directory, split_pairs
    from ..losses import vgg as vgg_mod
    from ..models import get_model
    from ..train.trainer import Trainer, TrainerConfig, load_params
    from ..utils.platform import register_preemptible_pid

    register_preemptible_pid()  # a bench run may preempt us; the run resumes
    dev = resolve_device(args.device)
    os.makedirs(OUT, exist_ok=True)
    crop = tuple(args.crop_size)
    pairs = gather_all_samples_from_directory(args.data, crop, verbose=1)
    if not pairs:
        print("no pairs found", file=sys.stderr)
        print(json.dumps({"error": "no pairs found", "data": args.data}), flush=True)
        return 1
    train_pool, val_pool = split_pairs(pairs, 0.1)
    print(f"pool: {len(train_pool)} train / {len(val_pool)} val pairs", flush=True)

    def make_ds(seed=0):
        tr = SRDataset(train_pool, crop, args.samples_per_epoch, batch_size=args.batch_size,
                       seed=seed, transfer_dtype="uint8")
        va = SRDataset(val_pool, crop, max(args.samples_per_epoch // 8, 64),
                       batch_size=args.batch_size, flips=False, seed=1,
                       transfer_dtype="uint8")
        return tr, va

    base = get_model("pix_shuffle")

    def run(tag, model, epochs, vgg_params=None):
        ckpt_dir = os.path.join(OUT, tag)
        cfg = TrainerConfig(
            num_epochs=epochs, lr=args.lr, batch_size=args.batch_size,
            accumulation_steps=args.accumulation_steps,
            checkpoint_interval=5, early_stopping_patience=15,
            checkpoint_dir=ckpt_dir, samples_dir=args.samples_dir, verbose=1,
            device=args.device,
        )
        tr, va = make_ds()
        best_val, best_epoch, _ = Trainer(model, cfg, vgg_params).train(tr, va)
        print(f"[{tag}] best val {best_val:.5f} @ epoch {best_epoch}", flush=True)
        return ckpt_dir, best_val, best_epoch

    def evaluate(ckpt_dir):
        params = load_params(os.path.join(ckpt_dir, "checkpoint_best_pix_shuffle"),
                             base.init(torch.Generator().manual_seed(0), device=dev))
        _, va = make_ds()
        r = vggfree_eval(base, params, iter(va), device=dev)
        return {
            "novgg_val_loss": r["loss"],
            "srgb_psnr_db": r["srgb_psnr_db"],
            "ms_ssim_srgb": r["ms_ssim_srgb"],
        }

    summary = {}
    summary_path = os.path.join(OUT, "eval_summary.json")
    if os.path.exists(summary_path):
        # numbers measured on different corpus regenerations are not
        # comparable: each row's corpus_tag records its regeneration
        with open(summary_path) as f:
            summary = json.load(f)

    def write_summary():
        # 'last_run' describes THIS invocation only; the per-row provenance
        # is each row's own corpus_tag (a partial rerun must not relabel rows
        # measured on an older corpus)
        summary["last_run"] = {
            "data": args.data,
            "corpus_tag": args.corpus_tag,
            "provenance": "scripts/make_gt_frames.py --split -> "
                          "recipes/prepare_groundtruth.sh -> "
                          "recipes/generate_dataset.sh",
        }
        summary.pop("corpus", None)  # the old whole-file field
        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=1)

    if "ablation" not in args.skip:
        # (a) same-seed ablation: vgg off vs random-VGG on; the random leg
        # pins _random_init (init_vgg16 would pick up the self-trained asset)
        m_novgg = base._replace(loss=dataclasses.replace(base.loss, vgg_weight=0.0))
        ck_a, bv_a, be_a = run("ablation_novgg", m_novgg, args.ablation_epochs)
        ck_b, bv_b, be_b = run("ablation_randvgg", base, args.ablation_epochs,
                               vgg_params=vgg_mod._random_init(device=dev))
        summary["ablation"] = {
            "epochs": args.ablation_epochs,
            "corpus_tag": args.corpus_tag,
            "novgg": {"best_val_own_metric": bv_a, "best_epoch": be_a, **evaluate(ck_a)},
            "randvgg": {"best_val_own_metric": bv_b, "best_epoch": be_b, **evaluate(ck_b)},
            "note": "own-metric vals are NOT comparable across runs (different "
                    "criteria); novgg_val_loss and srgb_psnr_db are.",
        }
        write_summary()
        print(json.dumps(summary["ablation"], indent=1), flush=True)

    if "selfvgg" not in args.skip:
        # (c) the perceptual term with the self-trained in-domain features
        # (train_vgg_features -> assets/vgg16_features_selftrained.npz,
        # tap-RMS-calibrated to the random basis: vgg_weight keeps its meaning)
        self_path = os.path.abspath(vgg_mod._ASSET_SELFTRAINED)
        if not os.path.exists(self_path):
            print(f"selfvgg leg skipped: no asset at {self_path}", file=sys.stderr)
        else:
            ck_c, bv_c, be_c = run("ablation_selfvgg", base, args.ablation_epochs,
                                   vgg_params=vgg_mod._load_asset(self_path, dev))
            summary.setdefault("ablation", {})["selfvgg"] = {
                "best_val_own_metric": bv_c, "best_epoch": be_c,
                "corpus_tag": args.corpus_tag, **evaluate(ck_c),
            }
            write_summary()
            print(json.dumps(summary["ablation"]["selfvgg"], indent=1), flush=True)

    if "plateau" not in args.skip:
        # (b) full-criterion run to plateau, pinned to the RANDOM basis: the
        # committed 50-epoch run trained under it, and init_vgg16's default
        # would swap the criterion to the asset on a rerun or resume
        ck_c, bv_c, be_c = run("plateau_full", base, args.plateau_epochs,
                               vgg_params=vgg_mod._random_init(device=dev))
        summary["plateau"] = {
            "epochs": args.plateau_epochs, "best_val": bv_c,
            "best_epoch": be_c, "corpus_tag": args.corpus_tag,
            **evaluate(ck_c),
            "reference_anchor": {
                "file": "model/model_pix_shuffle/training_stats_pix_shuffle.csv",
                "best_val": 0.11051, "best_epoch": 41,
                "note": "different corpus and VGG features; curve SHAPE is "
                        "the comparable quantity, not the value",
            },
        }
        write_summary()
        print(json.dumps(summary.get("plateau", {}), indent=1), flush=True)
    elif (
        summary.get("plateau")
        and "superseded_by" not in summary["plateau"]
        # stale means measured on a different corpus: a plateau row the
        # current corpus paid for is never clobbered by a --skip plateau rerun
        and summary["plateau"].get("corpus_tag") != args.corpus_tag
    ):
        # a stale plateau row of an earlier corpus must not sit silently next
        # to fresh ablation rows: point at the current corpus's long-run curve
        summary["plateau"] = {
            "superseded_by": "artifacts/model_pix_shuffle_trained/"
                             "training_stats_pix_shuffle.csv",
            "note": "94-epoch full-criterion curve on the regenerated "
                    "corpus (scripts/train_psh_long.py, round 5; best val "
                    "0.01734 @ epoch 73). The round-2-corpus 50-epoch "
                    "checkpoint remains at plateau_full/ for history; its "
                    "numbers are not comparable to this corpus's rows.",
        }
        write_summary()

    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Head-to-head: the shipped pix_shuffle weights against weights trained by the
framework, scored on the same held-out pairs.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.eval_headtohead \\
        --data DIR [--num_samples 1024] [--batch_size 8] [--crop_size 376 288] \\
        [--trained_onnx FILE] [--work_dir DIR] [--out FILE] [--device cpu]

Port of the repo's ``scripts/eval_headtohead.py``, with its protocol and its
report's fields: the training-parity study's validation pipeline (the same
gather, the ``split_pairs(seed=0)`` 10% held-out pool, ``SRDataset(seed=1,
flips=False)`` draws, the pixel criterion with VGG off, sRGB PSNR and sRGB
MS-SSIM, :func:`common.vggfree_eval`), one row a set of weights:

1. the shipped graph's weights (``--ref_onnx``, default
   ``artifacts/model_pix_shuffle/pix_shuffle.onnx``);
2. the JAX script's 50-epoch plateau checkpoint, the orbax checkpoint
   ``artifacts/training_parity/plateau_full/checkpoint_best_pix_shuffle``
   (read by ``train.orbax_reader`` through ``load_params``);
3. the port's long fresh run (``common.TRAINED_CKPTS["pix_shuffle_long"]``
   under ``--work_dir``) where it exists;
4. the trained pix_shuffle graph of the repo (``--trained_onnx``, default
   ``artifacts/model_pix_shuffle_trained/pix_shuffle_trained.onnx``), its
   caveat from the corpus tag its ``parity_report.json`` carries;
5. pix_shuffle_heavy: the port's checkpoint where it exists, else the
   committed graph ``artifacts/model_pix_shuffle_heavy/``, its caveat from
   that graph's corpus tag.

Each row carries its fairness caveat. One line a row; the report goes to
``--out`` (default: not written) and is printed as the last line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from .common import ARTIFACTS, CURRENT_CORPUS_TAG, WORK_DIR, trained_checkpoint, vggfree_eval

REF_ONNX = os.path.join(ARTIFACTS, "model_pix_shuffle", "pix_shuffle.onnx")
TRAINED_ONNX = os.path.join(ARTIFACTS, "model_pix_shuffle_trained", "pix_shuffle_trained.onnx")
HEAVY_ONNX = os.path.join(ARTIFACTS, "model_pix_shuffle_heavy", "pix_shuffle_heavy.onnx")
PLATEAU_CKPT = os.path.join(ARTIFACTS, "training_parity", "plateau_full",
                            "checkpoint_best_pix_shuffle")

CAVEAT_SHIPPED = (
    "zero-leak: the reference's shipped weights never saw any version of this corpus "
    "(trained on its own unpublished captures); this row carries a distribution "
    "disadvantage against every trained row")
CAVEAT_R2_TRAINED = (
    "trained on the superseded round-2 corpus; never saw these exact regenerated pairs, "
    "but the corpus is re-synthesized from overlapping seeded scenes and the same 8 "
    "reference frames, so pair-level overlap with its training pairs is unknown "
    "(make_gt_frames is deterministic)")
CAVEAT_FRESH = (
    "trained on this corpus's other 90% (split_pairs(seed=0)); the held-out pool scored "
    "here was its early-stopping selection set (selection only; no pair trained on)")


def graph_caveat(onnx: str, corpus_tag: str) -> str:
    """The caveat of weights read back from a committed graph: from the corpus
    tag that its directory's ``parity_report.json`` carries."""
    rep = os.path.join(os.path.dirname(onnx), "parity_report.json")
    tag, wsrc = None, ""
    if os.path.exists(rep):
        with open(rep) as f:
            r = json.load(f)
        tag, wsrc = r.get("weights_corpus_tag"), r.get("weights", "")
    if tag == corpus_tag:
        return CAVEAT_FRESH + (" (weights reimported from the committed ONNX emitted from "
                               "that checkpoint)")
    if tag is not None:
        return (f"trained on corpus '{tag}', scored on '{corpus_tag}': cross-corpus row; "
                + CAVEAT_R2_TRAINED)
    return ("reimported from a committed ONNX with no corpus provenance tag (parity_report "
            f"weights: {wsrc!r}); treat the training corpus as unknown: it may include this "
            "corpus's other 90% and the early-stopping selection pool")


def graph_params(path: str, model, device):
    """The weights of a committed graph: the lightweight pix_shuffle's as the
    importer gives them (the JAX script's ``import_pix_shuffle``), the heavy
    one's on ``model``'s structure."""
    from ..export.enhance import _match_structure
    from ..export.onnx_import import import_any, import_pix_shuffle
    from ..interop import params_from_jax

    if model.variant == "lightweight":
        return params_from_jax(import_pix_shuffle(path).params, device=device)
    params = _match_structure(model, import_any(path).params)
    if params is None:
        raise ValueError(f"{path} does not fit the {model.name} {model.variant} structure")
    return params_from_jax(params, device=device)


def run(data: str, crop=(376, 288), num_samples: int = 1024, batch_size: int = 8,
        device: str = "cuda", ref_onnx: str = REF_ONNX, trained_onnx: str = TRAINED_ONNX,
        heavy_onnx: str = HEAVY_ONNX, work_dir: str = WORK_DIR,
        corpus_tag: str = CURRENT_CORPUS_TAG) -> dict:
    import torch

    from .. import resolve_device
    from ..data import SRDataset, gather_all_samples_from_directory, split_pairs
    from ..models import get_model
    from ..train.trainer import load_params

    dev = resolve_device(device)
    crop = tuple(crop)
    pairs = gather_all_samples_from_directory(data, crop, verbose=0)
    if not pairs:
        raise FileNotFoundError(f"no pairs found under {data}")
    _, val_pool = split_pairs(pairs, 0.1)  # seed 0: the study's split
    print(f"held-out pool: {len(val_pool)} pairs", flush=True)

    def run_row(model, params, label, caveat):
        va = SRDataset(val_pool, crop, num_samples, batch_size=batch_size, flips=False,
                       seed=1, transfer_dtype="uint8")
        t0 = time.perf_counter()
        r = vggfree_eval(model, params, iter(va), device=dev)
        row = {"label": label, "pixel_loss_vggfree": r["loss"],
               "srgb_psnr_db": r["srgb_psnr_db"], "ms_ssim_srgb": r["ms_ssim_srgb"],
               "batches": r["batches"], "eval_s": time.perf_counter() - t0,
               "caveat": caveat}
        print(json.dumps(row), flush=True)
        return row

    def fresh(m):
        return m.init(torch.Generator().manual_seed(0), device=dev)

    base = get_model("pix_shuffle")
    heavy = get_model("pix_shuffle", "heavyweight")
    rows, skipped = [], []
    rows.append(run_row(base, graph_params(ref_onnx, base, dev),
                        f"shipped pix_shuffle graph {os.path.relpath(ref_onnx)}",
                        CAVEAT_SHIPPED))
    rows.append(run_row(base, load_params(PLATEAU_CKPT, fresh(base)),
                        "trained here: pix_shuffle plateau-50", CAVEAT_R2_TRAINED))
    ck = trained_checkpoint("pix_shuffle_long", work_dir)
    if ck:
        rows.append(run_row(base, load_params(ck, fresh(base)),
                            "trained here: pix_shuffle fresh run on this corpus (port "
                            "checkpoint)", CAVEAT_FRESH))
    if trained_onnx and os.path.exists(trained_onnx):
        rows.append(run_row(base, graph_params(trained_onnx, base, dev),
                            f"trained here: pix_shuffle graph {os.path.relpath(trained_onnx)}",
                            graph_caveat(trained_onnx, corpus_tag)))
    else:
        skipped.append({"label": "trained pix_shuffle graph", "path": trained_onnx,
                        "reason": "absent"})
    ck_h = trained_checkpoint("pix_shuffle_heavy", work_dir)
    if ck_h:
        rows.append(run_row(heavy, load_params(ck_h, fresh(heavy)),
                            "trained here: pix_shuffle_heavy (port checkpoint)", CAVEAT_FRESH))
    elif heavy_onnx and os.path.exists(heavy_onnx):
        rows.append(run_row(heavy, graph_params(heavy_onnx, heavy, dev),
                            "trained here: pix_shuffle_heavy (reimported from committed ONNX)",
                            graph_caveat(heavy_onnx, corpus_tag)))
    else:
        skipped.append({"label": "pix_shuffle_heavy", "path": heavy_onnx, "reason": "absent"})

    # the held-out pool's fingerprint: pairs are filename-addressed, so a
    # digest of its sorted basenames pins the regeneration scored
    fp = hashlib.sha256("\n".join(sorted(
        os.path.basename(s) + "|" + os.path.basename(t)
        for s, t in val_pool)).encode()).hexdigest()[:16]
    return {
        "date": time.strftime("%Y-%m-%d"),
        "harness": "fs_uae_image_enhancer_project_tpu_torch.scripts.eval_headtohead",
        "device": str(dev),
        "data": data,
        "held_out_pairs": len(val_pool),
        "num_samples": num_samples,
        "protocol": ("training_parity_study val pipeline: split_pairs(seed=0) 10% pool, "
                     "SRDataset(seed=1, flips=False) deterministic draws, vgg-free pixel "
                     "criterion, sRGB PSNR + sRGB MS-SSIM"),
        "caveats": ("per-row (see rows[*].caveat); every trained row keeps a distribution "
                    "advantage over the shipped reference row: this measures "
                    "same-distribution (re)training value, not weight quality on the "
                    "reference's own distribution"),
        "corpus_generation": corpus_tag,
        "heldout_pool_fingerprint_sha256_16": fp,
        "rows": rows,
        "skipped": skipped,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Shipped against trained pix_shuffle weights")
    ap.add_argument("--data", required=True, help="a generator split (its pairs)")
    ap.add_argument("--crop_size", type=int, nargs=2, default=[376, 288])
    ap.add_argument("--num_samples", type=int, default=1024)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--ref_onnx", default=REF_ONNX, help="the shipped pix_shuffle graph")
    ap.add_argument("--trained_onnx", default=TRAINED_ONNX,
                    help="a trained lightweight pix_shuffle graph")
    ap.add_argument("--heavy_onnx", default=HEAVY_ONNX,
                    help="the heavy pix_shuffle graph, where no port checkpoint is")
    ap.add_argument("--work_dir", default=WORK_DIR,
                    help="where the port's trained checkpoints are")
    ap.add_argument("--corpus_tag", default=CURRENT_CORPUS_TAG,
                    help="provenance tag of the corpus under --data (numbers are not "
                         "comparable across corpora)")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report = run(args.data, args.crop_size, args.num_samples, args.batch_size, args.device,
                 args.ref_onnx, args.trained_onnx, args.heavy_onnx, args.work_dir,
                 args.corpus_tag)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

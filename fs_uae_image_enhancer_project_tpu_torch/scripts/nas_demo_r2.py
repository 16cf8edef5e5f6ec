"""The widest NAS surface on the card: the prune_act_r2 study.

    NAS_OUT=DIR NAS_DATA=DIR [NAS_TRIALS=14 NAS_EPOCHS=5 NAS_SAMPLES=256 \\
    NAS_MIN_FPS=0 NAS_BUDGET_S=0 NAS_CROP=376x288 NAS_FPS_S=3] \\
        python -m fs_uae_image_enhancer_project_tpu_torch.scripts.nas_demo_r2 [--device cpu]

Port of the repo's ``scripts/nas_demo_r2.py`` (the counterpart of the
reference's ``optuna_study_prune_act_r2.py``): all 20 registry activations
across the 7 conv6 layers, layer 6's kernel size in {3, 5, 7}, TPE sampling
and median pruning (``nas.search``), SQLite persistence and the shared FPS
cache (``nas.fps_cache``), on the generator's corpus. Each trial's FPS at
576x752 bf16 is measured and cached but not gated by default (the reference
records FPS for the pareto view and optimises the training loss only).
Then the best trial's architecture is replayed
(``nas.studies.config_from_trial_params``) against the FPS cache with a
sentinel measurement: a hit returns the stored figure without calling it.

It reads the root script's environment variables, when ``main`` runs:
``NAS_OUT`` (default: ``nas_demo_r2`` under the port's work directory; the
root script's is the repo's ``artifacts/nas_demo_r2``), ``NAS_DATA``,
``NAS_TRIALS``, ``NAS_EPOCHS``, ``NAS_SAMPLES``, ``NAS_MIN_FPS`` and
``NAS_BUDGET_S`` (a wall-clock budget: the study is SQLite-resumable, so a
stopped run is a valid partial study), and two of its own: ``NAS_CROP``
(``WxH`` of the corpus's targets, the root script's fixed 376x288) and
``NAS_FPS_S`` (seconds an FPS reading, the root script's fixed 3.0).

Outputs in ``NAS_OUT``: ``studies.sqlite``, ``model_performance_cache.json``,
``prune_act_r2_{history,importances,pareto}.png`` and ``best_trial.json``.
The one departure from the root script: the three plots need matplotlib, and
where it does not import, the driver still writes ``best_trial.json`` and
names the plots it did not write, on stderr and in the summary's
``"plots"``. conv6 runs eagerly (cuDNN's convolutions: no kernel of the
repo). Preemptible as ``train_psh_long`` is. The last line is one JSON
object: the summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .common import WORK_DIR

PLOTS = ("prune_act_r2_history.png", "prune_act_r2_importances.png",
         "prune_act_r2_pareto.png")


def settings() -> dict:
    """The run's settings from the environment, as the root script reads them."""
    w, h = (int(v) for v in os.environ.get("NAS_CROP", "376x288").split("x"))
    return dict(
        out=os.environ.get("NAS_OUT") or os.path.join(WORK_DIR, "nas_demo_r2"),
        data=os.environ.get("NAS_DATA", os.path.join(WORK_DIR, "dataset_lores", "train")),
        trials=int(os.environ.get("NAS_TRIALS", "14")),
        epochs=int(os.environ.get("NAS_EPOCHS", "5")),
        samples=int(os.environ.get("NAS_SAMPLES", "256")),
        min_fps=float(os.environ.get("NAS_MIN_FPS", "0")),  # 0 = no gate (ref parity)
        budget_s=float(os.environ.get("NAS_BUDGET_S", "0")),  # 0 = no budget
        crop=(w, h),
        fps_s=float(os.environ.get("NAS_FPS_S", "3.0")),
    )


def write_plots(study, out: str) -> dict:
    """The three plots, where matplotlib imports: ``{"written": [...],
    "not_written": [...], "missing_module": None or its name}``."""
    from ..nas import visualize

    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        names = list(PLOTS)
        print(f"plots not written ({', '.join(names)}): {e}", file=sys.stderr, flush=True)
        return {"written": [], "not_written": names, "missing_module": e.name or "matplotlib"}
    for fn, name in zip((visualize.plot_optimization_history,
                         visualize.plot_param_importances, visualize.plot_pareto), PLOTS):
        fn(study, os.path.join(out, name))  # a plot with no data writes nothing
    written = [n for n in PLOTS if os.path.exists(os.path.join(out, n))]
    return {"written": written, "not_written": [n for n in PLOTS if n not in written],
            "missing_module": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The prune_act_r2 NAS study")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    s = settings()

    from .. import resolve_device
    from ..data.dataset import gather_all_samples_from_directory, split_pairs
    from ..models.configs import config_to_json
    from ..nas.fps_cache import FPSCache
    from ..nas.search import MedianPruner, TPESampler, create_study
    from ..nas.studies import STUDY_PRESETS, config_from_trial_params, make_objective
    from ..utils.platform import register_preemptible_pid

    register_preemptible_pid()  # a bench run may preempt us; the study resumes
    dev = resolve_device(args.device)
    os.makedirs(s["out"], exist_ok=True)
    pairs = gather_all_samples_from_directory(s["data"], s["crop"], verbose=1)
    train_pairs, val_pairs = split_pairs(pairs, 0.1)
    print(f"corpus: {len(train_pairs)} train / {len(val_pairs)} val pairs", flush=True)

    cache = FPSCache(os.path.join(s["out"], "model_performance_cache.json"))
    objective = make_objective(
        train_pairs=train_pairs,
        val_pairs=val_pairs,
        crop_size=s["crop"],
        epochs_per_trial=s["epochs"],
        samples_per_epoch=s["samples"],
        min_fps=s["min_fps"],
        fps_cache=cache,
        fps_duration_s=s["fps_s"],
        device=dev,
        **STUDY_PRESETS["prune_act_r2"],
    )
    study = create_study(
        "prune_act_r2", os.path.join(s["out"], "studies.sqlite"),
        load_if_exists=True,
        sampler=TPESampler(seed=0),
        pruner=MedianPruner(n_warmup_steps=1),
    )
    t0 = time.monotonic()
    for _ in range(s["trials"]):
        if s["budget_s"] and time.monotonic() - t0 > s["budget_s"]:
            print(f"budget {s['budget_s']:.0f}s reached after {len(study.trials)} total "
                  "trials; finalizing (resume by re-running: SQLite load_if_exists)",
                  flush=True)
            break
        study.optimize(objective, n_trials=1)

    bt = study.best_trial
    if bt is None:
        print("no completed trials", file=sys.stderr)
        print(json.dumps({"error": "no completed trials",
                          "trials_total": len(study.trials)}), flush=True)
        return 1
    print(f"best value {bt.value:.6g} (trial {bt.number})", flush=True)

    # FPS-cache hit demonstration: the best trial's architecture through
    # get_or_measure with a sentinel measurement; a hit never calls it
    best_cfg = config_from_trial_params("prune_act_r2", bt.params)
    measured = {"count": 0}

    def _sentinel():
        measured["count"] += 1
        return -1.0

    hit_fps = cache.get_or_measure(config_to_json(best_cfg), _sentinel)
    cache_hit = measured["count"] == 0 and hit_fps > 0
    print(f"fps-cache replay of best arch: fps={hit_fps:.1f} "
          f"hit={cache_hit} (measure invoked {measured['count']}x)", flush=True)
    plots = write_plots(study, s["out"])

    n_complete = sum(1 for t in study.trials if t.is_complete)
    summary = {
        "study": "prune_act_r2",
        "trials_total": len(study.trials),
        "trials_complete": n_complete,
        "trials_pruned_or_failed": len(study.trials) - n_complete,
        "epochs_per_trial": s["epochs"],
        "samples_per_epoch": s["samples"],
        "crop_size": list(s["crop"]),
        "min_fps_gate": s["min_fps"],
        "best_trial": {"number": bt.number, "value": bt.value, "params": bt.params},
        "fps_cache_hit_on_best_arch": {
            "fps": hit_fps,
            "hit": bool(cache_hit),
            "measure_invocations": measured["count"],
        },
        "plots": plots,
    }
    with open(os.path.join(s["out"], "best_trial.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

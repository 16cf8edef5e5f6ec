"""Delete FAIL / non-finite trials from a study database.

Port of ``fs_uae_image_enhancer_project_tpu/nas/prune_failed.py``, the
counterpart of the reference's ``model/prune_failed_trials.py`` (which deletes
rows from Optuna's SQLite tables); here it is a Study operation, on either
package's study database.

    python -m fs_uae_image_enhancer_project_tpu_torch.nas.prune_failed --study NAME
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    import argparse

    from .search import Study

    ap = argparse.ArgumentParser(description="Prune failed/non-finite trials")
    ap.add_argument("--storage", default="tuning_results/studies.sqlite")
    ap.add_argument("--study", required=True)
    ap.add_argument("--delete_pruned", action="store_true",
                    help="also delete PRUNED trials (default: FAIL and "
                         "non-finite only, matching the reference's cleanup)")
    args = ap.parse_args(argv)
    study = Study(args.study, args.storage)
    states = ("FAIL", "PRUNED") if args.delete_pruned else ("FAIL",)
    n = study.delete_trials(states=states)
    print(f"deleted {n} failed/non-finite trials from '{args.study}'")
    print(f"{len(study.trials)} trials remain; best value: {study.best_value}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

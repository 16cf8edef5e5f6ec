"""Long fresh pix_shuffle_heavy training run for the head-to-head study.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.train_psh_heavy_long \\
        [--data DIR] [--out DIR] [--epochs 120] [--device cpu]

Port of the repo's ``scripts/train_psh_heavy_long.py``: pix_shuffle_heavy
(the fastest family of the zoo, with 4.4x the parameters of the production
lightweight) trained fresh under ``train_psh_long``'s exact protocol, its
arguments and defaults (the same gather, ``split_pairs(seed=0)``, the
criterion pinned to the JAX package's fixed-seed random VGG, the learning
rate of the reference's ``train_pix_shuffle.sh``), so that the head-to-head
gains a trained heavy row. Preemptible as ``train_psh_long`` is.

The checkpoints go to ``--out``, by default ``train_psh`` under the port's
work directory: the path ``common.TRAINED_CKPTS["pix_shuffle_heavy"]``
points at, so ``eval_headtohead`` picks the run up. The heavy model runs
eagerly (K1 is the lightweight stack's kernel). The last line is one JSON
object, as ``train_psh_long``'s.
"""
from __future__ import annotations

import os
import sys

from . import train_psh_long
from .common import WORK_DIR

OUT = os.path.join(WORK_DIR, "train_psh")
DESCRIPTION = "Long fresh pix_shuffle_heavy training run"


def build_parser():
    return train_psh_long.build_parser(OUT, DESCRIPTION)


def main(argv=None) -> int:
    return train_psh_long.run(argv, "heavyweight", OUT, DESCRIPTION)


if __name__ == "__main__":
    sys.exit(main())

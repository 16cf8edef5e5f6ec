#!/bin/bash
# NAS study recipe (prune_act study: first-round activation pruning over the
# conv6 model, lores dataset, crop 376x288), on the card. Pass --fps_cache
# <file> after the data directory to keep the FPS cache outside the working
# directory.
DATA=${1:-data/quantized/train}
"${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.nas.studies \
  --study prune_act --trials 35 \
  --generator_train_dir "$DATA" --crop_size 376 288 \
  --epochs_per_trial 10 --samples_per_epoch 512 \
  --storage tuning_results/studies.sqlite "${@:2}"

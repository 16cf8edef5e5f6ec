#!/bin/bash
# NAS study recipe (opt_act study: activation search on layers 1/2/4/6/7 of
# the conv6 model, 10 epochs per trial, MedianPruner warmup 6, crop
# 376x288), on the card. Pass --fps_cache <file> after the data directory to
# keep the FPS cache outside the working directory.
DATA=${1:-data/quantized/train}
"${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.nas.studies \
  --study opt_act --trials 35 \
  --generator_train_dir "$DATA" --crop_size 376 288 \
  --epochs_per_trial 10 --samples_per_epoch 512 \
  --pruning_warmup_steps 6 \
  --storage tuning_results/studies.sqlite "${@:2}"

#!/bin/bash
# Ground-truth normalization: ICC->sRGB PNGs, fit within 1920x1080 (LANCZOS),
# mirrored tree; the port's counterpart of the root recipe (host only).
#   usage: prepare_groundtruth.sh <src_dir> <dst_dir> [extra flags...]
"${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.datagen.prepare_groundtruth \
  --max_crop_size 1920 1080 \
  --src "${1:-dataset/original_train}" \
  --dst "${2:-dataset/groundtruth_train}" \
  "${@:3}"

#!/bin/bash
# conv5 training recipe on the card (sRGB-domain model; SSIM-weighted loss).
DATA=${1:-data/quantized/train}
CKPT=${2:-ckpts/conv5}
"${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.train.cli \
  --model_type conv5 --generator_train_dir "$DATA" \
  --checkpoint_dir "$CKPT" --crop_size 376 288 \
  --epochs 40 --train_samples 9000 --val_samples 1000 \
  --batch_size 8 --accumulation_steps 2 "${@:3}"

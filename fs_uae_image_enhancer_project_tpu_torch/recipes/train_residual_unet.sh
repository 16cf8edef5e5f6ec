#!/bin/bash
# residual U-Net training recipe on the card (input sizes must divide
# 2^depth).
DATA=${1:-data/quantized/train}
CKPT=${2:-ckpts/residual_unet}
"${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.train.cli \
  --model_type residual_unet --generator_train_dir "$DATA" \
  --checkpoint_dir "$CKPT" --crop_size 368 288 \
  --epochs 50 --train_samples 20000 --val_samples 2000 \
  --batch_size 4 --accumulation_steps 4 "${@:3}"

#!/bin/bash
# Production training recipe for the lightweight pix_shuffle on the card (lr
# from the NAS study, crop 376x288, 50k samples/epoch); validation runs
# through the fused-stack CUDA kernel. Add --samples_dir <frames> after the
# checkpoint directory to render frames at each new best.
DATA=${1:-data/quantized/train}
CKPT=${2:-ckpts/pix_shuffle}
"${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.train.cli \
  --model_type pix_shuffle --generator_train_dir "$DATA" \
  --checkpoint_dir "$CKPT" --crop_size 376 288 \
  --epochs 50 --train_samples 50000 --val_samples 5000 \
  --batch_size 8 --accumulation_steps 4 \
  --learning_rate 0.000544 --early_stopping_patience 10 "${@:3}"

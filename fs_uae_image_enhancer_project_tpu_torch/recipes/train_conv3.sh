#!/bin/bash
# Curriculum recipe for conv3 on the card: staged runs with growing
# epochs/epoch-size (resume is CSV-based, so each stage continues the
# previous one).
DATA=${1:-data/quantized/train}
CKPT=${2:-ckpts/conv3}
for STAGE in "20 5000" "60 7000" "200 9000"; do
  set -- $STAGE
  "${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.train.cli \
    --model_type conv3 --generator_train_dir "$DATA" \
    --checkpoint_dir "$CKPT" --crop_size 376 288 \
    --epochs "$1" --train_samples "$2" --val_samples 1000 \
    --batch_size 8 --accumulation_steps 2
done

#!/bin/bash
# Curriculum recipe for conv3_heavy on the card: five stages with growing
# epochs / epoch-size / accumulation at lr 0.0006, early-stopping patience
# widening 10->30 (CSV-based resume chains stages).
DATA=${1:-data/quantized/train}
CKPT=${2:-ckpts/conv3_heavy}
#         epochs  bs  accum  samples  patience
for STAGE in "20 16 1 5000 10" "40 32 1 6000 15" "80 32 2 7000 20" \
             "120 32 4 8000 25" "200 32 8 9000 30"; do
  set -- $STAGE
  "${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.train.cli \
    --model_type conv3_heavy --generator_train_dir "$DATA" \
    --checkpoint_dir "$CKPT" --crop_size 376 288 \
    --learning_rate 0.0006 --checkpoint_interval 5 \
    --epochs "$1" --batch_size "$2" --accumulation_steps "$3" \
    --train_samples "$4" --val_samples $(($4 / 10)) --val_split_ratio 0.1 \
    --early_stopping_patience "$5"
done

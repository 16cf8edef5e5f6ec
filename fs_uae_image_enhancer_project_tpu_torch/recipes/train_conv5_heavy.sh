#!/bin/bash
# Curriculum recipe for conv5_heavy on the card: three stages at lr 0.0006
# (5k/6k/10k samples, patience 10/15/20).
DATA=${1:-data/quantized/train}
CKPT=${2:-ckpts/conv5_heavy}
#         epochs  bs  accum  samples  patience
for STAGE in "20 16 1 5000 10" "40 32 2 6000 15" "200 32 2 10000 20"; do
  set -- $STAGE
  "${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.train.cli \
    --model_type conv5_heavy --generator_train_dir "$DATA" \
    --checkpoint_dir "$CKPT" --crop_size 376 288 \
    --learning_rate 0.0006 --checkpoint_interval 5 \
    --epochs "$1" --batch_size "$2" --accumulation_steps "$3" \
    --train_samples "$4" --val_samples $(($4 / 10)) --val_split_ratio 0.1 \
    --early_stopping_patience "$5"
done

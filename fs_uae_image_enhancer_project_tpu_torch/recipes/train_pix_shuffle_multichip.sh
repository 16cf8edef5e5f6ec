#!/bin/bash
# Multi-card training: a dp x sp mesh, one process a rank on one card each,
# joined in an nccl process group (the CLI spawns the ranks; gradients are
# all-reduced and conv halos exchanged over torch.distributed). The defaults
# are for a host with 8 cards: the CLI exits 1, and trains nothing, when
# fewer cards are visible than NDEV. For a local smoke run of the ranks as
# gloo processes on the CPU, call the CLI with --device cpu.
DATA=${1:-data/quantized/train}
CKPT=${2:-ckpts/pix_shuffle_mc}
NDEV=${3:-8}
SP=${4:-2}
"${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.train.cli \
  --model_type pix_shuffle --generator_train_dir "$DATA" \
  --checkpoint_dir "$CKPT" --crop_size 376 288 \
  --n_devices "$NDEV" --spatial "$SP" \
  --epochs 50 --batch_size "$((NDEV / SP * 2))" --accumulation_steps 4 \
  --train_samples 50000 --val_samples 5000 \
  --learning_rate 0.000544

#!/usr/bin/env bash
# Staged pix_shuffle_heavy training on the card: an LR-restart stage seeded
# from a prior best checkpoint, run as a chain of processes that resume from
# the stage's CSV.
#
# Why a chain of processes: it is the crash and preemption resume. The
# trainer registers as preemptible (a bench run on the card stops it through
# the pid file), and a process that dies (a preemption, an OOM kill, a lost
# card) is started again at the same target; CSV resume is lossless
# (trainer.load_last_epoch_and_checkpoint), so a stop loses at most the
# in-flight epoch. The process is NOT restarted to bound host memory: the
# port's transfer probe (the port's scripts.probe_transfer_retention)
# retained 0.00 GB per GB sent to an H100, so one long process holds its RSS.
# The 12-epoch stride bounds nothing: it is kept only so that each stage
# process's command line is the root recipe's (--epochs 12, 24, ...), and
# each restart costs one process start, the VGG asset's load and cuDNN's
# warm-up.
#
# Why the CSV seed row: the trainer's resume semantics (reference
# train.py:86-148) take model weights from "Checkpoint Path", the learning
# rate from the last CSV row, and rebuild fresh optimizer state — exactly
# the reference's staged-curriculum pattern (train_*.sh stages), so a
# hand-seeded row IS a stage boundary: weights from the previous stage's
# best, lr reset to $LR, stage-local best starts at inf.
#
# Usage: train_heavy_staged.sh [OUT] [LR] [TOTAL_EPOCHS] [SEED_CKPT]
# (OUT and SEED_CKPT default to the port's work directory, build/work, where
# its training drivers write; relative paths are from the repo root)
set -euo pipefail
cd "$(dirname "$0")/../.."
OUT=${1:-build/work/train_psh2}
LR=${2:-0.00015}
TOTAL=${3:-40}
SEED_CKPT=${4:-build/work/train_psh/checkpoint_best_pix_shuffle}
STRIDE=12

mkdir -p "$OUT"
CSV="$OUT/training_stats_pix_shuffle.csv"
if [ ! -f "$CSV" ]; then
  if [ ! -d "$SEED_CKPT" ]; then
    echo "seed checkpoint not found: $SEED_CKPT" >&2
    exit 1
  fi
  printf 'Epoch,Train Loss,Validation Loss,EpochsNoImprove,LearningRate,Checkpoint Path\n' > "$CSV"
  printf '0,inf,inf,0,%s,%s\n' "$LR" "$SEED_CKPT" >> "$CSV"
  echo "seeded stage CSV: weights=$SEED_CKPT lr=$LR"
fi

TARGET=$STRIDE
TRIES=0
while true; do
  [ "$TARGET" -gt "$TOTAL" ] && TARGET=$TOTAL
  echo "=== stage process: epochs -> $TARGET ==="
  # a stopped or crashed process is retried at the same target: CSV resume
  # loses at most the in-flight epoch
  "${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.scripts.train_psh_heavy_long \
    --out "$OUT" --lr "$LR" --epochs "$TARGET" || echo "stage process exited nonzero; resuming"
  LAST=$(tail -1 "$CSV" | cut -d, -f1)
  if [ "$LAST" -ge "$TOTAL" ]; then break; fi
  # early stop: the trainer writes a final CSV row at the stopping epoch
  # with the patience counter past the budget (field 4), then exits early
  PAT=$(tail -1 "$CSV" | cut -d, -f4)
  if [ "$PAT" -gt 20 ]; then echo "early stop detected"; break; fi
  if [ "$LAST" -ge "$TARGET" ]; then
    TARGET=$((TARGET + STRIDE))
    TRIES=0
  else
    TRIES=$((TRIES + 1))
    if [ "$TRIES" -ge 5 ]; then
      echo "no forward progress after $TRIES tries; giving up" >&2
      exit 1
    fi
  fi
done
echo "staged run complete: $(tail -1 "$CSV")"

#!/bin/bash
# Start the resident enhance sidecar on the card for emulator integration.
# One process owns the enhance (the fused-stack CUDA kernel for pix_shuffle);
# emulators connect over the unix socket with runtime/sidecar_client.c (or
# test with the port's runtime.sidecar_replay). Concurrent instances share
# the card.
#
# usage: serve_sidecar.sh [socket] [model] [weights.onnx] [server flags...]
# (e.g. --stats FILE writes the server-side latency summary on exit)
set -e
SOCKET="${1:-/tmp/fsuae_enhance.sock}"
MODEL="${2:-pix_shuffle}"
WEIGHTS="${3:-}"

ARGS=(--socket "$SOCKET" --model "$MODEL" --depth 2 --max_clients 4)
[ -n "$WEIGHTS" ] && ARGS+=(--weights "$WEIGHTS")

exec "${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar \
  "${ARGS[@]}" "${@:4}"

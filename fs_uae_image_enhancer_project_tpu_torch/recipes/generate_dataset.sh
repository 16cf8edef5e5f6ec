#!/bin/bash
# Canonical dataset generation on the card: the root recipe's styles
# (376x288 lores crops, palettes {none,32..1024}, all 11 dithers, rotations
# {0,20..80}, downscales {40..90}) through the port's generator. The palettes
# are kmeans_torch on the card and the vectorizable dithers run through the
# CUDA dither kernel in batches of 16 crops (README.md's on-device variant):
# sklearn's kmeans is not on the card machine, and the numpy backend never
# reaches the kernel. Flags given after the third argument override these.
#   usage: generate_dataset.sh <train_images> <test_images> [dest_dir] [flags...]
"${PYTHON:-python3}" -m fs_uae_image_enhancer_project_tpu_torch.datagen.generator \
  --train_images "$1" --test_images "$2" --dest_dir "${3:-data/quantized}" \
  --crop_size 376 288 \
  --resolution lores \
  --colorspace RGB444 \
  --palette 0 32 64 128 256 512 1024 \
  --dither none checkerboard bayer2x2 bayer4x4 bayer8x8 \
           floyd-steinberg atkinson sierra2 sierra3 stucki burkes \
  --rotation 0 20 40 60 80 \
  --downscale 40 50 60 70 80 90 \
  --grid overlap \
  --palette_algorithm kmeans_torch --quantize_backend device --device_batch 16 \
  --workers 1 \
  "${@:4}"
# --grid overlap: the centered 20%-overlap grid (~1.5x more crops than the
# reference's tiling, which is the CLI default), as the root recipe pins it,
# so a corpus made by either recipe is rerun idempotently.

"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--parent DIR]

Phases, each printing one JSON line with its wall time:

1. device     the card (nvidia-smi name and power limit, torch's name)
2. build      nvcc build of the port's kernels (time, ptxas registers/spills);
              K1's and K2's registers, local memory (spills) and shared
              memory from cudaFuncGetAttributes, and their plan (tile, ring)
              held to ops/cuda/fused_stack_plan.py; the same for every
              width K4 is compiled at and each case's plan (its ring's
              shared memory held to ops/cuda/lane_packing.py's), and for
              K3's three modes (threads, pixels a thread); no kernel spills
3. k1_parity  the fused-stack kernel (K1) against its plain PyTorch version,
              shipped weights, seeded inputs, half-res 288x376, 288x368 and
              290x375 (neither side a multiple of the 16x14 tile); three
              frames in one launch against three launches; then K1's
              enhance entry (uint8 RGBA in and out, one launch a call) on 8
              seeded 576x752 frames at 1 and 8 frames a call, byte-equal to
              K1's bf16 entry with the eager glue, u8_launches counted, and
              the device ms of both on the same frames
4. k2_parity  the pair-packed fused-stack kernel (K2) the same way, and
              against K1
5. k4_parity  the lane-packing kernel (K4, wgmma) against its plain version
              at the bench's 12 GEMM shapes, grid 2: the accumulator and the
              output
6. k3_parity  the palette-dither kernel (K3) against its plain version, byte
              for byte: 16 lores crops (188x144), one 376x288 crop and one
              ragged crop, N in {2, 32, 256, 1024}, every mode
7. epilogue   the conv epilogue kernel (ops/cuda/conv_epilogue.py) against its
              plain version bit for bit, in bf16 at the residual U-Net's
              largest shapes: 8x288x368x108 with bias and ReLU (conv2),
              8x288x368x72 with bias, ReLU and the residual (conv3), and the
              same with a projection's bias; then CUDA-event ms of each
              against its bytes' bound at 3.35 TB/s and the eager chain's ms
              (library_ms), and the kernels' registers and spills from the
              build's ptxas report (none may spill)
8. enhance    8 seeded 576x752 RGBA frames through enhance_from_onnx on cuda
9. server     the port's frame server at depth 0 and 2 (slice 1's main path):
              every launch counter is set to 0 just before and read just after
10. recipes    the port's run recipes (fs_uae_image_enhancer_project_tpu_torch/
              recipes, slice 13), each through bash in a temporary directory
              with PYTHON this interpreter, the work cut only through their
              pass-through: prepare_groundtruth.sh on the datagen phase's two
              source images; generate_dataset.sh on its output (16 crops: 4
              an image at scale 100% and 90%, palettes 64 and 256, dithers
              none and bayer4x4, one rotation; 376x288 lores crops, the
              device route), its command line recorded through a shim PYTHON and run
              again by the port's generator in this process (K3 counted from
              0 there; both PNG trees byte-equal); train_pix_shuffle.sh on
              that tree for one epoch of 32 samples and 8 validation samples
              at the recipe's batch and accumulation (one optimizer step; the
              CSV, the best checkpoint, K1 in the child's validation from its
              metrics line); serve_sidecar.sh as a child with the shipped
              graph and --stats, the C replay tool (runtime/sidecar_client.c
              built with cc or gcc) 8 loops of one 576x752 frame and the
              Python client once, byte-equal to each other and to this
              process's enhance, K1's launches from the server's stats
11. families   every other model family of the served path (slice 7's main
              path), the six shipped graphs artifacts/model_{conv3,
              conv3_heavy,conv5,conv5_heavy,conv6,residual_unet}, one seeded
              576x752 frame each, counters from 0 (cuDNN's convolutions
              and the conv epilogue kernel, once a biased convolution of a
              bf16 forward, a projection's bias in its block's conv3 pass;
              no other kernel of the repo): shape, dtype and alpha, on
              the card; the bf16 enhance against the fp32 one (no TF32)
              >= 50 dB; the card's fp32 against the CPU's on a 160x160
              window within one level; the imported weights re-exported at
              the graph's own precision by the port's exporter give the
              shipped file's bytes, and its frames equal the shipped
              graph's; the U-Net served at depth 2, byte-equal to the direct
              enhance
12. parallel_tools  slice 8's paths with the shipped pix_shuffle graph in one
              process, K1's launches counted on each: measure_stream_throughput
              at depth 1 and 2 over 200 seeded frames (host arrays in and
              out; K1 once a frame, warm-up included) beside the enhance's
              device-frame ms; enhance_directory over 8 seeded 576x752 PNGs
              at batch_size 4 on the 1x1 mesh (byte-equal to the per-frame
              enhance, K1 twice); the frame server as a child process at
              depth 2 with --stats, waited for with utils.subproc's
              wait_for_line, replayed by sidecar_replay --loops 2
              --shutdown (every saved PNG byte-equal to the per-frame
              enhance); served latency: a server child at depth 0 and one
              at depth 2, each replayed over 160 frames (20 loops), their
              --stats p50/p90/p99, byte-equal as above; models.benchmark for
              pix_shuffle and conv3 (1 s each); the spatial split at sp 2
              and 4 as a loop over slabs, within K1's 6e-3 of the unsplit
              K1 frame (K1 once a slab)
13. datagen   the port's dataset generator (slice 2's main path) on two seeded
              1504x1152 images, 376x288 lores crops, kmeans_torch palettes 64
              and 256, five dithers, device_batch 16, counters from 0; then
              its rerun (nothing to do), k-means on the card against the CPU,
              and the per-crop route against the batched one, PNG for PNG,
              with one worker and with two (spawned, a CUDA context each)
14. train     training (slice 6's main path) on the datagen phase's tree
              through the trainer CLI: the lightweight pix_shuffle with its
              own criterion (VGG 0.007 on the committed self-trained asset,
              Charbonnier, the HF term), 376x288 uint8 batches of 1,
              accumulation 4, 2 epochs of 16 samples and 4 validation
              samples with a seeded frame rendered, then a resume to epoch
              3; conv5 (BatchNorm, SSIM) for one epoch of 2 steps. Checks:
              finite losses, moved parameters and BN buffers, the CSV's
              columns and epochs 1-3, the orbax checkpoints and the render, K1's
              counter 0 inside the train steps and one a validation batch,
              validation through K1 within 1e-3 relative of apply_eager, one
              fp32 step on the card from the seeded and the trained weights
              on two fixed batches (the tree's first two pairs in sorted path
              order, and TRAIN_HARD_BATCH): its loss within 1e-4 relative of
              the CPU's, each gradient leaf within 1e-3 of its scale (max |g|;
              for a conv bias or an activation parameter, the max sum of the
              magnitudes of the terms its gradient adds up) of the fp64 step
              on the card that replays the fp32 step's branch at every kink
              (train/gradcheck.py: L1 signs, ReLU masks, clips, max-pool
              argmaxes; the fp32 step's own ops run unchanged). Then
              samples/s, ms a step, the loader-wait share and peak memory
              at accumulation 16, bf16, VGG on and off (one warm-up step,
              32 micro-batches). Then the trainer's mesh path (slice 9) on a
              1x1 mesh over nccl (world size 1) against the run without a
              mesh, cuDNN deterministic: the checkpoint within 1e-6, K1 once
              a validation batch, and the mesh path's collectives counted
              (rank 0's state broadcast leaf by leaf, each step's gradients
              and loss all-reduced, each validation loss all-reduced: the
              calls a larger mesh makes, over a world of one rank); and the
              CLI asked for more ranks than
              cards (--n_devices 2 on one card) exits 1 with JAX's message
15. nas       the NAS entry point (slice 9): nas.studies.main, prune_act_r2
              (20 activations, layer 6's kernel size), 4 trials on the
              datagen tree cut to 128x96, 1 epoch of 32 samples at batch
              16, FPS of each candidate at 576x752 bf16 for 0.5 s, the
              study and the FPS cache in a temporary directory, counters
              from 0 (conv6: cuDNN and the conv epilogue). Checks:
              every trial COMPLETE (a trial's exception is a FAIL row) with
              an FPS above 0 (a failed measurement is cached as 0.0), a
              finite best value, every trial's params replayed
              (config_from_trial_params) to an architecture the FPS cache
              holds with the trial's FPS, one cache entry an architecture,
              the best trial's FPS again from the cache with no new
              measurement, the database reloaded equal, prune_failed, and
              param_importances finite. Each completed trial's train step
              timed warm on one batch of the tree. Each trial's
              architecture hash, FPS, ms a step, validation loss and state
              on a line
16. tools     the VGG self-training (20 steps at the asset JSON's patch and
              batch from the committed encoder; loss down; rescale_taps to
              the random basis's tap RMS on the probe within 1e-4;
              save_asset read back),
              raw_runner on a seeded 752x576 raw RGBA file with the shipped
              pix_shuffle graph (its PNG byte-equal to enhance_from_onnx's
              frame, K1 once, counted from 0), onnx_dump and onnx_svg on
              that graph (one line and one box a node)
17. export    the torch.export route (slice 10): pix_shuffle, conv3_heavy and
              the residual U-Net from their shipped graphs through
              enhance_from_onnx, exported at 1x576x752 on the card with
              export.stablehlo.export_enhance, loaded back in this process
              (and pix_shuffle's in a child process that imports only the
              port), byte-equal to the eager enhance on 8 seeded frames; K1
              (the custom op torch.ops.fse.fused_stack) once a pix_shuffle
              call, never for the others, counted from 0; the text dump
              names the op once; ms a frame loaded against eager
18. int8      slice 10's int8 path: quantized._qconv's int32 accumulators
              on the card equal to the CPU's on one conv3_heavy frame, layer
              by layer; then scripts/bench_int8_qat.py's study (conv3_heavy
              PTQ and QAT at 300 steps, pix_shuffle PTQ: min PSNR against
              the fp32 enhance over the eight committed frames; the
              distillation loss; ms a frame bf16 against int8, and K1
              against eager bf16 against int8 for pix_shuffle)
19. benchmark_tools  the four design tools (slice 10) on reduced grids,
              about 0.05 s a case: the activations' fwd and fwd+bwd at
              1x288x376x36, the conv grid at kernels 1-5 x 12/36/72
              channels, the equal-latency search for kernels 1 and 5, the
              gamma curves' errors and SVG
20. drivers   slice 11's drivers (scripts/), each through its main on the card,
              counters from 0: make_gt_frames (2 seeded 1504x1152 scenes and
              the 8 flat fills; its rerun keeps every file);
              bench_generator_e2e on those scenes (one crop each: the host
              leg, kmeans_torch on the CPU under its own name where sklearn
              does not import; the per-crop device leg, K3 10 times a crop;
              the batched leg, which goes per crop here: every scene crop
              has fewer RGB444 colours than either palette, K3 5 times a
              crop and palette, counted from the tree); its batched leg
              alone on 4 many-coloured 752x576 frames, 4 crops each (one
              chunk of 16, every crop with more colours than either
              palette: K3 exactly 10 times);
              bench_sidecar_multiclient (a server child a point, 1 and 2
              clients at depth 0 and 2, 1 s a point; the server's K1
              launches one a frame plus its warm-up; every answer byte-equal
              to this process's enhance of the same frame); bench_families
              and bench_conv6_latency (0.5 s a family or variant; K1 once a
              pix_shuffle frame); eval_headtohead on the generator's batched
              tree, 8 samples (4 rows: the plateau-50 row from the JAX
              script's orbax checkpoint second, nothing skipped);
              precompile at 576x752 (the warm process at its first frame
              sooner than the cold one, which builds the kernels before
              it: the enhance loads the library when it is made, so the
              frame itself pays no build on either side); build_artifacts for
              pix_shuffle, conv3 and pix_shuffle_trained (their ONNX bytes
              the committed ones; pix_shuffle_trained's weights from the
              committed orbax checkpoint checkpoint_best_epoch73)
21. orbax     slice 14: the JAX package's TPU-trained orbax checkpoints read
              by the port (train/orbax_reader.py: OCDBT and zstd in Python
              and numpy, no jax, tensorstore or zstd codec), each read's
              seconds on the host, params only and the whole tree:
              model_pix_shuffle_trained/checkpoint_best_epoch73 (its 24
              leaves bit-equal to the port's import of
              pix_shuffle_trained.onnx; a seeded 576x752 frame through K1
              with them byte-equal to enhance_from_onnx of that graph, K1
              once), training_parity/plateau_full and
              model_pix_shuffle_heavy/checkpoint_best_epoch60 (its eager
              bf16 forward on the frame finite, no K1); then the trainer
              CLI resumed on the datagen phase's tree for one epoch of 4
              samples from a copy of training_parity/ablation_novgg (its
              CSV, the path column rewritten to the copy, and the epoch-12
              checkpoint its last row names): the new row at epoch 13, the
              first step at the CSV's learning rate from the checkpoint's
              weights, bit for bit, K1 once a validation batch
22. orbax_write  slice 15: the trainer's checkpoints in the JAX package's
              orbax format (train/orbax_writer.py over utils/ocdbt.py's
              writer and utils/zstd.py's compress: zstd frames of raw
              blocks, no jax, tensorstore or zstd codec), on the card's host:
              pix_shuffle (its own criterion, VGG on) and conv3 (BatchNorm)
              from seeded weights, cuDNN deterministic, two optimizer steps
              of 2 of the datagen phase's 376x288 crops, then
              save_checkpoint and two rewrites over it (each write's
              seconds, the bytes and files on disk, no temporary directory
              left); read_orbax of the whole tree against the state on the
              card, leaf for leaf (Adam's moments found by the tensor); a
              fresh state restored by load_checkpoint, its learning rate
              and leaves the state's, and one more step of both, leaf for
              leaf; one seeded 576x752 frame through K1 with the
              checkpoint's parameters against the state's, byte for byte
              (K1 twice); then model_pix_shuffle_trained/
              checkpoint_best_epoch73 read whole, written again by the port
              and read back, leaf for leaf
23. wheel     slice 16: the port as a user installs it. The repo's wheel
              built by pip wheel --no-deps --no-build-isolation --no-index
              from a copy of pyproject.toml, README.md and the two packages,
              installed with pip
              install --no-deps --target into a temporary directory; its
              bin/fse-torch-sidecar started as a child with PYTHONPATH that
              directory alone, a working directory outside the repo and
              XDG_CACHE_HOME a temporary directory, on the shipped
              pix_shuffle graph at depth 2 with --stats; its warm-up frame
              builds K1-K4 cold from the wheel's kernel sources into that
              cache. 16 seeded 576x752 frames through the port's
              SidecarClient, each byte-equal to this process's
              enhance_from_onnx; from the server's stats, K1 once a frame and
              its warm-up, its fused_stack module under the install, its
              library under the cache with the checkout's hash directory,
              built by it, and its build seconds, warm-up (first) frame and
              p50; the wheel's and the install's seconds; nothing added to
              the checkout
24. train_drivers  slice 12's training and NAS drivers (scripts/), each
              through its main on the card on the datagen phase's tree,
              outputs in temporary directories, K1's counter from 0 for
              each: the JAX package's random VGG basis drawn cold
              (utils.threefry, its seconds); train_psh_long and
              train_psh_heavy_long at 2 epochs of 8 samples (each
              optimizer step timed; K1 once a validation batch of the
              lightweight, never for the heavy); training_parity_study at
              one epoch a leg (ablation, selfvgg, plateau: every row's
              vgg-free loss and PSNR finite, K1 once a validation and an
              evaluation batch); plot_training_parity (exit 1 naming
              matplotlib where it does not import); train_nas_winner from
              artifacts/nas_r5/best_trial.json at 1 epoch, 64 evaluation
              samples and 0.5 s of FPS at 576x752 bf16; train_vgg_features
              at 20 steps of 32 128x128 patches under the optax chain (each
              step timed; the calibrated taps within 1e-4 of
              random_baseline_rms of its probe, recomputed here);
              nas_demo_r2 at 2 trials on the tree cut to 128x96 (a cache
              hit); convert_vgg16_weights (exit 1 naming torchvision); the
              retention probe at 8 MB x 50 (GB retained per GB sent). The
              trainers' pid file holds this process's pid and is removed
25. kernel_bench  the two kernel benches (slice 3's main path), about half
              a second a variant, counters from 0: bench_fused_stack (eager
              bf16, K1, K2 on a 576x752 frame) and bench_lane_packing (K4's
              12 cases at grid 64)
26. timing    K1's and K2's device time a call (median, min and max of 3
              repeats of 50 back-to-back calls) and CUDA-event medians of
              K1, K2, their plain versions, cuDNN, the enhance (and its
              device time a frame); of K4 at the 12 cases, grid 64 (each
              case's plan, its error there), its plain version, the device
              time of one torch.matmul(bf16(a), w) times the 512 products
              (cuBLAS's time for the same products: library_ms) and of the
              eager torch.matmul chain (chain_ms); of K3, its plain version,
              cdist + topk, the batched k-means; of every family (ms a
              frame from CUDA events, device ms a frame, GFLOP a frame from
              the shapes, share of the bf16 peak, the kernels cuDNN ran); K1's
              custom op against its direct call (the host's µs a call, the
              pix_shuffle enhance's ms with either), which decides the served
              path
    turns     with --parent DIR (another checkout, e.g. the parent commit
              unpacked with git archive under build/): K3 and K4 of both
              trees, each in child processes of its own, parent, this tree,
              this tree, parent (scripts/turns_k3_k4.py), on the datagen
              phase's crops and k-means palettes
27. kernels   every kernel launched, held against its plain version

Then the card's nvidia-smi line and the kernels line, and last the contract
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero and
prints no result; a watchdog ends the run with exit 3 at 900 s. Needs one
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import glob
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

WATCHDOG_S = 900
REPO = os.path.dirname(os.path.abspath(__file__))
ONNX = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")
K1_SOURCE = "fs_uae_image_enhancer_project_tpu_torch/ops/cuda/csrc/fused_stack.cu"
K1_REPLACES = "fs_uae_image_enhancer_project_tpu/ops/pallas/fused_stack.py:204"
K3_SOURCE = "fs_uae_image_enhancer_project_tpu_torch/ops/cuda/csrc/dither.cu"
K3_REPLACES = "fs_uae_image_enhancer_project_tpu/ops/pallas/dither.py:49"
K2_SOURCE = "fs_uae_image_enhancer_project_tpu_torch/ops/cuda/csrc/fused_stack_packed.cu"
K2_REPLACES = "fs_uae_image_enhancer_project_tpu/ops/pallas/fused_stack_packed.py:162"
K4_SOURCE = "fs_uae_image_enhancer_project_tpu_torch/ops/cuda/csrc/lane_packing.cu"
K4_REPLACES = "scripts/bench_lane_packing.py:38"
EPILOGUE_SOURCE = "fs_uae_image_enhancer_project_tpu_torch/ops/cuda/csrc/conv_epilogue.cu"
# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, fp32 on the
# CUDA cores (no tensor cores), HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# the generator's default crop, its pre-styled lores size, and the slice of
# the generator's run (2 images, at most 8 crops each, 2 palettes x 5 dithers)
CROP_W, CROP_H = 376, 288
LORES = (CROP_H // 2, CROP_W // 2)
PALETTES = (64, 256)
DITHERS = ("none", "checkerboard", "bayer2x2", "bayer4x4", "bayer8x8")
K1_MAX_ABS, K1_MEAN_ABS = 6e-3, 6e-4
# K4: the accumulator within 1e-3 of max |acc| (mma sums in another order
# than the plain product); o within 1e-6 (the same fp32 ops on a, the row
# sum's order aside)
K4_ACC_REL, K4_O_ABS = 1e-3, 1e-6
K4_PARITY_GRID, K4_BENCH_GRID = 2, 64
PSNR_MIN_DB = 50.0
# training: accumulation of the checked runs and of the timed loop;
# validation through K1 against apply_eager (relative), and one fp32 step on
# the card against the CPU (the loss relative, each gradient leaf against
# its max |g|)
TRAIN_ACCUM, TIMED_ACCUM = 4, 16
TRAIN_VAL_REL, TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-3, 1e-4, 1e-3
# the fp32 step's second fixed batch: two styled crops of the datagen tree
# (paths relative to it) on which the card's fp32 gradient of the first
# sinlu's parameters was 0.9% from its fp64 one, and from the CPU's fp64 one
# (l1_act1.b; the CPU's own fp32 0.035%): 18 elements at kinks (L1 signs of
# VGG's taps, ReLU masks, a max-pool argmax) within rounding of their switch
# took the other branch in fp32
TRAIN_HARD_BATCH = ("train/img_0/lores_376_0_s0_r0_rgb444_p256_dbayer4x4.png",
                    "train/img_0/lores_376_0_s0_r0_rgb444_p256_dbayer8x8.png")

# slice 7: the other families' shipped graphs, the card-vs-CPU window (the
# U-Net's width after its crop of 16, 144, and 160 are divisible by 2^3) and
# the most a uint8 value of the card's fp32 may differ from the CPU's
FAMILIES = ("conv3", "conv3_heavy", "conv5", "conv5_heavy", "conv6", "residual_unet")
FAMILY_WINDOW = 160
FAMILY_MAX_LEVELS = 1
SERVE_DEPTH = 2
# slice 8: frames a stream-throughput reading takes, and at least as many
# frames a served-latency reading replays
STREAM_FRAMES = 200
LATENCY_FRAMES = 160
# slice 9: the NAS study the nas phase runs, its trials (4: the fewest
# with which param_importances scores) and its crop (W, H)
NAS_STUDY, NAS_TRIALS, NAS_CROP = "prune_act_r2", 4, (128, 96)
# the VGG self-training's learning rate: the peak of the committed asset's
# run (scripts/train_vgg_features.py --lr)
VGG_LR = 2e-4

# slice 10: the exported families, frames a round trip checks, the study's
# QAT steps and seconds a timed int8 variant, and the served path's choice
# for K1's custom op (more than this share of the enhance's ms keeps the
# direct call)
EXPORT_FAMILIES = ("pix_shuffle", "conv3_heavy", "residual_unet")
EXPORT_FRAMES = 8
INT8_QAT_STEPS, INT8_DURATION_S = 300, 0.5
OP_SHARE_LIMIT = 0.05

# slice 11: the drivers phase's corpus (1504x1152 scenes) and generator
# crops a scene; the many-coloured frames (gradient_noise at sigma 48, so
# that every lores crop has more RGB444 colours than either palette) and
# their crops each, one spec chunk of 16 for the batched leg; its served
# points (clients x depths, seconds a point), the timed window of a family
# or variant, and the head-to-head's samples
DRIVER_SCENES, DRIVER_CROPS = 2, 1
DRIVER_RICH_IMAGES, DRIVER_RICH_CROPS = 4, 4
DRIVER_CLIENTS, DRIVER_DEPTHS, DRIVER_SERVE_S = (1, 2), (0, 2), 1.0
DRIVER_WINDOW_S, DRIVER_EVAL_SAMPLES = 0.5, 8
# slice 12: the VGG self-training's steps in the train_drivers phase
TRAIN_DRIVERS_VGG_STEPS = 20
# slice 13: the run recipes, and how the recipes phase cuts their amount of
# work through each recipe's pass-through (never the crop or the frame
# size): the generator on the datagen phase's two images at 16 crops (4 an
# image and scale: the generator adds the undownscaled scale to the one
# downscale, as the reference's does), two palettes, two dithers, one
# rotation; one epoch of 32 training and 8 validation samples (one optimizer
# step at the recipe's batch 8 and accumulation 4); the C replay tool's
# sessions of one frame, a warm-up (the session's set-up and the pipeline's
# fill) and a measured window
RECIPES = os.path.join(REPO, "fs_uae_image_enhancer_project_tpu_torch", "recipes")
RECIPE_GENERATE_CUT = ("--palette", "64", "256", "--dither", "none", "bayer4x4",
                       "--rotation", "0", "--downscale", "90", "--max_crops_per_image", "4")
RECIPE_CROPS = 16
RECIPE_TRAIN_CUT = ("--epochs", "1", "--train_samples", "32", "--val_samples", "8")
RECIPE_REPLAY_WARMUP = 16
RECIPE_REPLAY_LOOPS = 400
# slice 14: the JAX package's TPU-trained orbax checkpoints the orbax phase
# reads (the trained lightweight graph's checkpoint, the plateau-50 run, the
# heavy run at epoch 60), the run it resumes (its CSV's last row names its
# epoch-12 checkpoint) and the resume's samples
ART = os.path.join(REPO, "artifacts")
ORBAX_TRAINED = os.path.join(ART, "model_pix_shuffle_trained", "checkpoint_best_epoch73")
ORBAX_TRAINED_ONNX = os.path.join(ART, "model_pix_shuffle_trained", "pix_shuffle_trained.onnx")
ORBAX_PLATEAU = os.path.join(ART, "training_parity", "plateau_full", "checkpoint_best_pix_shuffle")
ORBAX_HEAVY = os.path.join(ART, "model_pix_shuffle_heavy", "checkpoint_best_epoch60")
ORBAX_RESUME = os.path.join(ART, "training_parity", "ablation_novgg")
ORBAX_RESUME_SAMPLES, ORBAX_RESUME_VAL = 4, 2
# slice 15: the orbax_write phase's micro-batches a step (two steps before
# the write, one after the restore) and the rewrites over the first write
ORBAX_WRITE_ACCUM, ORBAX_WRITE_REWRITES = 2, 2
# slice 16: the wheel phase's two packages and the frames sent to the
# installed server
PACKAGES = ("fs_uae_image_enhancer_project_tpu", "fs_uae_image_enhancer_project_tpu_torch")
WHEEL_FRAMES = 16

# a child that imports only the port: load the artifact, enhance the frames,
# save them and K1's launches

_phase = "start"


def _watchdog() -> None:
    time.sleep(WATCHDOG_S)
    print(json.dumps({"phase": _phase, "error": f"watchdog: over {WATCHDOG_S} s"}),
          flush=True)
    os._exit(3)


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **fields}), flush=True)


def psnr(a, b) -> float:
    import numpy as np

    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def median_ms(fn, n: int = 50, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, n: int = 50, reps: int = 3, preroll_ms: float = 30.0) -> dict:
    """The device's time per call of ``fn``: ``utils.profiler.device_times``
    (median, min and max over ``reps`` runs of ``n`` back-to-back calls)."""
    from fs_uae_image_enhancer_project_tpu_torch.utils.profiler import device_times

    return device_times(fn, n=n, reps=reps, preroll_ms=preroll_ms)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def library_stack(u, sw):
    """The K1 function as eager bf16 torch (cuDNN convs): the yardstick timed
    as library_ms. The port never calls it."""
    import torch
    import torch.nn.functional as F

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda.fused_stack import PARAM_OFFSETS

    bf = torch.bfloat16
    p = sw.prm.to(bf)

    def v(name, n, shape=(1, -1, 1, 1)):
        o, _ = PARAM_OFFSETS[name]
        return p[o:o + n].view(shape)

    def conv(x, i, cout):
        o, _ = PARAM_OFFSETS[f"b{i + 1}"]
        return F.conv2d(x, sw.plain[i].to(bf), p[o:o + cout], padding=1)

    sc = v("scalars", 6, (6,))

    def sinlu(x, a, b):
        return torch.sigmoid(x) * (x + a * torch.sin(b * x))

    def bprelu(x, bias, slope):
        s = x - bias
        return torch.where(s >= 0, s, slope * s)

    x = u.permute(2, 0, 1)[None]
    l1 = sinlu(conv(x, 0, 36), sc[0], sc[1]).clamp(0, 6)
    t = conv(l1, 1, 36)
    t = t * torch.tanh(torch.exp(t)) + l1
    l2 = bprelu(sinlu(t, sc[2], sc[3]), v("p2b", 36), v("p2s", 36))
    l3 = conv(l2, 2, 72)
    l4 = torch.relu(torch.tanh(bprelu(F.mish(conv(l3, 3, 72)), v("p4b", 72), v("p4s", 72)) + l3))
    l5 = conv(l4, 4, 36)
    l6 = F.mish(conv(torch.cat([l1, l5], 1), 5, 36)).clamp(0, 6)
    return bprelu(conv(l6, 6, 12), sc[4], sc[5])[0].permute(1, 2, 0)


def stack_parity(dev, stack, plain, sw, other=None) -> list:
    """A fused-stack kernel (``stack``, K1 or K2) against its plain version on
    ``dev``: seeded linear-light inputs at half-res 288x376, 288x368 and
    290x375, the max and mean abs error against the plain version's fp32
    result, the largest error on the seams of the kernels' tile, and,
    with ``other`` (another kernel and its weights), the largest difference
    from it. Then three frames in one launch against the three frames one
    launch each."""
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda.fused_stack_plan import TILE

    gen = torch.Generator().manual_seed(0)
    recs = []
    th, tw = TILE
    for h2, w2 in ((288, 376), (288, 368), (290, 375)):
        u = (torch.rand(h2, w2, 12, generator=gen) ** 2.2).to(torch.bfloat16).to(dev)
        y = stack(u, sw).float()
        ref = plain(u, sw, out_fp32=True)
        err = (y - ref).abs()
        row, col = err.amax(dim=(1, 2)), err.amax(dim=(0, 2))
        seam_r = torch.tensor([r for r in range(h2) if r % th in (0, th - 1)], device=dev)
        seam_c = torch.tensor([c for c in range(w2) if c % tw in (0, tw - 1)], device=dev)
        rec = dict(shape=[h2, w2], max_abs=err.max().item(), mean_abs=err.mean().item(),
                   seam_row_max=row[seam_r].max().item(), seam_col_max=col[seam_c].max().item(),
                   right_edge_max=col[-2:].max().item(),
                   row_max_top5=sorted(row.tolist(), reverse=True)[:5],
                   finite=bool(torch.isfinite(y).all()))
        if other is not None:
            rec["max_abs_vs_other"] = (y - other[0](u, other[1]).float()).abs().max().item()
        recs.append(rec)
    trio = (torch.rand(3, 40, 58, 12, generator=gen) ** 2.2).to(torch.bfloat16).to(dev)
    one_by_one = torch.stack([stack(f.contiguous(), sw) for f in trio])
    recs.append(dict(shape=[3, 40, 58], batch_equals_frames=bool(torch.equal(stack(trio, sw),
                                                                            one_by_one))))
    return recs


def check_stack(name: str, recs: list) -> None:
    for rec in recs[:-1]:
        check(rec["finite"], f"{name} output not finite at {rec['shape']}")
        check(rec["max_abs"] <= K1_MAX_ABS, f"{name} max abs {rec['max_abs']} > {K1_MAX_ABS}")
        check(rec["mean_abs"] <= K1_MEAN_ABS,
              f"{name} mean abs {rec['mean_abs']} > {K1_MEAN_ABS}")
    check(recs[-1]["batch_equals_frames"], f"{name}: three frames in one launch differ")


def fused_enhance_parity(dev, imp, params) -> dict:
    """K1's enhance entry (``ops/cuda/fused_enhance.py``) against the
    composition it replaces, K1's bf16 entry with the eager glue, with the
    shipped graph's contract: 8 seeded 576x752 frames on the card, a frame
    a call and all 8 in one call. Byte equality, the launches counted
    (``fused_stack.u8_launches``), and the device ms a call of each
    (``device_times``: the host's launches hidden behind a sleep)."""
    import numpy as np
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import make_enhance_fn
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_enhance as fe
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs

    kw = dict(crop_left=imp.crop_left, srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
              linear_to_srgb_exponent=imp.linear_to_srgb_exponent, device=dev)
    fused = fe.make_fused_enhance_fn(params, **kw)
    composition = make_enhance_fn(get_model("pix_shuffle").apply, params, **kw)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, 576, 752, 4), dtype=np.uint8)).to(dev)
    before = fs.fused_stack.u8_launches
    equal = {1: all(torch.equal(fused(frames[i:i + 1]), composition(frames[i:i + 1]))
                    for i in range(8)),
             8: bool(torch.equal(fused(frames), composition(frames)))}
    u8_launches = fs.fused_stack.u8_launches - before
    rec = dict(fused=isinstance(fused, fe.FusedEnhance), crop_left=imp.crop_left,
               byte_equal={str(k): bool(v) for k, v in equal.items()},
               u8_launches=u8_launches, calls=9)
    for n in (1, 8):
        batch = frames[:n]
        f_ms = device_ms(lambda: fused(batch), n=20)
        c_ms = device_ms(lambda: composition(batch), n=20)
        rec[f"frames_{n}"] = dict(fused_ms=f_ms["ms"], fused=f_ms, composition_ms=c_ms["ms"],
                                 composition=c_ms, fused_ms_per_frame=f_ms["ms"] / n,
                                 composition_ms_per_frame=c_ms["ms"] / n)
    return rec


def k4_inputs(rng, m: int, k: int, n: int, dev):
    """The bench's data for one case: a ~ N(0, 1) fp32, w ~ N(0, 0.05) bf16."""
    import numpy as np
    import torch

    a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32))
    return a, w.to(torch.bfloat16).to(dev)


def k4_errors(got, want) -> dict:
    """K4's ``(o, acc)`` against the plain version's."""
    import torch

    (o, acc), (po, pacc) = got, want
    scale = pacc.abs().max().item()
    return dict(acc_max_abs=(acc - pacc).abs().max().item(), acc_scale=scale,
                acc_rel=(acc - pacc).abs().max().item() / scale,
                o_max_abs=(o - po).abs().max().item(),
                finite=bool(torch.isfinite(acc).all() and torch.isfinite(o).all()))


def k4_parity(dev, grid: int = K4_PARITY_GRID, cases=None) -> list:
    """K4 against its plain version at the bench's 12 shapes (seeded as the
    bench seeds them), ``grid`` steps of 8 products."""
    import numpy as np

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import lane_packing as k4

    rng = np.random.default_rng(0)
    out = []
    for label, variant, m, k, n in (k4.CASES if cases is None else cases):
        a, w = k4_inputs(rng, m, k, n, dev)
        rec = dict(case=f"{label} {variant}", shape=[m, k, n], grid=grid,
                   **k4_errors(k4.lane_packing_mm(a, w, grid), k4.lane_packing_mm_plain(a, w, grid)))
        out.append(rec)
    return out


def check_k4(recs: list) -> None:
    for r in recs:
        check(r["finite"], f"K4 not finite: {r['case']}")
        check(r["acc_rel"] <= K4_ACC_REL,
              f"K4 accumulator {r['acc_rel']} of max|acc| > {K4_ACC_REL}: {r['case']}")
        check(r["o_max_abs"] <= K4_O_ABS, f"K4 o {r['o_max_abs']} > {K4_O_ABS}: {r['case']}")


def library_lane_chain(a, w, grid: int):
    """K4's chain as eager torch with torch.matmul on bf16 (cuBLAS), about
    2,560 launches a call: timed as chain_ms, which earlier PRs reported as
    library_ms. The port never calls it."""
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda.lane_packing import REPS

    ab = a.to(torch.bfloat16)
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
    for _ in range(REPS * grid):
        acc = torch.matmul(ab, w).float() * 1e-4 + acc * 0.5
    return a * 0.999 + 1e-7 * acc.sum(dim=1, keepdim=True), acc


def kernel_bench(dev, duration_s: float = 0.5, fused_shape=(1, 576, 752, 3), lane_cases=None,
                 grid: int = K4_BENCH_GRID) -> dict:
    """Slice 3's main path: the two kernel benches' ``main`` with short
    windows, every launch counter set to 0 just before and read just after."""
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_packed as k2
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import lane_packing as k4
    from fs_uae_image_enhancer_project_tpu_torch.scripts import bench_fused_stack, bench_lane_packing

    counters = {"fused_stack": fs.fused_stack, "fused_stack_packed": k2.fused_stack_packed,
                "lane_packing_mm": k4.lane_packing_mm, "palette_dither": k3.palette_dither}
    for c in counters.values():
        c.launches = 0
    fused = bench_fused_stack.main(duration_s=duration_s, warmup=3, device=dev, shape=fused_shape,
                                   only="")
    lane = bench_lane_packing.main(duration_s=duration_s, warmup=2, device=dev, cases=lane_cases,
                                   grid=grid)
    return dict(launches={k: c.launches for k, c in counters.items()}, fused=fused, lane=lane)


def library_matmul_ms(a, w, products: int) -> float:
    """cuBLAS's time for K4's products: the device time of one
    torch.matmul(bf16(a), w) (:func:`device_ms`), times ``products``. The
    yardstick timed as library_ms; the port never calls it."""
    import torch

    ab = a.to(torch.bfloat16)
    return device_ms(lambda: torch.matmul(ab, w), n=20)["ms"] * products


def k4_timing(dev, grid: int = K4_BENCH_GRID, cases=None) -> list:
    """K4, its plain version and the eager torch.matmul chain at the 12 cases
    and ``grid`` (CUDA-event medians), cuBLAS's time for the same products
    (:func:`library_matmul_ms`), with each case's bound from its shape, its
    plan, and K4's error against the plain version at this grid."""
    import numpy as np

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import lane_packing as k4

    rng = np.random.default_rng(0)
    rows = []
    for label, variant, m, k, n in (k4.CASES if cases is None else cases):
        a, w = k4_inputs(rng, m, k, n, dev)
        flops = 2.0 * m * k * n * k4.REPS * grid
        nbytes = 4 * m * k * 2 + 2 * k * n + 4 * m * n
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
        kern = median_ms(lambda: k4.lane_packing_mm(a, w, grid), n=20, warmup=3)
        plain = median_ms(lambda: k4.lane_packing_mm_plain(a, w, grid), n=3, warmup=1)
        chain = median_ms(lambda: library_lane_chain(a, w, grid), n=3, warmup=1)
        lib = library_matmul_ms(a, w, k4.REPS * grid)
        err = k4_errors(k4.lane_packing_mm(a, w, grid), k4.lane_packing_mm_plain(a, w, grid))
        plan = k4.tile_plan(m, k, n)
        rows.append(dict(
            case=f"{label} {variant}", shape=[m, k, n], grid=grid, gflop=flops / 1e9,
            k4_ms=kern, plain_ms=plain, library_ms=lib, chain_ms=chain,
            slower_than_library=kern > lib, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            share_of_bound=max(ops_ms, bytes_ms) / kern, tflops_raw=flops / kern / 1e9,
            n_per_instruction=plan.nc, ctas=plan.ctas,
            ring="resident" if plan.resident else "streamed", smem=plan.smem, **err))
    return rows


def k3_modes():
    """(label, method, bayer) for each of K3's modes."""
    from fs_uae_image_enhancer_project_tpu_torch.datagen.quantize import (
        BAYER_MATRIX_2X2, BAYER_MATRIX_4X4, BAYER_MATRIX_8X8)

    return [("map", "none", None), ("checker", "checkerboard", None),
            ("bayer2x2", "ordered", BAYER_MATRIX_2X2), ("bayer4x4", "ordered", BAYER_MATRIX_4X4),
            ("bayer8x8", "ordered", BAYER_MATRIX_8X8)]


def library_nearest_two(px, pal):
    """The distance search of K3 as PyTorch calls (cdist, then the two
    smallest): the yardstick timed as library_ms. The port never calls it."""
    import torch

    return torch.cdist(px, pal).topk(2, dim=2, largest=False)


def tree_bytes(root: str) -> dict:
    out = {}
    for r, _d, files in os.walk(root):
        for f in files:
            with open(os.path.join(r, f), "rb") as fh:
                out[os.path.relpath(os.path.join(r, f), root)] = fh.read()
    return out


def k3_parity(dev) -> dict:
    """K3 against its plain version on ``dev``: 16 lores crops, one 376x288
    (hires_laced) crop and one ragged crop, N in {2, 32, 256, 1024}, every
    mode. Returns the counts of differing pixels by case."""
    import numpy as np
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3
    from fs_uae_image_enhancer_project_tpu_torch.scripts.common import gradient_noise

    rng = np.random.default_rng(3)
    lores = np.stack([gradient_noise(*LORES, seed=100 + i) for i in range(16)])
    lores[::2] = lores[::2] // 16 * 16  # every other crop on the RGB444 grid
    crops = {"lores16": lores, "hires_laced": gradient_noise(CROP_H, CROP_W, seed=99)[None],
             "ragged": gradient_noise(29, 37, seed=98)[None]}  # 1073 px: not a multiple of 256
    err, cases, differ = 0, 0, {}
    for cname, arr in crops.items():
        x = torch.from_numpy(arr).to(dev)
        for n in (2, 32, 256, 1024):
            pal = torch.from_numpy(rng.integers(0, 256, (arr.shape[0], n, 3), dtype=np.uint8))
            pal = pal.to(dev)
            x[:, 0, :2] = pal[:, :2]  # pixels that sit on a palette colour
            for label, method, bayer in k3_modes():
                got = k3.palette_dither(x, pal, method, bayer)
                want = k3.palette_dither_plain(x, pal, method, bayer)
                d = int((got != want).any(-1).sum())
                err = max(err, int((got.int() - want.int()).abs().max()))
                cases += 1
                if d:
                    differ[f"{cname}/N{n}/{label}"] = d
    return dict(cases=cases, shapes={k: list(v.shape) for k, v in crops.items()},
                differing_pixels=sum(differ.values()), differing=differ, max_abs_err=err)


EPILOGUE_CASES = (  # (case, shape, activations, residual): the residual U-Net's largest, bf16
    ("conv2", (8, 288, 368, 108), dict(pre="relu"), "none"),
    ("conv3", (8, 288, 368, 72), dict(pre="relu"), "identity"),
    ("conv3_proj", (8, 288, 368, 72), dict(pre="relu"), "projection"),
)


def epilogue_phase(dev, cases=EPILOGUE_CASES, n: int = 50) -> dict:
    """The conv epilogue kernel against its plain version on ``dev`` (bit
    for bit, one launch a call), then the CUDA-event median ms of each, of
    the eager chain (ATen's bias add, relu and add: ``library_ms``, which is
    also the plain version) and the bytes' bound at ``PEAK_BYTES_S``; with
    the kernels' registers and spills from the build's ptxas report."""
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import conv_epilogue as ce

    g = torch.Generator().manual_seed(5)
    recs = []
    for name, shape, acts, residual in cases:
        c = shape[-1]
        y0 = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        b = (torch.randn(c, generator=g) * 0.5).to(dev)
        r = None if residual == "none" else torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        bp = (torch.randn(c, generator=g) * 0.5).to(dev) if residual == "projection" else None
        kw = dict(residual=r, residual_bias=bp, **acts)
        want = ce.epilogue_plain(y0.clone(), b, **kw)
        before = ce.conv_epilogue.launches
        got = ce.conv_epilogue(y0.clone(), b, **kw)
        launched = ce.conv_epilogue.launches - before
        equal = bool(torch.equal(got, want))
        err = float((got.float() - want.float()).abs().max())
        y = y0.clone()
        kernel_ms = median_ms(lambda: ce.conv_epilogue(y, b, **kw), n=n)
        library_ms = median_ms(lambda: ce.epilogue_plain(y, b, **kw), n=n)
        nbytes = (y.numel() * y.element_size() * (2 if r is None else 3)
                  + 4 * c * (1 if bp is None else 2))
        bound_ms = 1e3 * nbytes / PEAK_BYTES_S
        recs.append(dict(case=name, shape=list(shape), residual=residual, equal=equal,
                         max_abs_err=err, launched=launched, bytes=nbytes, kernel_ms=kernel_ms,
                         bound_ms=bound_ms, roofline_pct=100 * bound_ms / kernel_ms,
                         library_ms=library_ms))
    ptxas = ce.ptxas_report(build.build_info["ptxas"]) if dev.type == "cuda" else None
    return dict(cases=recs, ptxas=ptxas)


def check_epilogue(rec: dict, dev) -> None:
    for c in rec["cases"]:
        check(c["equal"] and c["max_abs_err"] == 0,
              f"the conv epilogue kernel differs from its plain version: {c}")
        check(c["launched"] == (dev.type == "cuda"), f"conv epilogue launches: {c}")
    if dev.type == "cuda":
        check(rec["ptxas"]["kernels"] > 0 and rec["ptxas"]["spill_bytes"] == 0,
              f"the conv epilogue kernels' ptxas report: {rec['ptxas']}")


def timed_stages(dev, run) -> dict:
    """Run ``run()`` with wall-clock timers around the generator's stages
    (module attributes wrapped for the call, then restored): seconds and
    calls per stage, and the run's total. Stages nest: targets include their
    base crops, the device stage (k-means, K3, the copies) includes its
    k-means and grid quantization. The k-means timer synchronises the card,
    so its time is the k-means' own; the device stage ends in a copy to the
    host, so its time includes the device's."""
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.datagen import device_batch as db
    from fs_uae_image_enhancer_project_tpu_torch.datagen import generator as gm

    stages = {"scan": (gm, "scan_image_task"), "targets": (gm, "save_target_worker"),
              "base_crops": (gm, "_prepare_base"),
              "pre_style": (db, "pre_apply_resolution_style"),
              "grid_quantize": (db, "grid_quantize"),
              "device_stage": (db, "style_batch_on_device"),
              "kmeans": (db, "generate_palettes_kmeans_torch_batch"),
              "png_save": (db, "_save_styled"),
              "scalar_fallback": (db, "reduce_color_depth_and_dither")}
    spent = {k: [0.0, 0] for k in stages}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if name == "kmeans" and dev.type == "cuda":
                    torch.cuda.synchronize()
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += 1
        return wrapper

    saved = {k: getattr(mod, attr) for k, (mod, attr) in stages.items()}
    for k, (mod, attr) in stages.items():
        setattr(mod, attr, timed(k, saved[k]))
    t0 = time.perf_counter()
    try:
        run()
    finally:
        total = time.perf_counter() - t0
        for k, (mod, attr) in stages.items():
            setattr(mod, attr, saved[k])
    return {"total_s": total, **{k: {"s": v[0], "calls": v[1]} for k, v in spent.items()}}


def source_images(src: str) -> None:
    """The datagen phase's source tree in ``src``: two seeded 1504x1152
    images, with noise strong enough that a lores crop keeps more than 256
    RGB444 colours, as a photo does: the k-means path runs, not the
    unique-colour fallback (at sigma 24 most crops fall back)."""
    from PIL import Image

    from fs_uae_image_enhancer_project_tpu_torch.scripts.common import gradient_noise

    os.makedirs(src)
    for i in range(2):
        Image.fromarray(gradient_noise(1152, 1504, seed=10 + i, sigma=48.0)).save(
            os.path.join(src, f"img_{i}.png"))


def datagen(dev, tree_dir=None) -> dict:
    """The port's generator on ``dev`` (slice 2's main path): two seeded
    1504x1152 images, 376x288 lores crops (at most 8 per image), kmeans_torch
    palettes 64 and 256, five dithers, device_batch 16, every launch counter
    from 0. Then its rerun, the k-means on ``dev`` against the CPU, and the
    per-crop route on the first image against the batched run's PNGs. With
    ``tree_dir`` the batched run's tree is copied there (the train phase
    trains on it)."""
    import numpy as np
    import torch
    from PIL import Image

    from fs_uae_image_enhancer_project_tpu_torch.datagen.generator import (
        DatasetGenerator, GeneratorConfig)
    from fs_uae_image_enhancer_project_tpu_torch.datagen.quantize import (
        generate_palettes_kmeans_torch_batch, grid_quantize)
    from fs_uae_image_enhancer_project_tpu_torch.datagen.util_img import (
        pre_apply_resolution_style)
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        source_images(src)

        def gen_cfg(dest, images, workers=1, **kw):
            return GeneratorConfig(
                train_images=images, dest_dir=os.path.join(tmp, dest), crop_w=CROP_W,
                crop_h=CROP_H, resolutions=("lores",), colorspaces=("RGB444",),
                palettes=PALETTES, dithers=DITHERS, palette_algorithm="kmeans_torch",
                quantize_backend="device", max_crops_per_image=8, workers=workers,
                cache_dir=os.path.join(tmp, "cache_" + dest), verbose=0, device=str(dev),
                **kw)

        batched = gen_cfg("batched", [src], device_batch=16)
        fs.fused_stack.launches = 0
        k3.palette_dither.launches = 0
        t0 = time.perf_counter()
        stats = DatasetGenerator(batched).run()
        sync()
        gen_s = time.perf_counter() - t0
        launches = {"fused_stack": fs.fused_stack.launches,
                    "palette_dither": k3.palette_dither.launches}
        out = tree_bytes(batched.dest_dir)
        targets = sorted(k for k in out if os.path.basename(k).startswith("target_"))
        rerun = DatasetGenerator(batched).run()
        if tree_dir:
            shutil.copytree(batched.dest_dir, tree_dir)

        # the pre-styled lores crops of the run (the targets are the base crops)
        arrs = []
        for t in targets:
            with Image.open(os.path.join(batched.dest_dir, t)) as im:
                arrs.append(np.asarray(pre_apply_resolution_style(im.convert("RGB"), "lores"),
                                       np.uint8))
        arrs = np.stack(arrs)
        stacks = grid_quantize(arrs, "RGB444").reshape(len(arrs), -1, 3).astype(np.float32)
        km_differ = {}
        for k in PALETTES:
            card = generate_palettes_kmeans_torch_batch(stacks, k, device=dev).cpu()
            cpu = generate_palettes_kmeans_torch_batch(stacks[:4], k, device="cpu")
            km_differ[k] = int((card[:4] != cpu).any(-1).sum())

        per = gen_cfg("percrop", [os.path.join(src, "img_0.png")])
        before = k3.palette_dither.launches
        t0 = time.perf_counter()
        per_stats = DatasetGenerator(per).run()
        per_s = time.perf_counter() - t0
        per_launches = k3.palette_dither.launches - before
        per_out = tree_bytes(per.dest_dir)

        # the per-crop route with two workers: spawned, a CUDA context each
        # (their launches are counted in their own processes)
        two = gen_cfg("percrop_w2", [os.path.join(src, "img_0.png")], workers=2)
        t0 = time.perf_counter()
        two_stats = DatasetGenerator(two).run()
        two_s = time.perf_counter() - t0
        two_out = tree_bytes(two.dest_dir)

        # where the batched run's time goes: the same run again, into a new
        # directory, with timers around its stages
        again = gen_cfg("breakdown", [src], device_batch=16)
        breakdown = timed_stages(dev, lambda: DatasetGenerator(again).run())
    per_styled = [k for k in per_out if not os.path.basename(k).startswith("target_")]
    styled = len(out) - len(targets)
    return dict(
        stats=stats, launches=launches, targets=len(targets), styled=styled,
        generator_seconds=gen_s, styled_crops_per_s=styled / gen_s,
        rerun_generated=rerun["generated_this_run"], rerun_missing=rerun["missing"],
        kmeans_colours_differing_card_vs_cpu=km_differ, percrop_stats=per_stats,
        percrop_styled=len(per_styled), percrop_files=len(per_out),
        percrop_k3_launches=per_launches,
        percrop_seconds=per_s, percrop_styled_crops_per_s=len(per_styled) / per_s,
        percrop_files_differing_from_batched=sum(per_out[k] != out.get(k) for k in per_out),
        workers2_stats=two_stats, workers2_files=len(two_out), workers2_seconds=two_s,
        workers2_files_differing_from_batched=sum(two_out[k] != out.get(k) for k in two_out),
        breakdown=breakdown, arrs=arrs, stacks=stacks)


def k3_timing(dev, arrs, stacks):
    """K3 held to its plain version (byte equality) and timed at the
    generator's batch (the datagen phase's 16 lores crops and their k-means
    palettes, N = 64 and 256, every mode), with K3's bound from
    this run's inputs: the device time of K3 (palette luminance given), its
    plain version and cdist + topk (:func:`device_ms`); the median time of
    one K3 call from Python with its palette luminance (``call_ms``); and the
    median time of one batched k-means call."""
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.datagen.quantize import (
        generate_palettes_kmeans_torch_batch)
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3

    x = torch.from_numpy(arrs).to(dev)
    px = x.reshape(len(arrs), -1, 3).float()
    rows = []
    for k in PALETTES:
        pal = generate_palettes_kmeans_torch_batch(stacks, k, device=dev)
        lum = k3.palette_luminance(pal)
        palf = pal.float()
        lib = device_ms(lambda: library_nearest_two(px, palf), n=10)
        for label, method, bayer in k3_modes():
            ops = k3.kernel_ops(x, pal, method)
            nbytes = 2 * x.numel() + pal.numel() + 4 * lum.numel()
            o_ms, b_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
            same = torch.equal(k3.palette_dither(x, pal, method, bayer),
                               k3.palette_dither_plain(x, pal, method, bayer))
            kern = device_ms(lambda: k3.palette_dither(x, pal, method, bayer, lum))
            plain = device_ms(lambda: k3.palette_dither_plain(x, pal, method, bayer, lum), n=5)
            row = dict(
                n=k, mode=label, equal_to_plain=same, gflop=ops / 1e9, mbytes=nbytes / 1e6,
                k3_ms=kern["ms"],
                call_ms=median_ms(lambda: k3.palette_dither(x, pal, method, bayer), n=20),
                plain_ms=plain["ms"], library_ms=lib["ms"], bound_ms=max(o_ms, b_ms),
                bound_by="operations" if o_ms >= b_ms else "bytes",
                host_behind={"k3": kern["host_behind"], "plain": plain["host_behind"],
                             "library": lib["host_behind"]})
            row["share_of_bound"] = row["bound_ms"] / row["k3_ms"]
            rows.append(row)
    pts = torch.from_numpy(stacks).to(dev)
    kmeans_ms = {k: median_ms(lambda: generate_palettes_kmeans_torch_batch(pts, k, device=dev),
                              n=5, warmup=1) for k in PALETTES}
    return rows, kmeans_ms


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_ms(fn, dev, n: int = 10) -> float:
    """Mean ms a call on the host's clock, two warm-up calls, synchronised
    at both ends (on a card the host's launches are included)."""
    for _ in range(2):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / n * 1e3


def _device_busy(fn, dev):
    """The card's kernel time in one call of ``fn`` from ``torch.profiler``:
    ``(ms, the 8 kernels with the most time [(name, ms, calls)], kernel
    launches)``, the ms the sum of CUDA kernels' self time; ``(None, [], 0)``
    on the CPU or when the profiler records no device time."""
    if dev.type != "cuda":
        return None, [], 0
    from fs_uae_image_enhancer_project_tpu_torch.utils.profiler import trace

    with trace(cuda=True) as prof:
        fn()
        _sync(dev)
    kernels = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
            kernels.append((e.key[:80], us / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
    return (sum(k[1] for k in kernels) or None), kernels[:8], sum(k[2] for k in kernels)


def step_timing(dev, pairs, crop, accum: int, steps: int, vgg: bool) -> dict:
    """The trainer's loop (uint8 batches of 1 through the pinned prefetch,
    ``accum`` micro-batches an optimizer step, bf16) on the lightweight
    pix_shuffle with its own criterion (VGG on or off): one warm-up step,
    then ``steps`` timed steps on the host's clock, ended by a synchronise.
    The loader wait is the time the loop spends in the prefetch's ``next``;
    the peak memory is torch's over the timed steps. Then the same steps on
    the last step's batches, already on the device (the step without the
    loader), and the card's kernel time in one of them (``torch.profiler``)."""
    import dataclasses

    import torch

    from fs_uae_image_enhancer_project_tpu_torch.data import (
        SRDataset, batch_transform, device_prefetch)
    from fs_uae_image_enhancer_project_tpu_torch.losses import build_criterion
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model, train_apply
    from fs_uae_image_enhancer_project_tpu_torch.parallel import train_step as ts

    m = get_model("pix_shuffle")
    loss = m.loss if vgg else dataclasses.replace(m.loss, vgg_weight=0.0)
    ds = SRDataset(pairs, crop, accum * (steps + 1), batch_size=1, linear=True, seed=4,
                   transfer_dtype="uint8")
    state = ts.init_train_state(m.init(torch.Generator().manual_seed(0), device=dev),
                                ts.make_optimizer(steps_per_epoch=steps + 1))
    step = ts.make_train_step(train_apply(m), build_criterion(loss, device=dev),
                              compute_dtype=torch.bfloat16, input_transform=batch_transform(True))
    batches = device_prefetch(iter(ds), device=dev)
    wait = 0.0
    losses = []
    try:
        for i in range(steps + 1):
            if i == 1:  # after the warm-up step
                _sync(dev)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                wait, t0 = 0.0, time.perf_counter()
            lrs, hrs = [], []
            for _ in range(accum):
                tw = time.perf_counter()
                lr_b, hr_b = next(batches)
                wait += time.perf_counter() - tw
                lrs.append(lr_b)
                hrs.append(hr_b)
            state, loss_t = step(state, torch.stack(lrs), torch.stack(hrs))
            losses.append(loss_t)
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        batches.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    staged = torch.stack(lrs), torch.stack(hrs)
    staged_ms = _wall_ms(lambda: step(state, *staged), dev, n=steps)
    busy_ms, top, _ = _device_busy(lambda: step(state, *staged), dev)
    return dict(vgg=vgg, accumulation=accum, timed_steps=steps, micro_batches=accum * steps,
                wall_s=wall, ms_per_step=wall / steps * 1e3,
                samples_per_s=accum * steps / wall, loader_wait_s=wait,
                loader_wait_share=wait / wall, max_memory_allocated=peak,
                staged_ms_per_step=staged_ms, device_busy_ms_per_step=busy_ms,
                device_busy_share=None if busy_ms is None else busy_ms / staged_ms,
                top_kernels=top,
                losses=[float(x) for x in torch.stack(losses).cpu()])


def train_phase(dev, tree: str, crop=(CROP_W, CROP_H), accum: int = TRAIN_ACCUM,
                train_samples: int = 16, val_samples: int = 4, timed_accum: int = TIMED_ACCUM,
                timed_steps: int = 2, hard_batch=TRAIN_HARD_BATCH) -> dict:
    """Training (slice 6's main path) on the generator's tree at ``tree``,
    through the trainer CLI on ``dev``: the lightweight pix_shuffle with its
    own criterion (VGG on the committed self-trained asset), uint8 batches
    of 1, ``accum`` micro-batches a step, 2 epochs of ``train_samples`` with
    ``val_samples`` validation samples and one seeded frame to render, then
    a resume to epoch 3; conv5 (BatchNorm, the SSIM criterion) for one epoch
    of 2 steps. K1's launches are counted inside the train steps and in all.
    Then validation through K1 against ``apply_eager``, one fp32 step on
    ``dev`` against the same step on the CPU and against the fp64 step on
    ``dev`` that replays its kinks (``train/gradcheck.py``), on the tree's first
    two pairs in sorted order and on ``hard_batch`` (styled crops by path
    relative to ``tree``), and the timed loop (:func:`step_timing`) with VGG
    on and off."""
    import numpy as np
    import torch
    from PIL import Image

    from fs_uae_image_enhancer_project_tpu_torch.data import (
        SRDataset, batch_transform, gather_all_samples_from_directory, split_pairs)
    from fs_uae_image_enhancer_project_tpu_torch.losses import build_criterion
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model, pix_shuffle, train_apply
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.parallel import train_step as ts
    from fs_uae_image_enhancer_project_tpu_torch.scripts.common import gradient_noise
    from fs_uae_image_enhancer_project_tpu_torch.train import cli
    from fs_uae_image_enhancer_project_tpu_torch.train import gradcheck as gc
    from fs_uae_image_enhancer_project_tpu_torch.train import trainer as tr
    from fs_uae_image_enhancer_project_tpu_torch.train.orbax_reader import (
        is_orbax_checkpoint, read_orbax)

    w, h = crop
    m = get_model("pix_shuffle")
    rec: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        samples = os.path.join(tmp, "samples")
        os.makedirs(samples)
        Image.fromarray(gradient_noise(h, w, seed=30)).save(os.path.join(samples, "frame0.png"))
        ck, ck5 = os.path.join(tmp, "pix_shuffle"), os.path.join(tmp, "conv5")
        common = ["--generator_train_dir", tree, "--crop_size", str(w), str(h),
                  "--batch_size", "1", "--accumulation_steps", str(accum),
                  "--checkpoint_interval", "1", "--verbose", "0", "--device", str(dev)]
        pix = ["--model_type", "pix_shuffle", "--checkpoint_dir", ck, "--samples_dir", samples,
               "--train_samples", str(train_samples), "--val_samples", str(val_samples), *common]

        real = tr.make_train_step
        in_steps = {"launches": 0, "steps": 0}

        def counting(*a, **kw):  # K1's launches inside the train steps
            step = real(*a, **kw)

            def counted(state, lr_b, hr_b):
                before = fs.fused_stack.launches
                out = step(state, lr_b, hr_b)
                in_steps["launches"] += fs.fused_stack.launches - before
                in_steps["steps"] += 1
                return out
            return counted

        tr.make_train_step = counting
        fs.fused_stack.launches = 0
        try:
            t0 = time.perf_counter()
            rcs = [cli.main(pix + ["--epochs", "2"])]
            _sync(dev)
            rec["two_epochs_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rcs.append(cli.main(pix + ["--epochs", "3"]))  # the resume
            _sync(dev)
            rec["resume_s"] = time.perf_counter() - t0
            pix_steps = in_steps["steps"]
            rcs.append(cli.main(["--model_type", "conv5", "--checkpoint_dir", ck5, "--epochs", "1",
                                 "--train_samples", str(2 * accum), "--val_samples", "2",
                                 *common]))
        finally:
            tr.make_train_step = real
        rec.update(exit_codes=rcs, pix_shuffle_steps=pix_steps,
                   conv5_steps=in_steps["steps"] - pix_steps,
                   k1_launches={"train_steps": in_steps["launches"],
                                "all": fs.fused_stack.launches},
                   validation_batches=3 * val_samples)

        with open(os.path.join(ck, "training_stats_pix_shuffle.csv")) as f:
            rows = [line.rstrip("\n").split(",") for line in f]
        rec["csv_header"] = rows[0]
        rec["csv_epochs"] = [int(r[0]) for r in rows[1:]]
        rec["csv_losses"] = [[float(r[1]), float(r[2])] for r in rows[1:]]
        with open(os.path.join(ck, "metrics_pix_shuffle.jsonl")) as f:
            rec["metrics"] = [json.loads(line) for line in f]
        rec["files"] = {n: is_orbax_checkpoint(os.path.join(ck, n)) for n in (
            "checkpoint_best_pix_shuffle",
            *(f"checkpoint_epoch_{e}_pix_shuffle" for e in (1, 2, 3)))}
        rec["files"]["predicted/frame0.png"] = os.path.exists(
            os.path.join(ck, "predicted", "frame0.png"))
        first = m.init(torch.Generator().manual_seed(0), device="cpu")
        last = tr.load_params(os.path.join(ck, "checkpoint_epoch_3_pix_shuffle"), first)
        rec["leaves_unmoved"] = sum(torch.equal(a, b) for a, b in zip(ts.leaves(first),
                                                                    ts.leaves(last)))
        c5 = read_orbax(os.path.join(ck5, "checkpoint_epoch_1_conv5"))
        rec["conv5_checkpoint_step"] = int(c5["step"])
        rec["conv5_bn_unmoved"] = sum(
            not v["mean"].any() or bool((v["var"] == 1).all()) for v in c5["buffers"].values())
        best = tr.load_params(os.path.join(ck, "checkpoint_best_pix_shuffle"),
                              m.init(device=dev))

    # validation through K1 (m.apply, bf16 on a card) against apply_eager
    pairs = gather_all_samples_from_directory(tree, crop, verbose=0)
    train_pool, val_pool = split_pairs(pairs, 0.1)
    crit = build_criterion(m.loss, device=dev)
    to_float = batch_transform(True)
    val = {"k1": [], "eager": []}
    with torch.no_grad():
        for lr_b, hr_b in SRDataset(val_pool, crop, val_samples, linear=True, flips=False, seed=1,
                                    transfer_dtype="uint8"):
            x = to_float(torch.from_numpy(lr_b).to(dev)).to(torch.bfloat16)
            hr = to_float(torch.from_numpy(hr_b).to(dev))
            val["k1"].append(crit(m.apply(best, x).float(), hr).item())
            val["eager"].append(crit(pix_shuffle.apply_eager(best, x, m.config).float(), hr).item())
    rec["val_loss_k1"] = float(np.mean(val["k1"]))
    rec["val_loss_eager"] = float(np.mean(val["eager"]))
    rec["val_rel_diff"] = abs(rec["val_loss_k1"] - rec["val_loss_eager"]) / rec["val_loss_eager"]
    with torch.no_grad():  # a validation batch's time, and its forward's
        rec["validation_ms"] = dict(
            batch=_wall_ms(lambda: crit(m.apply(best, x).float(), hr), dev),
            k1_forward=_wall_ms(lambda: m.apply(best, x), dev),
            eager_forward=_wall_ms(lambda: pix_shuffle.apply_eager(best, x, m.config), dev))

    # one fp32 step on dev against the same step on the CPU and against the
    # fp64 step on dev that takes the fp32 step's branch at every kink, from
    # the trainer's seeded initial weights and from the trained ones, on two
    # fixed batches of the tree: its first two pairs in sorted path order
    # (no machine's directory order in it) and the hard batch (check_train)
    styled = sorted(os.path.relpath(a, tree) for a, _ in pairs)
    batches = {"sorted": tuple(styled[:2]), "hard": tuple(hard_batch)}
    names = gc.leaf_names(best)
    rec["fp32_step"] = {}
    for label, weights in (("initial", m.init(torch.Generator().manual_seed(0), device="cpu")),
                           ("trained", best)):
        weights = {k: {n: t.detach().cpu() for n, t in v.items()} for k, v in weights.items()}
        for batch, paths in batches.items():
            lr_b, hr_b = gc.load_batch(tree, paths)
            decisions, sums = [], []
            l_dev, g_dev = gc.fp32_step(m, weights, lr_b, hr_b, dev, decisions)
            l_cpu, g_cpu = gc.fp32_step(m, weights, lr_b, hr_b, torch.device("cpu"))
            l64, g64, replayed = gc.fp64_step(m, weights, lr_b, hr_b, dev, decisions, sums)
            leaves = {}
            for n, a, b, t, s in zip(names, g_dev, g_cpu, g64, sums):
                # a broadcast leaf's scale: its terms' magnitudes (check_train)
                top = float(t.abs().max())
                scale = top if s is None else float(s.max())
                leaves[n] = dict(dev_vs_fp64=float((a - t).abs().max()) / scale,
                                 dev_vs_cpu=float((a - b).abs().max()) / scale,
                                 of_max_g=float((a - t).abs().max()) / top,
                                 terms_over_max_g=scale / top)
            worst = max(leaves, key=lambda n: leaves[n]["dev_vs_fp64"])
            cancel = max(leaves, key=lambda n: leaves[n]["terms_over_max_g"])
            rec["fp32_step"][f"{label}_{batch}"] = dict(
                pairs=list(paths), loss_dev=l_dev, loss_cpu=l_cpu, loss_fp64=l64,
                loss_rel_diff=abs(l_dev - l_cpu) / abs(l_cpu),
                kinks_recorded=len(decisions), kinks_replayed=replayed,
                grad_worst_dev_vs_fp64=[worst, leaves[worst]["dev_vs_fp64"]],
                grad_worst_dev_vs_cpu=max(v["dev_vs_cpu"] for v in leaves.values()),
                grad_worst_of_max_g=max(v["of_max_g"] for v in leaves.values()),
                grad_most_cancelled=[cancel, leaves[cancel]["terms_over_max_g"]],
                grad_leaves=len(leaves), grad_leaves_by_terms=sum(s is not None for s in sums),
                leaves_over_1e4={n: v for n, v in leaves.items()
                                 if max(v["dev_vs_fp64"], v["dev_vs_cpu"], v["of_max_g"]) > 1e-4})

    rec["timing"] = [step_timing(dev, train_pool, crop, timed_accum, timed_steps, vgg=v)
                     for v in (True, False)]
    return rec


def check_train(rec: dict, dev) -> None:
    """The train phase's checks; K1 launches in validation only on a card."""
    check(rec["exit_codes"] == [0, 0, 0], f"trainer CLI exit codes {rec['exit_codes']}")
    check(rec["csv_header"] == ["Epoch", "Train Loss", "Validation Loss", "EpochsNoImprove",
                                "LearningRate", "Checkpoint Path"],
          f"CSV header {rec['csv_header']}")
    check(rec["csv_epochs"] == [1, 2, 3], f"CSV epochs {rec['csv_epochs']}")
    losses = [x for pair in rec["csv_losses"] for x in pair] + [
        r[k] for r in rec["metrics"] for k in ("train_loss", "val_loss")]
    losses += [x for t in rec["timing"] for x in t["losses"]]
    check(all(math.isfinite(x) for x in losses), f"a loss is not finite: {losses}")
    check(all(rec["files"].values()), f"missing checkpoint or render: {rec['files']}")
    check(rec["leaves_unmoved"] == 0, f"{rec['leaves_unmoved']} parameter leaves did not move")
    check(rec["conv5_steps"] == 2 and rec["conv5_checkpoint_step"] == 2,
          f"conv5 took {rec['conv5_steps']} steps")
    check(rec["conv5_bn_unmoved"] == 0, f"{rec['conv5_bn_unmoved']} conv5 BN buffers did not move")
    k1 = rec["k1_launches"]
    check(k1["train_steps"] == 0, f"K1 launched {k1['train_steps']} times inside the train steps")
    want = rec["validation_batches"] if dev.type == "cuda" else 0
    check(k1["all"] == want, f"K1 launched {k1['all']} times, not once a validation batch ({want})")
    check(rec["val_rel_diff"] <= TRAIN_VAL_REL,
          f"validation through K1 vs apply_eager: rel {rec['val_rel_diff']}")
    # each leaf of the card's fp32 gradient within 1e-3 of its scale, from
    # the fp64 step on the card that took the same branch at every kink (the
    # whole record replayed): a kink's side is a subgradient's choice, which
    # rounding makes, and on a leaf whose sum nearly cancels it moved the
    # fp32 gradient 0.9% from a plain fp64 step (PERF.md, section 6). The
    # scale is the leaf's max |g|, or, for a leaf broadcast over an
    # activation (conv biases, activation parameters), its max sum of its
    # terms' magnitudes (train/gradcheck.py): fp32's rounding is relative to
    # that, and a trained scalar's terms may cancel (0.84% of |g| on
    # l1_act1.a in one call, PERF.md section 6)
    fp = rec["fp32_step"]
    check(sorted(fp) == ["initial_hard", "initial_sorted", "trained_hard", "trained_sorted"],
          f"fp32 step cases {sorted(fp)}")
    for label, r in fp.items():
        check(r["loss_rel_diff"] <= TRAIN_LOSS_REL, f"fp32 step loss, card vs cpu, {label}: {r}")
        check(r["kinks_recorded"] > 0 and r["kinks_replayed"] == r["kinks_recorded"],
              f"fp32 step {label}: {r['kinks_replayed']} of {r['kinks_recorded']} kinks replayed")
        bad = {n: v for n, v in r["leaves_over_1e4"].items() if v["dev_vs_fp64"] > TRAIN_GRAD_REL}
        check(not bad, f"fp32 step gradients against fp64, {label}: {bad}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def train_mesh(dev, tree: str, crop=(CROP_W, CROP_H), samples: int = 4, accum: int = 2,
               val_samples: int = 2) -> dict:
    """The trainer's mesh path (slice 9) on a 1x1 mesh in a process group of
    world size 1 (``nccl`` on a card, ``gloo`` on the CPU, at
    ``tcp://localhost:<free port>``) against the same run with no mesh:
    the lightweight pix_shuffle with its own criterion, one epoch of
    ``samples`` uint8 batches of 1 (``accum`` a step), ``val_samples``
    validation batches, cuDNN deterministic in both runs; K1's launches in
    the mesh run's validation, and the mesh run's calls of
    ``torch.distributed.broadcast`` and ``all_reduce`` (the 1x1 mesh holds
    the world group, so its trainer and train step make every collective of
    a larger mesh). Then the training CLI asked for one rank more than the
    cards visible (at least 2), which must exit 1."""
    import contextlib
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from fs_uae_image_enhancer_project_tpu_torch.data import (
        SRDataset, gather_all_samples_from_directory, split_pairs)
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.parallel import mesh as pm
    from fs_uae_image_enhancer_project_tpu_torch.parallel.train_step import leaves
    from fs_uae_image_enhancer_project_tpu_torch.train import cli
    from fs_uae_image_enhancer_project_tpu_torch.train import trainer as tr
    from fs_uae_image_enhancer_project_tpu_torch.train.orbax_reader import read_orbax

    m = get_model("pix_shuffle")
    train_pool, val_pool = split_pairs(gather_all_samples_from_directory(tree, crop, verbose=0),
                                       0.1)
    rec: dict = {}

    def run(mesh, ckpt_dir):
        cfg = tr.TrainerConfig(num_epochs=1, batch_size=1, accumulation_steps=accum,
                               checkpoint_interval=1, checkpoint_dir=ckpt_dir, verbose=0,
                               device=str(dev), mesh=mesh)
        tr.Trainer(m, cfg).train(
            SRDataset(train_pool, crop, samples, transfer_dtype="uint8"),
            SRDataset(val_pool, crop, val_samples, flips=False, seed=1, transfer_dtype="uint8"))
        return read_orbax(os.path.join(ckpt_dir, "checkpoint_epoch_1_pix_shuffle"))

    keep = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            plain = run(None, os.path.join(tmp, "plain"))
            pm.init_process_group(0, 1, device=dev, init_method=f"tcp://localhost:{_free_port()}")
            try:
                rec["backend"], rec["world_size"] = dist.get_backend(), dist.get_world_size()
                calls = {"broadcast": 0, "all_reduce": 0}
                real = {k: getattr(dist, k) for k in calls}

                def counted(name):
                    def call(*a, **kw):
                        calls[name] += 1
                        return real[name](*a, **kw)
                    return call

                fs.fused_stack.launches = 0
                for k in calls:
                    setattr(dist, k, counted(k))
                try:
                    meshed = run(pm.make_mesh(1, device=dev), os.path.join(tmp, "mesh"))
                finally:
                    for k, fn in real.items():
                        setattr(dist, k, fn)
                rec["k1_launches"] = fs.fused_stack.launches
                rec["collectives"] = calls
            finally:
                dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = keep
    pairs = list(zip(leaves(plain["params"]) + leaves(plain["buffers"]),
                     leaves(meshed["params"]) + leaves(meshed["buffers"])))
    rec.update(steps=[int(plain["step"]), int(meshed["step"])], leaves=len(pairs),
               param_leaves=len(leaves(meshed["params"])),
               max_abs_diff=max(float(np.abs(a - b).max()) for a, b in pairs),
               validation_batches=val_samples)

    asked = max(2, torch.cuda.device_count() + 1)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--model_type", "pix_shuffle", "--generator_train_dir", tree,
                       "--batch_size", str(asked), "--n_devices", str(asked), "--device", "cuda",
                       "--verbose", "0"])
    rec["cli_too_few_cards"] = dict(n_devices=asked, visible=torch.cuda.device_count(),
                                    exit_code=rc, stderr=err.getvalue().strip())
    return rec


def check_train_mesh(rec: dict, dev) -> None:
    check(rec["backend"] == ("nccl" if dev.type == "cuda" else "gloo") and rec["world_size"] == 1,
          f"the mesh's process group: {rec['backend']}, world size {rec['world_size']}")
    check(rec["steps"][0] == rec["steps"][1] > 0, f"steps {rec['steps']}")
    check(rec["max_abs_diff"] <= 1e-6,
          f"the 1x1 mesh's checkpoint is {rec['max_abs_diff']} from the run without a mesh")
    want = rec["validation_batches"] if dev.type == "cuda" else 0
    check(rec["k1_launches"] == want,
          f"K1 launched {rec['k1_launches']} times on the mesh path, not {want}")
    # the state's broadcast; a step's gradients and loss; a validation loss
    want = {"broadcast": rec["leaves"],
            "all_reduce": rec["steps"][1] * (rec["param_leaves"] + 1) + rec["validation_batches"]}
    check(rec["collectives"] == want,
          f"the mesh path's collectives: {rec['collectives']}, not {want}")
    cli_rec = rec["cli_too_few_cards"]
    msg = (f"Error: --n_devices {cli_rec['n_devices']} but only {cli_rec['visible']} devices "
           "visible")
    check(cli_rec["exit_code"] == 1 and cli_rec["stderr"].startswith(msg),
          f"the CLI with too few cards: {cli_rec}")


def nas_tree(tree: str, out: str, crop=NAS_CROP) -> int:
    """The generator tree's pairs cut to ``crop`` (W, H), their top-left
    corner: every PNG of ``tree``, target and styled crop alike, saved under
    its own name in ``out``. Returns the number of files."""
    from PIL import Image

    n = 0
    for root, _dirs, names in os.walk(tree):
        dest = os.path.join(out, os.path.relpath(root, tree))
        os.makedirs(dest, exist_ok=True)
        for name in names:
            if name.endswith(".png"):
                with Image.open(os.path.join(root, name)) as im:
                    im.crop((0, 0) + tuple(crop)).save(os.path.join(dest, name))
                n += 1
    return n


def arch_hash(arch_key: str) -> str:
    """A short name for an architecture: the first 12 hex digits of the
    SHA-256 of its canonical key (``config_to_json``)."""
    import hashlib

    return hashlib.sha256(arch_key.encode()).hexdigest()[:12]


def nas(dev, tree: str, crop=NAS_CROP, trials: int = NAS_TRIALS, samples: int = 32,
        fps_duration: float = 0.5, timed_steps: int = 5) -> dict:
    """The NAS entry point (slice 9): ``nas.studies.main`` with the
    prune_act_r2 preset (all 20 activations, layer 6's kernel size) for
    ``trials`` trials on the generator tree cut to ``crop``: one epoch of
    ``samples`` samples a trial at batch 16, FPS measured for
    ``fps_duration`` s at 576x752 bf16, the study's SQLite database and the
    FPS cache in a temporary directory. What each trial did is read back
    from those two files: its state, value and validation loss from the
    database, its architecture replayed from its params
    (``config_from_trial_params``) and looked up in the FPS cache, whose
    entries count the measurements. Each completed trial's train step
    (``studies.trial_train_step``) is then timed on its own, warm, on one
    batch of the tree. Then the best trial's FPS again through the cache,
    the database reloaded, ``prune_failed`` and ``param_importances``."""
    import contextlib
    import io

    import torch

    from fs_uae_image_enhancer_project_tpu_torch.data import (
        SRDataset, gather_all_samples_from_directory)
    from fs_uae_image_enhancer_project_tpu_torch.models import conv6
    from fs_uae_image_enhancer_project_tpu_torch.models.configs import config_to_json
    from fs_uae_image_enhancer_project_tpu_torch.nas import FPSCache, prune_failed, search, studies
    from fs_uae_image_enhancer_project_tpu_torch.nas.visualize import param_importances
    from fs_uae_image_enhancer_project_tpu_torch.parallel.train_step import (
        init_train_state, make_optimizer)

    rec: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "tree")
        rec["files"] = nas_tree(tree, src, crop)
        db, cache = os.path.join(tmp, "studies.sqlite"), os.path.join(tmp, "fps.json")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = studies.main([
                "--study", NAS_STUDY, "--storage", db, "--trials", str(trials),
                "--generator_train_dir", src, "--crop_size", str(crop[0]), str(crop[1]),
                "--epochs_per_trial", "1", "--samples_per_epoch", str(samples),
                "--fps_duration", str(fps_duration), "--fps_cache", cache,
                "--device", str(dev)])
        _sync(dev)
        rec["study_s"] = time.perf_counter() - t0
        rec["exit_code"] = rc
        with open(cache) as f:
            rec["fps_measurements"] = len(json.load(f))
        fps_cache = FPSCache(cache)
        study = search.Study(NAS_STUDY, db)
        batch = next(iter(SRDataset(gather_all_samples_from_directory(src, crop, verbose=0),
                                    crop, 16, batch_size=16, transfer_dtype="uint8")))
        lr_b, hr_b = (torch.as_tensor(a).to(dev)[None] for a in batch)
        rec["trials"] = []
        for t in study.trials:
            cfg = studies.config_from_trial_params(NAS_STUDY, t.params)
            key = config_to_json(cfg)
            ms = None
            if t.state == search.COMPLETE:
                state = init_train_state(conv6.init(cfg, torch.Generator().manual_seed(t.number),
                                                    device=dev),
                                         make_optimizer(lr=t.params["learning_rate"]))
                step = studies.trial_train_step(cfg)

                def one_step():
                    nonlocal state
                    state, _ = step(state, lr_b, hr_b)

                ms = _wall_ms(one_step, dev, n=timed_steps)
            rec["trials"].append(dict(
                number=t.number, state=t.state, value=t.value, arch=arch_hash(key),
                fps=t.params.get("fps_measured"), fps_cached=fps_cache.get(key),
                epochs=len(t.intermediate), ms_per_step=ms,
                val_loss=t.intermediate.get(max(t.intermediate, default=0)),
                layer6_kernel=t.params.get("layer6_kernel_size"),
                learning_rate=t.params.get("learning_rate")))
        best = study.best_trial
        rec["best"] = dict(number=best.number, value=best.value) if best else None
        if best is not None:
            key = config_to_json(studies.config_from_trial_params(NAS_STUDY, best.params))
            again = []
            fps = fps_cache.get_or_measure(key, lambda: again.append(1) or 0.0)
            rec["replay"] = dict(arch=arch_hash(key), fps_from_cache=fps,
                                 fps_recorded=best.params["fps_measured"],
                                 new_measurements=len(again))
        rec["reload_equal"] = search.Study(NAS_STUDY, db).trials == study.trials
        with contextlib.redirect_stdout(io.StringIO()):
            rec["prune_exit_code"] = prune_failed.main(["--storage", db, "--study", NAS_STUDY])
        rec["after_prune"] = len(search.Study(NAS_STUDY, db).trials)
        rec["importances"] = param_importances(search.Study(NAS_STUDY, db))
    rec["trials_asked"] = trials
    return rec


def check_nas(rec: dict) -> None:
    check(rec["exit_code"] == 0, f"nas.studies exited {rec['exit_code']}")
    trials = rec["trials"]
    check(len(trials) == rec["trials_asked"], f"{len(trials)} trials of {rec['trials_asked']}")
    check(all(t["state"] == "COMPLETE" for t in trials),
          f"a trial did not complete: {[(t['number'], t['state']) for t in trials]}")
    check(all(t["fps"] > 0 and math.isfinite(t["fps"]) for t in trials),
          f"an FPS measurement failed (a failure is cached as 0.0): {trials}")
    # the replayed architecture is the one the objective measured: its key
    # is in the cache, with the trial's FPS
    check(all(t["fps_cached"] == t["fps"] for t in trials),
          f"a trial's params replay to an architecture the cache does not hold: {trials}")
    check(all(t["epochs"] == 1 and math.isfinite(t["val_loss"])
              and t["ms_per_step"] is not None and t["ms_per_step"] > 0 for t in trials),
          f"epochs, validation losses or step times: {trials}")
    check(rec["fps_measurements"] == len({t["arch"] for t in trials}),
          f"{rec['fps_measurements']} FPS measurements for {len(trials)} trials")
    check(rec["best"] is not None and math.isfinite(rec["best"]["value"]),
          f"best value {rec['best']}")
    rp = rec["replay"]
    check(rp["fps_from_cache"] == rp["fps_recorded"] and rp["new_measurements"] == 0,
          f"the best trial's replay: {rp}")
    check(rec["reload_equal"], "the study database reloads to other trials")
    check(rec["prune_exit_code"] == 0 and rec["after_prune"] == len(trials),
          f"prune_failed: exit {rec['prune_exit_code']}, {rec['after_prune']} trials left")
    imps = rec["importances"]
    check(isinstance(imps, dict) and all(math.isfinite(v) for v in imps.values())
          and (imps or len(trials) < 4), f"param_importances: {imps}")


def tools(dev, vgg_steps: int = 20, vgg_batch=None, vgg_patch=None) -> dict:
    """The three tools of slice 9 on ``dev``: the VGG self-training
    (``vgg_steps`` Adam steps at the asset's peak learning rate on seeded
    patches at the asset JSON's patch size and batch, from the committed
    encoder and JAX's decoder of seed 0; one more step profiled; the tap
    calibration on a probe of 4 patches to the random basis's tap RMS on
    that probe; the asset written and read back), ``raw_runner`` on a seeded 752x576 raw RGBA
    file with the shipped pix_shuffle graph (K1's launches counted from 0),
    and ``onnx_dump`` and ``onnx_svg`` on that graph."""
    import contextlib
    import io

    import numpy as np
    import torch
    from PIL import Image

    from fs_uae_image_enhancer_project_tpu_torch.export import onnx_dump, onnx_svg, raw_runner
    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_proto import load_model
    from fs_uae_image_enhancer_project_tpu_torch.losses import vgg
    from fs_uae_image_enhancer_project_tpu_torch.losses import vgg_selftrain as st
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.scripts.common import gradient_noise
    from fs_uae_image_enhancer_project_tpu_torch.utils import threefry

    rec: dict = {}
    with open(st.ASSET_JSON) as f:
        meta = json.load(f)
    patch, batch = vgg_patch or meta["patch"], vgg_batch or meta["batch"]
    x = torch.from_numpy(np.stack([gradient_noise(patch, patch, seed=40 + i)
                                   for i in range(batch)]).astype(np.float32) / 255.0).to(dev)
    enc = vgg.init_vgg16(device=dev)
    dec = st.init_decoder(threefry.key(0), device=dev)
    step = st.make_train_step(enc, dec, VGG_LR)
    losses = [float(step(x))]
    _sync(dev)
    t0 = time.perf_counter()
    losses += [step(x) for _ in range(vgg_steps - 1)]
    _sync(dev)
    step_ms = (time.perf_counter() - t0) / max(vgg_steps - 1, 1) * 1e3
    losses = losses[:1] + [float(v) for v in losses[1:]]
    busy, top, n_kernels = _device_busy(lambda: step(x), dev)  # one more step, profiled
    host = dict(load_1min=os.getloadavg()[0], threads=threading.active_count())
    probe = x[:4].cpu().numpy()
    targets = st.random_baseline_rms(probe, device=dev)
    scaled = st.rescale_taps(enc, probe, targets)
    got = st.measure_tap_rms(scaled, probe)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vgg16_features_selftrained.npz")
        st.save_asset(scaled, path)
        back = vgg._load_asset(path, device=dev)
    rec["vgg_selftrain"] = dict(
        patch=patch, batch=batch, steps=vgg_steps, loss_first=losses[0], loss_last=losses[-1],
        ms_per_step=step_ms, profiled_kernel_ms=busy, kernels_per_step=n_kernels,
        top_kernels=top, host=host, tap_rms=got, tap_targets=targets,
        tap_rel_err=max(abs(a - b) / b for a, b in zip(got, targets)),
        asset_round_trip=all(torch.equal(a[k], b[k].detach()) for a, b in zip(back, scaled)
                             for k in ("w", "b")) and len(back) == len(scaled))

    frame = np.random.default_rng(7).integers(0, 256, (576, 752, 4), dtype=np.uint8)
    graph = load_model(ONNX).graph
    with tempfile.TemporaryDirectory() as tmp:
        raw, png = os.path.join(tmp, "frame.raw"), os.path.join(tmp, "frame.png")
        frame.tofile(raw)
        fs.fused_stack.launches = 0
        t0 = time.perf_counter()
        out = raw_runner.run_inference(ONNX, raw, png, verbose=0, device=dev)
        run_s = time.perf_counter() - t0
        launches = fs.fused_stack.launches
        want = enhance_from_onnx(ONNX, device=dev)(frame[None]).cpu().numpy()
        with Image.open(png) as im:
            written = np.asarray(im)
        rec["raw_runner"] = dict(seconds=run_s, k1_launches=launches, shape=list(written.shape),
                                 png_equal=bool(np.array_equal(written, want[0])),
                                 returned_equal=bool(np.array_equal(out, want)))
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc_dump = onnx_dump.main([ONNX])
            rc_svg = onnx_svg.main([ONNX, "--out", os.path.join(tmp, "graph.svg")])
        with open(os.path.join(tmp, "graph.svg")) as f:
            svg = f.read()
    dump = text.getvalue()
    rec["onnx_tools"] = dict(
        exit_codes=[rc_dump, rc_svg], nodes=len(graph.nodes),
        dump_lines=dump.count("\n"),
        dump_nodes=sum(1 for line in dump.splitlines() if line.startswith("  [")),
        svg_bytes=len(svg), svg_boxes=svg.count('rx="6"'))
    return rec


def check_tools(rec: dict, dev) -> None:
    v = rec["vgg_selftrain"]
    check(math.isfinite(v["loss_last"]) and v["loss_last"] < v["loss_first"],
          f"VGG self-training: loss {v['loss_first']} -> {v['loss_last']}")
    check(v["tap_rel_err"] <= 1e-4, f"rescale_taps: {v['tap_rms']} vs {v['tap_targets']}")
    check(v["asset_round_trip"], "save_asset does not read back through losses/vgg.py")
    r = rec["raw_runner"]
    check(r["png_equal"] and r["returned_equal"] and r["shape"] == [576, 752, 4],
          f"raw_runner's frame is not enhance_from_onnx's: {r}")
    want = 1 if dev.type == "cuda" else 0
    check(r["k1_launches"] == want, f"raw_runner launched K1 {r['k1_launches']} times, not {want}")
    o = rec["onnx_tools"]
    check(o["exit_codes"] == [0, 0] and o["dump_nodes"] == o["nodes"] == o["svg_boxes"],
          f"onnx_dump / onnx_svg: {o}")


def family_artifact(name: str) -> str:
    return os.path.join(REPO, "artifacts", f"model_{name}", f"{name}.onnx")


def reexport(path: str, out: str) -> str:
    """Write the weights imported from ``path`` back out with the port's
    exporter, at the graph's own precision (fp16 initializers or fp32) and
    with its wrapper (the conv stacks' ReLU before the add, the U-Net's
    crop)."""
    from fs_uae_image_enhancer_project_tpu_torch.export import onnx_export
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_any
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_proto import FLOAT16, load_model
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model
    from fs_uae_image_enhancer_project_tpu_torch.models.configs import ConvStackConfig

    imp = import_any(path)
    fp16 = any(t.data_type == FLOAT16 for t in load_model(path).graph.initializers.values())
    if imp.kind == "conv_stack":
        cfg = ConvStackConfig(channels=tuple(imp.params[f"conv{i + 1}"]["w"].shape[-1]
                                             for i in range(imp.num_conv_layers)),
                              residual_layers=imp.residual_layers)
        return onnx_export.export_conv_stack_onnx(
            imp.params, cfg, out, fp16=fp16,
            relu_before_residual_add=imp.relu_before_residual_add)
    if imp.kind == "conv6":
        return onnx_export.export_conv6_onnx(imp.params, get_model("conv6").config, out,
                                             fp16=fp16)
    return onnx_export.export_residual_unet_onnx(
        imp.params, get_model("residual_unet").config, out, fp16=fp16,
        crop_left=imp.crop_left)


def frame_gflop(fn, frame) -> float:
    """The convolutions' GFLOP (2 x MACs) of one call, counted from the
    shapes by ``torch.utils.flop_counter.FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn(frame)
    return fc.get_total_flops() / 1e9


def families(dev, frame_hw=(576, 752), window: int = FAMILY_WINDOW,
             serve_frames: int = 6) -> dict:
    """Slice 7's main path: each shipped graph of the other families through
    ``enhance_from_onnx`` on ``dev`` at ``frame_hw``, held to its fp32 run,
    to the CPU's fp32 on a ``window`` square, and to its own re-export; then
    the U-Net through the frame server at depth 2. Every kernel counter is
    set to 0 before and read after: the path runs the conv epilogue kernel
    alone, whose launches are also read around one bf16 forward of each
    family (``epilogue_launches``, against :func:`epilogue_launches_expected`
    from the graph's parameters). Returns the records and, under ``fns``,
    each family's bf16 enhance fn."""
    import numpy as np
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_any
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue
    from fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar import (
        SidecarClient, SidecarServer)

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (serve_frames, *frame_hw, 4), dtype=np.uint8)
    frame = frames[:1]
    win = frame[:, :window, :window]
    recs, fns = {}, {}
    for name in FAMILIES:
        path = family_artifact(name)
        imp = import_any(path)
        enh16 = enhance_from_onnx(path, device=dev)
        enh32 = enhance_from_onnx(path, device=dev, compute_dtype=torch.float32)
        before = conv_epilogue.launches
        o16 = enh16(frame)
        epilogues = conv_epilogue.launches - before
        o32 = enh32(frame)
        on_device = o16.device.type == o32.device.type == dev.type
        o16, o32 = o16.cpu().numpy(), o32.cpu().numpy()
        cpu32 = enhance_from_onnx(path, device="cpu", compute_dtype=torch.float32)(win).numpy()
        levels = np.abs(enh32(win).cpu().numpy().astype(int) - cpu32.astype(int))
        with tempfile.TemporaryDirectory() as tmp:
            out = reexport(path, os.path.join(tmp, "re.onnx"))
            with open(out, "rb") as a, open(path, "rb") as b:
                bytes_equal = a.read() == b.read()
            re16 = enhance_from_onnx(out, device=dev)(frame).cpu().numpy()
        recs[name] = dict(
            kind=imp.kind, crop_left=imp.crop_left, shape=list(o16.shape), dtype=str(o16.dtype),
            on_device=on_device, alpha_255=bool((o16[..., 3] == 255).all()),
            psnr_bf16_vs_fp32_db=psnr(o16[..., :3], o32[..., :3]),
            card_vs_cpu_fp32_max_levels=int(levels.max()),
            card_vs_cpu_fp32_differing_share=float((levels > 0).mean()),
            reexport_bytes_equal=bytes_equal,
            reexport_frames_equal=bool(np.array_equal(re16, o16)),
            epilogue_launches=epilogues,
            epilogue_expected=epilogue_launches_expected(imp.params),
            gflop=frame_gflop(enh16, torch.from_numpy(frame).to(dev)))
        fns[name] = enh16
    # the U-Net through the frame server
    enh = fns["residual_unet"]
    direct = [enh(frames[i:i + 1]).cpu().numpy()[0] for i in range(serve_frames)]
    with tempfile.TemporaryDirectory() as tmp:
        sock = os.path.join(tmp, "families.sock")
        server = SidecarServer(enh, sock, height=frame_hw[0], width=frame_hw[1],
                               depth=SERVE_DEPTH, verbose=0, device=dev, client_timeout=60.0)
        server.warmup()
        server.bind()
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        client = SidecarClient(sock, timeout=60.0)
        try:
            got = [r for r in (client.submit(f) for f in frames) if r is not None]
            got += client.drain()
            client.shutdown_server()
        finally:
            client.close()
        th.join(timeout=10)
    served = dict(model="residual_unet", depth=SERVE_DEPTH, frames=len(got),
                  joined=not th.is_alive(),
                  byte_equal=len(got) == serve_frames
                  and all(np.array_equal(g, d) for g, d in zip(got, direct)))
    return dict(families=recs, served=served, on_card=dev.type == "cuda",
                launches={k: c.launches for k, c in counters.items()}, fns=fns, frame=frame)


def epilogue_launches_expected(params: dict) -> int:
    """The conv epilogue's launches in one forward of a model with these
    parameters on a card: one a convolution with a bias, none for a residual
    block's projection, whose bias goes into its block's conv3 pass."""
    def walk(node, key=None) -> int:
        if not isinstance(node, dict):
            return 0
        if "w" in node and getattr(node["w"], "ndim", 0) == 4:
            return int("b" in node and key != "proj")
        return sum(walk(v, k) for k, v in node.items())

    return walk(params)


def check_families(rec: dict) -> None:
    for name, r in rec["families"].items():
        check(r["on_device"], f"{name}: the enhance did not stay on the device")
        check(r["shape"][-1] == 4 and r["dtype"] == "uint8" and r["alpha_255"],
              f"{name}: bad output {r['shape']} {r['dtype']} alpha {r['alpha_255']}")
        check(r["psnr_bf16_vs_fp32_db"] >= PSNR_MIN_DB,
              f"{name}: bf16 {r['psnr_bf16_vs_fp32_db']} dB from fp32 < {PSNR_MIN_DB}")
        check(r["card_vs_cpu_fp32_max_levels"] <= FAMILY_MAX_LEVELS,
              f"{name}: the device's fp32 {r['card_vs_cpu_fp32_max_levels']} levels from the CPU's")
        check(r["reexport_bytes_equal"] and r["reexport_frames_equal"],
              f"{name}: the re-export differs (bytes {r['reexport_bytes_equal']}, "
              f"frames {r['reexport_frames_equal']})")
    s = rec["served"]
    check(s["joined"] and s["byte_equal"], f"served {s['model']}: {s}")
    for name, r in rec["families"].items():
        want = r["epilogue_expected"] if rec["on_card"] else 0
        check(r["epilogue_launches"] == want and r["epilogue_expected"] > 0,
              f"{name}: {r['epilogue_launches']} conv epilogue launches a forward, not {want}")
    check((rec["launches"]["conv_epilogue"] > 0) == rec["on_card"]
          and not any(v for k, v in rec["launches"].items() if k != "conv_epilogue"),
          f"the families' path launched another kernel of the repo: {rec['launches']}")


def _bench_numbers(text: str) -> dict:
    """``models.benchmark``'s printed ms a step and fps."""
    out = {}
    for line in text.splitlines():
        if line.startswith("Mean step:"):
            out["ms"] = float(line.split()[2])
        elif line.startswith("Average FPS:"):
            out["fps"] = float(line.split()[2])
    return out


def parallel_tools(dev, frame_hw=(576, 752), stream_frames: int = STREAM_FRAMES,
                   dir_frames: int = 8, dir_batch: int = 4, bench_duration: float = 1.0,
                   bench_crop=None, latency_frames: int = LATENCY_FRAMES) -> dict:
    """Slice 8's paths on ``dev`` with the shipped pix_shuffle graph, one
    process (the 1x1 mesh), K1's launches counted on each:

    - ``measure_stream_throughput`` at depth 1 and 2 over ``stream_frames``
      seeded frames (host arrays through the pinned slots and back), beside
      the device-frame ms of the same enhance;
    - ``enhance_directory`` over ``dir_frames`` seeded PNGs at ``batch_size``
      ``dir_batch``, each output against the per-frame enhance;
    - the frame server as a child process (``--depth 2 --stats``), waited for
      with ``utils.subproc.wait_for_line``, and ``sidecar_replay.main`` with
      ``--loops 2 --shutdown`` over the same PNGs: every saved PNG against
      the per-frame enhance;
    - served latency: a server child at depth 0 and one at depth 2, each
      replayed over at least ``latency_frames`` frames, the server's
      ``--stats`` p50/p90/p99 (at depth 0 the server's own time a frame; at
      depth 2 a frame waits for the client's second next frame, so there it
      is the client's pace), every saved PNG checked as above;
    - ``models.benchmark.main`` for pix_shuffle and conv3;
    - the spatial split at sp 2 and 4 as a loop over slabs in this process
      against the unsplit forward of one linear bf16 frame."""
    import contextlib
    import io

    import numpy as np
    import torch
    from PIL import Image

    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_pix_shuffle
    from fs_uae_image_enhancer_project_tpu_torch.export.streaming import (
        measure_stream_throughput)
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
    from fs_uae_image_enhancer_project_tpu_torch.models import benchmark, get_model
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.parallel import make_mesh, spatial
    from fs_uae_image_enhancer_project_tpu_torch.parallel.inference import enhance_directory
    from fs_uae_image_enhancer_project_tpu_torch.runtime import sidecar_replay
    from fs_uae_image_enhancer_project_tpu_torch.utils.subproc import wait_for_line

    h, w = frame_hw
    enhance = enhance_from_onnx(ONNX, device=dev)
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (dir_frames, h, w, 4), dtype=np.uint8)
    direct = [enhance(frames[i:i + 1]).cpu().numpy()[0] for i in range(dir_frames)]
    rec: dict = {"inputs": dict(stream_frames=stream_frames, dir_frames=dir_frames,
                                dir_batch=dir_batch, latency_frames=latency_frames),
                 "launches": {}}

    def counted(name, fn):
        before = fs.fused_stack.launches
        out = fn()
        rec["launches"][name] = fs.fused_stack.launches - before
        return out

    frame_dev = torch.from_numpy(frames[:1]).to(dev)
    rec["enhance_device_frame_ms"] = median_ms(lambda: enhance(frame_dev))
    rec["stream"] = [counted(f"stream_depth{d}", lambda d=d: measure_stream_throughput(
        enhance, depth=d, n_frames=stream_frames, frame_shape=(h, w, 4), device=dev))
        for d in (1, 2)]

    def equal_to_direct(out_dir, suffix=".png"):
        got = []
        for i in range(dir_frames):
            with Image.open(os.path.join(out_dir, f"f{i}{suffix}")) as im:
                got.append(np.array_equal(np.asarray(im), direct[i]))
        return got

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        for i, f in enumerate(frames):
            Image.fromarray(f, mode="RGBA").save(os.path.join(src, f"f{i}.png"))
        out = os.path.join(tmp, "out")
        n = counted("enhance_directory", lambda: enhance_directory(
            enhance, src, out, batch_size=dir_batch, mesh=make_mesh(device=dev), verbose=0))
        rec["enhance_directory"] = dict(frames=n, batch_size=dir_batch,
                                        byte_equal=all(equal_to_direct(out)))

        def serve_and_replay(depth: int, loops: int, tag: str) -> dict:
            """A server child at ``depth`` (``--stats``), waited for with
            wait_for_line, replayed ``loops`` times over the PNGs with
            ``--shutdown``; every saved PNG against the per-frame enhance."""
            sock, stats = os.path.join(tmp, f"{tag}.sock"), os.path.join(tmp, f"{tag}.json")
            proc = subprocess.Popen(
                [sys.executable, "-m", "fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar",
                 "--socket", sock, "--device", dev.type, "--depth", str(depth),
                 "--height", str(h), "--width", str(w), "--stats", stats, "--quiet"],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            try:
                ready, lines = wait_for_line(proc, "SIDECAR_READY", timeout=180)
                check(ready, f"the server child did not come up: {lines[-5:]}")
                replay_out = os.path.join(tmp, tag)
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = sidecar_replay.main(["--socket", sock, "--frames", src, "--out",
                                              replay_out, "--loops", str(loops), "--shutdown"])
                server_rc = proc.wait(timeout=60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            with open(stats) as f:
                lat = json.load(f)
            return dict(
                rc=rc, server_rc=server_rc, depth=depth, loops=loops,
                client=json.loads(next(line for line in buf.getvalue().splitlines()
                                       if line.startswith("{"))),
                byte_equal=all(equal_to_direct(replay_out)),
                server_stats={k: lat[k] for k in ("frames", "depth", "p50_ms", "p90_ms",
                                                  "p99_ms", "mean_ms", "max_ms")})

        # the pairing check at --loops 2; then the latency readings, a few
        # hundred frames a depth, so that p99 is not the slowest frame
        rec["replay"] = serve_and_replay(SERVE_DEPTH, 2, "replay")
        loops = -(-latency_frames // dir_frames)
        rec["latency"] = [serve_and_replay(d, loops, f"latency{d}") for d in (0, SERVE_DEPTH)]

    crop = [] if bench_crop is None else ["--crop_size", str(bench_crop[0]), str(bench_crop[1])]
    rec["benchmark"] = {}
    for model in ("pix_shuffle", "conv3"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = counted(f"benchmark_{model}", lambda model=model: benchmark.main(
                ["--model_type", model, "--duration", str(bench_duration),
                 "--device", dev.type, *crop]))
        rec["benchmark"][model] = dict(rc=rc, **_bench_numbers(buf.getvalue()))

    m = get_model("pix_shuffle")
    params = params_from_jax(import_pix_shuffle(ONNX).params, device=dev)
    x = ((torch.from_numpy(frames[:1, :, :, :3]).to(dev).float() / 255.0) ** 2.2
         ).to(torch.bfloat16)
    whole = m.apply(params, x).float()
    halo = spatial.model_halo(m)
    rec["split"] = []
    for sp in (2, 4):
        got = counted(f"split_sp{sp}", lambda sp=sp: spatial.apply_split(
            m.apply, params, x, sp=sp, halo=halo)).float()
        rec["split"].append(dict(sp=sp, halo_rows=halo.rows,
                                 max_abs=float((got - whole).abs().max())))
    return rec


def check_parallel_tools(rec: dict, dev) -> None:
    """K1's launches are counted on the card only (the CPU takes its plain
    version, which counts nothing)."""
    on_card = dev.type == "cuda"
    stream_frames, dir_frames, dir_batch = (rec["inputs"][k] for k in (
        "stream_frames", "dir_frames", "dir_batch"))
    launches = rec["launches"]
    for s in rec["stream"]:
        check(s["frames"] == stream_frames and s["fps_end_to_end"] > 0,
              f"stream at depth {s['depth']}: {s}")
        want = (stream_frames + s["depth"] + 2) if on_card else 0
        check(launches[f"stream_depth{s['depth']}"] == want,
              f"stream at depth {s['depth']}: K1 launched {launches}, not {want}")
    d = rec["enhance_directory"]
    check(d["frames"] == dir_frames and d["byte_equal"], f"enhance_directory: {d}")
    want = -(-dir_frames // dir_batch) if on_card else 0
    check(launches["enhance_directory"] == want,
          f"enhance_directory launched K1 {launches['enhance_directory']} times, not {want}")
    for r in [rec["replay"], *rec["latency"]]:
        check(r["rc"] == 0 and r["server_rc"] == 0 and r["byte_equal"], f"replay: {r}")
        check(r["client"]["frames"] == r["loops"] * dir_frames
              and r["server_stats"]["frames"] == r["loops"] * dir_frames
              and r["server_stats"]["depth"] == r["depth"], f"replay counts: {r}")
    check([r["depth"] for r in rec["latency"]] == [0, SERVE_DEPTH]
          and all(r["loops"] * dir_frames >= rec["inputs"]["latency_frames"]
                  for r in rec["latency"]), f"latency readings: {rec['latency']}")
    for model, b in rec["benchmark"].items():
        check(b["rc"] == 0 and b.get("ms", 0) > 0 and b.get("fps", 0) > 0,
              f"models.benchmark {model}: {b}")
    check((launches["benchmark_pix_shuffle"] > 0) == on_card
          and launches["benchmark_conv3"] == 0,
          f"models.benchmark's K1 launches: {launches}")
    for s in rec["split"]:
        check(s["max_abs"] <= K1_MAX_ABS, f"split at sp {s['sp']}: {s['max_abs']} > {K1_MAX_ABS}")
        check(launches[f"split_sp{s['sp']}"] == (s["sp"] if on_card else 0),
              f"split at sp {s['sp']}: K1 launched {launches}")


EXPORT_CHILD = """
import sys
import numpy as np
from fs_uae_image_enhancer_project_tpu_torch.export.stablehlo import load_enhance
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
path, frames, out, device = sys.argv[1:5]
enhance = load_enhance(path, device=device)
x = np.load(frames)
fs.fused_stack.launches = 0
y = np.stack([enhance(x[i:i + 1]).cpu().numpy()[0] for i in range(len(x))])
np.savez(out, frames=y, k1_launches=fs.fused_stack.launches,
         jax_loaded=any(m.split(".")[0] == "jax" for m in sys.modules))
"""


def export_phase(dev, frame_hw=(576, 752), n_frames: int = EXPORT_FRAMES) -> dict:
    """Slice 10's export route: each family of ``EXPORT_FAMILIES`` from its
    shipped graph (``enhance_from_onnx``) exported with
    ``export.stablehlo.export_enhance`` at 1 x frame_hw on ``dev``, loaded
    back in this process (K1's launches counted from 0) and, for
    pix_shuffle, in a child process that imports only the port; the frames
    against the eager enhance's on ``n_frames`` seeded frames; the text dump's
    K1 op nodes; ms a frame of the loaded program against the eager
    enhance (CUDA events)."""
    import numpy as np
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.export import stablehlo
    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs

    h, w = frame_hw
    frames = np.random.default_rng(11).integers(0, 256, (n_frames, h, w, 4), dtype=np.uint8)
    frame_dev = torch.from_numpy(frames[:1]).to(dev)
    rec: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fam in EXPORT_FAMILIES:
            enhance = enhance_from_onnx(family_artifact(fam), device=dev)
            path = os.path.join(tmp, f"{fam}.pt2")
            t0 = time.perf_counter()
            stablehlo.export_enhance(enhance, path, frame_h=h, frame_w=w, device=dev)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = stablehlo.load_enhance(path, device=dev)
            load_s = time.perf_counter() - t0
            want = np.stack([enhance(frames[i:i + 1]).cpu().numpy()[0] for i in range(n_frames)])
            fs.fused_stack.launches = 0
            got = np.stack([loaded(frames[i:i + 1]).cpu().numpy()[0] for i in range(n_frames)])
            r = dict(export_s=export_s, load_s=load_s, bytes=os.path.getsize(path),
                     k1_launches=fs.fused_stack.launches, calls=n_frames,
                     byte_equal=bool(np.array_equal(got, want)),
                     differing=int((got != want).sum()),
                     ms_loaded=median_ms(lambda: loaded(frame_dev)),
                     ms_eager=median_ms(lambda: enhance(frame_dev)))
            if fam == "pix_shuffle":
                text = stablehlo.stablehlo_text(enhance, frame_h=h, frame_w=w, device=dev)
                r["text_op_nodes"] = text.count("torch.ops.fse.fused_stack.default(")
                npy, out = os.path.join(tmp, "frames.npy"), os.path.join(tmp, "child.npz")
                np.save(npy, frames)
                env = dict(os.environ, PYTHONPATH=REPO)
                t0 = time.perf_counter()
                proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, path, npy, out,
                                       dev.type], cwd=REPO, env=env, capture_output=True,
                                      text=True, timeout=240)
                check(proc.returncode == 0, f"the export child failed: {proc.stderr[-2000:]}")
                child = np.load(out)
                r["child"] = dict(seconds=time.perf_counter() - t0,
                                  k1_launches=int(child["k1_launches"]),
                                  byte_equal=bool(np.array_equal(child["frames"], want)),
                                  jax_loaded=bool(child["jax_loaded"]))
            rec[fam] = r
    return rec


def check_export(rec: dict, dev) -> None:
    # on the CPU the served pix_shuffle route is the eager forward: no K1
    per_call = 1 if dev.type == "cuda" else 0
    for fam, r in rec.items():
        check(r["byte_equal"], f"export {fam}: the loaded program differs from the eager "
                               f"enhance in {r['differing']} values")
        want = per_call * r["calls"] if fam == "pix_shuffle" else 0
        check(r["k1_launches"] == want, f"export {fam}: K1 {r['k1_launches']} launches, not {want}")
    p = rec["pix_shuffle"]
    check(p["text_op_nodes"] == per_call, f"export: {p['text_op_nodes']} K1 op nodes in the text")
    c = p["child"]
    check(c["byte_equal"] and not c["jax_loaded"] and c["k1_launches"] == per_call * p["calls"],
          f"export: the child process's load: {c}")


def int8_phase(dev, qat_steps: int = INT8_QAT_STEPS, duration_s: float = INT8_DURATION_S,
               frame_hw=None, crop: int = 256) -> dict:
    """Slice 10's int8 path: the int32 accumulators of ``quantized._qconv``
    on ``dev`` against the CPU's, layer by layer of conv3_heavy's int8 PTQ
    forward on the first study frame (the codes of each layer's input from
    the device's forward); then the study of
    ``scripts/bench_int8_qat.py`` (PTQ and QAT quality, bf16 against int8
    ms a frame; K1's launches counted from 0)."""
    import numpy as np
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.export import qat
    from fs_uae_image_enhancer_project_tpu_torch.export import quantized as q
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_any
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.scripts import bench_int8_qat as study

    imp = import_any(family_artifact("conv3_heavy"))
    qp = qat.quantize_conv_stack(params_from_jax(imp.params, device=dev))
    x = torch.from_numpy(study.load_samples(frame_hw)[0][None]).to(dev, torch.bfloat16)
    layers = []
    with torch.no_grad():
        for i in range(imp.num_conv_layers):
            p = qp[f"conv{i + 1}"]
            scale = float(x.float().abs().max()) / 127.0
            codes = q.quantize_act(x, scale)
            acc = q.qconv_acc(p["w_q"], codes)
            acc_cpu = q.qconv_acc(p["w_q"].cpu(), codes.cpu())
            layers.append(dict(k=int(np.prod(p["w_q"].shape[:3])), cout=int(p["w_q"].shape[3]),
                               equal=bool(torch.equal(acc.cpu(), acc_cpu)),
                               max_abs_acc=int(acc_cpu.abs().max())))
            x = torch.relu(q._qconv(p, x, scale))
    fs.fused_stack.launches = 0
    t0 = time.perf_counter()
    report = study.run(dev, qat_steps=qat_steps, duration_s=duration_s, frame_hw=frame_hw,
                       crop=crop)
    return dict(accumulators=layers, study=report, study_s=time.perf_counter() - t0,
                k1_launches=fs.fused_stack.launches)


def check_int8(rec: dict, dev) -> None:
    check(all(r["equal"] for r in rec["accumulators"]),
          f"int8: the card's int32 accumulators differ from the CPU's: {rec['accumulators']}")
    c3, ps = rec["study"]["conv3_heavy"], rec["study"]["pix_shuffle"]
    for name, v in (("conv3_heavy PTQ", c3["ptq_min_psnr_db"]),
                    ("conv3_heavy QAT", c3["qat_min_psnr_db"]),
                    ("pix_shuffle PTQ", ps["ptq_min_psnr_db"])):
        check(math.isfinite(v) and v > 20.0, f"int8: {name} min PSNR {v} dB")
    check(math.isfinite(c3["distill_loss_last"]), f"int8: distillation loss {c3}")
    times = list(c3["ms_per_frame"].values()) + list(ps["ms_per_frame"].values())
    check(all(math.isfinite(t) and t > 0 for t in times), f"int8: times {times}")
    if dev.type == "cuda":
        check(rec["k1_launches"] > 0, "int8: the study's K1 enhance did not launch K1")


def benchmark_tools_phase(dev, duration_s: float = 0.05, shape=(288, 376),
                          act_shape=(1, 288, 376, 36)) -> dict:
    """Slice 10's four design tools on a reduced grid, about ``duration_s``
    a case: every activation's forward and backward at ``act_shape``; the
    conv grid at kernels 1-5 x channels 12, 36, 72 at ``shape``; the
    equal-latency search for kernels 1 and 5 against the 3x3, 36-channel
    conv; the gamma curves' errors and their SVG."""
    import contextlib
    import io

    import torch

    from fs_uae_image_enhancer_project_tpu_torch.benchmark_tools import (
        benchmark_activation_functions as acts,
        benchmark_kernel_sizes as ks,
        benchmark_search_channels as sc,
        gamma_plot,
    )

    out, rec = io.StringIO(), {}
    with contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        table = acts.activation_table([act_shape], dtype=torch.bfloat16, device=dev,
                                      duration_s=duration_s, chunk=20)
        rec["activations"] = dict(seconds=time.perf_counter() - t0,
                                  table=table["x".join(map(str, act_shape))])
        t0 = time.perf_counter()
        rows = ks.kernel_table(*shape, dtype=torch.bfloat16, duration_s=duration_s, chunk=20,
                               device=dev, kernels=[1, 2, 3, 4, 5], channels=[12, 36, 72])
        rec["kernel_sizes"] = dict(seconds=time.perf_counter() - t0, rows=rows)
        t0 = time.perf_counter()
        found = sc.search(3, 36, (1, 5), 72, *shape, dtype=torch.bfloat16, duration=duration_s,
                          device=dev, hi=256)
        rec["search_channels"] = dict(seconds=time.perf_counter() - t0, **found)
        t0 = time.perf_counter()
        err = gamma_plot.errors(device=dev)
        svg = gamma_plot.render_svg(device=dev)
        rec["gamma"] = dict(seconds=time.perf_counter() - t0, svg_bytes=len(svg),
                            polylines=svg.count("<polyline"),
                            max_err={d: {k: float(v.max()) for k, v in e.items()}
                                     for d, e in err.items()})
    return rec


def check_benchmark_tools(rec: dict) -> None:
    a = rec["activations"]["table"]
    check(a and all(v["fwd_us"] > 0 and v["fwd_bwd_us"] > 0 for v in a.values()),
          f"benchmark_activation_functions: {a}")
    rows = rec["kernel_sizes"]["rows"]
    check(len(rows) == 15 and all(r["ms"] > 0 for r in rows),
          f"benchmark_kernel_sizes: {rows}")
    s = rec["search_channels"]
    check(s["reference_ms"] > 0 and sorted(s["iso_latency_channels"]) == [1, 5],
          f"benchmark_search_channels: {s}")
    g = rec["gamma"]
    check(g["polylines"] == 10 and all(e["fp32"] < 0.05 and e["bf16"] < 0.05
                                       for e in g["max_err"].values()), f"gamma_plot: {g}")


def run_driver(name: str, argv: list):
    """``scripts.<name>.main(argv)`` in this process with its output captured:
    ``(exit code, its last line as JSON, seconds)``. A driver's own child
    processes (servers, first-frame probes) run as the driver starts them."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"fs_uae_image_enhancer_project_tpu_torch.scripts.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    lines = buf.getvalue().strip().splitlines()
    seconds = time.perf_counter() - t0
    print(f"drivers: {name} exited {rc} in {seconds:.1f} s", file=sys.stderr, flush=True)
    return rc, json.loads(lines[-1]), seconds


def batched_k3_launches(tree: str, batch: int = 16) -> dict:
    """K3's launches that the batched styled phase makes on the generator
    tree ``tree`` (PALETTES x DITHERS, one spec chunk of at most ``batch``
    crops): one a (palette, dither) for the chunk's crops whose lores crop
    has at least ``palette`` RGB444 colours, and one a crop and dither for
    each crop with fewer (the reference's unique-colour palette: the
    per-crop route). ``{"launches", "crops", "degenerate": {palette: n}}``."""
    import numpy as np
    from PIL import Image

    from fs_uae_image_enhancer_project_tpu_torch.datagen.quantize import grid_quantize
    from fs_uae_image_enhancer_project_tpu_torch.datagen.util_img import (
        pre_apply_resolution_style)

    colours = []
    for root, _dirs, files in os.walk(tree):
        for f in files:
            if f.startswith("target_"):
                with Image.open(os.path.join(root, f)) as im:
                    low = np.asarray(pre_apply_resolution_style(im.convert("RGB"), "lores"),
                                     np.uint8)
                colours.append(len(np.unique(grid_quantize(low, "RGB444").reshape(-1, 3),
                                             axis=0)))
    check(0 < len(colours) <= batch, f"{len(colours)} crops: not one spec chunk of {batch}")
    degenerate = {p: sum(c < p for c in colours) for p in PALETTES}
    launches = len(DITHERS) * sum(d + (d < len(colours)) for d in degenerate.values())
    return dict(launches=launches, crops=len(colours), degenerate=degenerate)


def drivers(dev, scenes: int = DRIVER_SCENES, scene_wh=(1504, 1152), crops: int = DRIVER_CROPS,
            rich: int = DRIVER_RICH_IMAGES, rich_crops: int = DRIVER_RICH_CROPS,
            clients=DRIVER_CLIENTS, depths=DRIVER_DEPTHS, serve_s: float = DRIVER_SERVE_S,
            serve_hw=(576, 752), window_s: float = DRIVER_WINDOW_S,
            eval_samples: int = DRIVER_EVAL_SAMPLES, shapes=("576x752",)) -> dict:
    """Slice 11's drivers (``scripts/``), each through its ``main`` on ``dev``
    at reduced scale: the seeded corpus (``scenes`` scenes and the eight flat
    fills) and its rerun; the generator's three legs on those scenes,
    ``crops`` crops each, kept in a work directory (every scene crop has
    fewer colours than the palettes: the batched leg goes per crop), and its
    batched leg alone on ``rich`` many-coloured 752x576 frames,
    ``rich_crops`` crops each (the batched route proper); the multi-client serving
    bench (a server child a point, ``clients`` x ``depths``, ``serve_s`` a
    point) with its answers against this process's enhance of the same
    frames; every family's fps and the conv3_heavy/conv6 geometry variants,
    ``window_s`` each; the head-to-head on the generator's batched tree with
    ``eval_samples`` samples; precompile at ``shapes``; the artifacts of
    pix_shuffle and conv3. No trained checkpoint of a work directory is
    read: the weights are the committed graphs'."""
    import hashlib

    from PIL import Image

    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
    from fs_uae_image_enhancer_project_tpu_torch.scripts import bench_generator_e2e
    from fs_uae_image_enhancer_project_tpu_torch.scripts.common import gradient_noise
    from fs_uae_image_enhancer_project_tpu_torch.scripts import bench_sidecar_multiclient as bsm

    on = ["--device", dev.type]
    rec: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        gt, work = os.path.join(tmp, "gt"), os.path.join(tmp, "work")
        no_ckpt = ["--work_dir", os.path.join(tmp, "no_checkpoints")]
        corpus = ["--out", gt, "--scenes", str(scenes), "--width", str(scene_wh[0]),
                  "--height", str(scene_wh[1])]
        for key in ("make_gt_frames", "make_gt_frames_rerun"):
            rc, out, s = run_driver("make_gt_frames", corpus)
            rec[key] = dict(rc=rc, seconds=s, written=out["written"], kept=out["kept"])
        images = [f"scene_{i:03d}.png" for i in range(scenes)]
        rc, out, s = run_driver("bench_generator_e2e", [
            "--gt", gt, "--images", *images, "--n_images", str(scenes), "--max_crops",
            str(crops), "--device_batch", "16", "--work_dir", work, *on])
        rec["generator"] = dict(rc=rc, seconds=s, report=out,
                                sklearn=bench_generator_e2e.sklearn_available(),
                                batched_k3=batched_k3_launches(
                                    os.path.join(work, "genbench_device_batched")))
        many, work_many = os.path.join(tmp, "many"), os.path.join(tmp, "work_many")
        os.makedirs(many)
        names = [f"noise_{i}.png" for i in range(rich)]
        for i, name in enumerate(names):
            Image.fromarray(gradient_noise(576, 752, seed=50 + i, sigma=48.0)).save(
                os.path.join(many, name))
        rc, out, s = run_driver("bench_generator_e2e", [
            "--gt", many, "--images", *names, "--n_images", str(rich), "--max_crops",
            str(rich_crops), "--device_batch", "16", "--legs", "device_batched",
            "--work_dir", work_many, *on])
        rec["generator_many_colours"] = dict(
            rc=rc, seconds=s, report=out,
            batched_k3=batched_k3_launches(os.path.join(work_many, "genbench_device_batched")))
        rc, out, s = run_driver("bench_sidecar_multiclient", [
            "--clients", *map(str, clients), "--depths", *map(str, depths), "--seconds",
            str(serve_s), "--height", str(serve_hw[0]), "--width", str(serve_hw[1]), *on])
        enhance = enhance_from_onnx(ONNX, device=dev)
        want = {str(k): hashlib.sha256(enhance(f[None]).cpu().numpy()[0].tobytes()).hexdigest()
                for k, f in enumerate(bsm.client_frames(*serve_hw))}
        rec["multiclient"] = dict(rc=rc, seconds=s, report=out,
                                  answers_equal_to_enhance=out["answer_digests"] == want)
        for name in ("bench_families", "bench_conv6_latency"):
            rc, out, s = run_driver(name, ["--duration", str(window_s), *no_ckpt, *on])
            rec[name] = dict(rc=rc, seconds=s, report=out)
        rc, out, s = run_driver("eval_headtohead", [
            "--data", os.path.join(work, "genbench_device_batched", "train"),
            "--num_samples", str(eval_samples), "--batch_size", str(eval_samples), *no_ckpt, *on])
        rec["eval_headtohead"] = dict(rc=rc, seconds=s, report=out)
        rc, out, s = run_driver("precompile", ["--shapes", *shapes, *on])
        rec["precompile"] = dict(rc=rc, seconds=s, report=out)
        rc, out, s = run_driver("build_artifacts", [
            "--out", os.path.join(tmp, "artifacts"), "--models", "pix_shuffle", "conv3",
            "pix_shuffle_trained", *no_ckpt, *on])
        rec["build_artifacts"] = dict(rc=rc, seconds=s, report=out)
    return rec


def check_drivers(rec: dict, dev, scenes: int = DRIVER_SCENES, crops: int = DRIVER_CROPS,
                  rich: int = DRIVER_RICH_IMAGES, rich_crops: int = DRIVER_RICH_CROPS) -> None:
    """The drivers phase's checks; the kernels launch only on a card."""
    on_card = dev.type == "cuda"
    for key, r in rec.items():
        check(r["rc"] == 0, f"driver {key} exited {r['rc']}")
    first, again = rec["make_gt_frames"], rec["make_gt_frames_rerun"]
    check(first["written"] == scenes + 8 and first["kept"] == 0, f"make_gt_frames: {first}")
    check(again["written"] == 0 and again["kept"] == scenes + 8, f"its rerun: {again}")
    g = rec["generator"]["report"]
    host = "host" if rec["generator"]["sklearn"] else "host_kmeans_torch_cpu"
    check(g["host_leg"] == host and host in g and ("host" in g) == (host == "host"),
          f"generator's host leg {g['host_leg']} (sklearn: {rec['generator']['sklearn']})")
    targets = scenes * crops
    for leg in (host, "device_per_crop", "device_batched"):
        r = g[leg]
        check(r["missing"] == 0 and r["target_crops"] == targets
              and r["styled_crops"] == targets * len(PALETTES) * len(DITHERS),
              f"generator leg {leg}: {r}")
    check(g[host]["k3_launches"] == 0, f"the host leg launched K3: {g[host]}")
    # per crop: one launch a crop and style; batched: one a style for the
    # chunk of 16, plus one a crop and style for a crop with fewer colours
    # than the palette (batched_k3_launches)
    batched = rec["generator"]["batched_k3"]
    want = ((len(PALETTES) * len(DITHERS) * targets, batched["launches"]) if on_card
            else (0, 0))
    got = (g["device_per_crop"]["k3_launches"], g["device_batched"]["k3_launches"])
    check(batched["crops"] == targets and got == want,
          f"K3 launches per crop / batched {got}, not {want} ({batched})")
    # the batched route proper: one chunk of 16 many-coloured crops, K3
    # once a (palette, dither)
    many = rec["generator_many_colours"]
    r, targets = many["report"]["device_batched"], rich * rich_crops
    check(many["report"]["slice"]["legs"] == ["device_batched"] and r["missing"] == 0
          and r["target_crops"] == targets == 16
          and r["styled_crops"] == targets * len(PALETTES) * len(DITHERS),
          f"generator's batched leg on many colours: {r}")
    want = len(PALETTES) * len(DITHERS) if on_card else 0
    check(many["batched_k3"] == dict(launches=len(PALETTES) * len(DITHERS), crops=16,
                                     degenerate={p: 0 for p in PALETTES})
          and r["k3_launches"] == want,
          f"K3 launched {r['k3_launches']} times for a chunk of 16, not {want} ({many})")
    m = rec["multiclient"]["report"]
    check(m["answers_agree"] and rec["multiclient"]["answers_equal_to_enhance"],
          "served frames differ from this process's enhance")
    for r in m["rows"]:
        st = r["server_stats"]
        check(r["clients_failed"] == 0 and r["answered_equals_sent"] and r["server_rc"] == 0,
              f"multiclient point: {r}")
        check(st["k1_launches"] == (st["frames"] + 1 if on_card else 0),
              f"server K1 launches {st['k1_launches']} for {st['frames']} frames + warm-up")
    for r in rec["bench_families"]["report"]["rows"]:
        want = r["frames"] if on_card and r["family"] == "pix_shuffle" else 0
        check(r["fps"] > 0 and r["k1_launches"] == want, f"bench_families: {r}")
    check(len(rec["bench_conv6_latency"]["report"]["variants"]) == 6
          and all(v["fps"] > 0 for v in rec["bench_conv6_latency"]["report"]["variants"].values()),
          f"bench_conv6_latency: {rec['bench_conv6_latency']['report']}")
    e = rec["eval_headtohead"]["report"]
    # the plateau-50 row from the JAX script's orbax checkpoint, second
    check(len(e["rows"]) == 4 and all(math.isfinite(r["srgb_psnr_db"]) and r["batches"] == 1
                                      for r in e["rows"])
          and e["rows"][1]["label"] == "trained here: pix_shuffle plateau-50"
          and not e["skipped"], f"eval_headtohead: {e}")
    for row in rec["precompile"]["report"]["shapes"]:
        if on_card:
            check(row["cold"]["built"] and not row["warm"]["built"]
                  and (row["warm"]["process_to_first_frame_s"]
                       < row["cold"]["process_to_first_frame_s"])
                  and row["cold"]["k1_launches"] == row["warm"]["k1_launches"] == 1,
                  f"precompile: {row}")
    check(all(rec["build_artifacts"]["report"]["onnx_equal_to_committed"].values()),
          f"build_artifacts' ONNX differs: {rec['build_artifacts']['report']}")
    trained = rec["build_artifacts"]["report"]["weights"]["pix_shuffle_trained"]
    check(trained == f"committed checkpoint {ORBAX_TRAINED}",
          f"build_artifacts took pix_shuffle_trained's weights from {trained}")


def flat(tree, pre=()):
    """(dotted path, leaf) of a nested dict or list, None leaves and empty
    dicts left out."""
    if isinstance(tree, (dict, list)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        return [x for k in keys for x in flat(tree[k], pre + (str(k),))]
    return [] if tree is None else [(".".join(pre), tree)]


def orbax_phase(dev, tree: str, crop=(CROP_W, CROP_H), frame_hw=(576, 752),
                samples: int = ORBAX_RESUME_SAMPLES, val_samples: int = ORBAX_RESUME_VAL) -> dict:
    """Slice 14: the JAX package's TPU-trained orbax checkpoints read by the
    port (``train/orbax_reader.py``, no jax, tensorstore or zstd codec), each
    read timed on the host, params only and the whole tree (``opt_state``
    too). The trained lightweight checkpoint's 24 leaves against the port's
    import of its graph, bit for bit, and one seeded frame through K1 with
    them against ``enhance_from_onnx`` of that graph, byte for byte; the
    heavy run's eager bf16 forward on the frame; then the trainer CLI
    resumed for one epoch of ``samples`` samples on ``tree`` from a copy of
    the ``ablation_novgg`` run (its CSV, the path column pointing at the
    copy, and the epoch-12 checkpoint its last row names): the first train
    step's parameters and learning rate, and the CSV's new row."""
    import csv

    import numpy as np
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import (
        enhance_from_onnx, make_enhance_fn)
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_pix_shuffle
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.parallel.train_step import leaves
    from fs_uae_image_enhancer_project_tpu_torch.train import cli
    from fs_uae_image_enhancer_project_tpu_torch.train import trainer as tr
    from fs_uae_image_enhancer_project_tpu_torch.train.orbax_reader import (
        is_orbax_checkpoint, read_orbax)

    rec: dict = {"reads": {}}
    read = {}
    for name, path in (("trained_epoch73", ORBAX_TRAINED), ("plateau_50", ORBAX_PLATEAU),
                       ("heavy_epoch60", ORBAX_HEAVY)):
        t0 = time.perf_counter()
        read[name] = read_orbax(path)
        params_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole = read_orbax(path, subtrees=("step", "params", "buffers", "opt_state"))
        whole_s = time.perf_counter() - t0
        rec["reads"][name] = dict(
            path=os.path.relpath(path, REPO), params_s=params_s, whole_s=whole_s,
            step=int(read[name]["step"]), param_leaves=len(flat(read[name]["params"])),
            buffers=len(flat(read[name]["buffers"])),
            opt_state_leaves=len(flat(whole["opt_state"])))
        print(f"orbax read {name}: {params_s:.3f} s params only, {whole_s:.3f} s the whole "
              "tree", flush=True)

    # the trained checkpoint: its leaves and its K1 frame against its graph's
    got = flat(read["trained_epoch73"]["params"])
    want = flat(import_pix_shuffle(ORBAX_TRAINED_ONNX).params)
    rec["trained_leaves"] = len(got)
    rec["trained_leaves_equal_to_graph"] = (
        [k for k, _ in got] == [k for k, _ in want]
        and all(a.dtype == np.float32 and np.array_equal(a, b)
                for (_, a), (_, b) in zip(got, want)))
    frame = np.random.default_rng(14).integers(0, 256, (1, *frame_hw, 4), dtype=np.uint8)
    m = get_model("pix_shuffle")
    enhance_ck = make_enhance_fn(m.apply, params_from_jax(read["trained_epoch73"]["params"],
                                                          device=dev), crop_left=16, device=dev)
    before = fs.fused_stack.launches
    out_ck = enhance_ck(frame).cpu().numpy()
    rec["trained_k1_launches"] = fs.fused_stack.launches - before
    out_graph = enhance_from_onnx(ORBAX_TRAINED_ONNX, device=dev)(frame).cpu().numpy()
    rec["trained_frame_equal_to_graph"] = bool(np.array_equal(out_ck, out_graph))
    rec["trained_frame_shape"] = list(out_ck.shape)

    # the heavy run: eager bf16 (K1 takes the lightweight stack only)
    hm = get_model("pix_shuffle", "heavyweight")
    hp = params_from_jax(read["heavy_epoch60"]["params"], device=dev)
    x = (torch.from_numpy(frame[..., :3]).to(dev).float() / 255.0) ** 2.2
    before = fs.fused_stack.launches
    with torch.no_grad():
        y = hm.apply(hp, x.to(torch.bfloat16)).float()
    rec["heavy_k1_launches"] = fs.fused_stack.launches - before
    rec["heavy_forward"] = dict(shape=list(y.shape), dtype="bfloat16",
                                finite=bool(torch.isfinite(y).all()),
                                mean=float(y.mean()), std=float(y.std()))

    # the resume: the JAX run's CSV and checkpoint, copied
    w, h = crop
    with open(os.path.join(ORBAX_RESUME, "training_stats_pix_shuffle.csv")) as f:
        rows = list(csv.reader(f))
    last = os.path.basename(rows[-1][5])
    first_step: dict = {}
    real = tr.make_train_step

    def capturing(*a, **kw):
        step = real(*a, **kw)

        def first(state, lr_b, hr_b):
            if not first_step:
                first_step["params"] = [t.detach().cpu().clone() for t in leaves(state.params)]
                first_step["lr"] = state.optimizer.param_groups[0]["lr"]
            return step(state, lr_b, hr_b)
        return first

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ablation_novgg")
        shutil.copytree(os.path.join(ORBAX_RESUME, last), os.path.join(ck, last))
        with open(os.path.join(ck, "training_stats_pix_shuffle.csv"), "w", newline="") as f:
            csv.writer(f).writerows(
                [rows[0]] + [r[:5] + [os.path.join(ck, os.path.basename(r[5]))]
                             for r in rows[1:]])
        start_epoch = int(rows[-1][0])
        before = fs.fused_stack.launches
        tr.make_train_step = capturing
        try:
            t0 = time.perf_counter()
            rc = cli.main(["--model_type", "pix_shuffle", "--checkpoint_dir", ck,
                           "--epochs", str(start_epoch + 1), "--generator_train_dir", tree,
                           "--crop_size", str(w), str(h), "--batch_size", "1",
                           "--accumulation_steps", "2", "--train_samples", str(samples),
                           "--val_samples", str(val_samples), "--verbose", "0",
                           "--device", str(dev)])
            _sync(dev)
            resume_s = time.perf_counter() - t0
        finally:
            tr.make_train_step = real
        rec["resume_k1_launches"] = fs.fused_stack.launches - before
        with open(os.path.join(ck, "training_stats_pix_shuffle.csv")) as f:
            after = list(csv.reader(f))
        saved = read_orbax(os.path.join(ORBAX_RESUME, last))
        want = [torch.from_numpy(np.asarray(a, np.float32)) for _, a in flat(saved["params"])]
        new_ck = after[-1][5] if len(after) > len(rows) else None
        rec["resume"] = dict(
            rc=rc, seconds=resume_s, checkpoint=last, val_samples=val_samples,
            csv_rows_before=len(rows) - 1,
            csv_rows_after=len(after) - 1, csv_lr=float(rows[-1][4]),
            first_step_lr=first_step.get("lr"), new_row=after[-1] if new_ck else None,
            new_checkpoint_written=bool(new_ck and is_orbax_checkpoint(new_ck)),
            first_step_params_equal_to_checkpoint=bool(first_step) and len(
                first_step["params"]) == len(want) and all(
                torch.equal(a, b) for a, b in zip(first_step["params"], want)))
    return rec


def check_orbax(rec: dict, dev) -> None:
    """The orbax phase's checks; K1 launches only on a card."""
    on_card = dev.type == "cuda"
    for name, r in rec["reads"].items():
        check(r["param_leaves"] > 0 and r["buffers"] == 0 and r["opt_state_leaves"] > 0
              and math.isfinite(r["params_s"]) and math.isfinite(r["whole_s"]),
              f"orbax read {name}: {r}")
    check(rec["trained_leaves"] == 24 and rec["trained_leaves_equal_to_graph"],
          "the trained checkpoint's leaves differ from its graph's")
    check(rec["trained_frame_equal_to_graph"],
          "the trained checkpoint's frame differs from enhance_from_onnx of its graph")
    check(rec["trained_k1_launches"] == (1 if on_card else 0),
          f"K1 launched {rec['trained_k1_launches']} times for the trained checkpoint's frame")
    check(rec["heavy_forward"]["finite"] and rec["heavy_k1_launches"] == 0,
          f"the heavy checkpoint's forward: {rec['heavy_forward']}")
    r = rec["resume"]
    row = r["new_row"]
    check(r["rc"] == 0 and row is not None and r["csv_rows_after"] == r["csv_rows_before"] + 1,
          f"the resume: {r}")
    check(int(row[0]) == 13 and r["first_step_lr"] == r["csv_lr"]
          and math.isclose(float(row[4]), r["csv_lr"] * 0.955, rel_tol=1e-9),
          f"the resume did not go on at epoch 13 from the CSV's learning rate: {r}")
    check(r["first_step_params_equal_to_checkpoint"] and r["new_checkpoint_written"],
          f"the resume's first step did not start from the checkpoint's weights: {r}")
    want = r["val_samples"] if on_card else 0  # one a validation batch of 1
    check(rec["resume_k1_launches"] == want,
          f"the resume's validation launched K1 {rec['resume_k1_launches']} times, not {want}")


def orbax_write(dev, tree: str, crop=(CROP_W, CROP_H), accum: int = ORBAX_WRITE_ACCUM,
                frame_hw=(576, 752), rewrites: int = ORBAX_WRITE_REWRITES) -> dict:
    """Slice 15: the trainer's checkpoints in the JAX package's orbax format
    (``train/orbax_writer.py`` over ``utils/ocdbt.py``'s writer and
    ``utils/zstd.py``'s ``compress``), written on the card's host. For the
    lightweight pix_shuffle (its own criterion, VGG on) and conv3
    (BatchNorm), cuDNN deterministic: two optimizer steps of ``accum`` uint8
    crops of ``tree`` at ``crop`` from the seeded initial weights, then
    ``save_checkpoint`` once and ``rewrites`` times more over it (the best
    checkpoint is rewritten on each improvement), each write timed, and the
    bytes and files on disk; ``read_orbax`` of the whole tree against the
    state on the card, leaf for leaf (Adam's moments found by the tensor);
    a fresh state from other seeds restored by ``load_checkpoint``, and one
    more step of both on a third batch, leaf for leaf. For pix_shuffle, one
    seeded frame through K1 with the checkpoint's parameters
    (``load_params``) against the in-memory ones, byte for byte. Then the
    committed TPU-trained ``checkpoint_best_epoch73`` read whole, written
    again by the port and read back, leaf for leaf."""
    import numpy as np
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.data import (
        SRDataset, batch_transform, gather_all_samples_from_directory)
    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import make_enhance_fn
    from fs_uae_image_enhancer_project_tpu_torch.losses import build_criterion
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model, train_apply
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.parallel import train_step as ts
    from fs_uae_image_enhancer_project_tpu_torch.train import trainer as tr
    from fs_uae_image_enhancer_project_tpu_torch.train.orbax_reader import read_orbax
    from fs_uae_image_enhancer_project_tpu_torch.train.orbax_writer import write_orbax

    whole = ("step", "params", "buffers", "opt_state")
    pairs = gather_all_samples_from_directory(tree, crop, verbose=0)

    def on_host(state) -> dict:
        """``state`` as the leaves its checkpoint must hold: the optimizer's
        own state dicts, each moment by its parameter tensor."""
        params = dict(flat(state.params))
        out = {"step": np.int32(state.step), "opt_state.2.count": np.int32(
            state.scheduler.last_epoch)}
        out.update({f"params.{k}": t.detach().cpu().numpy() for k, t in params.items()})
        out.update({f"buffers.{k}": t.cpu().numpy() for k, t in flat(state.buffers)})
        for k, t in params.items():
            st = state.optimizer.state[t]
            out[f"opt_state.1.mu.{k}"] = st["exp_avg"].cpu().numpy()
            out[f"opt_state.1.nu.{k}"] = st["exp_avg_sq"].cpu().numpy()
            out["opt_state.1.count"] = np.int32(st["step"].item())
        return out

    def differing(got: dict, want: dict) -> list:
        if sorted(got) != sorted(want):
            return sorted(set(got) ^ set(want))
        return [k for k in want if not (np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
                                        and np.array_equal(got[k], want[k]))]

    def disk(path: str) -> dict:
        sizes = [os.path.getsize(os.path.join(r, f)) for r, _d, fs_ in os.walk(path)
                 for f in fs_]
        return dict(bytes=sum(sizes), files=len(sizes))

    rec: dict = {}
    keep = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name in ("pix_shuffle", "conv3"):
                m = get_model(name)
                bn = name == "conv3"
                ds = SRDataset(pairs, crop, 3 * accum, batch_size=1, linear=m.linear_io,
                               flips=False, seed=15, transfer_dtype="uint8")
                lrs, hrs = zip(*[(torch.from_numpy(a), torch.from_numpy(b)) for a, b in ds])
                batches = [(torch.stack(lrs[i:i + accum]).to(dev),
                            torch.stack(hrs[i:i + accum]).to(dev))
                           for i in range(0, 3 * accum, accum)]
                step = ts.make_train_step(train_apply(m), build_criterion(m.loss, device=dev),
                                          has_batchnorm=bn, compute_dtype=torch.bfloat16,
                                          input_transform=batch_transform(m.linear_io))

                def fresh(seed):
                    return ts.init_train_state(
                        m.init(torch.Generator().manual_seed(seed), device=dev),
                        ts.make_optimizer(steps_per_epoch=1), has_batchnorm=bn)

                state = fresh(0)
                for b in batches[:2]:
                    state, _ = step(state, *b)
                _sync(dev)
                path = os.path.join(tmp, f"checkpoint_best_{name}")
                write_s = []
                for _ in range(1 + rewrites):
                    t0 = time.perf_counter()
                    tr.save_checkpoint(path, state)
                    write_s.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                back = read_orbax(path, whole)
                read_s = time.perf_counter() - t0
                want = on_host(state)
                r = dict(write_s=write_s, read_s=read_s, **disk(path),
                         leaves=len(want), step=int(back["step"]),
                         lr=state.optimizer.param_groups[0]["lr"],
                         left_over=[n for n in os.listdir(tmp) if "orbax-checkpoint" in n],
                         read_differing=differing(dict(flat(back)), want),
                         buffers=len(flat(back["buffers"])))
                restored = tr.load_checkpoint(path, fresh(1))
                r["restored_lr"] = restored.optimizer.param_groups[0]["lr"]
                r["restored_differing"] = differing(on_host(restored), want)
                if name == "pix_shuffle":
                    # the checkpoint's weights through K1 against the state's
                    frame = np.random.default_rng(15).integers(0, 256, (1, *frame_hw, 4),
                                                               dtype=np.uint8)
                    before = fs.fused_stack.launches
                    outs = [make_enhance_fn(m.apply, p, crop_left=16, device=dev)(frame)
                            .cpu().numpy() for p in (
                                ts.merge_bn_buffers(state.params, state.buffers),
                                tr.load_params(path, m.init(device=dev)))]
                    r["k1_launches"] = fs.fused_stack.launches - before
                    r["frame_equal"] = bool(np.array_equal(*outs))
                    r["frame_shape"] = list(outs[0].shape)
                state, loss_a = step(state, *batches[2])
                restored, loss_b = step(restored, *batches[2])
                r["next_step_losses"] = [float(loss_a), float(loss_b)]
                r["next_step_differing"] = differing(on_host(restored), on_host(state))
                rec[name] = r
                print(f"orbax_write {name}: {r['bytes']} bytes in {r['files']} files, "
                      f"written in {min(write_s):.4f}-{max(write_s):.4f} s", flush=True)

            # the committed TPU-trained checkpoint written again by the port
            t0 = time.perf_counter()
            src = read_orbax(ORBAX_TRAINED, whole)
            read_s = time.perf_counter() - t0
            src["buffers"] = {tr.EMPTY_BUFFERS: np.zeros((1,), np.float32)}
            out = os.path.join(tmp, "checkpoint_best_epoch73")
            t0 = time.perf_counter()
            write_orbax(out, src)
            write_s = time.perf_counter() - t0
            again = read_orbax(out, whole)
            rec["epoch73"] = dict(
                read_s=read_s, write_s=write_s, **disk(out),
                jax_bytes=disk(ORBAX_TRAINED)["bytes"], leaves=len(flat(again)),
                differing=differing(dict(flat(again)), dict(flat(dict(src, buffers={})))))
    finally:
        torch.backends.cudnn.deterministic = keep
    return rec


def check_orbax_write(rec: dict, dev) -> None:
    """The orbax_write phase's checks; K1 launches only on a card."""
    for name in ("pix_shuffle", "conv3"):
        r = rec[name]
        check(not r["read_differing"] and r["step"] == 2
              and (r["buffers"] > 0) == (name == "conv3"),
              f"{name}: the checkpoint read back differs from the state: {r}")
        check(not r["left_over"], f"{name}: the rewrites left {r['left_over']}")
        check(not r["restored_differing"] and r["restored_lr"] == r["lr"],
              f"{name}: the restored state differs: {r}")
        check(not r["next_step_differing"] and r["next_step_losses"][0] == r["next_step_losses"][1],
              f"{name}: the next step from the restored state differs: {r}")
        check(r["bytes"] > 0 and all(math.isfinite(x) for x in r["write_s"]),
              f"{name}: the writes: {r}")
    p = rec["pix_shuffle"]
    check(p["frame_equal"], "the checkpoint's frame through K1 differs from the state's")
    check(p["k1_launches"] == (2 if dev.type == "cuda" else 0),
          f"K1 launched {p['k1_launches']} times for the two frames")
    e = rec["epoch73"]
    check(not e["differing"] and e["leaves"] > 0,
          f"epoch73 written again differs: {e['differing']}")


def _pip(args: list, cache: str) -> None:
    """``python -m pip`` with no index (nothing is fetched, and pip skips its
    version check) and no cache; pip's other caches go to ``cache``."""
    r = subprocess.run([sys.executable, "-m", "pip", *args, "--no-index", "--no-cache-dir",
                        "--disable-pip-version-check"], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, XDG_CACHE_HOME=cache))
    check(r.returncode == 0, f"pip {args[0]} exited {r.returncode}: {r.stderr[-3000:]}")


def build_wheel(out: str, cache: str, root: str = REPO) -> str:
    """The repo's wheel, built by ``pip wheel --no-deps --no-build-isolation``
    in ``out`` from a copy of ``pyproject.toml``, ``README.md`` and the two
    packages without ``__pycache__``, so that the build's ``build/`` and
    ``*.egg-info`` land in the copy, not in ``root``. Returns its path."""
    src = os.path.join(out, "src")
    os.makedirs(src)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(os.path.join(root, name), src)
    for pkg in PACKAGES:
        shutil.copytree(os.path.join(root, pkg), os.path.join(src, pkg),
                        ignore=shutil.ignore_patterns("__pycache__"))
    _pip(["wheel", "--no-deps", "--no-build-isolation", "-w", os.path.join(out, "dist"), src],
         cache)
    (whl,) = glob.glob(os.path.join(out, "dist", "*.whl"))
    return whl


def install_wheel(whl: str, target: str, cache: str) -> None:
    """``pip install --no-deps --target``: the wheel's declared dependencies
    are the JAX package's, which the port does not import."""
    _pip(["install", "--no-deps", "--target", target, whl], cache)


def serve_installed(target: str, cache: str, work: str, frames, dev,
                    depth: int = SERVE_DEPTH) -> dict:
    """The installed ``bin/fse-torch-sidecar`` as a child process, with
    ``PYTHONPATH`` the install ``target`` alone, ``XDG_CACHE_HOME`` at
    ``cache`` and ``work`` its working directory (the checkout off its
    path), on the shipped pix_shuffle graph at ``depth`` with ``--stats``:
    ``frames`` (n, h, w, 4) sent through the port's ``SidecarClient``, then
    a shutdown. Returns the responses, the server's stats, its exit code and
    the seconds to its ready line (imports, graph and warm-up frame)."""
    from fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar import SidecarClient
    from fs_uae_image_enhancer_project_tpu_torch.utils.subproc import wait_for_line

    on_cpu = () if dev.type == "cuda" else ("--device", "cpu")
    sock, stats = os.path.join(work, "fse.sock"), os.path.join(work, "stats.json")
    env = dict(os.environ, PYTHONPATH=target, XDG_CACHE_HOME=cache)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [os.path.join(target, "bin", "fse-torch-sidecar"), "--socket", sock, "--weights", ONNX,
         "--depth", str(depth), "--height", str(frames.shape[1]), "--width",
         str(frames.shape[2]), "--stats", stats, *on_cpu],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ready, lines = wait_for_line(proc, "SIDECAR_READY", timeout=300)
        check(ready, f"the installed fse-torch-sidecar did not come up: {lines[-20:]}")
        ready_s = time.perf_counter() - t0
        client = SidecarClient(sock, timeout=60.0)
        try:
            got = [out for out in map(client.submit, frames) if out is not None]
            got += client.drain()
            client.shutdown_server()
        finally:
            client.close()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(stats) as f:
        served = json.load(f)
    return dict(responses=got, stats=served, rc=rc, ready_s=ready_s)


def wheel_phase(dev, frame_hw=(576, 752), n_frames: int = WHEEL_FRAMES) -> dict:
    """Slice 16: a user's installed port on ``dev``. The repo's wheel built
    from a copy of the tree (``build_wheel``), installed with
    ``pip install --no-deps --target`` into a temporary directory, and
    its ``fse-torch-sidecar`` served from there (``serve_installed``) with a
    temporary ``XDG_CACHE_HOME``: on a card its first frame builds K1-K4
    from the wheel's kernel sources into that cache. ``n_frames`` seeded
    frames against the checkout's ``enhance_from_onnx`` in this process; the
    server's K1 launches (a new process: its counter starts at 0 and is read
    from its stats at exit), its ``fused_stack`` module, its kernel library
    (path, built, seconds), its warm-up frame (the first, the build
    included) and its p50. The wheel's and the install's seconds, and the
    repo's top-level entries that the phase added (none)."""
    import numpy as np

    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build

    frames = np.random.default_rng(16).integers(0, 256, (n_frames, *frame_hw, 4), dtype=np.uint8)
    enhance = enhance_from_onnx(ONNX, device=dev)
    direct = [enhance(frames[i:i + 1]).cpu().numpy()[0] for i in range(n_frames)]
    before = sorted(os.listdir(REPO))
    rec: dict = dict(frames=n_frames, frame_hw=list(frame_hw), depth=SERVE_DEPTH,
                     checkout_library=build.library_path())
    with tempfile.TemporaryDirectory() as tmp:
        target, cache, work = (os.path.join(tmp, d) for d in ("target", "cache", "work"))
        os.makedirs(work)
        t0 = time.perf_counter()
        whl = build_wheel(os.path.join(tmp, "wheel"), cache)
        rec["wheel_s"] = time.perf_counter() - t0
        rec["wheel_bytes"] = os.path.getsize(whl)
        t0 = time.perf_counter()
        install_wheel(whl, target, cache)
        rec["install_s"] = time.perf_counter() - t0
        served = serve_installed(target, cache, work, frames, dev)
        st = served["stats"]
        lib = st["kernel_library"]
        rec.update(
            target=target, cache=cache, server_rc=served["rc"], ready_s=served["ready_s"],
            responses=len(served["responses"]),
            equal=[bool(np.array_equal(g, d)) for g, d in zip(served["responses"], direct)],
            served_frames=st["frames"], k1_launches=st["k1_launches"],
            first_frame_ms=st["warmup_ms"], p50_ms=st["p50_ms"], p90_ms=st["p90_ms"],
            module=st["fused_stack_module"], library=lib["path"], built=lib["built"],
            build_s=lib["seconds"],
            cache_files=sorted(os.path.relpath(os.path.join(r, f), cache)
                               for r, _d, fs_ in os.walk(cache) for f in fs_))
    rec["repo_added"] = sorted(set(os.listdir(REPO)) - set(before))
    return rec


def _under(path: str, root: str) -> bool:
    root = os.path.abspath(root)
    return os.path.commonpath([os.path.abspath(path), root]) == root


def check_wheel(rec: dict, dev) -> None:
    """The wheel phase's checks; K1 launches, and the library is built, only
    on a card."""
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build

    on_card = dev.type == "cuda"
    check(rec["server_rc"] == 0, f"the installed server exited {rec['server_rc']}")
    check(rec["responses"] == rec["served_frames"] == rec["frames"] == len(rec["equal"])
          and all(rec["equal"]),
          f"the installed server's responses differ from the checkout's enhance: {rec['equal']}")
    check(rec["k1_launches"] == (rec["frames"] + 1 if on_card else 0),
          f"the installed server launched K1 {rec['k1_launches']} times for "
          f"{rec['frames']} frames and its warm-up")
    check(_under(rec["module"], rec["target"]),
          f"the server's fused_stack came from {rec['module']}, not the install")
    check(os.path.dirname(os.path.dirname(rec["library"]))
          == os.path.join(rec["cache"], build.PACKAGE, "torch_kernels"),
          f"the server's kernel library {rec['library']} is not in the temporary cache")
    check(os.path.basename(os.path.dirname(rec["library"]))
          == os.path.basename(os.path.dirname(rec["checkout_library"])),
          f"the install's kernel hash differs from the checkout's: {rec['library']} "
          f"against {rec['checkout_library']}")
    check(rec["built"] is (True if on_card else None)
          and (not on_card or rec["build_s"] > 0),
          f"the installed server's library: built {rec['built']} in {rec['build_s']} s")
    check(not on_card or os.path.relpath(rec["library"], rec["cache"]) in rec["cache_files"],
          f"{rec['library']} is not among the cache's files {rec['cache_files']}")
    check(not rec["repo_added"], f"the phase left {rec['repo_added']} in the checkout")


def timed_steps(module, name: str, dev, record: list):
    """``module.<name>`` (a train-step factory) wrapped so that every step it
    builds is timed on the host's clock, synchronised at both ends, into
    ``record`` (ms a step); returns the restore function."""
    real = getattr(module, name)

    def factory(*a, **kw):
        step = real(*a, **kw)

        def timed(*sa, **skw):
            _sync(dev)
            t0 = time.perf_counter()
            out = step(*sa, **skw)
            _sync(dev)
            record.append((time.perf_counter() - t0) * 1e3)
            return out
        timed.__dict__.update(step.__dict__)  # step.optimizer
        return timed

    setattr(module, name, factory)
    return lambda: setattr(module, name, real)


def train_drivers(dev, tree: str, crop=(CROP_W, CROP_H), long_samples: int = 8,
                  long_epochs: int = 2, batch: int = 8, parity_samples: int = 8,
                  winner_samples: int = 8, eval_samples: int = 64, fps_s: float = 0.5,
                  vgg_steps: int = TRAIN_DRIVERS_VGG_STEPS, vgg_batch: int = 32,
                  vgg_patch: int = 128, vgg_warmup: int = 5, nas_crop=NAS_CROP,
                  nas_trials: int = 2, nas_samples: int = 32, probe_mb: float = 8.0,
                  probe_n: int = 50) -> dict:
    """Slice 12's training and NAS drivers (``scripts/``), each through its
    ``main`` on ``dev`` on the generator tree ``tree``, outputs in temporary
    directories, K1's counter from 0 for each: the random VGG basis drawn
    cold (``vgg._random_init``, its host cache cleared); the two long
    trainers at ``long_epochs`` epochs of ``long_samples`` samples (each
    optimizer step timed); the parity study at one epoch of
    ``parity_samples`` a leg; the plot (where matplotlib does not import,
    its exit 1); the NAS winner (``artifacts/nas_r5/best_trial.json``) at one
    epoch, ``eval_samples`` held-out draws and ``fps_s`` of FPS; the VGG
    self-training at ``vgg_steps`` steps of ``vgg_batch`` ``vgg_patch``
    patches (each step timed), its calibration target recomputed here on
    its probe; ``nas_demo_r2`` for ``nas_trials`` trials on the tree cut to
    ``nas_crop``; the converter (exit 1 without torchvision); the retention
    probe at ``probe_mb`` MB x ``probe_n``. The trainers' pid file is read,
    then removed."""
    import numpy as np

    from fs_uae_image_enhancer_project_tpu_torch.losses import vgg
    from fs_uae_image_enhancer_project_tpu_torch.losses import vgg_selftrain as st
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.scripts import train_vgg_features as tvf
    from fs_uae_image_enhancer_project_tpu_torch.scripts import training_parity_study as tps
    from fs_uae_image_enhancer_project_tpu_torch.train import trainer as tr
    from fs_uae_image_enhancer_project_tpu_torch.utils import platform

    on = ["--device", dev.type]
    w, h = crop
    rec: dict = {}
    vgg._random_basis.cache_clear()
    t0 = time.perf_counter()
    vgg._random_init(device=dev)
    _sync(dev)
    rec["basis_draw_s"] = time.perf_counter() - t0
    if os.path.exists(platform.PREEMPTIBLE_PIDFILE):
        os.remove(platform.PREEMPTIBLE_PIDFILE)

    def drive(key, name, argv, env=None):
        fs.fused_stack.launches = 0
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            rc, out, s = run_driver(name, argv)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        rec[key] = dict(rc=rc, seconds=s, k1_launches=fs.fused_stack.launches, report=out)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        for key, name in (("train_psh_long", "train_psh_long"),
                          ("train_psh_heavy_long", "train_psh_heavy_long")):
            steps: list = []
            restore = timed_steps(tr, "make_train_step", dev, steps)
            try:
                drive(key, name, ["--data", tree, "--out", os.path.join(tmp, name),
                                  "--crop_size", str(w), str(h), "--epochs", str(long_epochs),
                                  "--samples_per_epoch", str(long_samples),
                                  "--batch_size", str(batch), *on])
            finally:
                restore()
            rec[key].update(step_ms=steps, samples_per_step=batch)
        rec["pidfile"] = None
        if os.path.exists(platform.PREEMPTIBLE_PIDFILE):
            with open(platform.PREEMPTIBLE_PIDFILE) as f:
                rec["pidfile"] = f.read().strip()
        old_out = tps.OUT
        tps.OUT = os.path.join(tmp, "training_parity")
        try:
            drive("training_parity_study", "training_parity_study", [
                "--data", tree, "--crop_size", str(w), str(h), "--ablation_epochs", "1",
                "--plateau_epochs", "1", "--samples_per_epoch", str(parity_samples),
                "--batch_size", str(batch), *on])
        finally:
            tps.OUT = old_out
        rec["training_parity_study"]["val_batches_a_leg"] = 2 * max(parity_samples // 8, 64) // batch
        try:
            import matplotlib  # noqa: F401
            rec["matplotlib"] = True
        except ImportError:
            rec["matplotlib"] = False
        drive("plot_training_parity", "plot_training_parity",
              ["--out_dir", os.path.join(tmp, "plot")])
        nas_out = os.path.join(tmp, "nas_r5")
        os.makedirs(nas_out)
        shutil.copy(os.path.join(REPO, "artifacts", "nas_r5", "best_trial.json"), nas_out)
        drive("train_nas_winner", "train_nas_winner", [
            "--nas_out", nas_out, "--data", tree, "--out", os.path.join(tmp, "conv6"),
            "--crop_size", str(w), str(h), "--epochs", "1", "--samples_per_epoch",
            str(winner_samples), "--batch_size", str(batch), "--eval_samples",
            str(eval_samples), "--fps_seconds", str(fps_s), *on])
        steps = []
        restore = timed_steps(st, "make_train_step", dev, steps)
        data, gt = os.path.join(tree, "train"), os.path.join(tmp, "gt")
        os.makedirs(gt)
        try:
            drive("train_vgg_features", "train_vgg_features", [
                "--data", data, "--gt", gt, "--steps", str(vgg_steps), "--batch_size",
                str(vgg_batch), "--patch", str(vgg_patch), "--warmup", str(vgg_warmup),
                "--work", os.path.join(tmp, "vgg_work"),
                "--out", os.path.join(tmp, "vgg", "vgg16_features_selftrained.npz"), *on])
        finally:
            restore()
        # the driver's probe: its validation sampler (seed 0 + 1) after the
        # validation batch
        files = sorted(glob.glob(os.path.join(data, "*", "*.png")))
        val_sampler = tvf.PatchSampler(files, vgg_patch, 200, 1)
        val_sampler.batch(vgg_batch)
        probe = val_sampler.batch(16).astype(np.float32) / 255.0
        rec["train_vgg_features"].update(
            step_ms=steps, target_here=st.random_baseline_rms(probe, device=dev))
        nas_data = os.path.join(tmp, "nas_tree")
        nas_tree(tree, nas_data, nas_crop)
        drive("nas_demo_r2", "nas_demo_r2", on, env=dict(
            NAS_OUT=os.path.join(tmp, "nas_demo_r2"), NAS_DATA=nas_data,
            NAS_TRIALS=str(nas_trials), NAS_EPOCHS="1", NAS_SAMPLES=str(nas_samples),
            NAS_CROP=f"{nas_crop[0]}x{nas_crop[1]}", NAS_FPS_S=str(fps_s)))
        try:
            import torchvision  # noqa: F401
            rec["torchvision"] = True  # its weights need the network: not converted here
        except ImportError:
            rec["torchvision"] = False
            drive("convert_vgg16_weights", "convert_vgg16_weights",
                  ["--out", os.path.join(tmp, "vgg16_features.npz")])
        drive("probe_transfer_retention", "probe_transfer_retention", [
            "--mb", str(probe_mb), "--n", str(probe_n), "--sample_every",
            str(max(probe_n // 5, 1)), *on])
    if os.path.exists(platform.PREEMPTIBLE_PIDFILE):
        os.remove(platform.PREEMPTIBLE_PIDFILE)
    rec["pidfile_removed"] = not os.path.exists(platform.PREEMPTIBLE_PIDFILE)
    # the readings PERF.md keeps: a step after the first is warm
    long_ms = rec["train_psh_long"]["step_ms"]
    warm = statistics.median(long_ms[1:] or long_ms)
    rec["readings"] = dict(
        basis_draw_s=rec["basis_draw_s"],
        driver_seconds={k: r["seconds"] for k, r in rec.items()
                        if isinstance(r, dict) and "seconds" in r},
        train_psh_long_first_step_ms=long_ms[0], train_psh_long_warm_step_ms=warm,
        train_psh_long_samples_per_s=batch / warm * 1e3,
        vgg_ms_per_step=statistics.median(rec["train_vgg_features"]["step_ms"][1:]
                                          or rec["train_vgg_features"]["step_ms"]),
        nas_winner_fps=rec["train_nas_winner"]["report"]["fps_deployment_shape"],
        retained_gb_per_gb_sent=rec["probe_transfer_retention"]["report"]["samples"][-1]["ratio"])
    return rec


def check_train_drivers(rec: dict, dev, long_epochs: int = 2, long_samples: int = 8,
                        batch: int = 8) -> None:
    """The train_drivers phase's checks; K1 launches only on a card."""
    on_card = dev.type == "cuda"
    missing = {"plot_training_parity": None if rec["matplotlib"] else "matplotlib",
               "convert_vgg16_weights": "torchvision"}
    for key, r in rec.items():
        if not isinstance(r, dict) or "rc" not in r:
            continue
        module = missing.get(key)
        if module:
            check(r["rc"] == 1 and r["report"].get("missing_module") == module
                  and module in r["report"]["error"],
                  f"{key} without {module}: exit {r['rc']}, {r['report']}")
        else:
            check(r["rc"] == 0, f"driver {key} exited {r['rc']}: {r['report']}")
    val_batches = max(long_samples // 8, 64) // batch
    for key, k1 in (("train_psh_long", long_epochs * val_batches), ("train_psh_heavy_long", 0)):
        r = rec[key]
        epochs = r["report"]["epochs"]
        check(len(epochs) == long_epochs and all(math.isfinite(e["train_loss"])
                                                 and math.isfinite(e["val_loss"])
                                                 for e in epochs), f"{key}: {epochs}")
        want = k1 if on_card else 0
        check(r["k1_launches"] == want, f"{key}: K1 launched {r['k1_launches']} times, "
                                        f"not {want} (once a validation batch)")
        check(len(r["step_ms"]) == long_epochs, f"{key}: {len(r['step_ms'])} optimizer steps")
    check(rec["pidfile"] == str(os.getpid()) and rec["pidfile_removed"],
          f"the trainers' pid file held {rec['pidfile']} (this process: {os.getpid()})")
    p = rec["training_parity_study"]
    s = p["report"]
    legs = [s["ablation"][k] for k in ("novgg", "randvgg", "selfvgg")] + [s["plateau"]]
    check(all(math.isfinite(v["novgg_val_loss"]) and math.isfinite(v["srgb_psnr_db"])
              and v["best_epoch"] == 1 for v in legs)
          and s["plateau"]["corpus_tag"] == s["ablation"]["corpus_tag"]
          and {"last_run", "ablation", "plateau"} <= set(s), f"parity study: {s}")
    want = 4 * p["val_batches_a_leg"] if on_card else 0
    check(p["k1_launches"] == want, f"parity study: K1 launched {p['k1_launches']}, not {want}")
    if rec["matplotlib"]:
        check(rec["plot_training_parity"]["report"]["ours_epochs"] > 0, "plot: no points")
    wn = rec["train_nas_winner"]["report"]
    check(math.isfinite(wn["eval"]["srgb_psnr_db"]) and wn["fps_deployment_shape"] > 0
          and math.isfinite(wn["best_val_own_metric"]), f"NAS winner: {wn}")
    v = rec["train_vgg_features"]
    meta = v["report"]
    check(math.isfinite(meta["final_val_recon_charbonnier"]) and len(v["step_ms"]) > 0,
          f"VGG self-training: {meta}")
    for got, target, here in zip(meta["tap_rms_calibrated"], meta["tap_rms_target_random"],
                                 v["target_here"]):
        check(abs(got - here) <= 1e-4 * here and abs(target - here) <= 1e-5 * here,
              f"calibrated taps {meta['tap_rms_calibrated']} vs random_baseline_rms(probe) "
              f"{v['target_here']}")
    n = rec["nas_demo_r2"]["report"]
    hit = n["fps_cache_hit_on_best_arch"]
    check(n["trials_total"] >= 2 and hit["hit"] and hit["measure_invocations"] == 0
          and math.isfinite(n["best_trial"]["value"]), f"nas_demo_r2: {n}")
    check(n["plots"]["missing_module"] == (None if rec["matplotlib"] else "matplotlib"),
          f"nas_demo_r2's plots: {n['plots']}")
    for key in ("train_nas_winner", "train_vgg_features", "nas_demo_r2"):
        check(rec[key]["k1_launches"] == 0, f"{key} launched K1")
    pr = rec["probe_transfer_retention"]["report"]
    check(len(pr["samples"]) == 5 and all(math.isfinite(x["ratio"]) for x in pr["samples"]),
          f"retention probe: {pr}")


def compile_replay(out_dir: str) -> str:
    """The emulator's C client built as its replay tool
    (``runtime/sidecar_client.c``, ``-DFSE_REPLAY_MAIN``) into ``out_dir``
    with the host's C compiler; no compiler fails the phase."""
    cc = shutil.which("cc") or shutil.which("gcc")
    check(cc is not None, "no C compiler (cc or gcc) to build runtime/sidecar_client.c")
    binary = os.path.join(out_dir, "sidecar_replay")
    r = subprocess.run([cc, "-O2", "-std=c11", "-DFSE_REPLAY_MAIN",
                        os.path.join(REPO, "runtime", "sidecar_client.c"), "-o", binary],
                       capture_output=True, text=True, timeout=120)
    check(r.returncode == 0, f"{cc} failed on sidecar_client.c: {r.stderr[-2000:]}")
    return binary


def recipes(dev, frame, direct) -> dict:
    """Slice 13: the deployed chain through the port's run recipes, each run
    with ``bash`` in a temporary directory with ``PYTHON`` this interpreter,
    on ``dev`` (the recipes' default, the card; ``--device cpu`` is passed
    through for a CPU rehearsal), their work cut only through the
    pass-through:

    - ``prepare_groundtruth.sh`` on the datagen phase's two source images;
    - ``generate_dataset.sh`` on its output at :data:`RECIPE_GENERATE_CUT`
      (376x288 lores crops, the device route): the tree, and the generator's
      last line, its summary with K3's launches in the recipe's child;
    - ``train_pix_shuffle.sh`` on that tree at :data:`RECIPE_TRAIN_CUT`: the
      CSV, the best checkpoint and the metrics line, whose
      ``val_k1_launches`` counts K1 in the child's validation;
    - ``serve_sidecar.sh`` as a child with the shipped graph and ``--stats``,
      waited for with ``wait_for_line``; the C replay tool sends ``frame`` in
      a warm-up session of :data:`RECIPE_REPLAY_WARMUP` frames and a
      measured one of :data:`RECIPE_REPLAY_LOOPS`, the Python client once,
      then shuts the server down. Both answers against ``direct`` (this
      process's enhance of ``frame``), and the server's K1 launches and
      latency from its stats. Then ``socket_floor``: the replay tool's
      measured session against this package's server in this process with
      an identity enhance on the host, the server's own per-frame cost with
      no device work at all.

    Each step's seconds are in ``step_seconds``.
    """
    import numpy as np
    from PIL import Image

    from fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar import (
        SidecarClient, SidecarServer)
    from fs_uae_image_enhancer_project_tpu_torch.utils.subproc import wait_for_line

    on_cpu = () if dev.type == "cuda" else ("--device", "cpu")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHON=sys.executable,
               PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    rec: dict = {"step_seconds": {}}

    with tempfile.TemporaryDirectory() as tmp:
        def run(name, *args) -> str:
            t0 = time.perf_counter()
            r = subprocess.run(["bash", os.path.join(RECIPES, name), *args], cwd=tmp, env=env,
                               capture_output=True, text=True, timeout=300)
            rec["step_seconds"][name] = time.perf_counter() - t0
            check(r.returncode == 0, f"{name} exited {r.returncode}: {r.stderr[-3000:]}")
            return r.stdout

        def replay(sock: str, loops: int) -> dict:
            r = subprocess.run([binary, sock, raw_in, raw_out, str(loops)],
                               capture_output=True, text=True, timeout=120)
            check(r.returncode == 0, f"the C replay tool exited {r.returncode}: {r.stderr}")
            return json.loads(r.stdout.strip().splitlines()[-1])

        binary = compile_replay(tmp)
        src, gt = os.path.join(tmp, "src"), os.path.join(tmp, "gt")
        source_images(src)
        run("prepare_groundtruth.sh", src, gt)
        sizes = {}
        for name in sorted(os.listdir(gt)):
            with Image.open(os.path.join(gt, name)) as im:
                sizes[name] = list(im.size)
        rec["groundtruth"] = sizes

        data = os.path.join(tmp, "data")
        out = run("generate_dataset.sh", gt, "", data, "--test_images", *RECIPE_GENERATE_CUT,
                  "--cache_dir", os.path.join(tmp, "cache"), "--verbose", "0", *on_cpu)
        summary = json.loads(out.strip().splitlines()[-1])
        files = [os.path.join(r, f) for r, _d, fs in os.walk(data) for f in fs]
        targets = [f for f in files if os.path.basename(f).startswith("target_")]
        crop_sizes = set()
        for f in files:
            with Image.open(f) as im:
                crop_sizes.add(im.size)
        rec["generate"] = dict(files=len(files), targets=len(targets),
                               styled=len(files) - len(targets),
                               crop_sizes=sorted(list(x) for x in crop_sizes), summary=summary)

        ck = os.path.join(tmp, "ckpt")
        run("train_pix_shuffle.sh", os.path.join(data, "train"), ck, *RECIPE_TRAIN_CUT,
            "--verbose", "0", *on_cpu)
        with open(os.path.join(ck, "training_stats_pix_shuffle.csv")) as f:
            rows = [line.rstrip("\n").split(",") for line in f]
        with open(os.path.join(ck, "metrics_pix_shuffle.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        rec["train"] = dict(
            csv_epochs=[int(r[0]) for r in rows[1:]], metrics=metrics,
            best_checkpoint=sorted(os.listdir(os.path.join(ck, "checkpoint_best_pix_shuffle"))))

        sock, stats = os.path.join(tmp, "fse.sock"), os.path.join(tmp, "stats.json")
        raw_in, raw_out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.raw")
        np.ascontiguousarray(frame).tofile(raw_in)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            ["bash", os.path.join(RECIPES, "serve_sidecar.sh"), sock, "pix_shuffle", ONNX,
             "--stats", stats, *on_cpu],
            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            ready, lines = wait_for_line(proc, "SIDECAR_READY", timeout=180)
            check(ready, f"serve_sidecar.sh did not come up: {lines[-5:]}")
            warm = replay(sock, RECIPE_REPLAY_WARMUP)
            c_line = replay(sock, RECIPE_REPLAY_LOOPS)
            client = SidecarClient(sock, timeout=60.0)
            try:
                first = client.submit(frame)
                py_out = first if first is not None else client.drain()[0]
                client.shutdown_server()
            finally:
                client.close()
            server_rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        rec["step_seconds"]["serve_sidecar.sh"] = time.perf_counter() - t0
        c_out = np.fromfile(raw_out, np.uint8).reshape(frame.shape)
        with open(stats) as f:
            served = json.load(f)

        floor = SidecarServer(lambda x: x, os.path.join(tmp, "floor.sock"),
                              depth=SERVE_DEPTH, verbose=0, device="cpu", client_timeout=60.0)
        floor.bind()
        th = threading.Thread(target=floor.serve_forever, daemon=True)
        th.start()
        try:
            floor_line = replay(floor.socket_path, RECIPE_REPLAY_LOOPS)
        finally:
            client = SidecarClient(floor.socket_path, timeout=60.0)
            client.shutdown_server()
            client.close()
            th.join(timeout=10)
        rec["serve"] = dict(
            server_rc=server_rc, replay_warmup=warm, replay=c_line, depth=served["depth"],
            frames=served["frames"], k1_launches=served["k1_launches"],
            **{k: served[k] for k in ("p50_ms", "p90_ms", "mean_ms", "max_ms")},
            c_equal_python=bool(np.array_equal(c_out, py_out)),
            c_equal_direct=bool(np.array_equal(c_out, direct)),
            python_equal_direct=bool(np.array_equal(py_out, direct)),
            socket_floor=floor_line)
    rec["launches"] = {
        "fused_stack": sum(m["val_k1_launches"] for m in rec["train"]["metrics"])
        + rec["serve"]["k1_launches"],
        "palette_dither": rec["generate"]["summary"]["k3_launches"]}
    return rec


def check_recipes(rec: dict, dev) -> None:
    """The chain's outputs; K1 and K3 counted on the card only (the CPU
    takes their plain versions, which count nothing)."""
    on_card = dev.type == "cuda"
    check(len(rec["groundtruth"]) == 2
          and all(w <= 1920 and h <= 1080 for w, h in rec["groundtruth"].values()),
          f"prepare_groundtruth.sh: {rec['groundtruth']}")
    gen = rec["generate"]
    summ = gen["summary"]
    check(gen["targets"] == RECIPE_CROPS and gen["styled"] == 4 * gen["targets"]
          and gen["crop_sizes"] == [[CROP_W, CROP_H]],
          f"generate_dataset.sh wrote {gen['targets']} targets, {gen['styled']} styled crops "
          f"of sizes {gen['crop_sizes']}")
    check(summ["missing"] == 0 and not summ["stopped"]
          and summ["expected"] == summ["present"] == summ["generated_this_run"] == gen["files"],
          f"the generator's summary {summ} against the {gen['files']} files written")
    check((summ["k3_launches"] > 0) == on_card,
          f"K3 launched {summ['k3_launches']} times in the recipe's generator")
    trn = rec["train"]
    check(trn["csv_epochs"] == [1] and [m["epoch"] for m in trn["metrics"]] == [1],
          f"train_pix_shuffle.sh: CSV epochs {trn['csv_epochs']}, metrics {trn['metrics']}")
    check(all(math.isfinite(m["train_loss"]) and math.isfinite(m["val_loss"])
              for m in trn["metrics"]), f"train_pix_shuffle.sh losses: {trn['metrics']}")
    check({"_METADATA", "manifest.ocdbt"} <= set(trn["best_checkpoint"]),
          f"train_pix_shuffle.sh saved no orbax best checkpoint: {trn['best_checkpoint']}")
    check((trn["metrics"][0]["val_k1_launches"] > 0) == on_card,
          f"validation launched K1 {trn['metrics'][0]['val_k1_launches']} times")
    srv = rec["serve"]
    check(srv["server_rc"] == 0 and srv["depth"] == SERVE_DEPTH
          and srv["replay_warmup"]["frames"] == RECIPE_REPLAY_WARMUP
          and srv["replay"]["frames"] == RECIPE_REPLAY_LOOPS
          and srv["replay"]["depth"] == SERVE_DEPTH
          and srv["frames"] == RECIPE_REPLAY_WARMUP + RECIPE_REPLAY_LOOPS + 1,
          f"serve_sidecar.sh: {srv}")
    check(srv["c_equal_python"] and srv["c_equal_direct"] and srv["python_equal_direct"],
          f"served frames differ: {srv}")
    check((srv["k1_launches"] > 0) == on_card, f"the server launched K1 {srv['k1_launches']} times")
    check(srv["socket_floor"]["frames"] == RECIPE_REPLAY_LOOPS
          and srv["socket_floor"]["ms_per_frame"] > 0, f"socket floor: {srv['socket_floor']}")


def op_dispatch(dev, enhance_direct, enhance_op, u, sw, frame_dev, rounds: int = 4) -> dict:
    """K1's custom op against its direct call: the host's µs a call (200
    calls queued without a synchronise) and the pix_shuffle enhance's ms a
    frame (CUDA-event medians) with the stack called either way, in
    alternating rounds; the op's share of the enhance's ms decides the
    served path (``OP_SHARE_LIMIT``)."""
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs

    def host_us(fn, n=200):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        _sync(dev)
        return t / n * 1e6

    direct = lambda: fs.fused_stack(u, sw)  # noqa: E731
    op = lambda: torch.ops.fse.fused_stack(u, *sw.frags, sw.prm)  # noqa: E731
    rec = {k: [] for k in ("host_us_direct", "host_us_op", "enhance_ms_direct", "enhance_ms_op")}
    for _ in range(rounds):
        rec["host_us_direct"].append(host_us(direct))
        rec["host_us_op"].append(host_us(op))
        rec["enhance_ms_direct"].append(median_ms(lambda: enhance_direct(frame_dev), n=100))
        rec["enhance_ms_op"].append(median_ms(lambda: enhance_op(frame_dev), n=100))
    mean = {k: statistics.mean(v) for k, v in rec.items()}
    share = (mean["enhance_ms_op"] - mean["enhance_ms_direct"]) / mean["enhance_ms_direct"]
    return dict(rec, dispatch_us=mean["host_us_op"] - mean["host_us_direct"],
                op_share_of_enhance=share, share_limit=OP_SHARE_LIMIT,
                served_path="direct" if share > OP_SHARE_LIMIT else "op")


def _counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_packed as k2
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import lane_packing as k4
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue

    return {"fused_stack": fs.fused_stack, "fused_stack_packed": k2.fused_stack_packed,
            "palette_dither": k3.palette_dither, "lane_packing_mm": k4.lane_packing_mm,
            "conv_epilogue": conv_epilogue}


def family_timing(dev, fns: dict, frame, gflops: dict) -> list:
    """ms a frame (CUDA events around single calls), the device's ms a frame
    (``device_times``), the share of the bf16 peak, and the kernels the
    device ran in one frame (``torch.profiler``), each family's bf16 enhance
    on a device frame."""
    import torch

    frame_dev = torch.from_numpy(frame).to(dev)
    rows = []
    for name, fn in fns.items():
        ms = median_ms(lambda: fn(frame_dev))
        dev_ms = device_ms(lambda: fn(frame_dev), n=20)
        busy, top, n_kernels = _device_busy(lambda: fn(frame_dev), dev)
        bound = gflops[name] * 1e9 / PEAK_BF16_FLOPS * 1e3
        rows.append(dict(family=name, ms_per_frame=ms, device_ms_per_frame=dev_ms["ms"],
                         device=dev_ms, gflop=gflops[name], bound_ms=bound,
                         share_of_peak=bound / dev_ms["ms"], profiled_kernel_ms=busy,
                         kernels_per_frame=n_kernels, top_kernels=top))
    return rows


def main(argv=None) -> int:
    global _phase
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout whose K3 and K4 to time in turns with these")
    args = ap.parse_args(argv)
    threading.Thread(target=_watchdog, daemon=True).start()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    import numpy as np

    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import (
        enhance_from_onnx, make_enhance_fn)
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_pix_shuffle
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_packed as k2
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_plan as plan
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import lane_packing as k4
    from fs_uae_image_enhancer_project_tpu_torch.ops.pixel_shuffle import pixel_unshuffle
    from fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar import (
        SidecarClient, SidecarServer)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # the plain version is the fp32 reference: no TF32 in cuDNN's convs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    _phase = "device"
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", t0, nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    _phase = "build"
    t0 = time.perf_counter()
    lib = build.load_library()
    ptxas = [line.strip() for line in build.build_info["ptxas"].splitlines()
             if any(k in line for k in ("Compiling entry", "registers", "spill", "smem"))]
    info = {"K1": fs.kernel_info("fse_fused_stack", dev),
            "K2": fs.kernel_info("fse_fused_stack_packed", dev),
            "K3": k3.kernel_info(dev)}
    # K4: every compiled width (with a one-chunk ring), then each case's plan
    k4_widths = {nc: k4.kernel_info(k4.TilePlan(1, nc, 1, 1, 1, 1, True, 0), dev)
                 for nc in k4.WIDTHS}
    k4_plans = {f"{c[0]} {c[1]}": k4.tile_plan(*c[2:]) for c in k4.CASES}
    k4_plans = {case: (p, k4.kernel_info(p, dev)) for case, p in k4_plans.items()}
    info["K4"] = {case: dict(n_per_instruction=p.nc, ctas=p.ctas,
                             ring="resident" if p.resident else "streamed", **i)
                  for case, (p, i) in k4_plans.items()}
    emit("build", t0, build_seconds=round(build.build_info["seconds"], 3),
         built=build.build_info["built"], smem_bytes=lib.fse_fused_stack_smem_bytes(),
         k2_smem_bytes=lib.fse_fused_stack_packed_smem_bytes(), kernel_info=info,
         k4_widths=k4_widths, ptxas=ptxas)
    check(info["K3"]["local_bytes"] == 0, f"K3 spills: {info['K3']}")
    for nc, i in k4_widths.items():
        check(i["local_bytes"] == 0 and i["chains"] == k4.WIDTHS[nc],
              f"K4 at width {nc} spills or is not the plan's: {i}")
    for case, (p, i) in k4_plans.items():
        check(i["dynamic_smem"] == p.smem <= k4.SMEM_LIMIT and i["threads"] == k4.THREADS,
              f"K4 {case}: compiled {i}, plan {p}")
    for pk, name in ((1, "K1"), (2, "K2")):
        want = dict(dynamic_smem=plan.smem_bytes(pk), threads=32 * plan.NWARPS,
                    tile_rows=plan.TILE[0], tile_cols=plan.TILE[1],
                    ring3_bytes=plan.smem(pk)["ring3"][1])
        got = {k: info[name][k] for k in want}
        check(got == want, f"{name}'s compiled plan {got} is not fused_stack_plan's {want}")

    # 3. k1_parity: shipped weights, seeded linear-light inputs
    _phase = "k1_parity"
    t0 = time.perf_counter()
    imp = import_pix_shuffle(ONNX)
    params = params_from_jax(imp.params, device=dev)
    sw = fs.prepare_weights(params, dev)
    k1_recs = stack_parity(dev, fs.fused_stack, fs.fused_stack_plain, sw)
    k1_u8 = fused_enhance_parity(dev, imp, params)
    emit("k1_parity", t0, cudnn_allow_tf32=False, tol_max_abs=K1_MAX_ABS,
         tol_mean_abs=K1_MEAN_ABS, shapes=k1_recs, fused_enhance=k1_u8)
    check_stack("K1", k1_recs)
    k1_err = max(r["max_abs"] for r in k1_recs[:-1])
    check(k1_u8["fused"] and all(k1_u8["byte_equal"].values()),
          f"K1's enhance entry differs from the eager composition: {k1_u8['byte_equal']}")
    check(k1_u8["u8_launches"] == k1_u8["calls"],
          f"K1's enhance entry launched {k1_u8['u8_launches']} times in {k1_u8['calls']} calls")

    # 4. k2_parity: the same for K2, and K2 against K1
    _phase = "k2_parity"
    t0 = time.perf_counter()
    sw2 = k2.prepare_weights(params, dev)
    k2_recs = stack_parity(dev, k2.fused_stack_packed, k2.fused_stack_packed_plain, sw2,
                           other=(fs.fused_stack, sw))
    emit("k2_parity", t0, matmul_allow_tf32=False, tol_max_abs=K1_MAX_ABS,
         tol_mean_abs=K1_MEAN_ABS, shapes=k2_recs)
    check_stack("K2", k2_recs)
    k2_err = max(r["max_abs"] for r in k2_recs[:-1])

    # 5. k4_parity: the accumulator and the output at the 12 shapes
    _phase = "k4_parity"
    t0 = time.perf_counter()
    k4_recs = k4_parity(dev)
    emit("k4_parity", t0, tol_acc_rel=K4_ACC_REL, tol_o_abs=K4_O_ABS, cases=k4_recs)
    check_k4(k4_recs)

    # 6. k3_parity: byte equality with the plain version at every N and mode
    _phase = "k3_parity"
    t0 = time.perf_counter()
    k3_par = k3_parity(dev)
    emit("k3_parity", t0, **k3_par)
    check(not k3_par["differing"], f"K3 differs from its plain version: {k3_par['differing']}")

    # 7. epilogue: the conv epilogue kernel bit for bit, then timed
    _phase = "epilogue"
    t0 = time.perf_counter()
    epi = epilogue_phase(dev)
    emit("epilogue", t0, **epi)
    check_epilogue(epi, dev)

    # 8. enhance: the entry point on cuda vs the same run with the plain stack
    _phase = "enhance"
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, 576, 752, 4), dtype=np.uint8)
    enhance = enhance_from_onnx(ONNX, device=dev)
    enhance_plain = make_enhance_fn(
        fs.fused_stack_apply_plain, params, crop_left=imp.crop_left,
        srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
        linear_to_srgb_exponent=imp.linear_to_srgb_exponent, device=dev)
    before = fs.fused_stack.launches
    outs = [enhance(frames[i:i + 1]).cpu().numpy() for i in range(8)]
    rose = fs.fused_stack.launches - before
    plain = [enhance_plain(frames[i:i + 1]).cpu().numpy() for i in range(8)]
    psnrs = [psnr(a, b) for a, b in zip(outs, plain)]
    emit("enhance", t0, frames=8, crop_left=imp.crop_left, psnr_db_min=min(psnrs),
         psnr_db_mean=statistics.mean(psnrs), k1_launches=rose)
    for o in outs:
        check(o.shape == (1, 576, 752, 4) and o.dtype == np.uint8, f"bad output {o.shape} {o.dtype}")
        check(bool((o[..., 3] == 255).all()), "alpha is not 255")
    check(min(psnrs) >= PSNR_MIN_DB, f"enhance PSNR {min(psnrs)} dB < {PSNR_MIN_DB}")
    check(rose == 8, f"K1 launches rose by {rose}, not 8")

    # 9. server: slice 1's main path, every counter from 0
    _phase = "server"
    t0 = time.perf_counter()
    fs.fused_stack.launches = 0
    k3.palette_dither.launches = 0
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        for depth in (0, 2):
            sock = os.path.join(tmp, f"fse{depth}.sock")
            server = SidecarServer(enhance, sock, depth=depth, verbose=0, device=dev,
                                   client_timeout=60.0)
            server.warmup()
            server.bind()
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
            client = SidecarClient(sock, timeout=60.0)
            try:
                got = []
                for i in range(6):
                    r = client.submit(frames[i])
                    if r is not None:
                        got.append(r)
                got += client.drain()
                client.shutdown_server()
            finally:
                client.close()
            th.join(timeout=10)
            check(not th.is_alive(), f"server thread (depth {depth}) did not join in 10 s")
            check(len(got) == 6, f"depth {depth}: {len(got)} responses for 6 frames")
            equal = all(np.array_equal(g, outs[i][0]) for i, g in enumerate(got))
            check(equal, f"depth {depth}: responses differ from the direct enhance")
            served[f"depth{depth}"] = dict(frames=len(got), byte_equal=equal)
    launches = {"fused_stack": fs.fused_stack.launches,
                "palette_dither": k3.palette_dither.launches}
    check(launches["fused_stack"] > 0, "the server ran without launching K1")
    emit("server", t0, launches=launches, **served)

    # 10. recipes: slice 13's run recipes, the deployed chain on the card
    _phase = "recipes"
    t0 = time.perf_counter()
    for counter in _counters().values():
        counter.launches = 0
    rcp = recipes(dev, frames[0], outs[0][0])
    emit("recipes", t0, **rcp, nvidia_smi=smi)
    check_recipes(rcp, dev)

    # 11. families: slice 7's main path, every counter from 0
    _phase = "families"
    t0 = time.perf_counter()
    fam = families(dev)
    emit("families", t0, families=fam["families"], served=fam["served"],
         launches=fam["launches"], max_levels=FAMILY_MAX_LEVELS, window=FAMILY_WINDOW)
    check_families(fam)

    # 12. parallel_tools: slice 8's paths, K1's launches counted on each
    _phase = "parallel_tools"
    t0 = time.perf_counter()
    ptools = parallel_tools(dev)
    emit("parallel_tools", t0, **ptools, split_tol_max_abs=K1_MAX_ABS, nvidia_smi=smi)
    check_parallel_tools(ptools, dev)

    # 13. datagen: slice 2's main path, every counter from 0
    _phase = "datagen"
    t0 = time.perf_counter()
    work = tempfile.TemporaryDirectory()
    tree = os.path.join(work.name, "tree")
    dg = datagen(dev, tree_dir=tree)
    emit("datagen", t0, **{k: v for k, v in dg.items() if k not in ("arrs", "stacks")})
    check(dg["stats"]["missing"] == 0, f"generator: {dg['stats']}")
    check(dg["targets"] == 16 and dg["styled"] == 16 * len(PALETTES) * len(DITHERS),
          f"generator wrote {dg['targets']} targets and {dg['styled']} styled crops")
    check(dg["launches"]["palette_dither"] > 0, "the generator ran without launching K3")
    check(dg["rerun_generated"] == 0 and dg["rerun_missing"] == 0, "the rerun was not a no-op")
    check(all(v == 0 for v in dg["kmeans_colours_differing_card_vs_cpu"].values()),
          f"k-means card vs cpu: {dg['kmeans_colours_differing_card_vs_cpu']}")
    check(dg["percrop_stats"]["missing"] == 0
          and dg["percrop_styled"] == 8 * len(PALETTES) * len(DITHERS),
          f"per-crop run: {dg['percrop_stats']}, {dg['percrop_styled']} styled")
    check(dg["percrop_files_differing_from_batched"] == 0,
          "the per-crop route's PNGs differ from the batched run's")
    check(dg["workers2_stats"]["missing"] == 0
          and dg["workers2_files"] == dg["percrop_files"],
          f"two-worker run: {dg['workers2_stats']}, {dg['workers2_files']} files")
    check(dg["workers2_files_differing_from_batched"] == 0,
          "the two-worker per-crop route's PNGs differ from the batched run's")

    # 14. train: slice 6's main path on the datagen phase's tree, K1's counter
    # from 0 (the train steps must not launch it; validation does)
    _phase = "train"
    t0 = time.perf_counter()
    trn = train_phase(dev, tree)
    trn["mesh"] = train_mesh(dev, tree)
    emit("train", t0, **trn, nvidia_smi=smi)
    check_train(trn, dev)
    check_train_mesh(trn["mesh"], dev)

    # 15. nas: slice 9's NAS entry point on the datagen phase's tree, cut to
    # 128x96 (conv6: cuDNN's convolutions, and the conv epilogue kernel for
    # their biases where the FPS is measured under no_grad)
    _phase = "nas"
    t0 = time.perf_counter()
    for counter in _counters().values():
        counter.launches = 0
    nas_rec = nas(dev, tree)
    nas_rec["launches"] = {k: c.launches for k, c in _counters().items()}
    emit("nas", t0, **nas_rec, nvidia_smi=smi)
    for t in nas_rec["trials"]:
        print(f"nas trial {t['number']}: arch {t['arch']} fps {t['fps']} "
              f"ms/step {t['ms_per_step']} val {t['val_loss']} {t['state']}", flush=True)
    check_nas(nas_rec)

    # 16. tools: the VGG self-training, raw_runner (K1) and the ONNX tools
    _phase = "tools"
    t0 = time.perf_counter()
    tools_rec = tools(dev)
    emit("tools", t0, **tools_rec, nvidia_smi=smi)
    check_tools(tools_rec, dev)

    # 17. export: slice 10's torch.export route (K1 as the custom op)
    _phase = "export"
    t0 = time.perf_counter()
    exp = export_phase(dev)
    emit("export", t0, families=exp, nvidia_smi=smi)
    check_export(exp, dev)

    # 18. int8: slice 10's int8 path and the study
    _phase = "int8"
    t0 = time.perf_counter()
    i8 = int8_phase(dev)
    emit("int8", t0, **i8, nvidia_smi=smi)
    check_int8(i8, dev)

    # 19. benchmark_tools: slice 10's four design tools, reduced grids
    _phase = "benchmark_tools"
    t0 = time.perf_counter()
    bt = benchmark_tools_phase(dev)
    emit("benchmark_tools", t0, **bt, nvidia_smi=smi)
    check_benchmark_tools(bt)

    # 20. drivers: slice 11's scripts, every counter from 0
    _phase = "drivers"
    t0 = time.perf_counter()
    for counter in _counters().values():
        counter.launches = 0
    drv = drivers(dev)
    drv_launches = {k: c.launches for k, c in _counters().items()}
    emit("drivers", t0, **drv, launches=drv_launches, nvidia_smi=smi)
    check_drivers(drv, dev)

    # 21. orbax: slice 14, the JAX package's TPU-trained checkpoints read,
    # served through K1 and resumed on the datagen phase's tree, counters
    # from 0
    _phase = "orbax"
    t0 = time.perf_counter()
    for counter in _counters().values():
        counter.launches = 0
    orb = orbax_phase(dev, tree)
    orb["launches"] = {k: c.launches for k, c in _counters().items()}
    emit("orbax", t0, **orb, nvidia_smi=smi)
    check_orbax(orb, dev)

    # 22. orbax_write: slice 15, the trainer's checkpoints written in the
    # JAX package's orbax format on the card's host, read back, restored and
    # served through K1; counters from 0
    _phase = "orbax_write"
    t0 = time.perf_counter()
    for counter in _counters().values():
        counter.launches = 0
    ow = orbax_write(dev, tree)
    ow["launches"] = {k: c.launches for k, c in _counters().items()}
    emit("orbax_write", t0, **ow, nvidia_smi=smi)
    check_orbax_write(ow, dev)

    # 23. wheel: slice 16, the port installed from the repo's wheel and
    # served by its fse-torch-sidecar, which builds K1-K4 from the wheel's
    # sources into a temporary user cache (a child process: its counters
    # start at 0 and are read from its stats at its exit)
    _phase = "wheel"
    t0 = time.perf_counter()
    wh = wheel_phase(dev)
    emit("wheel", t0, **wh, nvidia_smi=smi)
    check_wheel(wh, dev)

    # 24. train_drivers: slice 12's training and NAS drivers on the datagen
    # phase's tree, K1's counter from 0 for each
    _phase = "train_drivers"
    t0 = time.perf_counter()
    tdrv = train_drivers(dev, tree)
    work.cleanup()
    emit("train_drivers", t0, **tdrv, nvidia_smi=smi)
    check_train_drivers(tdrv, dev)

    # 25. kernel_bench: slice 3's main path, every counter from 0
    _phase = "kernel_bench"
    t0 = time.perf_counter()
    kb = kernel_bench(dev)
    emit("kernel_bench", t0, **kb)
    for name in ("fused_stack", "fused_stack_packed", "lane_packing_mm"):
        check(kb["launches"][name] > 0, f"the kernel benches ran without launching {name}")
    for rec in kb["fused"]:
        check(math.isfinite(rec["max_err"]), f"bench_fused_stack {rec['name']}: {rec}")

    # 26. timing at the main paths' shapes
    _phase = "timing"
    t0 = time.perf_counter()
    x = (torch.from_numpy(frames[0, :, imp.crop_left:, :3]).to(dev).float() / 255.0)
    x = x ** imp.srgb_to_linear_exponent
    u = pixel_unshuffle(x[None], 2)[0].to(torch.bfloat16).contiguous()
    h2, w2 = u.shape[:2]
    k1_dev = device_ms(lambda: fs.fused_stack(u, sw))
    k2_dev = device_ms(lambda: k2.fused_stack_packed(u, sw2))
    k1_call_ms = median_ms(lambda: fs.fused_stack(u, sw))
    plain_ms = median_ms(lambda: fs.fused_stack_plain(u, sw))
    library_ms = median_ms(lambda: library_stack(u, sw))
    k2_call_ms = median_ms(lambda: k2.fused_stack_packed(u, sw2))
    k2_plain_ms = median_ms(lambda: k2.fused_stack_packed_plain(u, sw2), n=10)
    k1_again = device_ms(lambda: fs.fused_stack(u, sw))
    k1_ms, k2_ms = k1_dev["ms"], k2_dev["ms"]
    frame_dev = torch.from_numpy(frames[:1]).to(dev)
    enhance_ms = median_ms(lambda: enhance(frame_dev))
    # the device's time of a frame, the host's launches hidden behind a sleep
    enhance_dev = device_ms(lambda: enhance(frame_dev), n=20)
    flops = 2.0 * fs.MACS_PER_PIXEL * h2 * w2
    nbytes = (2 * u.numel() * u.element_size()
              + sum(w.numel() * w.element_size() for w in sw.frags)
              + sw.prm.numel() * sw.prm.element_size())
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)

    k4_rows = k4_timing(dev)
    check_k4(k4_rows)
    k4_ref = next(r for r in k4_rows if r["case"] == "l4-class baseline")
    k3_rows, kmeans_ms = k3_timing(dev, dg["arrs"], dg["stacks"])
    k3_ref = next(r for r in k3_rows if r["n"] == 256 and r["mode"] == "bayer4x4")
    check(all(r["equal_to_plain"] for r in k3_rows),
          "K3 differs from its plain version on the generator's crops and palettes")
    fam_rows = family_timing(dev, fam["fns"], fam["frame"],
                             {k: r["gflop"] for k, r in fam["families"].items()})
    enhance_op = make_enhance_fn(
        lambda p, x: fs.apply_stack(
            lambda u_, sw_: torch.ops.fse.fused_stack(u_, *sw_.frags, sw_.prm),
            fs.prepare_weights_cached, p, x, None),
        params, crop_left=imp.crop_left, srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
        linear_to_srgb_exponent=imp.linear_to_srgb_exponent, device=dev)
    dispatch = op_dispatch(dev, enhance, enhance_op, u, sw, frame_dev)
    emit("timing", t0, shape=[h2, w2, 12], gflop=flops / 1e9, mbytes=nbytes / 1e6,
         k1_ms=k1_ms, k1_device=k1_dev, k1_again_device=k1_again, k1_call_ms=k1_call_ms,
         bound_ms=bound_ms, share_of_bound=bound_ms / k1_ms,
         plain_ms=plain_ms, library_ms=library_ms, k2_ms=k2_ms, k2_device=k2_dev,
         k2_call_ms=k2_call_ms, k2_plain_ms=k2_plain_ms,
         waves=plan.waves(h2, w2, plan.TILE), weight_bytes_per_cta={"K1": plan.weight_bytes_per_cta(1),
                                                         "K2": plan.weight_bytes_per_cta(2)},
         k2_share_of_bound=bound_ms / k2_ms, k4=k4_rows, enhance_ms_per_frame=enhance_ms,
         enhance_device_ms=enhance_dev,
         enhance_fps=1e3 / enhance_ms, k3_shape=list(dg["arrs"].shape), k3=k3_rows,
         kmeans_ms=kmeans_ms, datagen_styled_crops_per_s=dg["styled_crops_per_s"],
         families=fam_rows, op_dispatch=dispatch, nvidia_smi=smi)

    # turns: K3 and K4 against another tree's, in child processes
    if args.parent:
        _phase = "turns"
        t0 = time.perf_counter()
        from fs_uae_image_enhancer_project_tpu_torch.datagen.quantize import (
            generate_palettes_kmeans_torch_batch)
        from fs_uae_image_enhancer_project_tpu_torch.scripts import turns_k3_k4

        with tempfile.TemporaryDirectory() as tmp:
            npz = os.path.join(tmp, "k3_inputs.npz")
            np.savez(npz, crops=dg["arrs"], **{
                f"pal{k}": generate_palettes_kmeans_torch_batch(dg["stacks"], k, device=dev)
                .cpu().numpy() for k in PALETTES})
            turns = turns_k3_k4.main(args.parent, npz)
        emit("turns", t0, parent=args.parent, order=turns["order"], ok=turns["ok"],
             summary=turns["summary"], nvidia_smi=smi)
        check(turns["ok"], "a kernel of the turns differs from its plain version")

    # 27. kernels
    _phase = "kernels"
    kernels = [dict(
        name="fused_stack", route="cuda", source=K1_SOURCE, replaces=K1_REPLACES,
        counterpart="ops/pallas/fused_stack.py::_stack_kernel",
        launches=launches["fused_stack"], train_validation_launches=trn["k1_launches"]["all"],
        parallel_tools_launches=ptools["launches"],
        train_mesh_validation_launches=trn["mesh"]["k1_launches"],
        raw_runner_launches=tools_rec["raw_runner"]["k1_launches"],
        export_launches=exp["pix_shuffle"]["k1_launches"],
        export_child_launches=exp["pix_shuffle"]["child"]["k1_launches"],
        int8_study_launches=i8["k1_launches"], drivers_launches=drv_launches["fused_stack"],
        orbax_launches=orb["launches"]["fused_stack"],
        orbax_write_launches=ow["launches"]["fused_stack"],
        wheel_launches=wh["k1_launches"],
        recipes_launches=rcp["launches"]["fused_stack"],
        train_drivers_launches={k: r["k1_launches"] for k, r in tdrv.items()
                                if isinstance(r, dict) and "k1_launches" in r},
        max_abs_err=k1_err, ms=k1_ms, kernel_ms=k1_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=library_ms),
        dict(name="palette_dither", route="cuda", source=K3_SOURCE, replaces=K3_REPLACES,
             counterpart="ops/pallas/dither.py::_dither_kernel",
             at="16 lores crops 188x144, N=256, ordered 4x4",
             launches=dg["launches"]["palette_dither"], max_abs_err=k3_par["max_abs_err"],
             drivers_launches=drv_launches["palette_dither"],
             recipes_launches=rcp["launches"]["palette_dither"],
             ms=k3_ref["k3_ms"],
             kernel_ms=k3_ref["k3_ms"], plain_ms=k3_ref["plain_ms"],
             bound_ms=k3_ref["bound_ms"], bound_by=k3_ref["bound_by"],
             library_ms=k3_ref["library_ms"]),
        dict(name="fused_stack_packed", route="cuda", source=K2_SOURCE, replaces=K2_REPLACES,
             counterpart="ops/pallas/fused_stack_packed.py::_stack_kernel",
             at="one frame, half-res 288x376x12; bound and library as K1's (the same function)",
             launches=kb["launches"]["fused_stack_packed"], max_abs_err=k2_err, ms=k2_ms,
             kernel_ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=bound_ms,
             bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=library_ms),
        dict(name="lane_packing_mm", route="cuda", source=K4_SOURCE, replaces=K4_REPLACES,
             counterpart="scripts/bench_lane_packing.py::_mm_kernel",
             at=f"l4-class baseline (9216,648)x(648,72), grid {K4_BENCH_GRID}; every case "
                "in the timing phase",
             launches=kb["launches"]["lane_packing_mm"], max_abs_err=k4_ref["acc_max_abs"],
             ms=k4_ref["k4_ms"], kernel_ms=k4_ref["k4_ms"], plain_ms=k4_ref["plain_ms"],
             bound_ms=k4_ref["bound_ms"], bound_by=k4_ref["bound_by"],
             library_ms=k4_ref["library_ms"], chain_ms=k4_ref["chain_ms"]),
        dict(name="conv_epilogue", route="cuda", source=EPILOGUE_SOURCE,
             replaces="none: XLA fuses the bias, activation and residual adds on the TPU",
             at="8x288x368x108 bf16, bias and ReLU (conv2); every case in the epilogue phase",
             launches=fam["launches"]["conv_epilogue"],
             launches_a_forward={k: r["epilogue_launches"] for k, r in fam["families"].items()},
             epilogue_phase_launches=sum(c["launched"] for c in epi["cases"]),
             max_abs_err=max(c["max_abs_err"] for c in epi["cases"]),
             ms=epi["cases"][0]["kernel_ms"], kernel_ms=epi["cases"][0]["kernel_ms"],
             plain_ms=epi["cases"][0]["library_ms"], bound_ms=epi["cases"][0]["bound_ms"],
             bound_by="bytes", library_ms=epi["cases"][0]["library_ms"])]
    emit("done", t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception as e:  # report the phase, then fail
        print(json.dumps({"phase": _phase, "error": f"{type(e).__name__}: {e}"}), flush=True)
        raise
    sys.exit(rc)

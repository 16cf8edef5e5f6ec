"""fs_uae_image_enhancer_project_tpu_torch — the PyTorch/CUDA port.

The same framework as ``fs_uae_image_enhancer_project_tpu`` (the JAX
package, which stays the reference), written in PyTorch for one NVIDIA
H100. Each Pallas kernel of the JAX package becomes a CUDA C++ kernel for
``sm_90a`` under ``ops/cuda``. The layout mirrors the JAX package, so each
module sits where its counterpart does.

What is ported, by slice:

1. the deployed frame path: ops, the pix_shuffle model, ONNX weight import,
   the uint8 enhance function and the unix-socket frame server (K1);
2. the dataset generator's device route (``datagen``, K3);
3. the kernel benches (``scripts``, K2 and K4);
4-5. the kernels' redesigns for the H100;
6. training on one card: the losses with VGG (``losses``), the conv3/conv5
   BatchNorm models (``models.conv_stack``), the dataset and its pinned
   prefetch (``data.dataset``), the train step (``parallel.train_step``),
   the trainer and its CLI (``train``). Validation of the lightweight
   pix_shuffle runs through K1; the train step differentiates the eager
   forward (K1 has no backward);
7. every model family on the served path: conv6, the residual U-Net and its
   blocks (``models``), every shipped graph's import and enhance, and the
   ONNX exporter, its numpy runner and its CLI (``export``);
8. the parallel layer on torch process groups (``parallel``: the (dp, sp)
   mesh, the spatial split, the train step over a mesh with synchronised
   BatchNorm statistics, sharded inference and ``enhance_directory``, the
   gloo dry run) and the serving tools (``export.streaming.
   measure_stream_throughput``, ``runtime.sidecar_replay``,
   ``utils.subproc``, ``models.benchmark`` and ``models.summary``), with the
   ground-truth tools ``datagen.prepare_groundtruth`` and
   ``datagen.rgb444_flat``;
9. the parallel layer's two gaps (BatchNorm under sp, the training CLI's
   launcher of one process a rank), NAS (``nas``: the search engine, the FPS
   cache, the activation studies over conv6, the cleanup and the plots),
   the VGG self-training (``losses.vgg_selftrain``), the raw-frame runner
   (``export.raw_runner``, K1 for pix_shuffle) and the ONNX text and SVG
   tools (``export.onnx_dump``, ``export.onnx_svg``).

10. the last missing modules: the enhance as a ``torch.export`` program with
   the fused-stack kernel as the custom op ``torch.ops.fse.fused_stack``
   (``export.stablehlo``, the export CLI's ``--stablehlo``, ``raw_runner``'s
   ``.pt2`` route), the int8 PTQ/QAT path (``export.quantized``,
   ``export.qat``, measured by ``scripts.bench_int8_qat``), the bench lock
   (``utils.platform``) and the design benchmarks (``benchmark_tools``).

11. the root drivers that serve, bench and evaluate (``scripts``:
   ``make_gt_frames``, ``bench_generator_e2e``, ``bench_sidecar_multiclient``,
   ``bench_families``, ``bench_conv6_latency``, ``eval_headtohead``,
   ``precompile``, ``build_artifacts``);
12. the JAX package's fixed-seed random VGG basis, drawn without jax
   (``utils.threefry``, ``losses.vgg._random_init``), and the root drivers
   that train and search (``scripts``: ``train_psh_long``,
   ``train_psh_heavy_long``, ``training_parity_study``,
   ``plot_training_parity``, ``train_nas_winner``, ``train_vgg_features``,
   ``nas_demo_r2``, ``convert_vgg16_weights``, ``probe_transfer_retention``).

The port now does all that the JAX package does. Two JAX modules keep no
counterpart: ``utils/compile_cache.py`` (the hash-keyed nvcc cache of
``ops/cuda/build.py`` stands for it) and ``honor_jax_platforms_env`` of
``utils/platform.py`` (the port names its device explicitly).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
:func:`resolve_device` raises when a card is asked for (or implied) and
absent, so nothing carries on quietly on the CPU.
"""
from __future__ import annotations

__version__ = "0.1.0"

FRAME_W = 752
FRAME_H = 576
# The deployed graph crops 16 px from the left edge so the model sees 736x576
# (width divisible by 32); the output is padded back with black.
CROP_LEFT = 16
MODEL_W = FRAME_W - CROP_LEFT  # 736
MODEL_H = FRAME_H              # 576


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when ``cuda`` is asked for and absent.
    torch is imported here, not with the package, so that a frame server's
    client process (``runtime.client``) imports no torch."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev

"""Per-family model benchmark CLI.

Port of ``fs_uae_image_enhancer_project_tpu/models/benchmark.py``, the
counterpart of the reference's per-model ``__main__`` perf self-tests
(model_pix_shuffle.py / model_conv3.py / model_conv5.py /
model_residual_unet.py "Test performance" blocks: fuse -> half -> measure
FPS over a fixed window). The model runs on a bf16 input of zeros and is
timed with ``utils.profiler.measure_chained`` (each output feeds the next
call; CUDA events close each chunk on a card). conv3 and conv5 fold their
BatchNorm into the convs first, as the deployed graphs do. On a card the
lightweight pix_shuffle runs as the fused-stack kernel K1
(``models.pix_shuffle.apply``); the other families run cuDNN's
convolutions. The parameters stay fp32: every conv casts its weights to the
input's bf16.

    python -m fs_uae_image_enhancer_project_tpu_torch.models.benchmark \
        --model_type pix_shuffle [--batch_size 1] [--duration 20] [--device cpu]
"""
from __future__ import annotations

import sys
from typing import List, Optional

from . import MODEL_NAMES, count_params, get_model


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Model performance benchmark")
    ap.add_argument("--model_type", required=True, choices=sorted(MODEL_NAMES))
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--duration", type=float, default=20.0,
                    help="measurement window in seconds (reference uses 20)")
    ap.add_argument("--crop_size", type=int, nargs=2, default=[752, 576],
                    metavar=("W", "H"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda with no card raises")
    args = ap.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..utils.profiler import measure_chained

    dev = resolve_device(args.device)
    model = get_model(args.model_type)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    n_params = count_params(params)
    name = f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""
    print(f"Using device: {dev}{name}")

    w, h = args.crop_size
    x = torch.zeros((args.batch_size, h, w, 3), dtype=torch.bfloat16, device=dev)
    apply = model.apply
    if model.name in ("conv3", "conv5"):
        # fuse Conv+BN before timing — the reference self-benchmarks fuse
        # first (model_conv3.py:213-275 'model.fuse()'), and the deployed
        # graphs never execute live BatchNorm
        from .conv_stack import apply_fused, fuse

        params = fuse(params, model.config)
        apply = lambda p, t: apply_fused(p, t, model.config)  # noqa: E731

    @torch.no_grad()
    def fwd(t):
        return apply(params, t)

    print("Starting warm-up...")
    out_shape = tuple(fwd(x).shape)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print("Warm-up finished.\nMeasuring FPS...")
    res = measure_chained(fwd, x, warmup=5, duration_s=args.duration)
    fps = res.fps * args.batch_size

    print("\n--- Results ---")
    print("Model output shape:", out_shape)
    print(f"Model size (trainable parameters): {n_params}")
    print(f"Model size (MB, assuming bfloat16): {n_params * 2 / 1e6:.2f} MB")
    print(f"Mean step: {res.ms_per_call:.3f} ms")
    print(f"Average FPS: {fps:.2f}")
    print("---------------")
    return 0


if __name__ == "__main__":
    sys.exit(main())

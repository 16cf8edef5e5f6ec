"""Frame latency of conv3_heavy and conv6 across the frame's geometry variants.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.bench_conv6_latency \\
        [--duration 10] [--work_dir DIR] [--out FILE] [--device cpu]

Port of the repo's ``scripts/bench_conv6_latency.py``: one run that times
each family's enhance at three geometries of the 576x752 frame, the whole
width (``baseline_752``), the 16-column left crop (``crop16_736``) and the
width padded to 768 with the output cut back (``pad768``), each with
``utils.profiler.measure_chained`` (20 warm-up frames, then the window, CUDA
events on a card).

- conv3_heavy: the shipped graph ``artifacts/model_conv3_heavy/
  conv3_heavy.onnx`` (its deployed semantics: ReLU before the residual add,
  no final activation), in the sRGB domain;
- conv6: a trained checkpoint of the port under ``--work_dir`` where there
  is one, else the shipped graph ``artifacts/model_conv6/conv6.onnx``, in
  linear light.

One line a variant, then the report as the last line (also to ``--out``).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

from .common import ARTIFACTS, WORK_DIR, trained_checkpoint

CONV3_HEAVY = os.path.join(ARTIFACTS, "model_conv3_heavy", "conv3_heavy.onnx")
CONV6 = os.path.join(ARTIFACTS, "model_conv6", "conv6.onnx")


def pad768(apply):
    """``apply`` on the input padded on the right to width 768, cut back to 752."""
    import torch.nn.functional as F

    def f(p, x):
        return apply(p, F.pad(x, (0, 0, 0, 16)))[:, :, :752, :]
    return f


def variants(device, work_dir: str = WORK_DIR) -> list:
    """``[(family, tag, enhance, weights)]``, the six variants in the JAX
    script's order."""
    from ..export.enhance import _match_structure, make_enhance_fn
    from ..export.onnx_import import import_any
    from ..interop import params_from_jax
    from ..models import get_model
    from ..models.configs import ConvStackConfig
    from ..models.conv_stack import apply_fused
    from ..train.trainer import load_params

    imp = import_any(CONV3_HEAVY)
    cfg = ConvStackConfig(
        channels=tuple(imp.params[f"conv{i + 1}"]["w"].shape[-1]
                       for i in range(imp.num_conv_layers)),
        residual_layers=imp.residual_layers, final_act="none")
    c3h = functools.partial(apply_fused, cfg=cfg,
                            relu_before_residual_add=imp.relu_before_residual_add)
    p3 = params_from_jax(imp.params, device=device)
    src = f"shipped graph {CONV3_HEAVY}"
    out = []
    for tag, crop in (("conv3_heavy_baseline_752", 0), ("conv3_heavy_crop16_736", 16)):
        out.append(("conv3_heavy", tag, make_enhance_fn(c3h, p3, crop_left=crop,
                                                        srgb_domain=True, device=device), src))
    out.append(("conv3_heavy", "conv3_heavy_pad768",
                make_enhance_fn(pad768(c3h), p3, crop_left=0, srgb_domain=True, device=device),
                src))

    m = get_model("conv6")
    ck = trained_checkpoint("conv6", work_dir)
    if ck:
        import torch

        p6 = load_params(ck, m.init(torch.Generator().manual_seed(0), device=device))
        src = f"trained checkpoint {ck}"
    else:
        p6 = params_from_jax(_match_structure(m, import_any(CONV6).params), device=device)
        src = f"shipped graph {CONV6}"
    for tag, crop in (("conv6_baseline_752", 0), ("conv6_crop16_736", 16)):
        out.append(("conv6", tag, make_enhance_fn(m.apply, p6, crop_left=crop,
                                                  srgb_domain=not m.linear_io, device=device),
                    src))
    out.append(("conv6", "conv6_pad768",
                make_enhance_fn(pad768(m.apply), p6, crop_left=0, srgb_domain=not m.linear_io,
                                device=device), src))
    return out


def run(duration_s: float = 10.0, device: str = "cuda", work_dir: str = WORK_DIR,
        warmup: int = 20, chunk: int = 200) -> dict:
    import numpy as np
    import torch

    from .. import resolve_device
    from ..utils.platform import wait_for_bench_lock
    from ..utils.profiler import measure_chained

    dev = resolve_device(device)
    wait_for_bench_lock()
    rng = np.random.default_rng(0)
    results, weights = {}, {}
    for family, tag, fn, src in variants(dev, work_dir):
        frame = torch.from_numpy(
            rng.integers(0, 256, (1, 576, 752, 4), dtype=np.uint8)).to(dev)
        res = measure_chained(fn, frame, warmup=warmup, duration_s=duration_s, chunk=chunk)
        results[tag] = {"ms_per_frame": res.ms_per_call, "p50_ms": res.p50_ms,
                        "p99_ms": res.p99_ms, "fps": res.fps, "compile_s": res.compile_s,
                        "frames": warmup + res.iterations}
        weights[family] = src
        print(json.dumps({tag: results[tag]}), flush=True)
    report = {"harness": "fs_uae_image_enhancer_project_tpu_torch.scripts.bench_conv6_latency",
              "device": str(dev), "duration_s": duration_s, "weights": weights,
              "variants": results}
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(0)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="conv3_heavy and conv6 latency by frame geometry")
    ap.add_argument("--duration", type=float, default=10.0, help="seconds a variant")
    ap.add_argument("--work_dir", default=WORK_DIR,
                    help="where the port's trained checkpoints are")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report = run(args.duration, args.device, args.work_dir)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

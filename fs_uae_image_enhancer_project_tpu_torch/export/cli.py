"""Export CLI: a trained checkpoint to an ONNX deployment graph.

    python -m fs_uae_image_enhancer_project_tpu_torch.export.cli \
        --checkpoint ckpts/checkpoint_best_pix_shuffle \
        --model_type pix_shuffle --output pix_shuffle.onnx [--device cpu]

Port of ``fs_uae_image_enhancer_project_tpu/export/cli.py``: it loads an
orbax checkpoint of either package's trainer (``train.trainer.load_params``),
exports the
family (conv3/conv5 fused first) with ``export.onnx_export``, verifies the
graph with the numpy runner on a random uint8 frame (the full frame for
pix_shuffle, a 160x160 graph with the same weights for the rest) and
cross-checks it against the port's own fp32 enhance on ``--device``. It exits
1 under 40 dB. ``--stablehlo PATH`` also writes the enhance as a
``torch.export`` program (``export.stablehlo``, a ``.pt2`` file; the flag
keeps the JAX CLI's name), for ``--device``, with the ONNX graph's
per-family semantics: the conv stacks fused in the sRGB domain, the crop for
pix_shuffle and the U-Net only.
"""
from __future__ import annotations

import sys
import tempfile
from typing import List, Optional

VERIFY_SIDE = 160
MIN_PSNR_DB = 40.0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Export a trained model for deployment")
    ap.add_argument("--checkpoint", required=True,
                    help="an orbax checkpoint dir of either package's trainer")
    ap.add_argument("--model_type", default="pix_shuffle",
                    choices=["pix_shuffle", "pix_shuffle_heavy",
                             "conv3", "conv3_heavy", "conv5", "conv5_heavy",
                             "conv6", "residual_unet"])
    ap.add_argument("--output", required=True, help=".onnx output path")
    ap.add_argument("--stablehlo", default=None,
                    help="optional output path of the port's torch.export artifact (.pt2) "
                         "of the enhance on --device")
    ap.add_argument("--crop_left", type=int, default=16,
                    help="left crop in px (the crop-16 contract)")
    ap.add_argument("--fp32", action="store_true", help="export fp32 (default fp16)")
    ap.add_argument("--skip_verify", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for the cross-check's enhance")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..interop import params_to_numpy
    from ..models import get_model
    from ..models.conv_stack import apply_fused, fuse
    from ..train.trainer import load_params
    from .enhance import make_enhance_fn
    from .onnx_export import (
        export_conv6_onnx,
        export_conv_stack_onnx,
        export_pix_shuffle_onnx,
        export_residual_unet_onnx,
    )

    device = resolve_device(args.device)
    m = get_model(args.model_type)  # resolves the '<name>_heavy' aliases
    params = load_params(args.checkpoint, m.init(device=device))
    print(f"loaded checkpoint {args.checkpoint}")

    fp16 = not args.fp32
    srgb = m.name in ("conv3", "conv5")
    if srgb:
        params = fuse(params, m.config)
    export_params = params_to_numpy(params)
    # (exporter, its keyword arguments): the full frame is written with them,
    # the verification graph with a 160x160 frame instead
    if m.name == "pix_shuffle":
        exporter, kw = export_pix_shuffle_onnx, dict(crop_left=args.crop_left)
    elif srgb:
        exporter, kw = export_conv_stack_onnx, {}
    elif m.name == "conv6":
        exporter, kw = export_conv6_onnx, {}
    else:
        exporter, kw = export_residual_unet_onnx, dict(crop_left=args.crop_left)
    out = exporter(export_params, m.config, args.output, fp16=fp16, **kw)
    print(f"wrote {out}")
    if not args.skip_verify:
        rc = _verify(args, m, params, exporter, kw, export_params, out, fp16, srgb, device)
        if rc:
            return rc
    if args.stablehlo:
        from .stablehlo import export_enhance

        crop = args.crop_left if m.name in ("pix_shuffle", "residual_unet") else 0
        apply = (lambda p, x: apply_fused(p, x, m.config)) if srgb else m.apply  # noqa: E731
        enhance = make_enhance_fn(apply, params, crop_left=crop, srgb_domain=srgb,
                                  device=device)
        export_enhance(enhance, args.stablehlo, device=device)
        print(f"wrote {args.stablehlo} (crop_left={crop}, srgb={srgb}, device={device.type})")
    return 0


def _verify(args, m, params, exporter, kw, export_params, out, fp16, srgb, device) -> int:
    """The ONNX graph through the numpy runner against the port's fp32
    enhance; 1 under ``MIN_PSNR_DB``."""
    import numpy as np
    import torch

    from ..models.conv_stack import apply_fused
    from .enhance import make_enhance_fn
    from .onnx_runner import verify_onnx_model

    if m.name == "pix_shuffle":
        outs = verify_onnx_model(out)
        shape, crop_left = (1, 576, 752, 4), args.crop_left
    else:
        # a crop-sized graph with the same weights: the full frame through
        # the numpy runner would take minutes
        with tempfile.NamedTemporaryFile(suffix=".onnx") as tmp:
            small = dict(kw, crop_left=0) if "crop_left" in kw else kw
            exporter(export_params, m.config, tmp.name, fp16=fp16,
                     frame_h=VERIFY_SIDE, frame_w=VERIFY_SIDE, **small)
            outs = verify_onnx_model(tmp.name)
        shape, crop_left = (1, VERIFY_SIDE, VERIFY_SIDE, 4), 0
    apply = (lambda p, x: apply_fused(p, x, m.config)) if srgb else m.apply  # noqa: E731
    enhance = make_enhance_fn(apply, params, crop_left=crop_left,
                              compute_dtype=torch.float32, srgb_domain=srgb, device=device)
    frame = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    ours = enhance(frame).cpu().numpy()
    theirs = outs["output_rgba_uint8_chunky"]
    mse = np.mean((ours[..., :3].astype(np.float64) - theirs[..., :3].astype(np.float64)) ** 2)
    psnr = 99.0 if mse == 0 else 10 * np.log10(255.0**2 / mse)
    print(f"onnx-vs-port cross-check PSNR: {psnr:.2f} dB")
    if psnr < MIN_PSNR_DB:
        print("ERROR: the exported graph diverges from the port's enhance", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

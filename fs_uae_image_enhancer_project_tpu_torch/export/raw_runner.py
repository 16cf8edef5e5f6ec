"""Raw framebuffer dump -> enhanced PNG.

Port of ``fs_uae_image_enhancer_project_tpu/export/raw_runner.py``, the
counterpart of the reference's
``convertion_tools/convert_raw_to_png_using_final_model.py``: reads a raw
752x576x4 uint8 RGBA file (an FS-UAE framebuffer capture), runs the deployed
enhance, saves the uint8 RGBA result as PNG. The model is a shipped or
exported ``.onnx`` graph, run through :func:`.enhance.enhance_from_onnx`
(the lightweight pix_shuffle graph launches the fused-stack kernel K1 on a
card), or a ``.pt2`` program of :func:`.stablehlo.export_enhance` (the
counterpart of the JAX package's ``jax.export`` route), run through
:func:`.stablehlo.load_enhance`. Any other model path raises.

    python -m fs_uae_image_enhancer_project_tpu_torch.export.raw_runner \\
        --model artifacts/model_pix_shuffle/pix_shuffle.onnx --raw F.raw --out F.png
"""
from __future__ import annotations

import sys

import numpy as np

from .. import FRAME_H, FRAME_W


def load_raw_rgba(path: str, width: int = FRAME_W, height: int = FRAME_H) -> np.ndarray:
    """Raw uint8 RGBA dump -> (1, H, W, 4), validating the byte count
    (reference convert_raw_to_png_using_final_model.py:10-37)."""
    data = np.fromfile(path, dtype=np.uint8)
    expected = width * height * 4
    if data.size != expected:
        raise ValueError(
            f"raw file {path} has {data.size} bytes, expected {expected} "
            f"({width}x{height}x4 RGBA)"
        )
    return data.reshape(1, height, width, 4)


def save_rgba_png(frame: np.ndarray, out_path: str) -> None:
    from PIL import Image

    Image.fromarray(frame, mode="RGBA").save(out_path)


def run_inference(model_path: str, raw_path: str, out_path: str, verbose: int = 1, *,
                  device=None) -> np.ndarray:
    """raw RGBA file -> enhance on ``device`` (default ``cuda``) -> RGBA PNG;
    returns the (1, H, W, 4) uint8 frame."""
    if model_path.endswith(".onnx"):
        from .enhance import enhance_from_onnx

        enhance = enhance_from_onnx(model_path, device=device)
    elif model_path.endswith(".pt2"):
        from .stablehlo import load_enhance

        enhance = load_enhance(model_path, device=device)
    else:
        raise ValueError(
            f"{model_path}: the port runs .onnx graphs and .pt2 torch.export programs "
            "(export.stablehlo); a jax.export artifact runs in the JAX package only")
    frame = load_raw_rgba(raw_path)
    out = enhance(frame).cpu().numpy()
    save_rgba_png(out[0], out_path)
    if verbose:
        print(f"wrote {out_path} ({out.shape[2]}x{out.shape[1]})")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Raw framebuffer -> enhanced PNG")
    ap.add_argument("--model", required=True, help=".onnx graph or .pt2 program")
    ap.add_argument("--raw", required=True, help="raw 752x576x4 RGBA file")
    ap.add_argument("--out", required=True, help="output PNG path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda with no card raises")
    args = ap.parse_args(argv)
    run_inference(args.model, args.raw, args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

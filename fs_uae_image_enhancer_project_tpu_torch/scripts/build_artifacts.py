"""Build the shipped artifacts of each model with the port: the ONNX graph, its
SVG and the predicted sample frames.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.build_artifacts \\
        --out DIR [--models pix_shuffle conv3 ...] [--samples DIR] [--work_dir DIR] \\
        [--device cpu]

Port of the repo's ``scripts/build_artifacts.py``. For each model it writes
``<out>/model_<name>/``, never over the repo's ``artifacts/``:

1. ``<name>.onnx``: the weights re-exported by the port's exporter
   (``export/onnx_export.py``) with the JAX script's settings: the shipped
   pix_shuffle and conv stacks as fp16 graphs with their wrapper (crop,
   gamma exponents, ReLU before the residual add), the heavy and trained
   pix_shuffle, conv6 and the U-Net as fp32 graphs (the pix_shuffle ones
   with an ``_fp16`` twin). Its bytes are held to the committed
   ``artifacts/model_<name>/<name>.onnx``;
2. ``<name>.onnx.svg``: the graph's SVG (``export/onnx_svg.py``);
3. ``predicted/sample{0..7}.png``: the eight sample frames through the
   port's enhance of the re-exported graph in fp32 on ``--device``.

The weights are the committed graph's (the shipped families' graphs are
re-exports of the reference's); for the trained families a trained
checkpoint of the port under ``--work_dir`` takes their place where there is
one (its ONNX is then not held to the committed one). pix_shuffle_trained
comes first from the committed orbax checkpoint of the highest epoch,
``artifacts/model_pix_shuffle_trained/checkpoint_best_epoch<N>``, as the JAX
script takes it (the port reads it with ``train.orbax_reader``), then from
``--work_dir``, then from its graph. The sample frames are
the reference's eight (``--samples``, its ``model/samples`` directory) where
given, else the eight committed 752x576 frames
``artifacts/model_conv3_heavy/predicted/`` (the frames
``scripts/bench_int8_qat.py`` also takes). A ``parity_report.json`` a model
records the weights, whether the ONNX and SVG bytes equal the committed
files' and, with the reference's samples, the PSNR against the committed
predicted frames. The summary is printed as the last line.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Optional

from .common import ARTIFACTS, CURRENT_CORPUS_TAG, WORK_DIR, psnr_u8, trained_checkpoint

MODELS = ("pix_shuffle", "conv3", "conv3_heavy", "conv5", "conv5_heavy", "pix_shuffle_heavy",
          "pix_shuffle_trained", "conv6", "residual_unet")
CONV_STACKS = ("conv3", "conv3_heavy", "conv5", "conv5_heavy")
COMMITTED_FRAMES = os.path.join(ARTIFACTS, "model_conv3_heavy", "predicted")


def committed(name: str) -> str:
    return os.path.join(ARTIFACTS, f"model_{name}", f"{name}.onnx")


def committed_checkpoint() -> Optional[str]:
    """The committed TPU-trained pix_shuffle checkpoint of the highest epoch
    number (not the last name: epoch100 sorts before epoch73), or None."""
    def epoch(path: str) -> int:
        m = re.search(r"epoch(\d+)$", path)
        return int(m.group(1)) if m else -1

    cks = sorted(glob.glob(os.path.join(ARTIFACTS, "model_pix_shuffle_trained",
                                        "checkpoint_best_epoch*")), key=epoch)
    return cks[-1] if cks else None


def export_model(name: str, out_dir: str, device, work_dir: str = WORK_DIR) -> dict:
    """Write ``<name>.onnx`` (and the fp16 twin where the JAX script writes
    one) into ``out_dir``; returns the weights' source and the enhance of the
    written graph in fp32 on ``device``."""
    import torch

    from ..export import onnx_export
    from ..export.enhance import _match_structure, enhance_from_onnx, make_enhance_fn
    from ..export.onnx_import import import_any, import_pix_shuffle
    from ..interop import params_to_numpy
    from ..models import get_model
    from ..models.configs import ConvStackConfig
    from ..train.trainer import load_params

    src = committed(name)
    onnx_out = os.path.join(out_dir, f"{name}.onnx")
    if name == "pix_shuffle":
        imp = import_pix_shuffle(src)
        onnx_export.export_pix_shuffle_onnx(
            imp.params, get_model(name).config, onnx_out, crop_left=imp.crop_left, fp16=True,
            srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
            linear_to_srgb_exponent=imp.linear_to_srgb_exponent)
        weights, ckpt = f"shipped graph {src}", None
    elif name in CONV_STACKS:
        imp = import_any(src)
        cfg = ConvStackConfig(channels=tuple(imp.params[f"conv{i + 1}"]["w"].shape[-1]
                                             for i in range(imp.num_conv_layers)),
                              residual_layers=imp.residual_layers, final_act="none")
        onnx_export.export_conv_stack_onnx(
            imp.params, cfg, onnx_out, fp16=True,
            relu_before_residual_add=imp.relu_before_residual_add)
        weights, ckpt = f"shipped graph {src}", None
    else:
        m = get_model("pix_shuffle", "heavyweight") if name == "pix_shuffle_heavy" else (
            get_model("pix_shuffle") if name == "pix_shuffle_trained" else get_model(name))
        ckpt = committed_checkpoint() if name == "pix_shuffle_trained" else None
        weights = f"committed checkpoint {ckpt}"
        if ckpt is None:
            ckpt = trained_checkpoint(
                "pix_shuffle_long" if name == "pix_shuffle_trained" else name, work_dir)
            weights = f"trained checkpoint {ckpt}"
        if ckpt:
            params = params_to_numpy(load_params(
                ckpt, m.init(torch.Generator().manual_seed(0), device="cpu")))
        else:
            params = _match_structure(m, import_any(src).params)
            weights = f"committed graph {src}"
        if name.startswith("pix_shuffle"):
            for path, fp16 in ((onnx_out, False),
                               (os.path.join(out_dir, f"{name}_fp16.onnx"), True)):
                onnx_export.export_pix_shuffle_onnx(params, m.config, path, crop_left=16,
                                                    fp16=fp16)
        elif name == "conv6":
            onnx_export.export_conv6_onnx(params, m.config, onnx_out, fp16=False)
        else:
            onnx_export.export_residual_unet_onnx(params, m.config, onnx_out, crop_left=16,
                                                  fp16=False)
    if name in ("pix_shuffle_heavy", "pix_shuffle_trained"):
        # no reconstructable config in the file: the enhance of the weights
        from ..interop import params_from_jax

        m = get_model("pix_shuffle",
                      "heavyweight" if name == "pix_shuffle_heavy" else "lightweight")
        p = _match_structure(m, import_any(onnx_out).params)
        enhance = make_enhance_fn(m.apply, params_from_jax(p, device=device), crop_left=16,
                                  compute_dtype=torch.float32, device=device)
    else:
        enhance = enhance_from_onnx(onnx_out, device=device, compute_dtype=torch.float32)
    return dict(weights=weights, checkpoint=ckpt, onnx=onnx_out, src=src, enhance=enhance)


def build(name: str, out: str, samples, device, work_dir: str = WORK_DIR) -> dict:
    """One model's directory under ``out``; its parity report. ``samples``:
    the reference's sample frames, or None for the committed frames."""
    import numpy as np
    from PIL import Image

    from ..export.onnx_proto import load_model
    from ..export.onnx_svg import render_file, render_svg

    out_dir = os.path.join(out, f"model_{name}")
    os.makedirs(os.path.join(out_dir, "predicted"), exist_ok=True)
    r = export_model(name, out_dir, device, work_dir)
    svg = r["onnx"] + ".svg"
    if name in CONV_STACKS:  # as the JAX script: the source graph's drawing
        with open(svg, "w") as f:
            f.write(render_svg(load_model(r["src"]).graph, title=f"{name}.onnx"))
    else:
        render_file(r["onnx"])
    with open(r["onnx"], "rb") as f, open(committed(name), "rb") as g:
        equal = f.read() == g.read()
    with open(svg) as f, open(committed(name) + ".svg") as g:
        svg_equal = f.read() == g.read()
    report = {"weights": r["weights"], "onnx_equal_to_committed": equal,
              "svg_equal_to_committed": svg_equal, "samples": samples or COMMITTED_FRAMES}
    if r["checkpoint"]:
        report["weights_corpus_tag"] = CURRENT_CORPUS_TAG
    for i in range(8):
        frame = np.asarray(Image.open(os.path.join(samples or COMMITTED_FRAMES,
                                                   f"sample{i}.png")).convert("RGBA"))
        pred = r["enhance"](frame[None]).cpu().numpy()[0]
        path = os.path.join(out_dir, "predicted", f"sample{i}.png")
        Image.fromarray(pred, mode="RGBA").save(path)
        if samples:  # the committed frames are the reference samples' predictions
            want = np.asarray(Image.open(os.path.join(ARTIFACTS, f"model_{name}", "predicted",
                                                      f"sample{i}.png")).convert("RGB"))
            report[f"sample{i}_psnr_vs_committed_db"] = psnr_u8(pred[..., :3], want)
    if samples:
        report["min_psnr_db"] = min(v for k, v in report.items() if k.endswith("_db"))
    with open(os.path.join(out_dir, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(name, json.dumps(report), flush=True)
    return report


def run(out: str, models=MODELS, samples=None, device: str = "cuda",
        work_dir: str = WORK_DIR) -> dict:
    from .. import resolve_device

    out = os.path.abspath(out)
    if os.path.commonpath([out, ARTIFACTS]) == ARTIFACTS:
        raise ValueError(f"--out {out} lies in the repo's artifacts/; name another directory")
    dev = resolve_device(device)
    reports = {name: build(name, out, samples, dev, work_dir) for name in models}
    return {"harness": "fs_uae_image_enhancer_project_tpu_torch.scripts.build_artifacts",
            "out": out, "device": str(dev), "samples": samples or COMMITTED_FRAMES,
            "onnx_equal_to_committed": {n: r["onnx_equal_to_committed"]
                                        for n, r in reports.items()},
            "weights": {n: r["weights"] for n, r in reports.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Re-export the shipped artifacts with the port")
    ap.add_argument("--out", required=True, help="where to write (not the repo's artifacts/)")
    ap.add_argument("--models", nargs="+", default=list(MODELS), choices=MODELS)
    ap.add_argument("--samples", default=None,
                    help="the reference's model/samples directory (sample0..7.png); default: "
                         "the committed conv3_heavy frames")
    ap.add_argument("--work_dir", default=WORK_DIR,
                    help="where the port's trained checkpoints are")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    summary = run(args.out, args.models, args.samples, args.device, args.work_dir)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

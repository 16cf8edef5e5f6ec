"""Sustained enhance throughput of each served family on the card.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.bench_families \\
        [--duration 12] [--work_dir DIR] [--out FILE] [--device cpu]

Port of the repo's ``scripts/bench_families.py``, the counterpart of the
reference's per-model FPS loop: 20 warm-up frames, then a timed window of
back-to-back frames (``utils.profiler.measure_chained``, each output fed
back as the next input, CUDA events on a card) through the port's enhance
on one device frame of 576x752.

Weights, first found: the family's shipped graph
``artifacts/model_<name>/<name>.onnx`` (pix_shuffle through K1, one launch a
frame, counted); a trained checkpoint of the port under ``--work_dir``
(``common.TRAINED_CKPTS``); else fresh weights from seed 0, labelled so.
One line a family, then the report as the last line (also to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .common import ARTIFACTS, WORK_DIR, trained_checkpoint

FAMILIES = ("pix_shuffle", "pix_shuffle_heavy", "conv3", "conv3_heavy", "conv5",
            "conv5_heavy", "conv6", "residual_unet")


def model_def(name: str):
    """The ModelDef of a family name (``_heavy`` picks the heavyweight variant)."""
    from ..models import get_model

    base = name.partition("_heavy")[0]
    return get_model(base, "heavyweight" if name.endswith("_heavy") else "lightweight")


def family_fn(name: str, device, work_dir: str = WORK_DIR):
    """``(enhance, weights)``: the family's enhance on ``device`` and where
    its weights came from."""
    import torch

    from ..export.enhance import _match_structure, enhance_from_onnx, make_enhance_fn
    from ..export.onnx_import import import_any
    from ..interop import params_from_jax
    from ..train.trainer import load_params

    graph = os.path.join(ARTIFACTS, f"model_{name}", f"{name}.onnx")
    m = model_def(name)
    crop = 16 if name in ("residual_unet", "pix_shuffle_heavy") else 0
    if os.path.exists(graph):
        try:
            return enhance_from_onnx(graph, device=device), f"shipped graph {graph}"
        except ValueError:  # the heavy pix_shuffle graph: its config is not in the file
            params = _match_structure(m, import_any(graph).params)
            if params is not None:
                return (make_enhance_fn(m.apply, params_from_jax(params, device=device),
                                        crop_left=crop, srgb_domain=not m.linear_io,
                                        device=device),
                        f"shipped graph {graph} (weights on the {m.variant} config)")
    params = m.init(torch.Generator().manual_seed(0), device=device)
    src = "fresh weights (seed 0)"
    ck = trained_checkpoint(name, work_dir)
    if ck:
        params, src = load_params(ck, params), f"trained checkpoint {ck}"
    return (make_enhance_fn(m.apply, params, crop_left=crop, srgb_domain=not m.linear_io,
                            device=device), src)


def run(families=FAMILIES, duration_s: float = 12.0, device: str = "cuda",
        work_dir: str = WORK_DIR, frame_hw=(576, 752), warmup: int = 20,
        chunk: int = 200) -> dict:
    import numpy as np
    import torch

    from .. import resolve_device
    from ..ops.cuda import fused_stack as fs
    from ..utils.platform import wait_for_bench_lock
    from ..utils.profiler import measure_chained

    dev = resolve_device(device)
    wait_for_bench_lock()
    rng = np.random.default_rng(0)
    rows = []
    for name in families:
        fn, src = family_fn(name, dev, work_dir)
        frame = torch.from_numpy(
            rng.integers(0, 256, (1, *frame_hw, 4), dtype=np.uint8)).to(dev)
        before = fs.fused_stack.launches
        res = measure_chained(fn, frame, warmup=warmup, duration_s=duration_s, chunk=chunk)
        row = {"family": name, "fps": res.fps, "ms_per_frame": res.ms_per_call,
               "p50_ms": res.p50_ms, "p99_ms": res.p99_ms, "compile_s": res.compile_s,
               "frames": warmup + res.iterations,
               "k1_launches": fs.fused_stack.launches - before, "weights": src}
        print(json.dumps(row), flush=True)
        rows.append(row)
    report = {"harness": "fs_uae_image_enhancer_project_tpu_torch.scripts.bench_families",
              "device": str(dev), "frame": list(frame_hw), "duration_s": duration_s,
              "warmup": warmup, "rows": rows}
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(0)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Sustained fps of each served family")
    ap.add_argument("--duration", type=float, default=12.0, help="seconds a family")
    ap.add_argument("--work_dir", default=WORK_DIR,
                    help="where the port's trained checkpoints are")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report = run(FAMILIES, args.duration, args.device, args.work_dir)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

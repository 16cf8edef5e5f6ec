"""The int8 study on the card: PTQ and QAT quality and int8 against bf16 time.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.bench_int8_qat \\
        [--qat_steps 300] [--duration 2.0] [--out artifacts/int8_qat_h100/report.json]

Counterpart of the repo's ``scripts/bench_int8_qat.py``, whose verdict on
the TPU (int8 at the bf16 rate, so a measured negative) does not carry over:
the H100's dense int8 rate is twice its bf16 rate. The frames are the eight
committed 752x576 RGBA frames ``artifacts/model_conv3_heavy/predicted/
sample{0..7}.png`` (the reference's own samples are not in the repo), as
sRGB [0, 1] RGB.

1. conv3_heavy from ``artifacts/model_conv3_heavy/conv3_heavy.onnx``: the
   activation scales calibrated on frames 0-3; int8 PTQ, then QAT
   (distillation at the JAX script's settings: 24 batches of 4 random
   256x256 crops, seeded, ``--qat_steps`` steps at lr 2e-5); each path's
   PSNR against the fp32 enhance (TF32 off) over the eight frames, and the
   distillation loss, the mean of the first 24 steps against the last 24.
2. pix_shuffle from ``artifacts/model_pix_shuffle/pix_shuffle.onnx``: int8
   PTQ calibrated on frames 0-3 in linear light (the artifact's gamma
   exponents, so that the PSNR measures the int8 path alone), its PSNR
   against the fp32 enhance.
3. In one process, ms a frame (``utils.profiler.measure_chained`` on a
   device frame, CUDA events on a card): conv3_heavy bf16 against int8 QAT;
   pix_shuffle through K1 against the eager bf16 forward against int8 PTQ;
   and where conv3_heavy's 192->256 int8 conv spends its time against the
   same conv and GEMM in bf16 (:func:`layer_breakdown`).

The report is written to ``--out`` and printed as the last line. Runs on the
card unless ``--device cpu``; :func:`run` takes a smaller frame and crop for
a rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARTIFACTS = os.path.join(REPO, "artifacts")
SAMPLES = os.path.join(ARTIFACTS, "model_conv3_heavy", "predicted", "sample{}.png")
CONV3_HEAVY = os.path.join(ARTIFACTS, "model_conv3_heavy", "conv3_heavy.onnx")
PIX_SHUFFLE = os.path.join(ARTIFACTS, "model_pix_shuffle", "pix_shuffle.onnx")
OUT = os.path.join(ARTIFACTS, "int8_qat_h100", "report.json")
QAT_LR = 2e-5
QAT_BATCHES, QAT_BATCH, QAT_CROP = 24, 4, 256


def load_samples(frame_hw=None) -> list:
    """The eight frames as float32 sRGB (H, W, 3) in [0, 1], the top-left
    ``frame_hw`` window of each when given."""
    from PIL import Image

    out = []
    for i in range(8):
        s = np.asarray(Image.open(SAMPLES.format(i)).convert("RGB"), np.float32) / 255.0
        out.append(s if frame_hw is None else s[:frame_hw[0], :frame_hw[1]])
    return out


def rgba(s: np.ndarray) -> np.ndarray:
    """An sRGB [0, 1] frame as the uint8 RGBA (1, H, W, 4) the enhance takes."""
    return np.dstack([(s * 255).astype(np.uint8),
                      np.full(s.shape[:2], 255, np.uint8)])[None]


def psnr_u8(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def quality(enhance, samples, want) -> list:
    """PSNR (RGB) of ``enhance`` against the frames ``want`` a frame."""
    return [psnr_u8(enhance(rgba(s)).cpu().numpy()[0, ..., :3], w[..., :3])
            for s, w in zip(samples, want)]


def time_ms(fn, frame, duration_s: float) -> float:
    """ms a call of the uint8 enhance ``fn`` chained on a device frame."""
    from ..utils.profiler import measure_chained

    return measure_chained(fn, frame, warmup=5, duration_s=duration_s, chunk="auto").ms_per_call


def event_ms(fn, n: int = 20) -> float:
    """Median ms of single calls of ``fn`` (CUDA events on a card, the
    host's clock on the CPU), after two warm-up calls."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    fn()
    fn()
    times = []
    for _ in range(n):
        if cuda:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def layer_breakdown(qp: dict, p: dict, x: torch.Tensor, scale: float) -> dict:
    """Where one int8 conv's time goes, against the same conv in bf16: the
    activation codes, the im2col, ``torch._int_mm`` (B row-major as
    ``qconv_acc`` passes it, and column-major), the whole ``_qconv``, the
    bf16 GEMM of the same (M, K) x (K, N), and cuDNN's bf16 conv; with the
    GEMM's operations (2 M K N)."""
    from ..export import quantized as q
    from ..ops.conv import conv2d

    kh, kw, cin, cout = qp["w_q"].shape
    codes = q.quantize_act(x, scale)
    cols = q.im2col(codes, kh, kw)
    n8 = -(-cout // 8) * 8
    wm = torch.nn.functional.pad(qp["w_q"].reshape(kh * kw * cin, cout),
                                 (0, n8 - cout, 0, cols.shape[1] - kh * kw * cin)).contiguous()
    wm_cm = wm.t().contiguous().t()
    a16, w16 = cols.to(torch.bfloat16), wm.to(torch.bfloat16)
    pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
    return {"m": cols.shape[0], "k": cols.shape[1], "n": n8,
            "gemm_gop": 2.0 * cols.shape[0] * cols.shape[1] * n8 / 1e9,
            "quantize_ms": event_ms(lambda: q.quantize_act(x, scale)),
            "im2col_ms": event_ms(lambda: q.im2col(codes, kh, kw)),
            "int_mm_ms": event_ms(lambda: torch._int_mm(cols, wm)),
            "int_mm_col_major_b_ms": event_ms(lambda: torch._int_mm(cols, wm_cm)),
            "qconv_ms": event_ms(lambda: q._qconv(qp, x, scale)),
            "bf16_gemm_ms": event_ms(lambda: a16 @ w16),
            "bf16_conv_ms": event_ms(lambda: conv2d(pb, x))}


def qat_batches(samples, crop: int) -> list:
    """The JAX script's 24 batches of 4 random ``crop`` x ``crop`` crops
    (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(QAT_BATCHES):
        b = []
        for _ in range(QAT_BATCH):
            s = samples[rng.integers(0, len(samples))]
            y = rng.integers(0, s.shape[0] - crop + 1)
            x = rng.integers(0, s.shape[1] - crop + 1)
            b.append(s[y:y + crop, x:x + crop])
        batches.append(np.stack(b))
    return batches


def conv3_heavy_study(dev, samples, qat_steps: int, crop: int, duration_s: float,
                      frame) -> dict:
    from ..export import qat
    from ..export.enhance import make_enhance_fn
    from ..export.onnx_import import import_any
    from ..interop import params_from_jax
    from ..models.configs import ConvStackConfig
    from ..models.conv_stack import apply_fused
    from ..ops.conv import conv2d

    imp = import_any(CONV3_HEAVY)
    cfg = ConvStackConfig(
        channels=tuple(imp.params[f"conv{i + 1}"]["w"].shape[-1]
                       for i in range(imp.num_conv_layers)),
        residual_layers=imp.residual_layers, final_act="none")
    rbra = imp.relu_before_residual_add
    params = params_from_jax(imp.params, device=dev)
    scales = qat.calibrate_conv_stack(params, cfg, [s[None] for s in samples[:4]],
                                      relu_before_residual_add=rbra)

    def fused(p, x):
        return apply_fused(p, x, cfg, relu_before_residual_add=rbra)

    def int8(qp):
        def apply(_p, x):
            return qat.apply_fused_int8(qp, x, cfg, scales, relu_before_residual_add=rbra)
        return apply

    def enhance(apply, dtype):
        return make_enhance_fn(apply, params, crop_left=0, srgb_domain=True,
                               compute_dtype=dtype, device=dev)

    want = [enhance(fused, torch.float32)(rgba(s)).cpu().numpy()[0] for s in samples]
    rep = {"family": "conv3_heavy", "weights": os.path.relpath(CONV3_HEAVY, REPO),
           "act_scales": scales, "qat_steps": qat_steps, "qat_lr": QAT_LR,
           "qat_crop": crop}
    ptq = quality(enhance(int8(qat.quantize_conv_stack(params)), torch.bfloat16), samples, want)
    batches = qat_batches(samples, crop)
    t0 = time.perf_counter()
    trained, _, curve = qat.qat_distill_conv_stack(
        params, cfg, batches, relu_before_residual_add=rbra, steps=qat_steps, lr=QAT_LR,
        act_scales=scales, verbose=0)
    qat_seconds = time.perf_counter() - t0
    qp_qat = qat.quantize_conv_stack(trained)
    qat_q = quality(enhance(int8(qp_qat), torch.bfloat16), samples, want)
    rep.update(ptq_psnr_vs_fp32=ptq, ptq_min_psnr_db=min(ptq), qat_psnr_vs_fp32=qat_q,
               qat_min_psnr_db=min(qat_q), qat_seconds=qat_seconds,
               distill_loss_first=float(np.mean(curve[:24])),
               distill_loss_last=float(np.mean(curve[-24:])))
    with torch.no_grad():
        x = torch.from_numpy(samples[0][None]).to(dev, torch.bfloat16)
        x = torch.relu(conv2d(params["conv1"], x.float())).to(torch.bfloat16)
        rep["conv2_breakdown"] = layer_breakdown(qp_qat["conv2"], params["conv2"], x,
                                                 scales["conv2"])
    rep["ms_per_frame"] = {
        "bf16": time_ms(enhance(fused, torch.bfloat16), frame, duration_s),
        "int8_qat": time_ms(enhance(int8(qp_qat), torch.bfloat16), frame, duration_s)}
    return rep


def pix_shuffle_study(dev, samples, duration_s: float, frame) -> dict:
    from ..export.enhance import make_enhance_fn
    from ..export.onnx_import import import_pix_shuffle
    from ..export.quantized import make_quantized_enhance
    from ..interop import params_from_jax
    from ..models import get_model
    from ..models.pix_shuffle import apply_eager

    imp = import_pix_shuffle(PIX_SHUFFLE)
    m = get_model("pix_shuffle")
    params = params_from_jax(imp.params, device=dev)
    gamma = dict(crop_left=imp.crop_left, srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
                 linear_to_srgb_exponent=imp.linear_to_srgb_exponent, device=dev)
    int8 = make_quantized_enhance(params, m.config,
                                  [s ** imp.srgb_to_linear_exponent for s in samples[:4]],
                                  **gamma)
    fp32 = make_enhance_fn(m.apply, params, compute_dtype=torch.float32, **gamma)
    want = [fp32(rgba(s)).cpu().numpy()[0] for s in samples]
    ptq = quality(int8, samples, want)
    k1 = make_enhance_fn(m.apply, params, **gamma)
    eager = make_enhance_fn(functools.partial(apply_eager, cfg=m.config), params, **gamma)
    return {"family": "pix_shuffle", "weights": os.path.relpath(PIX_SHUFFLE, REPO),
            "ptq_psnr_vs_fp32": ptq, "ptq_min_psnr_db": min(ptq),
            "ms_per_frame": {"k1": time_ms(k1, frame, duration_s),
                             "eager_bf16": time_ms(eager, frame, duration_s),
                             "int8_ptq": time_ms(int8, frame, duration_s)}}


def _card(dev) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]


def run(device=None, qat_steps: int = 300, duration_s: float = 2.0, frame_hw=None,
        crop: int = QAT_CROP, out=None) -> dict:
    """The whole study on ``device`` (default ``cuda``); writes ``out`` when
    given and returns the report."""
    from .. import resolve_device

    dev = resolve_device(device)
    samples = load_samples(frame_hw)
    frame = torch.from_numpy(rgba(samples[0])).to(dev)
    report = {"frames": [os.path.relpath(SAMPLES.format(i), REPO) for i in range(8)],
              "frame_hw": list(samples[0].shape[:2]), "device": str(dev),
              "card": _card(dev),
              "conv3_heavy": conv3_heavy_study(dev, samples, qat_steps, crop, duration_s, frame),
              "pix_shuffle": pix_shuffle_study(dev, samples, duration_s, frame)}
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="int8 PTQ/QAT study on the card")
    ap.add_argument("--qat_steps", type=int, default=300)
    ap.add_argument("--duration", type=float, default=2.0, help="seconds a timed variant")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report = run(args.device, args.qat_steps, args.duration, out=args.out)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

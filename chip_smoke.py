"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time:

1. device     the card (nvidia-smi name and power limit, torch's name)
2. build      nvcc build of the port's kernels (time, ptxas registers/spills)
3. k1_parity  the fused-stack kernel (K1) against its plain PyTorch version,
              shipped weights, seeded inputs, half-res 288x376 and 288x368
4. k3_parity  the palette-dither kernel (K3) against its plain version, byte
              for byte: 16 lores crops (188x144), one 376x288 crop and one
              ragged crop, N in {2, 32, 256, 1024}, every mode
5. enhance    8 seeded 576x752 RGBA frames through enhance_from_onnx on cuda
6. server     the port's frame server at depth 0 and 2 (slice 1's main path):
              every launch counter is set to 0 just before and read just after
7. datagen    the port's dataset generator (slice 2's main path) on two seeded
              1504x1152 images, 376x288 lores crops, kmeans_torch palettes 64
              and 256, five dithers, device_batch 16, counters from 0; then
              its rerun (nothing to do), k-means on the card against the CPU,
              and the per-crop route against the batched one, PNG for PNG
8. timing     CUDA-event medians of K1, its plain version, cuDNN, the enhance;
              of K3, its plain version, cdist + topk, the batched k-means
9. kernels    every kernel launched, held against its plain version

Then the card's nvidia-smi line and the kernels line, and last the contract
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero and
prints no result; a watchdog ends the run with exit 3 at 600 s. Needs one
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

WATCHDOG_S = 600
REPO = os.path.dirname(os.path.abspath(__file__))
ONNX = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")
K1_SOURCE = "fs_uae_image_enhancer_project_tpu_torch/ops/cuda/csrc/fused_stack.cu"
K1_REPLACES = "fs_uae_image_enhancer_project_tpu/ops/pallas/fused_stack.py:204"
K3_SOURCE = "fs_uae_image_enhancer_project_tpu_torch/ops/cuda/csrc/dither.cu"
K3_REPLACES = "fs_uae_image_enhancer_project_tpu/ops/pallas/dither.py:49"
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
PSNR_MIN_DB = 50.0

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
    """Device time per call of ``fn``, with ``n`` calls back to back. A sleep
    kernel holds the stream while the host enqueues the calls, so the events
    time the device and not the Python that launches it (a short kernel
    takes less time than its wrapper). ``host_behind`` says that the host
    took longer to enqueue than the sleep lasted, so gaps may be counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = int(preroll_ms * 2e6)  # at most 2 GHz: the sleep lasts at least preroll_ms
    per, behind = [], False
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        h0 = time.perf_counter()
        s.record()
        for _ in range(n):
            fn()
        e.record()
        behind |= (time.perf_counter() - h0) * 1e3 > preroll_ms
        e.synchronize()
        per.append(s.elapsed_time(e) / n)
    return {"ms": statistics.median(per), "host_behind": behind}


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


def gradient_noise(h: int, w: int, seed: int, sigma: float = 24.0):
    """A seeded smooth gradient plus Gaussian noise, uint8 (h, w, 3)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)], -1)
    return np.clip(base + rng.normal(0, sigma, (h, w, 3)) + 30, 1, 255).astype(np.uint8)


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


def datagen(dev) -> dict:
    """The port's generator on ``dev`` (slice 2's main path): two seeded
    1504x1152 images, 376x288 lores crops (at most 8 per image), kmeans_torch
    palettes 64 and 256, five dithers, device_batch 16, every launch counter
    from 0. Then its rerun, the k-means on ``dev`` against the CPU, and the
    per-crop route on the first image against the batched run's PNGs."""
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
        os.makedirs(src)
        # noise strong enough that a lores crop keeps more than 256 RGB444
        # colours, as a photo does: the k-means path runs, not the
        # unique-colour fallback (at sigma 24 most crops fall back)
        for i in range(2):
            Image.fromarray(gradient_noise(1152, 1504, seed=10 + i, sigma=48.0)).save(
                os.path.join(src, f"img_{i}.png"))

        def gen_cfg(dest, images, **kw):
            return GeneratorConfig(
                train_images=images, dest_dir=os.path.join(tmp, dest), crop_w=CROP_W,
                crop_h=CROP_H, resolutions=("lores",), colorspaces=("RGB444",),
                palettes=PALETTES, dithers=DITHERS, palette_algorithm="kmeans_torch",
                quantize_backend="device", max_crops_per_image=8, workers=1,
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
        percrop_styled=len(per_styled), percrop_k3_launches=per_launches,
        percrop_seconds=per_s, percrop_styled_crops_per_s=len(per_styled) / per_s,
        percrop_files_differing_from_batched=sum(per_out[k] != out.get(k) for k in per_out),
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


def main() -> int:
    global _phase
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
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.ops.pixel_shuffle import pixel_unshuffle
    from fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar import (
        SidecarClient, SidecarServer)

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
    emit("build", t0, build_seconds=round(build.build_info["seconds"], 3),
         built=build.build_info["built"], smem_bytes=lib.fse_fused_stack_smem_bytes(),
         ptxas=ptxas)

    # 3. k1_parity: shipped weights, seeded linear-light inputs
    _phase = "k1_parity"
    t0 = time.perf_counter()
    imp = import_pix_shuffle(ONNX)
    params = params_from_jax(imp.params, device=dev)
    sw = fs.prepare_weights(params, dev)
    gen = torch.Generator().manual_seed(0)
    k1_err, shapes = 0.0, []
    for h2, w2 in ((288, 376), (288, 368)):
        u = (torch.rand(h2, w2, 12, generator=gen) ** 2.2).to(torch.bfloat16).to(dev)
        y = fs.fused_stack(u, sw).float()
        ref = fs.fused_stack_plain(u, sw, out_fp32=True)
        torch.cuda.synchronize()
        err = (y - ref).abs()
        row, col = err.amax(dim=(1, 2)), err.amax(dim=(0, 2))
        seam_r = torch.tensor([r for r in range(h2) if r % 16 in (0, 15)])
        seam_c = torch.tensor([c for c in range(w2) if c % 16 in (0, 15)])
        rec = dict(shape=[h2, w2], max_abs=err.max().item(), mean_abs=err.mean().item(),
                   seam_row_max=row[seam_r.to(dev)].max().item(),
                   seam_col_max=col[seam_c.to(dev)].max().item(),
                   row_max_top5=sorted(row.tolist(), reverse=True)[:5],
                   finite=bool(torch.isfinite(y).all()))
        shapes.append(rec)
        k1_err = max(k1_err, rec["max_abs"])
    emit("k1_parity", t0, cudnn_allow_tf32=False, tol_max_abs=K1_MAX_ABS,
         tol_mean_abs=K1_MEAN_ABS, shapes=shapes)
    for rec in shapes:
        check(rec["finite"], f"K1 output not finite at {rec['shape']}")
        check(rec["max_abs"] <= K1_MAX_ABS, f"K1 max abs {rec['max_abs']} > {K1_MAX_ABS}")
        check(rec["mean_abs"] <= K1_MEAN_ABS, f"K1 mean abs {rec['mean_abs']} > {K1_MEAN_ABS}")

    # 4. k3_parity: byte equality with the plain version at every N and mode
    _phase = "k3_parity"
    t0 = time.perf_counter()
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3

    k3_par = k3_parity(dev)
    emit("k3_parity", t0, **k3_par)
    check(not k3_par["differing"], f"K3 differs from its plain version: {k3_par['differing']}")

    # 5. enhance: the entry point on cuda vs the same run with the plain stack
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

    # 6. server: slice 1's main path, every counter from 0
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

    # 7. datagen: slice 2's main path, every counter from 0
    _phase = "datagen"
    t0 = time.perf_counter()
    dg = datagen(dev)
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

    # 8. timing at the main paths' shapes
    _phase = "timing"
    t0 = time.perf_counter()
    x = (torch.from_numpy(frames[0, :, imp.crop_left:, :3]).to(dev).float() / 255.0)
    x = x ** imp.srgb_to_linear_exponent
    u = pixel_unshuffle(x[None], 2)[0].to(torch.bfloat16).contiguous()
    h2, w2 = u.shape[:2]
    k1_ms = median_ms(lambda: fs.fused_stack(u, sw))
    plain_ms = median_ms(lambda: fs.fused_stack_plain(u, sw))
    library_ms = median_ms(lambda: library_stack(u, sw))
    frame_dev = torch.from_numpy(frames[:1]).to(dev)
    enhance_ms = median_ms(lambda: enhance(frame_dev))
    flops = 2.0 * fs.MACS_PER_PIXEL * h2 * w2
    nbytes = (2 * u.numel() * u.element_size()
              + sum(w.numel() * w.element_size() for w in sw.frags)
              + sw.prm.numel() * sw.prm.element_size())
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)

    k3_rows, kmeans_ms = k3_timing(dev, dg["arrs"], dg["stacks"])
    k3_ref = next(r for r in k3_rows if r["n"] == 256 and r["mode"] == "bayer4x4")
    check(all(r["equal_to_plain"] for r in k3_rows),
          "K3 differs from its plain version on the generator's crops and palettes")
    emit("timing", t0, shape=[h2, w2, 12], gflop=flops / 1e9, mbytes=nbytes / 1e6,
         k1_ms=k1_ms, bound_ms=bound_ms, share_of_bound=bound_ms / k1_ms,
         plain_ms=plain_ms, library_ms=library_ms, enhance_ms_per_frame=enhance_ms,
         enhance_fps=1e3 / enhance_ms, k3_shape=list(dg["arrs"].shape), k3=k3_rows,
         kmeans_ms=kmeans_ms, datagen_styled_crops_per_s=dg["styled_crops_per_s"],
         nvidia_smi=smi)

    # 9. kernels
    _phase = "kernels"
    kernels = [dict(
        name="fused_stack", route="cuda", source=K1_SOURCE, replaces=K1_REPLACES,
        counterpart="ops/pallas/fused_stack.py::_stack_kernel",
        launches=launches["fused_stack"], max_abs_err=k1_err, ms=k1_ms, kernel_ms=k1_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=library_ms),
        dict(name="palette_dither", route="cuda", source=K3_SOURCE, replaces=K3_REPLACES,
             counterpart="ops/pallas/dither.py::_dither_kernel",
             at="16 lores crops 188x144, N=256, ordered 4x4",
             launches=dg["launches"]["palette_dither"], max_abs_err=k3_par["max_abs_err"],
             ms=k3_ref["k3_ms"],
             kernel_ms=k3_ref["k3_ms"], plain_ms=k3_ref["plain_ms"],
             bound_ms=k3_ref["bound_ms"], bound_by=k3_ref["bound_by"],
             library_ms=k3_ref["library_ms"])]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # report the phase, then fail
        print(json.dumps({"phase": _phase, "error": f"{type(e).__name__}: {e}"}), flush=True)
        raise
    sys.exit(rc)

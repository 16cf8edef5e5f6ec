"""End-to-end dataset-generation throughput: the device route against the host route.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.bench_generator_e2e \\
        --gt DIR [--images 2] [--max_crops 8] [--device_batch 16] \\
        [--legs host device device_batched] [--out FILE] [--device cpu]

Port of the repo's ``scripts/bench_generator_e2e.py``. It runs the port's
generator (``datagen/generator.py``: scan, targets, styled phases) on the
same slice of the lores corpus in each leg, with the same crop specs:

- ``host``: ``palette_algorithm="kmeans"`` (sklearn's k-means a crop) and
  the host's ``numpy`` dither, the reference's architecture. Where sklearn
  does not import, the run says so on a line of its own and runs
  ``kmeans_torch`` on the CPU with the ``numpy`` dither instead, reported as
  ``host_kmeans_torch_cpu``, never as ``host``;
- ``device``: ``kmeans_torch`` and the palette-dither kernel (K3) a crop on
  ``--device``, one worker;
- ``device_batched``: the same at ``device_batch`` crops a call (one k-means
  call and one K3 launch a style and chunk).

``--legs`` runs a subset (default all three; the speedups need the host
leg).

The slice is the dither families K3 covers (none, checkerboard, bayer*) at
palettes 64 and 256. The images are ``--images`` frames of ``--gt`` whose
names start with ``sample`` (the JAX script's filter: the flat fills'
one-colour palettes would distort every leg), or the ``--images`` frames
given by name where the corpus has no reference samples
(``make_gt_frames`` writes ``scene_*`` and ``flat*``). Each leg's K3
launches are counted. Each leg writes its tree to ``genbench_<leg>`` under
``--work_dir``, kept there (a training split the evaluation can read), or
under a temporary directory. The report goes to ``--out`` when given and
is printed as the last line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

PALETTES = (64, 256)
DITHERS = ("none", "checkerboard", "bayer2x2", "bayer4x4", "bayer8x8")
CROP = (376, 288)


def sklearn_available() -> bool:
    try:
        import sklearn.cluster  # noqa: F401
    except ImportError:
        return False
    return True


def pick_images(gt: str, names, n: int) -> list:
    """``n`` frames of ``gt``: the named ones, or the ``sample*.png``."""
    if names:
        imgs = [os.path.join(gt, f) for f in names]
        missing = [p for p in imgs if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"no such images: {missing}")
        return imgs[:n]
    return sorted(os.path.join(gt, f) for f in os.listdir(gt)
                  if f.startswith("sample") and f.endswith(".png"))[:n]


def run_once(tag: str, images, work: str, palette_algorithm: str, backend: str,
             device: str, max_crops: int, device_batch: int = 0) -> dict:
    """One generator run into a fresh directory; its styled crops/s and its
    K3 launches."""
    import torch

    from ..datagen.generator import DatasetGenerator, GeneratorConfig
    from ..ops.cuda import dither as k3

    dest = os.path.join(work, f"genbench_{tag}")
    shutil.rmtree(dest, ignore_errors=True)
    cfg = GeneratorConfig(
        train_images=list(images), test_images=(), dest_dir=dest,
        crop_w=CROP[0], crop_h=CROP[1], resolutions=("lores",), colorspaces=("RGB444",),
        palettes=PALETTES, dithers=DITHERS, rotations=(0,), downscales=(100,),
        palette_algorithm=palette_algorithm, quantize_backend=backend,
        device_batch=device_batch, max_crops_per_image=max_crops, workers=1,
        cache_dir=os.path.join(work, f"genbench_cache_{tag}"), verbose=0, device=device)
    before = k3.palette_dither.launches
    t0 = time.perf_counter()
    stats = DatasetGenerator(cfg).run()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    styled = targets = 0
    for _r, _d, files in os.walk(dest):
        for f in files:
            if f.endswith(".png"):
                targets += f.startswith("target_")
                styled += not f.startswith("target_")
    res = {
        "palette_algorithm": palette_algorithm, "dither_backend": backend,
        "device": device, "device_batch": device_batch, "wall_s": dt,
        "target_crops": targets, "styled_crops": styled,
        "styled_crops_per_s": styled / dt, "k3_launches": k3.palette_dither.launches - before,
        "missing": stats["missing"],
    }
    print(json.dumps({tag: res}), flush=True)
    return res


LEGS = ("host", "device", "device_batched")


def run(gt: str, images=None, n_images: int = 2, max_crops: int = 8, device_batch: int = 16,
        device: str = "cuda", work_dir=None, legs=LEGS) -> dict:
    """The ``legs`` on the chosen frames of ``gt``; the report."""
    from ..utils.platform import wait_for_bench_lock

    imgs = pick_images(gt, images, n_images)
    if not imgs:
        raise FileNotFoundError(f"no sample*.png under {gt}; name the frames with --images")
    wait_for_bench_lock()
    results = {
        "slice": {"images": [os.path.basename(p) for p in imgs],
                  "max_crops_per_image": max_crops, "palettes": list(PALETTES),
                  "dithers": list(DITHERS), "crop": list(CROP), "legs": list(legs)},
        "cpu_count": os.cpu_count(),
        "device": device,
    }
    with contextlib.ExitStack() as stack:
        work = work_dir or stack.enter_context(tempfile.TemporaryDirectory())
        if "host" in legs:
            if sklearn_available():
                host_tag = "host"
                results[host_tag] = run_once(host_tag, imgs, work, "kmeans", "numpy", "cpu",
                                             max_crops)
            else:
                print("NOTE: sklearn does not import here, so the host leg (sklearn k-means) "
                      "cannot run; host_kmeans_torch_cpu runs kmeans_torch on the CPU with the "
                      "numpy dither instead", flush=True)
                host_tag = "host_kmeans_torch_cpu"
                results[host_tag] = run_once(host_tag, imgs, work, "kmeans_torch", "numpy",
                                             "cpu", max_crops)
            results["host_leg"] = host_tag
        if "device" in legs:
            results["device_per_crop"] = run_once("device", imgs, work, "kmeans_torch", "device",
                                                  device, max_crops)
        if "device_batched" in legs:
            results["device_batched"] = run_once("device_batched", imgs, work, "kmeans_torch",
                                                 "device", device, max_crops,
                                                 device_batch=device_batch)
    if "host_leg" in results:
        host_rate = max(results[results["host_leg"]]["styled_crops_per_s"], 1e-9)
        for leg, key in (("device_per_crop", "device_speedup_x"),
                         ("device_batched", "device_batched_speedup_x")):
            if leg in results:
                results[key] = results[leg]["styled_crops_per_s"] / host_rate
    if device.startswith("cuda"):
        import torch

        results["card"] = torch.cuda.get_device_name(0)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Generator throughput, device against host")
    ap.add_argument("--gt", required=True, help="the ground-truth frames (make_gt_frames)")
    ap.add_argument("--images", nargs="*", default=None,
                    help="frames of --gt by name (default: its sample*.png)")
    ap.add_argument("--n_images", type=int, default=2)
    ap.add_argument("--max_crops", type=int, default=8)
    ap.add_argument("--device_batch", type=int, default=16)
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--work_dir", default=None,
                    help="where the legs write their trees, kept (default: a temporary "
                         "directory, removed)")
    ap.add_argument("--legs", nargs="+", choices=LEGS, default=list(LEGS),
                    help="the legs to run (default all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = run(args.gt, args.images, args.n_images, args.max_crops, args.device_batch,
                  args.device, args.work_dir, args.legs)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

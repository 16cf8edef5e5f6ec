"""In-process batched styled phase for generation on the card.

The port of the JAX package's ``datagen/device_batch.py``. One process owns
the card; crops are staged in spec-chunks with their base preparation shared
across style combos, and each (style combo, chunk) becomes one batched torch
k-means call (:func:`.quantize.generate_palettes_kmeans_torch_batch`, when
the palette algorithm is ``kmeans_torch``) whose palettes stay on the
device, one batched K3 launch (:func:`..ops.cuda.dither.palette_dither`) on
the same device tensors, and one copy of the uint8 results to the host.
Outputs are byte-identical to the per-crop device path
(tests/test_torch_generator.py).

Error-diffusion dithers, palette-free combos, >1024-colour palettes and
degenerate crops (fewer unique grid colours than the palette target —
reference quantize.py:458-474 takes the unique colours directly) fall back
to the scalar in-process path, reusing the already-prepared base crop.

Reference counterpart: dataset_generator/generator.py:381-537 (per-crop
styled phase over a process pool with per-crop sklearn k-means).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .quantize import (
    BAYER_MATRIX_2X2,
    BAYER_MATRIX_4X4,
    BAYER_MATRIX_8X8,
    generate_palette_kmeans_sklearn,
    generate_palette_median_cut,
    generate_palette_octree,
    generate_palettes_kmeans_torch_batch,
    grid_quantize,
    reduce_color_depth_and_dither,
)
from .util_img import post_apply_resolution_style, pre_apply_resolution_style

# dither families the kernel covers, mapped to (kernel mode, bayer)
_VECTORIZABLE = {
    "none": ("none", None),
    "checkerboard": ("checkerboard", None),
    "bayer2x2": ("ordered", BAYER_MATRIX_2X2),
    "bayer4x4": ("ordered", BAYER_MATRIX_4X4),
    "bayer8x8": ("ordered", BAYER_MATRIX_8X8),
}


def _spec_key(spec_d: dict) -> tuple:
    return (
        spec_d["image_path"], spec_d["rot_deg"], spec_d["scale_perc"],
        spec_d["crop_x"], spec_d["crop_y"],
    )


def _combo_key(combo_d: dict) -> tuple:
    return (
        combo_d["resolution"], combo_d["colorspace"], combo_d["palette"],
        combo_d["dither"],
    )


def _host_palette(pixels: np.ndarray, arr: np.ndarray, n: int, algo: str):
    if algo == "kmeans":
        return generate_palette_kmeans_sklearn(pixels, n)
    if algo == "median_cut":
        return generate_palette_median_cut(arr, n)
    if algo == "octree":
        return generate_palette_octree(arr, n)
    raise ValueError(f"unexpected host palette algorithm {algo!r}")


def _save_styled(out_arr: np.ndarray, resolution: str, out_path: str) -> None:
    from PIL import Image

    styled = post_apply_resolution_style(Image.fromarray(out_arr), resolution)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    styled.save(out_path)


def style_batch_on_device(
    arrs: np.ndarray,
    palette: int,
    method: str,
    bayer,
    algorithm: str = "kmeans_torch",
    device=None,
    *,
    colorspace: str = "RGB444",
    host_palettes: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The device stage of one (style combo, chunk): (B, H, W, 3) uint8
    pre-styled crops -> (B, H, W, 3) uint8 dithered crops, no PIL.

    With ``algorithm='kmeans_torch'`` the palettes come from one batched
    k-means call on ``device`` (default ``cuda``) over the crops'
    ``colorspace`` grid-quantized pixels, and stay there; otherwise
    ``host_palettes`` ((B, palette, 3) uint8) are copied up. Then one K3
    launch (its plain version on the CPU) on the same device tensors, and
    one copy of the result to the host.
    """
    from ..ops.cuda.dither import palette_dither

    dev = resolve_device(device)
    if algorithm == "kmeans_torch":
        pixels = grid_quantize(arrs, colorspace).reshape(arrs.shape[0], -1, 3)
        palettes = generate_palettes_kmeans_torch_batch(
            pixels.astype(np.float32), palette, device=dev)
    else:
        palettes = torch.from_numpy(np.ascontiguousarray(host_palettes)).to(dev)
    x = torch.from_numpy(np.ascontiguousarray(arrs)).to(dev)
    return palette_dither(x, palettes, method, bayer).cpu().numpy()


def run_styled_jobs_batched(
    jobs: List[tuple],
    batch_size: int,
    report: Callable[[str, Optional[str]], None],
    should_stop: Callable[[], bool] = lambda: False,
) -> None:
    """Run styled-crop jobs (the tuples built by
    ``DatasetGenerator._generate``) through the batched device pipeline.

    ``report(out_path, err)`` is invoked once per job (err=None on success);
    ``should_stop`` is polled at chunk boundaries (SIGINT stays
    boundary-safe, like the process-pool path).
    """
    from .generator import _prepare_base

    if not jobs:
        return
    # crop geometry / algorithm / backend / device are per-run constants
    # (from GeneratorConfig) — identical across every styled job
    _, _, crop_w, crop_h, palette_algorithm, backend, device, _ = jobs[0]

    # stage jobs: spec -> [(combo_d, out_path)], preserving first-seen order
    by_spec: Dict[tuple, Tuple[dict, list]] = {}
    for spec_d, combo_d, _w, _h, _alg, _bk, _dev, out_path in jobs:
        entry = by_spec.setdefault(_spec_key(spec_d), (spec_d, []))
        entry[1].append((combo_d, out_path))

    spec_keys = list(by_spec.keys())
    for lo in range(0, len(spec_keys), batch_size):
        if should_stop():
            return
        chunk = spec_keys[lo : lo + batch_size]

        # host: one base preparation per spec, shared by every combo
        bases: Dict[tuple, "object"] = {}
        failed_specs: Dict[tuple, str] = {}
        for sk in chunk:
            spec_d = by_spec[sk][0]
            try:
                bases[sk] = _prepare_base(
                    spec_d["image_path"], spec_d["rot_deg"],
                    spec_d["scale_perc"],
                    (spec_d["crop_x"], spec_d["crop_y"]), crop_w, crop_h,
                )
            except Exception as e:  # propagate per-job below
                failed_specs[sk] = f"{type(e).__name__}: {e}"

        # regroup this chunk's jobs by style combo
        by_combo: Dict[tuple, list] = {}
        for sk in chunk:
            if sk in failed_specs:
                for _combo_d, out_path in by_spec[sk][1]:
                    report(out_path, failed_specs[sk])
                continue
            for combo_d, out_path in by_spec[sk][1]:
                by_combo.setdefault(_combo_key(combo_d), []).append(
                    (sk, combo_d, out_path)
                )

        pre_cache: Dict[tuple, np.ndarray] = {}  # (spec, resolution) -> arr

        def pre_styled(sk: tuple, resolution: str) -> np.ndarray:
            arr = pre_cache.get((sk, resolution))
            if arr is None:
                low = pre_apply_resolution_style(bases[sk], resolution)
                arr = np.asarray(low, dtype=np.uint8)
                pre_cache[(sk, resolution)] = arr
            return arr

        for ck, items in by_combo.items():
            resolution, colorspace, palette, dither = ck
            method_bayer = _VECTORIZABLE.get(dither)
            batchable = (
                method_bayer is not None
                and palette is not None
                and 2 <= palette <= 1024
            )

            scalar_items = []
            if not batchable:
                scalar_items = items
            else:
                method, bayer = method_bayer
                arrs, pal_host, batch_items = [], [], []
                for sk, combo_d, out_path in items:
                    # per-item staging failures report like the per-crop
                    # path (save_styled_worker) instead of aborting the
                    # whole styled phase
                    try:
                        arr = pre_styled(sk, resolution)
                        pixels = grid_quantize(arr, colorspace).reshape(-1, 3)
                        uniq = np.unique(pixels, axis=0)
                        if min(palette, len(uniq)) < palette:
                            # degenerate: reference semantics take the unique
                            # colours (or a sub-k palette) — scalar path
                            scalar_items.append((sk, combo_d, out_path))
                            continue
                        if palette_algorithm != "kmeans_torch":
                            pal_host.append(
                                _host_palette(pixels, arr, palette,
                                              palette_algorithm)
                            )
                    except Exception as e:
                        report(out_path, f"{type(e).__name__}: {e}")
                        continue
                    arrs.append(arr)
                    batch_items.append((sk, combo_d, out_path))

                if batch_items:
                    try:
                        out = style_batch_on_device(
                            np.stack(arrs), palette, method, bayer,
                            palette_algorithm, device, colorspace=colorspace,
                            host_palettes=np.stack(pal_host) if pal_host else None,
                        )
                        for i, (_sk, _combo_d, out_path) in enumerate(
                            batch_items
                        ):
                            try:
                                _save_styled(out[i], resolution, out_path)
                                report(out_path, None)
                            except Exception as e:
                                report(out_path,
                                       f"{type(e).__name__}: {e}")
                    except Exception as e:
                        # batch-level failure: every member reports it
                        err = f"{type(e).__name__}: {e}"
                        for _sk, _combo_d, out_path in batch_items:
                            report(out_path, err)

            for sk, combo_d, out_path in scalar_items:
                try:
                    arr = pre_styled(sk, resolution)
                    out_arr = reduce_color_depth_and_dither(
                        arr,
                        color_space=colorspace,
                        target_palette_size=palette,
                        dithering_method=dither,
                        palette_algorithm=palette_algorithm,
                        verbose=0,
                        backend=backend,
                        device=device,
                    )
                    _save_styled(out_arr, resolution, out_path)
                    report(out_path, None)
                except Exception as e:
                    report(out_path, f"{type(e).__name__}: {e}")
